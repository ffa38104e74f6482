"""Basic, FPaxos and the slot executor of the host oracle
(``fantoch_tpu_torch/protocol``, ``executor``, ``sim``) on the CPU.

* the exact latency means the reference's ``tests/test_sim_basic.py``
  pins for Basic n = 3 (f = 0, 1, 2; with 1 and 10 clients a region) and
  its GC completeness, on the port alone;
* the reference harness's ``sim_test`` checks (``tests/harness.py``:
  every process executes every key in one order, every command is GC'd
  at the f + 1 acceptors) for the ``tests/test_sim_fpaxos.py`` cases,
  and GC at every process for Basic, on the port's runner;
* the single-decree ``Synod`` against the reference's under the
  hypothesis actions of ``tests/test_synod_property.py`` (every output
  of every handler equal), with a fixed ``max_examples``;
* ``python -m fantoch_tpu_torch sim`` prints the reference CLI's bytes,
  for every protocol of ``protocol.BY_NAME``.

Tolerance: none."""

from __future__ import annotations

import json

import pytest
from hypothesis import given, settings

from fantoch_tpu.protocol import synod as rsynod
from fantoch_tpu_torch.client import ConflictPool, Workload
from fantoch_tpu_torch.core import Config, Planet
from fantoch_tpu_torch.protocol import Basic, FPaxos
from fantoch_tpu_torch.protocol import synod
from fantoch_tpu_torch.protocol.base import ProtocolMetricsKind
from fantoch_tpu_torch.sim import Runner
from harness import check_metrics, check_monitors
from test_synod_property import F, N, PRIMES, _actions, _proposal_gen


def run_basic(f, clients_per_process, commands_per_client):
    config = Config(n=3, f=f, gc_interval_ms=100)
    workload = Workload(
        shard_count=1,
        key_gen=ConflictPool(conflict_rate=100, pool_size=1),
        keys_per_command=1,
        commands_per_client=commands_per_client,
        payload_size=100,
    )
    runner = Runner(
        Basic, Planet.new(), config, workload, clients_per_process,
        ["asia-east1", "us-central1", "us-west1"], ["us-west1", "us-west2"],
    )
    metrics, _monitors, latencies = runner.run(extra_sim_time_ms=1000)
    expected = commands_per_client * clients_per_process
    (issued1, us_west1), (issued2, us_west2) = (
        latencies["us-west1"], latencies["us-west2"])
    assert issued1 == issued2 == expected
    for process_metrics, _executor_metrics in metrics.values():
        stable = process_metrics.get_aggregated(ProtocolMetricsKind.STABLE)
        assert stable == expected * 2
    return us_west1, us_west2


@pytest.mark.parametrize(
    "f,mean1,mean2", [(0, 0.0, 24.0), (1, 34.0, 58.0), (2, 118.0, 142.0)]
)
def test_basic_reference_means(f, mean1, mean2):
    # the reference's pins at 1,000 commands a client hold at 200: each
    # command's latency is the same in the steady closed loop
    us_west1, us_west2 = run_basic(f, 1, 200)
    assert us_west1.mean() == mean1
    assert us_west2.mean() == mean2


def test_basic_means_independent_of_client_count():
    one = run_basic(1, 1, 100)
    ten = run_basic(1, 10, 100)
    for a, b in zip(one, ten):
        assert a.mean() == b.mean() and a.cov() == b.cov()


def sim_test(protocol_cls, config, commands=20, clients=3, seed=0,
             basic=False):
    """The reference harness's ``sim_test`` on the port's runner, at its
    CI size (20 commands, 3 clients a process): 50 % conflicts over 2
    keys a command, reordered messages, 10 s of drain."""
    config = config.with_(
        executor_monitor_execution_order=True,
        gc_interval_ms=100,
        executor_executed_notification_interval_ms=100,
        shard_count=1,
    )
    planet = Planet.new()
    workload = Workload(
        shard_count=1,
        key_gen=ConflictPool(conflict_rate=50, pool_size=1),
        keys_per_command=2,
        commands_per_client=commands,
        payload_size=1,
    )
    regions = planet.regions()[: config.n]
    runner = Runner(protocol_cls, planet, config, workload, clients,
                    regions, regions, seed=seed)
    runner.reorder_messages = True
    metrics, mons, _latencies = runner.run(10_000)
    per_process = {
        pid: tuple(pm.get_aggregated(k) or 0 for k in (
            ProtocolMetricsKind.FAST_PATH, ProtocolMetricsKind.SLOW_PATH,
            ProtocolMetricsKind.STABLE))
        for pid, (pm, _em) in metrics.items()
    }
    if basic:
        # Basic orders nothing (its executor runs a command when it
        # commits) and counts no fast or slow paths: every command is
        # GC'd at every process
        total = commands * clients * config.n
        return sum(m[2] for m in per_process.values()) == config.n * total
    check_monitors(mons)
    return check_metrics(config, commands, clients, per_process)


@pytest.mark.parametrize("n,f,leader,seed", [
    (3, 1, 1, 0), (5, 1, 1, 0), (5, 2, 1, 0), (3, 1, 3, 7)])
def test_sim_fpaxos(n, f, leader, seed):
    # FPaxos has no fast/slow path distinction: the metric stays zero
    assert sim_test(FPaxos, Config(n=n, f=f, leader=leader), seed=seed) == 0


@pytest.mark.parametrize("n,f", [(3, 1), (5, 2)])
def test_sim_basic_gc(n, f):
    assert sim_test(Basic, Config(n=n, f=f), basic=True)


def _trace(mod, actions):
    """The reference test's ``_run`` on ``mod``'s ``Synod``, recording
    every handler output in order."""
    synods = {
        pid: mod.Synod(pid, N, F, _proposal_gen, PRIMES[pid])
        for pid in range(1, N + 1)
    }
    out = []

    def quorum(proposer, source, msg, members):
        results = []
        for dest, msg_lost, reply_lost in members:
            if msg_lost:
                continue
            reply = synods[dest].handle(source, msg)
            out.append(("reply", dest, reply))
            if reply is None or reply_lost:
                continue
            result = proposer.handle(dest, reply)
            out.append(("result", dest, result))
            if result is not None:
                results.append(result)
        return results

    for source, q1, q2 in actions:
        proposer = synods[source]
        prepare = proposer.new_prepare()
        promise = proposer.handle(source, prepare)
        out.append(("prepare", prepare, promise,
                    proposer.handle(source, promise)))
        outcome = quorum(proposer, source, prepare, q1)
        if len(outcome) != 1:
            continue
        accepted = proposer.handle(source, outcome[0])
        out.append(("accept", outcome[0], accepted))
        if accepted is not None:
            out.append(("local", proposer.handle(source, accepted)))
        out.append(("phase2", quorum(proposer, source, outcome[0], q2)))
    return out


@settings(max_examples=120, deadline=None, derandomize=True)
@given(_actions())
def test_synod_matches_the_reference(actions):
    got, want = _trace(synod, actions), _trace(rsynod, actions)
    assert got == want
    chosen = {o[1][0][1] for o in got
              if o[0] == "phase2" and len(o[1]) == 1
              and o[1][0][0] == synod.S_CHOSEN}
    assert len(chosen) <= 1


@pytest.mark.parametrize("argv", [
    ["--protocol", "fpaxos", "--n", "3", "--commands", "20"],
    ["--protocol", "fpaxos", "--n", "5", "--f", "2", "--commands", "10",
     "--conflict", "50", "--reorder", "--seed", "3"],
    ["--protocol", "basic", "--n", "3", "--commands", "10", "--arrivals",
     "burst", "--aws"],
    ["--protocol", "tempo", "--n", "3", "--commands", "10"],
    ["--protocol", "tempo_atomic", "--n", "5", "--f", "2", "--commands",
     "5", "--conflict", "50", "--reorder", "--seed", "3"],
    ["--protocol", "atlas", "--n", "5", "--f", "2", "--commands", "5"],
    ["--protocol", "epaxos", "--n", "3", "--commands", "10", "--conflict",
     "50", "--reorder", "--seed", "1"],
    ["--protocol", "caesar", "--n", "5", "--f", "2", "--commands", "5",
     "--conflict", "50"],
])
def test_sim_cli_matches_the_reference(argv, capsys):
    from fantoch_tpu.cli import main as r_main
    from fantoch_tpu_torch.cli import main

    r_main(["--platform", "cpu", "sim", *argv])
    want = capsys.readouterr().out
    main(["sim", *argv])
    got = capsys.readouterr().out
    assert got == want
    assert json.loads(got)["regions"]
