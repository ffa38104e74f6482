"""The host oracle's simulator (``fantoch_tpu_torch/sim/runner.py``) against
the reference's ``fantoch_tpu/sim/runner.py`` on the CPU.

The same inputs run through both ``Runner``s, for Basic and FPaxos: a
fault-free run, per-message reorder, a seeded jitter plan, a crash plan,
a lossy drop plan under a horizon and an open-loop arrival preset, all
on the ``DeviceStream`` workload at conflict 50. Equal are every
region's ``(issued, Histogram.all_values())``, every process's protocol
and executor metrics (counters and histograms) and every executor's
per-key execution order; an FPaxos run under a jitter + drop plan whose
channels pass 512 emissions equals the reference's too (the port
grows its seeded wire tables from 256 indices; the reference draws
16,384 at once). ``KeyGenState(DeviceStream)`` (keys through K3's
plain twin) gives the reference's keys and read flags for ConflictPool,
Zipf and two traffic presets past the first 512-key batch. Tolerance:
none."""

import pytest

from fantoch_tpu import client as rclient
from fantoch_tpu import core as rcore
from fantoch_tpu import protocol as rprotocol
from fantoch_tpu import sim as rsim
from fantoch_tpu.engine import faults as rfaults
from fantoch_tpu.traffic import schedule as rtraffic
from fantoch_tpu_torch import client, core, protocol, sim
from fantoch_tpu_torch.engine import faults
from fantoch_tpu_torch.traffic import schedule as traffic
from torch_oracle import snapshot

PORT = (client, core, protocol, sim, faults)
REF = (rclient, rcore, rprotocol, rsim, rfaults)

REGIONS = ["asia-east1", "us-central1", "us-west1"]

# each scenario: (fault plan JSON or None, reorder, arrival preset)
SCENARIOS = {
    "fault_free": (None, False, None),
    "reorder": (None, True, None),
    "jitter": ({"jitter_max": 8, "jitter_seed": 5}, False, None),
    "crash": ({"crash": {"1": 300}}, False, None),
    "drop": ({"drop_bp": 400, "seed": 3, "horizon": 5000,
              "jitter_max": 4, "jitter_seed": 2}, False, None),
    "open_loop": (None, False, "poisson"),
}


def run(pkgs, name, scenario, commands=10, runners=None):
    client, core, protocol, sim, faults = pkgs
    plan_json, reorder, arrivals = (scenario if isinstance(scenario, tuple)
                                    else SCENARIOS[scenario])
    config = core.Config(n=3, f=1, gc_interval_ms=100,
                         leader=1 if name == "fpaxos" else None,
                         executor_monitor_execution_order=True)
    workload = client.Workload(
        shard_count=1,
        key_gen=client.DeviceStream(conflict_rate=50, pool_size=2, seed=4),
        keys_per_command=1,
        commands_per_client=commands,
        payload_size=0,
    )
    runner = sim.Runner(
        protocol.BY_NAME[name], core.Planet.new(), config, workload, 2,
        REGIONS, REGIONS, seed=7,
        fault_plan=(None if plan_json is None
                    else faults.FaultPlan.from_json(plan_json)),
        arrivals=arrivals, open_window=2,
    )
    runner.reorder_messages = reorder
    out = runner.run(extra_sim_time_ms=1000)
    if runners is not None:
        runners.append(runner)
    return snapshot(*out)


@pytest.mark.parametrize("scenario", list(SCENARIOS))
@pytest.mark.parametrize("name", ["basic", "fpaxos"])
def test_runner_matches_the_reference(name, scenario):
    got, want = run(PORT, name, scenario), run(REF, name, scenario)
    assert got == want
    completed = sum(len(v) for _, v in got["latencies"].values())
    assert completed > 0
    if scenario in ("fault_free", "reorder", "jitter", "open_loop"):
        assert completed == 10 * 6
        assert all(got["orders"][pid] for pid in got["orders"])


def _stream(pkgs, kg, client_id, count):
    client = pkgs[0]
    state = client.KeyGenState(kg, 1, client_id)
    keys, reads = [], []
    for _ in range(count):
        keys.append(state.gen_cmd_key())
        reads.append(state.traffic_read_only())
    return keys, reads


@pytest.mark.parametrize("kind", ["conflict_pool", "zipf", "churn",
                                  "diurnal"])
def test_device_stream_keys_match_the_reference(kind):
    count = 600  # past the first 512-key batch
    kw = dict(conflict_rate=40, pool_size=3, seed=9)
    if kind == "zipf":
        kw["zipf"] = (1.0, 16)
    got_kw, want_kw = dict(kw), dict(kw)
    if kind in ("churn", "diurnal"):
        # a budget past one batch: the epoch tables are recompiled to
        # cover the second batch's seqs
        got_kw["traffic"] = traffic.resolve_traffic(
            kind, conflict=40, pool_size=3, commands=count)
        want_kw["traffic"] = rtraffic.resolve_traffic(
            kind, conflict=40, pool_size=3, commands=count)
    for client_id in (1, 4):
        got = _stream(PORT, client.DeviceStream(**got_kw), client_id, count)
        want = _stream(REF, rclient.DeviceStream(**want_kw), client_id,
                       count)
        assert got == want
        keys, reads = got
        assert len(set(keys)) > 1
        if kind == "diurnal":
            assert set(reads) == {True, False}
        elif kind != "churn":
            assert set(reads) == {None}


# a jitter + drop plan on a run long enough that the leader's channels
# pass the first build of the seeded wire tables (256 emission indices)
GROWTH = {"drop_bp": 20, "seed": 3, "horizon": 20_000, "jitter_max": 4,
          "jitter_seed": 2}


def test_wire_tables_grow_as_the_reference():
    """The port's ``Runner`` builds the seeded drop and jitter tables for
    256 channel indices and doubles them on demand (the reference builds
    ``[n, n, 16384]`` at once): a table is the prefix of every longer
    one, and a run whose channels pass 256 emissions equals the
    reference's."""
    plan, rplan = (faults.FaultPlan.from_json(GROWTH),
                   rfaults.FaultPlan.from_json(GROWTH))
    for k in (256, 512):
        assert (plan.jitter_table(3, k)
                == rplan.jitter_table(3, 1 << 14)[..., :k]).all()
        assert (plan.drop_table(3, k)
                == rplan.drop_table(3, 1 << 14)[..., :k]).all()
    runners = []
    got = run(PORT, "fpaxos", (GROWTH, False, None), 100, runners)
    want = run(REF, "fpaxos", (GROWTH, False, None), 100)
    assert got == want
    # past two doublings; a drop stalled some clients
    assert runners[0]._wire_k == 1024
    assert 0 < sum(len(v) for _, v in got["latencies"].values()) < 6 * 100
