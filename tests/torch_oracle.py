"""The host oracle's runs on both sides, for the parity tests of
``fantoch_tpu_torch/sim``, ``protocol`` and ``executor``: one
``sim.Runner`` run of a named protocol under the reference harness's
``sim_test`` settings (``tests/harness.py``: 50 % conflicts over 2 keys a
command, per-message reorder, 10 s of drain, the execution monitors
on), reduced to what the two sides must agree on exactly: every
region's ``(issued, latency values)``, every process's protocol and
executor metrics (counters and histograms) and every process's per-key
execution order."""

from fantoch_tpu import client as rclient
from fantoch_tpu import core as rcore
from fantoch_tpu import protocol as rprotocol
from fantoch_tpu import sim as rsim
from fantoch_tpu_torch import client, core, protocol, sim

PORT = (client, core, protocol, sim)
REF = (rclient, rcore, rprotocol, rsim)


def _metrics(m):
    return {
        "aggregated": {k.value: v for k, v in sorted(
            m.aggregated.items(), key=lambda kv: kv[0].value)},
        "collected": {k.value: h.all_values() for k, h in sorted(
            m.collected.items(), key=lambda kv: kv[0].value)},
    }


def snapshot(metrics, monitors, latencies):
    """What two runs must agree on, as plain data."""
    return {
        "latencies": {r: (issued, h.all_values())
                      for r, (issued, h) in sorted(latencies.items())},
        "metrics": {pid: (_metrics(pm), _metrics(em))
                    for pid, (pm, em) in sorted(metrics.items())},
        "orders": {pid: {k: [(r.source, r.sequence) for r in m.get_order(k)]
                         for k in sorted(m.keys())}
                   for pid, m in sorted(monitors.items())},
    }


def sim_run(pkgs, name, *, n, f, commands=10, clients=3, seed=0,
            shard_count=1, reorder=True, protocol_cls=None, **config_kw):
    """One run of protocol ``name`` (or ``protocol_cls``) through
    ``pkgs``' runner, as the reference harness's ``sim_test`` runs it at
    ``commands`` a client and ``clients`` a process; returns
    :func:`snapshot`."""
    client, core, protocol, sim = pkgs
    config = core.Config(
        n=n, f=f, shard_count=shard_count,
        executor_monitor_execution_order=True, gc_interval_ms=100,
        executor_executed_notification_interval_ms=100, **config_kw)
    planet = core.Planet.new()
    workload = client.Workload(
        shard_count=shard_count,
        key_gen=client.ConflictPool(conflict_rate=50, pool_size=1),
        keys_per_command=2,
        commands_per_client=commands,
        payload_size=1,
    )
    regions = planet.regions()[:n]
    runner = sim.Runner(
        protocol_cls or protocol.BY_NAME[name], planet, config, workload,
        clients, regions, regions, seed=seed)
    runner.reorder_messages = reorder
    return snapshot(*runner.run(extra_sim_time_ms=10_000))


def totals(snap, kinds=("fast_path", "slow_path", "stable")):
    """The protocol counters summed over processes, by kind name."""
    out = dict.fromkeys(kinds, 0)
    for pm, _em in snap["metrics"].values():
        for kind in kinds:
            out[kind] += pm["aggregated"].get(kind, 0) or 0
    return out
