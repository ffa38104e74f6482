"""Tempo and Atlas under partial replication on the host oracle
(``fantoch_tpu_torch/protocol/partial.py`` with ``tempo.py``,
``atlas.py``, the table and the graph executor across shards) against
the reference on the CPU.

The cases of ``tests/test_sim_partial.py`` (2 clients a region, 10
commands a client, 2 keys a command at 50 % conflicts, reordered
messages): Tempo and Atlas at n = 3 over 2 and 3 shards and at (5, 2)
over 2 shards. Every region's latencies, every process's metrics and
per-key execution orders equal the reference's, and the reference's
invariants hold on the port: every client completes, the processes of
a shard agree on every key's order, each command commits once per shard
it touches and is stable at the n processes of its own shard.

Tolerance: none."""

import pytest

from torch_oracle import PORT, REF, sim_run, totals

CASES = {
    "tempo_3_1_x2": ("tempo", 3, 1, 2, 0),
    "tempo_3_1_x3": ("tempo", 3, 1, 3, 0),
    "tempo_5_2_x2": ("tempo", 5, 2, 2, 1),
    "atlas_3_1_x2": ("atlas", 3, 1, 2, 0),
    "atlas_3_1_x3": ("atlas", 3, 1, 3, 0),
    "atlas_5_2_x2": ("atlas", 5, 2, 2, 0),
}
COMMANDS, CPR = 10, 2


@pytest.mark.parametrize("case", list(CASES))
def test_partial_replication_matches_the_reference(case):
    name, n, f, shards, seed = CASES[case]
    kw = dict(n=n, f=f, shard_count=shards, seed=seed, commands=COMMANDS,
              clients=CPR)
    if name == "tempo":
        kw["tempo_detached_send_interval_ms"] = 100
    got = sim_run(PORT, name, **kw)
    assert got == sim_run(REF, name, **kw)

    cmds = COMMANDS * CPR * n
    assert sum(issued for issued, _ in got["latencies"].values()) == cmds
    assert sum(len(v) for _, v in got["latencies"].values()) == cmds
    for shard in range(shards):
        group = [o for pid, o in got["orders"].items()
                 if (pid - 1) // n == shard]
        assert len(group) == n and group[0]
        assert all(o == group[0] for o in group)
    t = totals(got)
    assert cmds <= t["fast_path"] + t["slow_path"] <= cmds * shards
    assert t["stable"] == n * cmds
