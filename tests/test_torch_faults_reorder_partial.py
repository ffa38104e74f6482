"""The reorder perturbation over a partially replicated Tempo lane on the
CPU: ``tests/test_engine_partial.py``'s
``test_engine_tempo_partial_reorder_invariants`` lane (n = 3, 2 shards,
2 keys per command, 10 commands, seed 5), ``LaneResults.to_json()``
equal to the reference's byte for byte, with that test's invariants: the
readiness gates absorb every overtake, every command completes and is
GC'd at every process of its shard. Tolerance: none (integer state)."""

from test_torch_faults_reorder import check, partial_lane
from torch_threads import one_torch_thread  # noqa: F401


def test_tempo_partial_reorder_lane_matches_reference():
    res = check(partial_lane)
    assert res.completed == 30
    assert int(res.protocol_metrics["stable"].sum()) == 3 * 30
    assert res.requeues > 0
