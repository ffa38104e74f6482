"""One open-loop lane of each single-shard protocol the port runs —
Basic, FPaxos, Tempo, Atlas, EPaxos and Caesar (n = 3, one client a
region, 3 commands, conflict 100, Poisson arrivals at load 200, a window
of 2) — through the port on the CPU: ``LaneResults.to_json()``
byte-identical to the reference engine's, every command completed, no
error. Tolerance: none (integer state)."""

import pytest

from test_torch_serving import N, _both
from torch_threads import one_torch_thread  # noqa: F401

PROTOCOLS = ("basic", "fpaxos", "tempo", "atlas", "epaxos", "caesar")


@pytest.mark.parametrize("name", PROTOCOLS)
def test_open_loop_lane_byte_identical(name):
    ref, port, results = _both(name, 3, "poisson", [(200, 2)], seed=1)
    assert port == ref
    assert not results[0].err, results[0].err_cause
    assert results[0].completed == 3 * N
