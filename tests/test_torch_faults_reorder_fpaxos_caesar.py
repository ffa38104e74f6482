"""The reorder perturbation through the port on the CPU, for FPaxos and
Caesar: ``tests/test_engine_reorder.py``'s quick shapes (n = 3, f = 1,
conflict 100, 20 commands, seed 0), ``LaneResults.to_json()`` equal to
the reference's byte for byte, with its invariants
(``tests/test_torch_faults_reorder.py`` has the lanes and the check).
Tolerance: none (integer state)."""

import pytest

from test_torch_faults_reorder import check_quick
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", ["fpaxos", "caesar"])
def test_reorder_quick_shape_matches_reference(name):
    check_quick(name)
