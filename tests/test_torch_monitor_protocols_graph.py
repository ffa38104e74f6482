"""Monitored golden batches of Atlas, EPaxos and Caesar through the
port's ``run_lanes(monitor_keys=)`` on the CPU against the reference's,
byte for byte (``to_json`` with the monitor fields), on the batch of
``torch_monitor_lanes.LANES`` (see ``test_torch_monitor_protocols.py``).
Tolerance: none."""

import pytest

from fantoch_tpu_torch.engine.monitor import VIOL_KEYRANGE, VIOL_MISSING
from torch_monitor_lanes import KEYRANGE_LANE, MISSING_LANE, run_both
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", ["atlas", "epaxos", "caesar"])
def test_monitored_batch_equals_reference(name):
    want, got, res = run_both(name)
    assert got == want
    assert all(r.coverage != 0 for r in res)
    assert res[KEYRANGE_LANE].violation & VIOL_KEYRANGE
    assert res[MISSING_LANE].violation & VIOL_MISSING
