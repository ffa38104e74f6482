"""Monitored golden batches through the port's ``run_lanes(monitor_keys=)``
on the CPU against the reference's, byte for byte (``to_json`` with the
violation word, its first step and the coverage digest): Basic, FPaxos
and Tempo here, Atlas, EPaxos and Caesar in
``test_torch_monitor_protocols_graph.py``. Each batch
(``torch_monitor_lanes.LANES``) has a fault-free, a jittered, a crash
and a lossy lane, a conflict-0 lane whose private keys run past the two
monitor keys and a jittered lane with a 1 ms drain tail. Tolerance:
none."""

import pytest

from fantoch_tpu_torch.engine.monitor import VIOL_KEYRANGE, VIOL_MISSING
from torch_monitor_lanes import KEYRANGE_LANE, MISSING_LANE, run_both
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", ["basic", "fpaxos", "tempo"])
def test_monitored_batch_equals_reference(name):
    want, got, res = run_both(name)
    assert got == want
    assert all(r.coverage != 0 for r in res)
    # Basic and FPaxos hash every execution into monitor key 0
    keyrange = bool(res[KEYRANGE_LANE].violation & VIOL_KEYRANGE)
    assert keyrange == (name == "tempo")
    missing = bool(res[MISSING_LANE].violation & VIOL_MISSING)
    assert missing == (name != "fpaxos")
