"""The monitor-coverage batches of ``chip_smoke.py`` (``MON_COVERAGE``)
run a 1,500 ms drain tail, not the fuzz default of 1000 + 500 x
jitter_max = 5,000 ms. This holds the cut on the CPU: per protocol, the
batch at 1,500 ms and at 5,000 ms gives every lane the same violation
bits, coverage digest and completed count, and its steps pop the same
message types and fire the same periodic timers, so the shorter tail
drives the same monitor and handler branches in fewer steps. Slow tier:
about 60 s of worker time for the six protocols. Tolerance: none."""

from dataclasses import replace

import pytest

import chip_smoke
from fantoch_tpu_torch.engine import core
from fantoch_tpu_torch.engine.dims import PMT
from fantoch_tpu_torch.engine.faults import FaultPlan
from fantoch_tpu_torch.mc.fuzz import FuzzSpec, point_lanes
from fantoch_tpu_torch.parallel import run_sweep
from torch_threads import one_torch_thread  # noqa: F401

FUZZ_DEFAULT_TAIL = 5000


def _branches(monkeypatch, name, extra):
    """The coverage batch of ``name`` at drain tail ``extra``: per-lane
    monitor results, the message types popped and timers fired."""
    seen = {"types": set(), "timers": set()}
    pop = core.qualify_pop

    def recorded(*a, **kw):
        out = pop(*a, **kw)
        fire, has, rows = out[4], out[6], out[7]
        seen["types"] |= set(rows[..., PMT][has].tolist())
        seen["timers"] |= set(fire.any(0).any(0).nonzero().flatten().tolist())
        return out

    spec = FuzzSpec(protocol=name,
                    **dict(chip_smoke.MON_COVERAGE, extra_time_ms=extra))
    proto, dims, specs, _plans, mk = point_lanes(spec)
    short = point_lanes(replace(spec, extra_time_ms=1, schedules=1),
                        plans=[FaultPlan(jitter_max=8, jitter_seed=1)])[2]
    with monkeypatch.context() as m:
        m.setattr(core, "qualify_pop", recorded)
        res = run_sweep(proto, dims, specs + short, device="cpu",
                        monitor_keys=mk)
    return {"violation": [r.violation for r in res],
            "coverage": [r.coverage for r in res],
            "completed": [r.completed for r in res],
            "types": seen["types"], "timers": seen["timers"]}, \
        [r.steps for r in res]


@pytest.mark.slow
@pytest.mark.parametrize("name", chip_smoke.MON_PROTOCOLS)
def test_coverage_tail_keeps_the_branches(monkeypatch, name):
    assert chip_smoke.MON_COVERAGE["extra_time_ms"] < FUZZ_DEFAULT_TAIL
    short, short_steps = _branches(
        monkeypatch, name, chip_smoke.MON_COVERAGE["extra_time_ms"])
    full, full_steps = _branches(monkeypatch, name, FUZZ_DEFAULT_TAIL)
    assert short == full
    assert short["types"] and short["completed"][0] > 0
    assert sum(short_steps) < sum(full_steps)
