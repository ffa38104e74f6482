"""Model checking (the reference's ``fantoch_tpu/mc``): two explorers.

* :class:`ModelChecker` (``checker.py``) — bounded exhaustive
  explicit-state exploration over the host ``Protocol`` interface: every
  message-delivery interleaving of a tiny workload, depth first, with
  agreement, exactly-once and progress checked at every quiescent state;
  host code over the host oracle, it launches no kernel;
* the fuzzer (``fuzz.py`` and ``shrink.py``) — thousands of
  independently perturbed schedules of one closed-loop workload run as
  lanes of one batch with the safety monitors on
  (``engine/monitor.py``); each lane comes back with its violation word,
  the step where it first showed and its coverage digest. A flagged lane
  replays through the host oracle (``sim/``), which confirms it; a
  confirmed violation shrinks to a minimal perturbation set written as a
  replayable repro artifact. The host oracle covers every protocol of
  the grid (Basic, FPaxos, Tempo, Atlas, EPaxos, Caesar).

``coverage.py`` closes the greybox loop (coverage maps, seed mutation,
budget steering) and ``covmap.py`` is its binary map format; both are
re-exported lazily, as the reference's are.
"""

from .checker import CheckResult, ModelChecker
from .fuzz import (
    REPLAY_HORIZON_MS, FuzzPointResult, FuzzSpec, LaneFinding,
    check_host_monitors, class_spec, draw_plans, host_check, load_artifact,
    plan_rng, point_config, point_protocol, replay_artifact, restore_rng,
    rng_state, run_fuzz_point,
)
from .shrink import RecordingPlan, ShrinkResult, ddmin

_COVERAGE_EXPORTS = (
    "CoverageError",
    "CoverageMap",
    "CoverageMismatchError",
    "SeedPool",
)
_COVMAP_EXPORTS = (
    "CovmapError",
    "CovmapVersionError",
)

__all__ = [
    "CheckResult", "FuzzPointResult", "FuzzSpec", "LaneFinding",
    "ModelChecker", "REPLAY_HORIZON_MS", "RecordingPlan", "ShrinkResult",
    "check_host_monitors", "class_spec", "ddmin", "draw_plans",
    "host_check", "load_artifact", "plan_rng", "point_config",
    "point_protocol", "replay_artifact", "restore_rng", "rng_state",
    "run_fuzz_point", *_COVERAGE_EXPORTS, *_COVMAP_EXPORTS,
]


def __getattr__(name):
    if name in _COVERAGE_EXPORTS:
        from . import coverage

        return getattr(coverage, name)
    if name in _COVMAP_EXPORTS:
        from . import covmap

        return getattr(covmap, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
