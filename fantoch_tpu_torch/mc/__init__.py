"""Schedule fuzzing (the reference's ``fantoch_tpu/mc``: ``fuzz.py`` and
``shrink.py``).

Thousands of independently perturbed schedules of one closed-loop
workload run as lanes of one batch with the safety monitors on
(``engine/monitor.py``); each lane comes back with its violation word,
the step where it first showed and its coverage digest. A flagged lane
replays through the host oracle (``sim/``), which confirms it; a
confirmed violation shrinks to a minimal perturbation set written as a
replayable repro artifact. The host oracle covers every protocol of the
grid (Basic, FPaxos, Tempo, Atlas, EPaxos, Caesar); the bounded model
checker (``mc/checker.py``) is not ported (ROADMAP Queue A item 17).
"""

from .fuzz import (
    REPLAY_HORIZON_MS, FuzzPointResult, FuzzSpec, LaneFinding,
    check_host_monitors, class_spec, draw_plans, host_check, load_artifact,
    plan_rng, point_config, point_protocol, replay_artifact, restore_rng,
    rng_state, run_fuzz_point,
)
from .shrink import RecordingPlan, ShrinkResult, ddmin

__all__ = [
    "FuzzPointResult", "FuzzSpec", "LaneFinding", "REPLAY_HORIZON_MS",
    "RecordingPlan", "ShrinkResult", "check_host_monitors", "class_spec",
    "ddmin", "draw_plans", "host_check", "load_artifact", "plan_rng",
    "point_config", "point_protocol", "replay_artifact", "restore_rng",
    "rng_state", "run_fuzz_point",
]
