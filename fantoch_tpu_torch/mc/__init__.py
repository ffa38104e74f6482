"""Schedule fuzzing on the device: the device half of the reference's
``fantoch_tpu/mc`` (``fuzz.py``).

Thousands of independently perturbed schedules of one closed-loop
workload run as lanes of one batch with the safety monitors on
(``engine/monitor.py``); each lane comes back with its violation word,
the step where it first showed and its coverage digest. Confirming a
flagged lane on the host oracle, shrinking it and replaying repro
artifacts need the reference's host simulator, which the port does not
have yet (ROADMAP Queue A item 17): those entry points raise
``NotImplementedError`` naming the item.
"""

from .fuzz import (
    FuzzPointResult, FuzzSpec, LaneFinding, class_spec, draw_plans,
    plan_rng, point_config, point_protocol, restore_rng, rng_state,
    run_fuzz_point,
)

__all__ = [
    "FuzzPointResult", "FuzzSpec", "LaneFinding", "class_spec",
    "draw_plans", "plan_rng", "point_config", "point_protocol",
    "restore_rng", "rng_state", "run_fuzz_point",
]
