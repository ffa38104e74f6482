"""Time-varying traffic schedules and open-loop arrival schedules
(:mod:`.schedule`): plain numpy, lowered by ``engine/spec.py make_lane``
to the ctx tables the ``key_table`` and ``emit_rewrite`` kernels read."""

from .schedule import (
    ARRIVAL_PRESETS,
    TRAFFIC_PRESETS,
    ArrivalPhase,
    ArrivalSchedule,
    TrafficPhase,
    TrafficSchedule,
    arrival_preset,
    resolve_arrivals,
    resolve_traffic,
    traffic_key_capacity,
    traffic_preset,
)

__all__ = [
    "ARRIVAL_PRESETS",
    "TRAFFIC_PRESETS",
    "ArrivalPhase",
    "ArrivalSchedule",
    "TrafficPhase",
    "TrafficSchedule",
    "arrival_preset",
    "resolve_arrivals",
    "resolve_traffic",
    "traffic_key_capacity",
    "traffic_preset",
]
