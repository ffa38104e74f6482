"""The host oracle's discrete-event simulator (reference:
``fantoch/src/sim/``): one configuration at a time, exact, no device."""

from .runner import Runner
from .schedule import Schedule
from .simulation import Simulation

__all__ = ["Runner", "Schedule", "Simulation"]
