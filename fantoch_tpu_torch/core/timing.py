"""System time abstraction.

Capability parity with ``fantoch/src/time.rs``: a ``SysTime`` interface with
a wall-clock implementation (``RunTime``, time.rs:9-27) and a settable,
monotonic simulated clock (``SimTime``, time.rs:30-70).
"""

from __future__ import annotations

import time as _time
from abc import ABC, abstractmethod


class SysTime(ABC):
    @abstractmethod
    def millis(self) -> int: ...

    @abstractmethod
    def micros(self) -> int: ...


class RunTime(SysTime):
    """Wall-clock time (time.rs:9-27)."""

    def millis(self) -> int:
        return _time.time_ns() // 1_000_000

    def micros(self) -> int:
        return _time.time_ns() // 1_000


class SimTime(SysTime):
    """Settable simulated clock; setting it backwards is a bug
    (time.rs:30-70)."""

    def __init__(self) -> None:
        self._millis = 0

    def set_millis(self, millis: int) -> None:
        assert millis >= self._millis, "simulation time must be monotonic"
        self._millis = millis

    def add_millis(self, millis: int) -> None:
        self._millis += millis

    def millis(self) -> int:
        return self._millis

    def micros(self) -> int:
        return self._millis * 1000
