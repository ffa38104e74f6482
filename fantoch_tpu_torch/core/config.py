"""System configuration and quorum-size formulas.

Capability parity with the reference's ``fantoch/src/config.rs``: one plain
config record flows through every layer, and all quorum-size formulas live
here (config.rs:263-329).

Durations are integer milliseconds (the simulator's clock unit); ``None``
means "disabled" exactly like the reference's ``Option<Duration>`` fields.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

from .ids import ProcessId


@dataclass
class Config:
    """Mirror of the reference ``Config`` (config.rs:7-43).

    Field defaults follow config.rs:50-97.
    """

    n: int
    f: int
    shard_count: int = 1
    execute_at_commit: bool = False
    executor_cleanup_interval_ms: int = 5
    executor_executed_notification_interval_ms: int = 50
    executor_monitor_pending_interval_ms: Optional[int] = None
    executor_monitor_execution_order: bool = False
    gc_interval_ms: Optional[int] = None
    leader: Optional[ProcessId] = None
    tempo_tiny_quorums: bool = False
    tempo_clock_bump_interval_ms: Optional[int] = None
    tempo_detached_send_interval_ms: Optional[int] = None
    caesar_wait_condition: bool = True
    skip_fast_ack: bool = False

    def __post_init__(self) -> None:
        assert self.shard_count >= 1

    def with_(self, **kwargs) -> "Config":
        return replace(self, **kwargs)

    # ------------------------------------------------------------------
    # quorum-size formulas (config.rs:263-329)
    # ------------------------------------------------------------------

    def basic_quorum_size(self) -> int:
        """f + 1 (config.rs:265-267)."""
        return self.f + 1

    def fpaxos_quorum_size(self) -> int:
        """Flexible-Paxos write quorum: f + 1 (config.rs:270-272)."""
        return self.f + 1

    def atlas_quorum_sizes(self) -> Tuple[int, int]:
        """(fast, write) = (n/2 + f, f + 1) (config.rs:275-281)."""
        return self.n // 2 + self.f, self.f + 1

    def epaxos_quorum_sizes(self) -> Tuple[int, int]:
        """EPaxos always tolerates a minority: with f = n/2,
        (fast, write) = (f + (f+1)/2, f + 1) (config.rs:284-292)."""
        f = self.n // 2
        return f + (f + 1) // 2, f + 1

    def caesar_quorum_sizes(self) -> Tuple[int, int]:
        """(fast, write) = (3n/4 + 1, n/2 + 1) (config.rs:295-300)."""
        return (3 * self.n) // 4 + 1, self.n // 2 + 1

    def tempo_quorum_sizes(self) -> Tuple[int, int, int]:
        """(fast, write, stability-threshold) (config.rs:317-329).

        The stability threshold is ``n - (fast_quorum_size - f + 1) + 1``:
        clocks are computed at ≥ fast_quorum_size - f + 1 processes, and
        threshold + that minimum must exceed n.
        """
        minority = self.n // 2
        if self.tempo_tiny_quorums:
            fast, threshold = 2 * self.f, self.n - self.f
        else:
            fast, threshold = minority + self.f, minority + 1
        write = self.f + 1
        return fast, write, threshold
