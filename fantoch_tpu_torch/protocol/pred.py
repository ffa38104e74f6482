"""Caesar common structures: logical clocks, per-key clock indexes, and
quorum aggregators.

Capability parity with ``fantoch_ps/src/protocol/common/pred/``:
``Clock`` is a totally-ordered (seq, process_id) pair with lexicographic
join (clocks/mod.rs:27-117); ``KeyClocks`` stores, per key, the set of
known commands by tentative timestamp and computes predecessors (lower
clock) and blockers (higher clock) in one sweep (clocks/keys/locked.rs);
``QuorumClocks`` aggregates MProposeAck replies with the early-reject
rule (a majority with some !ok ends the wait before the full fast
quorum, clocks/quorum.rs:58-69); ``QuorumRetries`` aggregates MRetryAck
deps over the write quorum (quorum.rs:84-124).

Device-engine note: ``Clock`` packs into one i64 as ``seq * N + pid``;
the per-key index becomes a [K, slots] clock-sorted table.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Set, Tuple

from ..core.command import Command
from ..core.ids import Dot, ProcessId, ShardId
from ..core.kvs import Key

# deps are plain dot sets (CaesarDeps, pred/mod.rs:14-50)
CaesarDeps = Set[Dot]


@dataclass(frozen=True, order=True)
class Clock:
    """Totally-ordered logical timestamp (clocks/mod.rs:27-60)."""

    seq: int
    process_id: ProcessId

    @classmethod
    def zero(cls, process_id: ProcessId) -> "Clock":
        return cls(0, process_id)

    def join(self, other: "Clock") -> "Clock":
        """Lexicographic join (clocks/mod.rs:41-56)."""
        return max(self, other)

    def is_zero(self) -> bool:
        return self.seq == 0


class KeyClocks:
    """Sequential equivalent of ``LockedKeyClocks``
    (clocks/keys/locked.rs:20-134): per key, a map from tentative
    timestamp to command dot; timestamps are unique per key."""

    def __init__(self, process_id: ProcessId, shard_id: ShardId):
        self.process_id = process_id
        self.shard_id = shard_id
        self.seq = 0
        self.clocks: Dict[Key, Dict[Clock, Dot]] = {}

    def clock_next(self) -> Clock:
        self.seq += 1
        return Clock(self.seq, self.process_id)

    def clock_join(self, other: Clock) -> None:
        self.seq = max(self.seq, other.seq)

    def add(self, dot: Dot, cmd: Command, clock: Clock) -> None:
        for key in cmd.keys(self.shard_id):
            commands = self.clocks.setdefault(key, {})
            assert clock not in commands, (
                "can't add a timestamp belonging to a command already added"
            )
            commands[clock] = dot

    def remove(self, cmd: Command, clock: Clock) -> None:
        for key in cmd.keys(self.shard_id):
            removed = self.clocks.get(key, {}).pop(clock, None)
            assert removed is not None, (
                "can't remove a timestamp belonging to a command never added"
            )

    def predecessors(
        self,
        dot: Dot,
        cmd: Command,
        clock: Clock,
        blocking: Optional[Set[Dot]] = None,
    ) -> CaesarDeps:
        """All conflicting commands with a lower timestamp; fills
        ``blocking`` with the higher-timestamp ones
        (clocks/keys/locked.rs:85-131)."""
        predecessors: CaesarDeps = set()
        for key in cmd.keys(self.shard_id):
            for cmd_clock, cmd_dot in self.clocks.get(key, {}).items():
                if cmd_clock < clock:
                    predecessors.add(cmd_dot)
                elif cmd_clock > clock:
                    if blocking is not None:
                        blocking.add(cmd_dot)
                else:
                    assert cmd_dot == dot, (
                        "found different command with the same timestamp"
                    )
        return predecessors

    @staticmethod
    def parallel() -> bool:
        return False


class QuorumClocks:
    """MProposeAck aggregation (clocks/quorum.rs:7-81)."""

    def __init__(
        self,
        process_id: ProcessId,
        fast_quorum_size: int,
        write_quorum_size: int,
    ):
        self.fast_quorum_size = fast_quorum_size
        self.write_quorum_size = write_quorum_size
        self.participants: Set[ProcessId] = set()
        self.clock = Clock.zero(process_id)
        self.deps: CaesarDeps = set()
        self.ok = True

    def add(
        self, process_id: ProcessId, clock: Clock, deps: CaesarDeps, ok: bool
    ) -> None:
        assert len(self.participants) < self.fast_quorum_size
        self.participants.add(process_id)
        self.clock = self.clock.join(clock)
        self.deps |= deps
        self.ok = self.ok and ok

    def all(self) -> bool:
        """Done on a full fast quorum, or early on a majority once some
        process rejected (clocks/quorum.rs:58-69)."""
        replied = len(self.participants)
        some_not_ok_after_majority = (
            not self.ok and replied >= self.write_quorum_size
        )
        return some_not_ok_after_majority or replied == self.fast_quorum_size

    def aggregated(self) -> Tuple[Clock, CaesarDeps, bool]:
        self.participants = set()
        deps, self.deps = self.deps, set()
        return self.clock, deps, self.ok


class QuorumRetries:
    """MRetryAck aggregation over the write quorum
    (clocks/quorum.rs:84-124)."""

    def __init__(self, write_quorum_size: int):
        self.write_quorum_size = write_quorum_size
        self.participants: Set[ProcessId] = set()
        self.deps: CaesarDeps = set()

    def add(self, process_id: ProcessId, deps: CaesarDeps) -> None:
        assert len(self.participants) < self.write_quorum_size
        self.participants.add(process_id)
        self.deps |= deps

    def all(self) -> bool:
        return len(self.participants) == self.write_quorum_size

    def aggregated(self) -> CaesarDeps:
        self.participants = set()
        deps, self.deps = self.deps, set()
        return deps
