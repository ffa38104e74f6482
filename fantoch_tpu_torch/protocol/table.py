"""Tempo's timestamp structures: key clocks, votes, quorum clock
aggregation.

Capability parity with ``fantoch_ps/src/protocol/common/table/``:

- ``VoteRange``/``Votes``: per-key vote ranges with contiguous-range
  compression (votes.rs:9-160);
- ``SequentialKeyClocks``: per-key u64 clocks; ``proposal`` bumps to
  ``max(min_clock, max-key-clock + 1)`` and votes the vacated range
  (clocks/keys/sequential.rs:36-104);
- ``QuorumClocks``: max clock + occurrence count over a fast quorum
  (clocks/quorum.rs:7-60).

The reference's ``AtomicKeyClocks``/``LockedKeyClocks`` exist to allow
multiple intra-process workers to bump clocks concurrently; the device
engine gets its concurrency from batching whole configurations, so the
sequential variant is the default — and :class:`NativeAtomicKeyClocks`
(below) is the AtomicKeyClocks twin over the native C++ CAS map, which
``TempoAtomic`` swaps in (the reference's tempo_atomic binary).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..core.command import Command
from ..core.ids import ProcessId, ShardId
from ..core.kvs import Key


@dataclass
class VoteRange:
    """Votes ``start..=end`` by process ``by`` (votes.rs:100-160)."""

    by: ProcessId
    start: int
    end: int

    def __post_init__(self) -> None:
        assert self.start <= self.end

    def try_compress(self, other: "VoteRange") -> Optional["VoteRange"]:
        """Extend self with ``other`` if contiguous; returns ``other`` back
        when it couldn't be compressed (votes.rs:131-147)."""
        assert self.by == other.by
        if self.end + 1 == other.start:
            self.end = other.end
            return None
        return other


class Votes:
    """key -> list of VoteRange (votes.rs:8-97)."""

    __slots__ = ("votes",)

    def __init__(self) -> None:
        self.votes: Dict[Key, List[VoteRange]] = {}

    def add(self, key: Key, vote: VoteRange) -> None:
        current = self.votes.setdefault(key, [])
        if current:
            rest = current[-1].try_compress(vote)
            if rest is not None:
                current.append(rest)
        else:
            current.append(vote)

    def set_(self, key: Key, key_votes: List[VoteRange]) -> None:
        assert key not in self.votes
        self.votes[key] = key_votes

    def merge(self, remote: "Votes") -> None:
        for key, key_votes in remote.votes.items():
            self.votes.setdefault(key, []).extend(key_votes)

    def get(self, key: Key) -> Optional[List[VoteRange]]:
        return self.votes.get(key)

    def remove(self, key: Key) -> List[VoteRange]:
        return self.votes.pop(key, [])

    def __len__(self) -> int:
        return len(self.votes)

    def is_empty(self) -> bool:
        return not self.votes

    def items(self):
        return self.votes.items()

    def __repr__(self) -> str:
        return f"Votes({self.votes!r})"


class SequentialKeyClocks:
    """clocks/keys/sequential.rs:9-104."""

    def __init__(self, process_id: ProcessId, shard_id: ShardId):
        self.process_id = process_id
        self.shard_id = shard_id
        self.clocks: Dict[Key, int] = {}

    def init_clocks(self, cmd: Command) -> None:
        for key in cmd.keys(self.shard_id):
            self.clocks.setdefault(key, 0)

    def proposal(self, cmd: Command, min_clock: int) -> Tuple[int, Votes]:
        """Bump to ``max(min_clock, highest-key-clock + 1)`` and vote the
        vacated ranges on every key (sequential.rs:36-47)."""
        clock = max(min_clock, self._clock(cmd) + 1)
        votes = Votes()
        self.detached(cmd, clock, votes)
        return clock, votes

    def detached(self, cmd: Command, up_to: int, votes: Votes) -> None:
        for key in cmd.keys(self.shard_id):
            self._maybe_bump(key, up_to, votes)

    def detached_all(self, up_to: int, votes: Votes) -> None:
        for key in list(self.clocks):
            self._maybe_bump(key, up_to, votes)

    @staticmethod
    def parallel() -> bool:
        return False

    def _clock(self, cmd: Command) -> int:
        return max(
            (self.clocks.get(key, 0) for key in cmd.keys(self.shard_id)),
            default=0,
        )

    def _maybe_bump(self, key: Key, up_to: int, votes: Votes) -> None:
        current = self.clocks.get(key, 0)
        if current < up_to:
            votes.add(key, VoteRange(self.process_id, current + 1, up_to))
            self.clocks[key] = up_to


class NativeAtomicKeyClocks:
    """The ``AtomicKeyClocks`` variant (common/table/clocks/keys/
    atomic.rs:13-90), backed by the native C++ sharded CAS map
    (fantoch_tpu_torch/native/keyclocks.cpp). Same observable semantics as
    :class:`SequentialKeyClocks` single-threaded; the clock bumps are
    lock-free CAS loops with the GIL released, and key interning takes
    a short lock on first sighting, so the structure stays safe if the
    runtime ever moves workers onto OS threads. The native key table
    is fixed-capacity (``$FANTOCH_NATIVE_KEYS``, default 65,536
    distinct keys); exhaustion raises instead of degrading."""

    def __init__(self, process_id: ProcessId, shard_id: ShardId,
                 capacity: Optional[int] = None):
        import os
        import threading

        from ..native.keyclocks import AtomicKeyClocks

        if capacity is None:
            capacity = int(
                os.environ.get("FANTOCH_NATIVE_KEYS", str(1 << 16))
            )
        self.process_id = process_id
        self.shard_id = shard_id
        self._kc = AtomicKeyClocks(capacity)
        self._ids: Dict[Key, int] = {}
        self._names: List[Key] = []
        self._intern_lock = threading.Lock()

    def _id(self, key: Key) -> int:
        i = self._ids.get(key)  # dict reads are GIL-atomic
        if i is None:
            with self._intern_lock:
                i = self._ids.get(key)
                if i is None:
                    i = len(self._names)
                    self._names.append(key)
                    self._ids[key] = i
        return i

    def init_clocks(self, cmd: Command) -> None:
        for key in cmd.keys(self.shard_id):
            self._id(key)

    def _add(self, votes: Votes, triples) -> None:
        for kid, start, end in triples:
            votes.add(
                self._names[kid], VoteRange(self.process_id, start, end)
            )

    def proposal(self, cmd: Command, min_clock: int) -> Tuple[int, Votes]:
        ids = [self._id(k) for k in cmd.keys(self.shard_id)]
        clock, triples = self._kc.proposal(ids, min_clock)
        votes = Votes()
        self._add(votes, triples)
        return clock, votes

    def detached(self, cmd: Command, up_to: int, votes: Votes) -> None:
        ids = [self._id(k) for k in cmd.keys(self.shard_id)]
        if ids:
            self._add(votes, self._kc.detached(ids, up_to))

    def detached_all(self, up_to: int, votes: Votes) -> None:
        ids = list(range(len(self._names)))
        if ids:
            self._add(votes, self._kc.detached(ids, up_to))

    @staticmethod
    def parallel() -> bool:
        return True


# canonical name used by the protocol; TempoAtomic swaps in the native
# variant (the reference selects per-binary, bin/tempo_atomic.rs)
KeyClocks = SequentialKeyClocks


class QuorumClocks:
    """Max-clock/count aggregation over fast-quorum replies
    (clocks/quorum.rs:7-60)."""

    def __init__(self, fast_quorum_size: int):
        self.fast_quorum_size = fast_quorum_size
        self.participants: set = set()
        self.max_clock = 0
        self.max_clock_count = 0

    def add(self, process_id: ProcessId, clock: int) -> Tuple[int, int]:
        assert len(self.participants) < self.fast_quorum_size
        self.participants.add(process_id)
        if clock > self.max_clock:
            self.max_clock = clock
            self.max_clock_count = 1
        elif clock == self.max_clock:
            self.max_clock_count += 1
        return self.max_clock, self.max_clock_count

    def all(self) -> bool:
        return len(self.participants) == self.fast_quorum_size
