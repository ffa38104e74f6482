"""Identifier types.

Capability parity with the reference's ``fantoch/src/id.rs``: a generic
``Id = (source, sequence)`` pair with two instantiations — ``Dot`` (command
instance identifier, source = process id) and ``Rifl`` (request identifier,
source = client id) — plus sequential generators (id.rs:16-93).

The reference's lock-free ``AtomicIdGen`` (id.rs:95-123) exists for its
multi-threaded tokio runtime; the device engine allocates dot sequence
numbers with on-device counters instead (``fantoch_tpu_torch/engine``), so
only the sequential generator is needed on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Tuple

ProcessId = int
ClientId = int
ShardId = int


@dataclass(frozen=True, order=True)
class Id:
    """A (source, sequence) identifier (id.rs:16-22)."""

    source: int
    sequence: int

    def __repr__(self) -> str:  # matches reference's "source,sequence" Debug
        return f"({self.source}, {self.sequence})"


class Dot(Id):
    """Command instance identifier: source is a process id (id.rs:10)."""

    def target_shard(self, n: int) -> ShardId:
        """Shard that owns this dot (id.rs:58-62): processes are numbered
        1..=n per shard, so the shard is ``(source - 1) // n``."""
        return (self.source - 1) // n


class Rifl(Id):
    """Request identifier ("request id from last"): source is a client id
    (id.rs:11-13)."""


class IdGen:
    """Sequential id generator (id.rs:69-93)."""

    def __init__(self, source: int):
        self._source = source
        self._last = 0

    def source(self) -> int:
        return self._source

    def next_id(self) -> Id:
        self._last += 1
        return Id(self._source, self._last)


class DotGen(IdGen):
    def next_id(self) -> Dot:
        self._last += 1
        return Dot(self._source, self._last)


class RiflGen(IdGen):
    def next_id(self) -> Rifl:
        self._last += 1
        return Rifl(self._source, self._last)


def process_ids(shard_id: ShardId, n: int) -> List[ProcessId]:
    """All process ids in ``shard_id`` for a system with ``n`` processes per
    shard; ids are non-zero (util.rs:126-133)."""
    shift = n * shard_id
    return [i + shift for i in range(1, n + 1)]


def all_process_ids(
    shard_count: int, n: int
) -> Iterator[Tuple[ProcessId, ShardId]]:
    """(process id, shard id) pairs for every process (util.rs:135-143)."""
    for shard_id in range(shard_count):
        for process_id in process_ids(shard_id, n):
            yield process_id, shard_id


def dots(repr_: List[Tuple[ProcessId, int, int]]) -> Iterator[Dot]:
    """Expand a compressed (process, start, end) dot-range representation
    into dots (util.rs:146-150)."""
    for process_id, start, end in repr_:
        for sequence in range(start, end + 1):
            yield Dot(process_id, sequence)
