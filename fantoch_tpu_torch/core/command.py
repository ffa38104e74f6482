"""Multi-key, multi-shard commands and command results.

Capability parity with ``fantoch/src/command.rs``: a command is a ``Rifl``
plus ``shard -> key -> [KVOp]`` (command.rs:13-22); conflict detection is key
intersection (command.rs:182-188); executing into a ``KVStore`` produces a
``CommandResult`` aggregated per key (command.rs:227-292).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from .ids import Rifl, ShardId
from .kvs import Key, KVOp, KVOpResult, KVStore

DEFAULT_SHARD_ID: ShardId = 0


@dataclass
class Command:
    rifl: Rifl
    # shard -> key -> list of ops
    shard_to_ops: Dict[ShardId, Dict[Key, List[KVOp]]]

    def shards(self) -> Iterable[ShardId]:
        return self.shard_to_ops.keys()

    def shard_count(self) -> int:
        return len(self.shard_to_ops)

    def replicated_by(self, shard_id: ShardId) -> bool:
        return shard_id in self.shard_to_ops

    def multi_shard(self) -> bool:
        return len(self.shard_to_ops) > 1

    def keys(self, shard_id: ShardId) -> List[Key]:
        return list(self.shard_to_ops.get(shard_id, {}))

    def all_keys(self) -> List[Tuple[ShardId, Key]]:
        return [
            (shard_id, key)
            for shard_id, ops in self.shard_to_ops.items()
            for key in ops
        ]

    def key_count(self, shard_id: ShardId) -> int:
        return len(self.shard_to_ops.get(shard_id, {}))

    def total_key_count(self) -> int:
        return sum(len(ops) for ops in self.shard_to_ops.values())

    def items(self, shard_id: ShardId):
        return self.shard_to_ops.get(shard_id, {}).items()

    def conflicts(self, other: "Command") -> bool:
        """Two commands conflict iff they access a common key on a common
        shard (command.rs:182-188)."""
        for shard_id, ops in self.shard_to_ops.items():
            other_ops = other.shard_to_ops.get(shard_id)
            if other_ops and not ops.keys().isdisjoint(other_ops.keys()):
                return True
        return False

    def merge(self, other: "Command") -> None:
        """Fold ``other``'s ops into this command (command.rs:199-209).

        Used by client-side batching: the merged command keeps this
        command's rifl and is submitted once; the batcher remembers the
        member rifls and fans the single result back out.
        """
        for shard_id, ops in other.shard_to_ops.items():
            current = self.shard_to_ops.setdefault(shard_id, {})
            for key, kops in ops.items():
                current.setdefault(key, []).extend(kops)

    def execute(self, shard_id: ShardId, store: KVStore) -> "CommandResult":
        """Execute all of this command's ops on ``shard_id`` against the
        store (command.rs:142-157)."""
        builder = CommandResultBuilder(self.rifl, self.key_count(shard_id))
        for key, ops in self.items(shard_id):
            results = store.execute(key, ops, self.rifl)
            builder.add_partial(key, results)
        result = builder.build()
        assert result is not None
        return result


@dataclass
class CommandResult:
    rifl: Rifl
    results: Dict[Key, List[KVOpResult]]


class CommandResultBuilder:
    """Aggregates per-key partial results until all keys have reported
    (command.rs:240-292)."""

    def __init__(self, rifl: Rifl, key_count: int):
        self.rifl = rifl
        self.key_count = key_count
        self.results: Dict[Key, List[KVOpResult]] = {}

    def add_partial(self, key: Key, partial: List[KVOpResult]) -> None:
        assert key not in self.results
        self.results[key] = partial

    def ready(self) -> bool:
        return len(self.results) == self.key_count

    def build(self) -> Optional[CommandResult]:
        if self.ready():
            return CommandResult(self.rifl, self.results)
        return None
