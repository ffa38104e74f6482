"""Dependency structures shared by Atlas and EPaxos.

Capability parity with ``fantoch_ps/src/protocol/common/graph/``:
``Dependency`` (deps/keys/mod.rs:19-35), ``KeyDeps``/``SequentialKeyDeps``
(latest-dep-per-key map, sequential.rs:8-144) and ``QuorumDeps`` with the
two fast-path tests — threshold-union for Atlas and equal-union for
EPaxos (quorum.rs:8-98).

Device-engine note: the array twin encodes latest-dep-per-key as an
``[K]`` dot table and quorum deps as per-dep report counts; the
threshold/equality tests become masked count comparisons.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, Optional, Set, Tuple

from ..core.command import Command
from ..core.ids import Dot, ShardId
from ..core.kvs import Key


@dataclass(frozen=True)
class Dependency:
    """deps/keys/mod.rs:19-35: a dot plus the shards that replicate it
    (``None`` for noops)."""

    dot: Dot
    shards: Optional[FrozenSet[ShardId]] = None

    @classmethod
    def from_cmd(cls, dot: Dot, cmd: Command) -> "Dependency":
        return cls(dot, frozenset(cmd.shards()))

    @classmethod
    def from_noop(cls, dot: Dot) -> "Dependency":
        return cls(dot, None)


class SequentialKeyDeps:
    """Latest-command-per-key conflict index (sequential.rs:8-144)."""

    def __init__(self, shard_id: ShardId):
        self.shard_id = shard_id
        self.latest_deps: Dict[Key, Dependency] = {}
        self.noop_latest_dep: Optional[Dependency] = None

    def add_cmd(
        self,
        dot: Dot,
        cmd: Command,
        past: Optional[Set[Dependency]] = None,
    ) -> Set[Dependency]:
        """Sets ``dot`` as the latest on each of the command's keys and
        returns its dependencies (the previous latests, plus ``past``)."""
        deps: Set[Dependency] = set(past) if past is not None else set()
        new_dep = Dependency.from_cmd(dot, cmd)
        for key in cmd.keys(self.shard_id):
            prev = self.latest_deps.get(key)
            if prev is not None:
                deps.add(prev)
            self.latest_deps[key] = new_dep
        if self.noop_latest_dep is not None:
            deps.add(self.noop_latest_dep)
        return deps

    def add_noop(self, dot: Dot) -> Set[Dependency]:
        """Noops depend on everything (sequential.rs:106-132)."""
        deps: Set[Dependency] = set()
        prev = self.noop_latest_dep
        self.noop_latest_dep = Dependency.from_noop(dot)
        if prev is not None:
            deps.add(prev)
        deps.update(self.latest_deps.values())
        return deps

    @staticmethod
    def parallel() -> bool:
        return False


class QuorumDeps:
    """Aggregates deps reported by fast-quorum members (quorum.rs:8-98)."""

    def __init__(self, fast_quorum_size: int):
        self.fast_quorum_size = fast_quorum_size
        self.participants: Set = set()
        self.threshold_deps: Dict[Dependency, int] = {}

    def add(self, process_id, deps: Set[Dependency]) -> None:
        assert len(self.participants) < self.fast_quorum_size
        self.participants.add(process_id)
        for dep in deps:
            self.threshold_deps[dep] = self.threshold_deps.get(dep, 0) + 1

    def all(self) -> bool:
        return len(self.participants) == self.fast_quorum_size

    def check_threshold_union(
        self, threshold: int
    ) -> Tuple[Set[Dependency], bool]:
        """Atlas fast path: union == threshold-union(f), i.e. every dep
        was reported at least ``threshold`` times (quorum.rs:46-64)."""
        assert self.all()
        equal_to_union = all(
            count >= threshold for count in self.threshold_deps.values()
        )
        return set(self.threshold_deps), equal_to_union

    def check_union(self) -> Tuple[Set[Dependency], bool]:
        """EPaxos fast path: all quorum members reported identical deps
        (quorum.rs:67-98)."""
        assert self.all()
        counts = set(self.threshold_deps.values())
        if not counts:
            equal = True
        elif len(counts) == 1:
            equal = counts.pop() == self.fast_quorum_size
        else:
            equal = False
        return set(self.threshold_deps), equal
