"""Timestamp-stability executor (Tempo).

Capability parity with ``fantoch_ps/src/executor/table/``: commands execute
on a key once their timestamp is *stable* — i.e. once a
stability-threshold's worth of voters have voted past it. Per key, a
``VotesTable`` sorts pending commands by ``(clock, dot)`` and collects all
votes in an interval clock per voter; the stable clock is the
threshold-ranked frontier over voters (table/mod.rs:243-263). Multi-shard /
multi-key commands additionally wait for per-shard stability notifications
(``StableAtShard``) before executing (executor.rs:171-360).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple, Union

from ..core.config import Config
from ..core.ids import Dot, ProcessId, Rifl, ShardId
from ..core.intervals import IntervalSet
from ..core.kvs import ExecutionOrderMonitor, Key, KVOp, KVStore
from ..core.timing import SysTime
from ..protocol.table import VoteRange
from .base import Executor, ExecutorResult


# execution info variants (executor.rs:382-400)
@dataclass
class AttachedVotes:
    dot: Dot
    clock: int
    key: Key
    rifl: Rifl
    shard_to_keys: Dict[ShardId, List[Key]]
    ops: List[KVOp]
    votes: List[VoteRange]


@dataclass
class DetachedVotes:
    key: Key
    votes: List[VoteRange]


@dataclass
class StableAtShard:
    key: Key
    rifl: Rifl


TableExecutionInfo = Union[AttachedVotes, DetachedVotes, StableAtShard]


@dataclass
class _Pending:
    """executor.rs:40-77."""

    rifl: Rifl
    shard_to_keys: Dict[ShardId, List[Key]]
    shard_key_count: int
    missing_stable_shards: int
    ops: List[KVOp]

    @classmethod
    def new(cls, shard_id, rifl, shard_to_keys, ops) -> "_Pending":
        return cls(
            rifl=rifl,
            shard_to_keys=shard_to_keys,
            shard_key_count=len(shard_to_keys[shard_id]),
            missing_stable_shards=len(shard_to_keys),
            ops=ops,
        )

    def single_key_command(self) -> bool:
        return self.missing_stable_shards == 1 and self.shard_key_count == 1


class _VotesTable:
    """Per-key table: ops sorted by (clock, dot) + votes per voter
    (table/mod.rs:103-266)."""

    def __init__(self, n: int, shard_id: ShardId, stability_threshold: int):
        from ..core.ids import process_ids

        assert stability_threshold <= n
        self.n = n
        self.stability_threshold = stability_threshold
        self.votes_clock: Dict[ProcessId, IntervalSet] = {
            p: IntervalSet() for p in process_ids(shard_id, n)
        }
        # (clock, dot) -> _Pending, kept sorted on demand
        self.ops: Dict[Tuple[int, Tuple[int, int]], _Pending] = {}

    def add_attached_votes(
        self, dot: Dot, clock: int, pending: _Pending, votes: List[VoteRange]
    ) -> None:
        sort_id = (clock, (dot.source, dot.sequence))
        assert sort_id not in self.ops
        self.ops[sort_id] = pending
        self.add_detached_votes(votes)

    def add_detached_votes(self, votes: List[VoteRange]) -> None:
        for vr in votes:
            added = self.votes_clock[vr.by].add_range(vr.start, vr.end)
            assert added, f"duplicate vote range {vr}"

    def stable_ops(self) -> List[_Pending]:
        """Commands with sort id below ``(stable_clock + 1, Dot(1,1))`` are
        executable (table/mod.rs:195-240)."""
        stable_clock = self._stable_clock()
        next_stable = (stable_clock + 1, (1, 1))
        stable_ids = sorted(sid for sid in self.ops if sid < next_stable)
        return [self.ops.pop(sid) for sid in stable_ids]

    def _stable_clock(self) -> int:
        """threshold-ranked frontier (table/mod.rs:243-263): the
        ``len - threshold``-th smallest per-voter frontier."""
        frontiers = sorted(c.frontier for c in self.votes_clock.values())
        return frontiers[len(frontiers) - self.stability_threshold]


class TableExecutor(Executor):
    """executor.rs:19-380."""

    def __init__(self, process_id: ProcessId, shard_id: ShardId,
                 config: Config, *,
                 shared_stable_counts: Optional[Dict[Rifl, int]] = None):
        super().__init__(process_id, shard_id, config)
        _, _, self.stability_threshold = config.tempo_quorum_sizes()
        self.execute_at_commit = config.execute_at_commit
        self.store = KVStore(monitor=config.executor_monitor_execution_order)
        self.tables: Dict[Key, _VotesTable] = {}
        # key -> (pending deque, buffered stable-at-shard counts)
        self.pending: Dict[Key, Tuple[Deque[_Pending], Dict[Rifl, int]]] = {}
        # cross-key stability counts; pool members share one map (the
        # reference shares between executor workers via SharedMap,
        # executor.rs:318-330) so multi-key rifls whose keys hash to
        # different members still complete their counts
        self.rifl_to_stable_count: Dict[Rifl, int] = (
            shared_stable_counts if shared_stable_counts is not None else {}
        )

    # -- Executor interface --------------------------------------------

    def handle(self, info, time: SysTime) -> None:
        if isinstance(info, AttachedVotes):
            pending = _Pending.new(
                self.shard_id, info.rifl, info.shard_to_keys, info.ops
            )
            if self.execute_at_commit:
                self._do_execute(info.key, pending)
            else:
                table = self._table(info.key)
                table.add_attached_votes(
                    info.dot, info.clock, pending, info.votes
                )
                self._send_stable_or_execute(info.key, table.stable_ops())
        elif isinstance(info, DetachedVotes):
            if not self.execute_at_commit:
                table = self._table(info.key)
                table.add_detached_votes(info.votes)
                self._send_stable_or_execute(info.key, table.stable_ops())
        elif isinstance(info, StableAtShard):
            self._handle_stable_msg(info.key, info.rifl)
        else:
            raise TypeError(f"unexpected execution info {info!r}")

    # safe behind key-hash executor pools *when constructed via
    # ``pool``*: the cross-key stability count (rifl_to_stable_count,
    # executor.rs:318-330) is shared between pool members exactly like
    # the reference shares it between executor workers via SharedMap;
    # per-key tables/queues are member-local.
    KEY_HASH_ROUTED = True

    @classmethod
    def pool(cls, process_id, shard_id, config, count):
        shared: Dict[Rifl, int] = {}
        return [
            cls(process_id, shard_id, config, shared_stable_counts=shared)
            for _ in range(count)
        ]

    @staticmethod
    def parallel() -> bool:
        return True

    def monitor(self) -> Optional[ExecutionOrderMonitor]:
        return self.store.monitor

    # -- internals (executor.rs:171-360) --------------------------------

    def _table(self, key: Key) -> _VotesTable:
        table = self.tables.get(key)
        if table is None:
            table = _VotesTable(
                self.config.n, self.shard_id, self.stability_threshold
            )
            self.tables[key] = table
        return table

    def _pending_per_key(self, key: Key):
        entry = self.pending.get(key)
        if entry is None:
            entry = (deque(), {})
            self.pending[key] = entry
        return entry

    def _handle_stable_msg(self, key: Key, rifl: Rifl) -> None:
        queue, buffered = self._pending_per_key(key)
        if queue and queue[0].rifl == rifl:
            pending = queue[0]
            pending.missing_stable_shards -= 1
            if pending.missing_stable_shards == 0:
                queue.popleft()
                self._do_execute(key, pending)
                # try to execute the remaining pending commands
                while queue:
                    pending = queue.popleft()
                    leftover = self._execute_single_or_mark_stable(
                        key, pending, buffered
                    )
                    if leftover is not None:
                        queue.appendleft(leftover)
                        return
        else:
            # not yet stable locally: buffer the message
            buffered[rifl] = buffered.get(rifl, 0) + 1

    def _send_stable_or_execute(
        self, key: Key, to_execute: List[_Pending]
    ) -> None:
        queue, buffered = self._pending_per_key(key)
        if queue:
            queue.extend(to_execute)
            return
        for i, pending in enumerate(to_execute):
            leftover = self._execute_single_or_mark_stable(
                key, pending, buffered
            )
            if leftover is not None:
                assert not queue
                queue.append(leftover)
                queue.extend(to_execute[i + 1 :])
                return

    def _execute_single_or_mark_stable(
        self, key: Key, pending: _Pending, buffered: Dict[Rifl, int]
    ) -> Optional[_Pending]:
        """executor.rs:279-360; returns the pending back when it cannot
        execute yet."""
        rifl = pending.rifl
        if pending.single_key_command():
            self._do_execute(key, pending)
            return None

        def send_stable_msg():
            for shard_id, shard_keys in pending.shard_to_keys.items():
                for shard_key in shard_keys:
                    if shard_key != key:
                        self.to_executors_buf.append(
                            (shard_id, StableAtShard(shard_key, rifl))
                        )

        if pending.shard_key_count == 1:
            send_stable_msg()
            pending.missing_stable_shards -= 1
        else:
            count = self.rifl_to_stable_count.get(rifl, 0) + 1
            self.rifl_to_stable_count[rifl] = count
            if count == pending.shard_key_count:
                send_stable_msg()
                pending.missing_stable_shards -= 1
                del self.rifl_to_stable_count[rifl]

        if rifl in buffered:
            pending.missing_stable_shards -= buffered.pop(rifl)

        if pending.missing_stable_shards == 0:
            self._do_execute(key, pending)
            return None
        return pending

    def _do_execute(self, key: Key, stable: _Pending) -> None:
        partial = self.store.execute(key, stable.ops, stable.rifl)
        self.to_clients_buf.append(ExecutorResult(stable.rifl, key, partial))
