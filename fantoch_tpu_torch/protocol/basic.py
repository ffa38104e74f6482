"""Toy ``Basic`` protocol: f+1 store-acks then commit.

Capability parity with ``fantoch/src/protocol/basic.rs``: the coordinator
sends ``MStore`` to all; fast-quorum members ack; after ``f+1`` acks the
coordinator broadcasts ``MCommit``; committed commands go straight to the
``BasicExecutor``; commit notifications feed the committed-clock GC flow
(basic.rs:20-330). 100% fast path — there is no write quorum / slow path.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..core.command import Command
from ..core.config import Config
from ..core.ids import Dot, ProcessId, ShardId
from ..core.timing import SysTime
from ..executor.base import BasicExecutionInfo, BasicExecutor
from .base import (
    BaseProcess,
    CommandsInfo,
    GCTrack,
    Message,
    Protocol,
    ProtocolMetrics,
    ToForward,
    ToSend,
)


# messages (basic.rs:362-385)
@dataclass
class MStore(Message):
    dot: Dot
    cmd: Command
    quorum: Set[ProcessId]


@dataclass
class MStoreAck(Message):
    dot: Dot


@dataclass
class MCommit(Message):
    dot: Dot


@dataclass
class MCommitDot(Message):
    WORKER = "gc"

    dot: Dot


@dataclass
class MGarbageCollection(Message):
    WORKER = "gc"

    committed: Dict[ProcessId, int]


@dataclass
class MStable(Message):
    WORKER = "gc"

    stable: List[Tuple[ProcessId, int, int]]


GARBAGE_COLLECTION = "garbage_collection"


@dataclass
class _BasicInfo:
    cmd: Optional[Command] = None
    acks: Set[ProcessId] = field(default_factory=set)


class Basic(Protocol):
    EXECUTOR = BasicExecutor

    def __init__(self, process_id: ProcessId, shard_id: ShardId, config: Config):
        super().__init__(process_id, shard_id, config)
        fast_quorum_size = config.basic_quorum_size()
        write_quorum_size = 0  # 100% fast paths (basic.rs:42)
        self.bp = BaseProcess(
            process_id, shard_id, config, fast_quorum_size, write_quorum_size
        )
        self.cmds: CommandsInfo[_BasicInfo] = CommandsInfo(_BasicInfo)
        self.gc_track = GCTrack(process_id, shard_id, config.n)
        self.buffered_mcommits: Set[Dot] = set()

    # -- Protocol interface -------------------------------------------

    def periodic_events(self):
        if self.bp.config.gc_interval_ms is not None:
            return [(GARBAGE_COLLECTION, self.bp.config.gc_interval_ms)]
        return []

    def id(self) -> ProcessId:
        return self.bp.process_id

    def shard_id(self) -> ShardId:
        return self.bp.shard_id

    def discover(self, processes):
        ok = self.bp.discover(processes)
        return ok, self.bp.closest_shard_process()

    def submit(self, dot: Optional[Dot], cmd: Command, time: SysTime) -> None:
        dot = dot if dot is not None else self.bp.next_dot()
        self.to_processes_buf.append(
            ToSend(
                target=self.bp.all(),
                msg=MStore(dot, cmd, self.bp.fast_quorum()),
            )
        )

    def handle(self, from_, from_shard_id, msg, time) -> None:
        if isinstance(msg, MStore):
            self._handle_mstore(from_, msg)
        elif isinstance(msg, MStoreAck):
            self._handle_mstoreack(from_, msg)
        elif isinstance(msg, MCommit):
            self._handle_mcommit(msg.dot)
        elif isinstance(msg, MCommitDot):
            self._handle_mcommit_dot(from_, msg)
        elif isinstance(msg, MGarbageCollection):
            self._handle_mgc(from_, msg)
        elif isinstance(msg, MStable):
            self._handle_mstable(from_, msg)
        else:
            raise TypeError(f"unexpected message {msg!r}")

    def handle_event(self, event, time) -> None:
        assert event == GARBAGE_COLLECTION
        self.to_processes_buf.append(
            ToSend(
                target=self.bp.all_but_me(),
                msg=MGarbageCollection(self.gc_track.clock_frontier()),
            )
        )

    @staticmethod
    def parallel() -> bool:
        return True

    @staticmethod
    def leaderless() -> bool:
        return True

    def metrics(self) -> ProtocolMetrics:
        return self.bp.metrics

    # -- handlers (basic.rs:169-334) -----------------------------------

    def _handle_mstore(self, from_: ProcessId, msg: MStore) -> None:
        info = self.cmds.get(msg.dot)
        info.cmd = msg.cmd
        if self.id() in msg.quorum:
            self.to_processes_buf.append(
                ToSend(target={from_}, msg=MStoreAck(msg.dot))
            )
        if msg.dot in self.buffered_mcommits:
            self.buffered_mcommits.remove(msg.dot)
            self._handle_mcommit(msg.dot)

    def _handle_mstoreack(self, from_: ProcessId, msg: MStoreAck) -> None:
        info = self.cmds.get(msg.dot)
        info.acks.add(from_)
        if len(info.acks) == self.bp.config.basic_quorum_size():
            self.to_processes_buf.append(
                ToSend(target=self.bp.all(), msg=MCommit(msg.dot))
            )

    def _handle_mcommit(self, dot: Dot) -> None:
        info = self.cmds.get(dot)
        if info.cmd is not None:
            cmd = info.cmd
            for key, ops in cmd.items(self.shard_id()):
                self.to_executors_buf.append(
                    BasicExecutionInfo(cmd.rifl, key, list(ops))
                )
            if self._gc_running():
                self.to_processes_buf.append(ToForward(MCommitDot(dot)))
            else:
                self.cmds.gc_single(dot)
        else:
            # payload hasn't arrived yet; buffer the commit notification
            self.buffered_mcommits.add(dot)

    def _handle_mcommit_dot(self, from_: ProcessId, msg: MCommitDot) -> None:
        assert from_ == self.id()
        self.gc_track.add_to_clock(msg.dot)

    def _handle_mgc(self, from_: ProcessId, msg: MGarbageCollection) -> None:
        self.gc_track.update_clock_of(from_, msg.committed)
        stable = self.gc_track.stable()
        if stable:
            self.to_processes_buf.append(ToForward(MStable(stable)))

    def _handle_mstable(self, from_: ProcessId, msg: MStable) -> None:
        assert from_ == self.id()
        stable_count = self.cmds.gc(msg.stable)
        self.bp.stable(stable_count)

    def _gc_running(self) -> bool:
        return self.bp.config.gc_interval_ms is not None
