"""Atlas protocol (EuroSys'20): dependency-based consensus with
f-dependent fast quorums.

Capability parity with ``fantoch_ps/src/protocol/atlas.rs``: submit
computes deps from per-key conflict indexes and broadcasts ``MCollect``
(atlas.rs:210-248); fast-quorum members merge the coordinator's deps as
"past" and reply (250-323); the fast path is taken iff the threshold
union (every dep reported by ≥ f processes) equals the plain union
(325-391); otherwise single-decree Paxos runs on the dependency set
(466-547); commits feed the graph executor (393-464) and the
committed-clock GC flow (630-703).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..core.command import Command
from ..core.config import Config
from ..core.ids import Dot, ProcessId, ShardId
from ..core.timing import SysTime
from ..executor.graph import GraphAdd, GraphExecutor
from . import partial
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
from .graph_deps import Dependency, QuorumDeps, SequentialKeyDeps
from .synod import S_ACCEPT, S_ACCEPTED, S_CHOSEN, Synod

# statuses (atlas.rs:898-905)
START, PAYLOAD, COLLECT, COMMIT = range(4)


@dataclass
class ConsensusValue:
    """(is_noop, deps) pair agreed on by consensus (atlas.rs:743-760)."""

    is_noop: bool = False
    deps: Set[Dependency] = field(default_factory=set)


def _proposal_gen(_values):
    raise NotImplementedError("recovery not implemented yet")


# messages (atlas.rs:804-854)
@dataclass
class MCollect(Message):
    dot: Dot
    cmd: Command
    deps: Set[Dependency]
    quorum: Set[ProcessId]


@dataclass
class MCollectAck(Message):
    dot: Dot
    deps: Set[Dependency]


@dataclass
class MCommit(Message):
    dot: Dot
    value: ConsensusValue


@dataclass
class MConsensus(Message):
    dot: Dot
    ballot: int
    value: ConsensusValue


@dataclass
class MConsensusAck(Message):
    dot: Dot
    ballot: int


@dataclass
class MForwardSubmit(Message):
    dot: Dot
    cmd: Command


@dataclass
class MShardCommit(Message):
    dot: Dot
    deps: Set[Dependency]


@dataclass
class MShardAggregatedCommit(Message):
    dot: Dot
    deps: Set[Dependency]


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


class _AtlasInfo:
    """Per-command lifecycle record (atlas.rs:766-802)."""

    def __init__(self, process_id: ProcessId, n: int, f: int,
                 fast_quorum_size: int):
        self.status = START
        self.quorum: Set[ProcessId] = set()
        self.synod: Synod[ConsensusValue] = Synod(
            process_id, n, f, _proposal_gen, ConsensusValue()
        )
        self.cmd: Optional[Command] = None
        self.quorum_deps = QuorumDeps(fast_quorum_size)
        self.shards_commits = None


class Atlas(Protocol):
    # implements partial.rs's multi-shard coordination paths
    PARTIAL_REPLICATION = True

    EXECUTOR = GraphExecutor

    def __init__(self, process_id: ProcessId, shard_id: ShardId, config: Config):
        super().__init__(process_id, shard_id, config)
        fast_quorum_size, write_quorum_size = config.atlas_quorum_sizes()
        self.bp = BaseProcess(
            process_id, shard_id, config, fast_quorum_size, write_quorum_size
        )
        self.key_deps = SequentialKeyDeps(shard_id)
        self.cmds: CommandsInfo[_AtlasInfo] = CommandsInfo(
            lambda: _AtlasInfo(process_id, config.n, config.f,
                               fast_quorum_size)
        )
        self.gc_track = GCTrack(process_id, shard_id, config.n)
        from ..core.ids import process_ids

        self.shard_processes = set(process_ids(shard_id, config.n))
        self.buffered_commits: Dict[Dot, Tuple[ProcessId, ConsensusValue]] = {}

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
        self._handle_submit(dot, cmd, target_shard=True)

    def handle(self, from_, from_shard_id, msg, time) -> None:
        if isinstance(msg, MCollect):
            self._handle_mcollect(from_, msg, time)
        elif isinstance(msg, MCollectAck):
            self._handle_mcollectack(from_, msg)
        elif isinstance(msg, MCommit):
            self._handle_mcommit(from_, msg.dot, msg.value)
        elif isinstance(msg, MConsensus):
            self._handle_mconsensus(from_, msg)
        elif isinstance(msg, MConsensusAck):
            self._handle_mconsensusack(from_, msg)
        elif isinstance(msg, MForwardSubmit):
            self._handle_submit(msg.dot, msg.cmd, target_shard=False)
        elif isinstance(msg, MShardCommit):
            self._handle_mshard_commit(from_, msg)
        elif isinstance(msg, MShardAggregatedCommit):
            self._handle_mshard_aggregated_commit(msg)
        elif isinstance(msg, MCommitDot):
            assert from_ == self.id()
            self.gc_track.add_to_clock(msg.dot)
        elif isinstance(msg, MGarbageCollection):
            self._handle_mgc(from_, msg)
        elif isinstance(msg, MStable):
            assert from_ == self.id()
            self.bp.stable(self.cmds.gc(msg.stable))
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
        # the reference ships AtlasLocked (RwLock-per-key KeyDeps) to make
        # W worker threads safe on shared state; this runtime's workers
        # are cooperative asyncio tasks, so every handle() is atomic and
        # the Locked capability holds with no locks
        return True

    @staticmethod
    def leaderless() -> bool:
        return True

    def metrics(self) -> ProtocolMetrics:
        return self.bp.metrics

    # -- handlers (atlas.rs:208-738) -----------------------------------

    def _handle_submit(self, dot, cmd, target_shard: bool) -> None:
        dot = dot if dot is not None else self.bp.next_dot()
        partial.submit_actions(
            self.bp, dot, cmd, target_shard, MForwardSubmit,
            self.to_processes_buf,
        )
        deps = self.key_deps.add_cmd(dot, cmd, None)
        self.to_processes_buf.append(
            ToSend(
                target=self.bp.all(),
                msg=MCollect(dot, cmd, deps, self.bp.fast_quorum()),
            )
        )

    def _handle_mcollect(self, from_, msg: MCollect, time) -> None:
        dot = msg.dot
        info = self.cmds.get(dot)
        if info.status != START:
            return
        if self.id() not in msg.quorum:
            # not in the fast quorum: just keep the payload; replay a
            # commit that overtook the collect (atlas.rs:278-293)
            info.status = PAYLOAD
            info.cmd = msg.cmd
            buffered = self.buffered_commits.pop(dot, None)
            if buffered is not None:
                self._handle_mcommit(buffered[0], dot, buffered[1])
            return
        if from_ == self.id():
            deps = msg.deps  # do not recompute own deps
        else:
            deps = self.key_deps.add_cmd(dot, msg.cmd, msg.deps)
        info.status = COLLECT
        info.quorum = set(msg.quorum)
        info.cmd = msg.cmd
        was_set = info.synod.set_if_not_accepted(
            lambda: ConsensusValue(deps=set(deps))
        )
        assert was_set
        self.to_processes_buf.append(
            ToSend(target={from_}, msg=MCollectAck(dot, deps))
        )

    def _handle_mcollectack(self, from_, msg: MCollectAck) -> None:
        info = self.cmds.get(msg.dot)
        if info.status != COLLECT:
            return
        info.quorum_deps.add(from_, msg.deps)
        if not info.quorum_deps.all():
            return
        # fast path iff threshold-union(f) == union (atlas.rs:353-390)
        all_deps, equal_to_union = info.quorum_deps.check_threshold_union(
            self.bp.config.f
        )
        value = ConsensusValue(deps=all_deps)
        if equal_to_union:
            self.bp.fast_path()
            self._mcommit_actions(info, msg.dot, value)
        else:
            self.bp.slow_path()
            ballot = info.synod.skip_prepare()
            self.to_processes_buf.append(
                ToSend(
                    target=self.bp.write_quorum(),
                    msg=MConsensus(msg.dot, ballot, value),
                )
            )

    def _handle_mcommit(self, from_, dot: Dot, value: ConsensusValue) -> None:
        info = self.cmds.get(dot)
        if info.status == START:
            # commit overtook the collect; buffer it (atlas.rs:411-419)
            self.buffered_commits[dot] = (from_, value)
            return
        if info.status == COMMIT:
            return
        assert not value.is_noop, "noop handling not implemented yet"
        cmd = info.cmd
        assert cmd is not None
        self.to_executors_buf.append(GraphAdd(dot, cmd, set(value.deps)))
        info.status = COMMIT
        chosen_out = info.synod.handle(from_, (S_CHOSEN, value))
        assert chosen_out is None
        my_shard = dot.source in self.shard_processes
        if self._gc_running() and my_shard:
            self.to_processes_buf.append(ToForward(MCommitDot(dot)))
        else:
            self.cmds.gc_single(dot)

    def _handle_mconsensus(self, from_, msg: MConsensus) -> None:
        info = self.cmds.get(msg.dot)
        out = info.synod.handle(from_, (S_ACCEPT, msg.ballot, msg.value))
        if out is None:
            return  # ballot too low
        kind = out[0]
        if kind == S_ACCEPTED:
            reply = MConsensusAck(msg.dot, out[1])
        elif kind == S_CHOSEN:
            reply = MCommit(msg.dot, out[1])
        else:
            raise AssertionError(f"unexpected synod output {out!r}")
        self.to_processes_buf.append(ToSend(target={from_}, msg=reply))

    def _handle_mconsensusack(self, from_, msg: MConsensusAck) -> None:
        info = self.cmds.get(msg.dot)
        out = info.synod.handle(from_, (S_ACCEPTED, msg.ballot))
        if out is None:
            return  # not enough accepts yet
        assert out[0] == S_CHOSEN
        self._mcommit_actions(info, msg.dot, out[1])

    def _handle_mshard_commit(self, from_, msg: MShardCommit) -> None:
        info = self.cmds.get(msg.dot)
        shard_count = info.cmd.shard_count()
        partial.handle_mshard_commit(
            self.bp,
            info,
            shard_count,
            from_,
            msg.dot,
            msg.deps,
            lambda current, deps: current.update(deps),
            lambda dot, current: MShardAggregatedCommit(dot, set(current)),
            self.to_processes_buf,
            set,
        )

    def _handle_mshard_aggregated_commit(
        self, msg: MShardAggregatedCommit
    ) -> None:
        info = self.cmds.get(msg.dot)
        partial.handle_mshard_aggregated_commit(
            self.bp,
            info,
            msg.dot,
            msg.deps,
            lambda _info: None,
            lambda dot, deps, _extra: MCommit(dot, ConsensusValue(deps=deps)),
            self.to_processes_buf,
        )

    def _handle_mgc(self, from_, msg: MGarbageCollection) -> None:
        self.gc_track.update_clock_of(from_, msg.committed)
        stable = self.gc_track.stable()
        if stable:
            self.to_processes_buf.append(ToForward(MStable(stable)))

    def _mcommit_actions(self, info, dot: Dot, value: ConsensusValue) -> None:
        shard_count = info.cmd.shard_count()
        partial.mcommit_actions(
            self.bp,
            info,
            shard_count,
            dot,
            value,
            None,
            lambda dot, value, _extra: MCommit(dot, value),
            lambda dot, value: MShardCommit(dot, set(value.deps)),
            lambda _info, _extra: None,
            self.to_processes_buf,
            set,
        )

    def _gc_running(self) -> bool:
        return self.bp.config.gc_interval_ms is not None
