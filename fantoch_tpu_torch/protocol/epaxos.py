"""EPaxos protocol (SOSP'13): dependency-based consensus that always
tolerates a minority of faults.

Capability parity with ``fantoch_ps/src/protocol/epaxos.rs``: quorums are
f-independent with f = ⌊n/2⌋ (config.rs:284-292); the coordinator
computes deps at submit and broadcasts ``MCollect`` (epaxos.rs:199-220);
fast-quorum members other than the coordinator merge the coordinator's
deps as "past" and ack (222-295); the fast path is taken iff *all*
reported dependency sets are equal (297-364, quorum.rs:67-98); the slow
path is single-decree Paxos on the deps; commits feed the graph executor
and the committed-clock GC flow. No partial-replication support (the
reference's EPaxos is single-shard: epaxos.rs:660-695 has no shard
messages).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from ..core.command import Command
from ..core.config import Config
from ..core.ids import Dot, ProcessId, ShardId
from ..core.timing import SysTime
from ..executor.graph import GraphAdd, GraphExecutor
from .atlas import (
    COLLECT,
    COMMIT,
    GARBAGE_COLLECTION,
    PAYLOAD,
    START,
    ConsensusValue,
    MCollect,
    MCollectAck,
    MCommit,
    MCommitDot,
    MConsensus,
    MConsensusAck,
    MGarbageCollection,
    MStable,
    _proposal_gen,
)
from .base import (
    BaseProcess,
    CommandsInfo,
    GCTrack,
    Protocol,
    ProtocolMetrics,
    ToForward,
    ToSend,
)
from .graph_deps import QuorumDeps, SequentialKeyDeps
from .synod import S_ACCEPT, S_ACCEPTED, S_CHOSEN, Synod


class _EPaxosInfo:
    """Per-command record (epaxos.rs:622-668). ``QuorumDeps`` is sized
    ``fast_quorum_size - 1`` because the coordinator, being a quorum
    member, does not ack itself (epaxos.rs:645-656)."""

    def __init__(self, process_id: ProcessId, n: int, f: int,
                 fast_quorum_size: int):
        self.status = START
        self.quorum: Set[ProcessId] = set()
        self.synod: Synod[ConsensusValue] = Synod(
            process_id, n, f, _proposal_gen, ConsensusValue()
        )
        self.cmd: Optional[Command] = None
        self.quorum_deps = QuorumDeps(fast_quorum_size - 1)


class EPaxos(Protocol):
    EXECUTOR = GraphExecutor

    def __init__(self, process_id: ProcessId, shard_id: ShardId, config: Config):
        super().__init__(process_id, shard_id, config)
        fast_quorum_size, write_quorum_size = config.epaxos_quorum_sizes()
        self.bp = BaseProcess(
            process_id, shard_id, config, fast_quorum_size, write_quorum_size
        )
        self.key_deps = SequentialKeyDeps(shard_id)
        # NOTE: like the reference, the synod is built with the *model*
        # f (config.f), while quorum sizes use the minority-based
        # formulas (epaxos.rs:45-70 via the Info trait)
        self.cmds: CommandsInfo[_EPaxosInfo] = CommandsInfo(
            lambda: _EPaxosInfo(process_id, config.n, config.f,
                                fast_quorum_size)
        )
        self.gc_track = GCTrack(process_id, shard_id, config.n)
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
        dot = dot if dot is not None else self.bp.next_dot()
        deps = self.key_deps.add_cmd(dot, cmd, None)
        self.to_processes_buf.append(
            ToSend(
                target=self.bp.all(),
                msg=MCollect(dot, cmd, deps, self.bp.fast_quorum()),
            )
        )

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
        elif isinstance(msg, MCommitDot):
            assert from_ == self.id()
            self.gc_track.add_to_clock(msg.dot)
        elif isinstance(msg, MGarbageCollection):
            self.gc_track.update_clock_of(from_, msg.committed)
            stable = self.gc_track.stable()
            if stable:
                self.to_processes_buf.append(ToForward(MStable(stable)))
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
        # EPaxosLocked equivalent under cooperative workers (see Atlas)
        return True

    @staticmethod
    def leaderless() -> bool:
        return True

    def metrics(self) -> ProtocolMetrics:
        return self.bp.metrics

    # -- handlers (epaxos.rs:221-482) ----------------------------------

    def _handle_mcollect(self, from_, msg: MCollect, time) -> None:
        dot = msg.dot
        info = self.cmds.get(dot)
        if info.status != START:
            return
        if self.id() not in msg.quorum:
            info.status = PAYLOAD
            info.cmd = msg.cmd
            buffered = self.buffered_commits.pop(dot, None)
            if buffered is not None:
                self._handle_mcommit(buffered[0], dot, buffered[1])
            return
        message_from_self = from_ == self.id()
        if message_from_self:
            deps = msg.deps
        else:
            deps = self.key_deps.add_cmd(dot, msg.cmd, msg.deps)
        info.status = COLLECT
        info.quorum = set(msg.quorum)
        info.cmd = msg.cmd
        was_set = info.synod.set_if_not_accepted(
            lambda: ConsensusValue(deps=set(deps))
        )
        assert was_set
        # the coordinator does not ack itself (epaxos.rs:285-295)
        if not message_from_self:
            self.to_processes_buf.append(
                ToSend(target={from_}, msg=MCollectAck(dot, deps))
            )

    def _handle_mcollectack(self, from_, msg: MCollectAck) -> None:
        assert from_ != self.id()
        info = self.cmds.get(msg.dot)
        if info.status != COLLECT:
            return
        info.quorum_deps.add(from_, msg.deps)
        if not info.quorum_deps.all():
            return
        # fast path iff all reported deps are equal (epaxos.rs:329-364)
        final_deps, all_equal = info.quorum_deps.check_union()
        value = ConsensusValue(deps=final_deps)
        if all_equal:
            self.bp.fast_path()
            self.to_processes_buf.append(
                ToSend(target=self.bp.all(), msg=MCommit(msg.dot, value))
            )
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
        if self._gc_running():
            self.to_processes_buf.append(ToForward(MCommitDot(dot)))
        else:
            self.cmds.gc_single(dot)

    def _handle_mconsensus(self, from_, msg: MConsensus) -> None:
        info = self.cmds.get(msg.dot)
        out = info.synod.handle(from_, (S_ACCEPT, msg.ballot, msg.value))
        if out is None:
            return
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
            return
        assert out[0] == S_CHOSEN
        self.to_processes_buf.append(
            ToSend(target=self.bp.all(), msg=MCommit(msg.dot, out[1]))
        )

    def _gc_running(self) -> bool:
        return self.bp.config.gc_interval_ms is not None
