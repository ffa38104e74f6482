"""Tempo (EuroSys'21): timestamp-stability consensus — the flagship
protocol.

Capability parity with ``fantoch_ps/src/protocol/tempo.rs``:

- submit bumps per-key clocks into a timestamp proposal with attached vote
  ranges (tempo.rs:267-339);
- fast path iff the max clock over the fast quorum was reported by >= f
  members (tempo.rs:517-536); otherwise single-decree Paxos on the
  timestamp (``MConsensus``/``MConsensusAck``, tempo.rs:538-552, 718-812);
- commit emits per-key attached votes to the ``TableExecutor``
  (tempo.rs:589-617); detached votes accelerate stability
  (``MDetached``, periodic ``SendDetached``); periodic ``ClockBump``
  implements real-time clocks (bump to ``max(max_commit_clock,
  time.micros())``, tempo.rs:972-992);
- partial replication via ``MForwardSubmit``/``MBump``/``MShardCommit``/
  ``MShardAggregatedCommit`` (tempo.rs:814-895, partial.rs);
- committed-clock GC identical to Basic's (tempo.rs:897-970).

The reference's ``skip_fast_ack`` optimization (fast-quorum processes
commit directly when the fast quorum size is 2; tempo.rs:91-93, 442-455)
is supported.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Dict, List, Optional, Set, Tuple

from ..core.command import Command
from ..core.config import Config
from ..core.ids import Dot, ProcessId, ShardId, process_ids
from ..core.timing import SysTime
from ..executor.table import AttachedVotes, DetachedVotes, TableExecutor
from . import partial
from .base import (
    BaseProcess,
    CommandsInfo,
    GCTrack,
    Message,
    Protocol,
    ToForward,
    ToSend,
)
from .synod import S_ACCEPT, S_ACCEPTED, S_CHOSEN, Synod
from .table import KeyClocks, QuorumClocks, Votes


class Status(IntEnum):
    START = 0
    PAYLOAD = 1
    COLLECT = 2
    COMMIT = 3


# messages (tempo.rs:1160-1224)
@dataclass
class MCollect(Message):
    dot: Dot
    cmd: Command
    quorum: Set[ProcessId]
    clock: int
    coordinator_votes: Votes


@dataclass
class MCollectAck(Message):
    dot: Dot
    clock: int
    process_votes: Votes


@dataclass
class MCommit(Message):
    dot: Dot
    clock: int
    votes: Votes


@dataclass
class MCommitClock(Message):
    WORKER = "aux"  # CLOCK_BUMP_WORKER_INDEX (tempo.rs:1226-1243)

    clock: int


@dataclass
class MDetached(Message):
    WORKER = "aux"  # CLOCK_BUMP_WORKER_INDEX (tempo.rs:1243-1245)

    detached: Votes


@dataclass
class MConsensus(Message):
    dot: Dot
    ballot: int
    clock: int


@dataclass
class MConsensusAck(Message):
    dot: Dot
    ballot: int


@dataclass
class MForwardSubmit(Message):
    dot: Dot
    cmd: Command


@dataclass
class MBump(Message):
    dot: Dot
    clock: int


@dataclass
class MShardCommit(Message):
    dot: Dot
    clock: int


@dataclass
class MShardAggregatedCommit(Message):
    dot: Dot
    clock: int


@dataclass
class MCommitDot(Message):
    WORKER = "gc"  # tempo.rs:1256-1262

    dot: Dot


@dataclass
class MGarbageCollection(Message):
    WORKER = "gc"

    committed: Dict[ProcessId, int]


@dataclass
class MStable(Message):
    WORKER = "gc"  # self-forwarded by the GC worker; stays there

    stable: List[Tuple[ProcessId, int, int]]


# periodic events (tempo.rs:1271-1276)
GARBAGE_COLLECTION = "garbage_collection"
CLOCK_BUMP = "clock_bump"
SEND_DETACHED = "send_detached"


def _proposal_gen(_values):
    raise NotImplementedError("recovery not implemented yet")  # tempo.rs:1098


@dataclass
class _ShardsCommitsInfo:
    """tempo.rs:1144-1158."""

    max_clock: int = 0
    votes: Optional[Votes] = None

    def add(self, clock: int) -> None:
        self.max_clock = max(self.max_clock, clock)

    def set_votes(self, votes: Votes) -> None:
        self.votes = votes


class _TempoInfo:
    """tempo.rs:1102-1141."""

    __slots__ = (
        "status",
        "quorum",
        "synod",
        "cmd",
        "votes",
        "quorum_clocks",
        "shards_commits",
    )

    def __init__(self, process_id: ProcessId, n: int, f: int, fast_quorum_size: int):
        self.status = Status.START
        self.quorum: Set[ProcessId] = set()
        self.synod: Synod[int] = Synod(process_id, n, f, _proposal_gen, 0)
        self.cmd: Optional[Command] = None
        self.votes = Votes()
        self.quorum_clocks = QuorumClocks(fast_quorum_size)
        self.shards_commits = None


class Tempo(Protocol):
    # implements partial.rs's multi-shard coordination paths
    PARTIAL_REPLICATION = True

    EXECUTOR = TableExecutor
    KEY_CLOCKS = KeyClocks

    def __init__(self, process_id: ProcessId, shard_id: ShardId, config: Config):
        super().__init__(process_id, shard_id, config)
        fast_quorum_size, write_quorum_size, _ = config.tempo_quorum_sizes()
        self.bp = BaseProcess(
            process_id, shard_id, config, fast_quorum_size, write_quorum_size
        )
        self.key_clocks = self.KEY_CLOCKS(process_id, shard_id)
        n, f = config.n, config.f
        self.cmds: CommandsInfo[_TempoInfo] = CommandsInfo(
            lambda: _TempoInfo(process_id, n, f, fast_quorum_size)
        )
        self.gc_track = GCTrack(process_id, shard_id, config.n)
        self.detached = Votes()
        self.buffered_mcommits: Dict[Dot, Tuple[ProcessId, int, Votes]] = {}
        self.buffered_mbumps: Dict[Dot, int] = {}
        self.max_commit_clock = 0
        self.skip_fast_ack = config.skip_fast_ack and fast_quorum_size == 2

    # -- Protocol interface --------------------------------------------

    def periodic_events(self):
        events = []
        cfg = self.bp.config
        if cfg.gc_interval_ms is not None:
            events.append((GARBAGE_COLLECTION, cfg.gc_interval_ms))
        if cfg.tempo_clock_bump_interval_ms is not None:
            events.append((CLOCK_BUMP, cfg.tempo_clock_bump_interval_ms))
        if cfg.tempo_detached_send_interval_ms is not None:
            events.append((SEND_DETACHED, cfg.tempo_detached_send_interval_ms))
        return events

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
            self._handle_mcommit(from_, msg.dot, msg.clock, msg.votes)
        elif isinstance(msg, MCommitClock):
            assert from_ == self.id()
            self.max_commit_clock = max(self.max_commit_clock, msg.clock)
        elif isinstance(msg, MDetached):
            self._handle_mdetached(msg.detached)
        elif isinstance(msg, MConsensus):
            self._handle_mconsensus(from_, msg)
        elif isinstance(msg, MConsensusAck):
            self._handle_mconsensusack(from_, msg)
        elif isinstance(msg, MForwardSubmit):
            self._handle_submit(msg.dot, msg.cmd, target_shard=False)
        elif isinstance(msg, MBump):
            self._handle_mbump(msg)
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

    def handle_event(self, event, time: SysTime) -> None:
        if event == GARBAGE_COLLECTION:
            self.to_processes_buf.append(
                ToSend(
                    target=self.bp.all_but_me(),
                    msg=MGarbageCollection(self.gc_track.clock_frontier()),
                )
            )
        elif event == CLOCK_BUMP:
            # bump all clocks to max(highest committed clock, current time
            # in MICROS) — millis lack precision with many clients
            # (tempo.rs:972-992)
            min_clock = max(self.max_commit_clock, time.micros())
            self.key_clocks.detached_all(min_clock, self.detached)
        elif event == SEND_DETACHED:
            detached, self.detached = self.detached, Votes()
            if not detached.is_empty():
                self.to_processes_buf.append(
                    ToSend(target=self.bp.all(), msg=MDetached(detached))
                )
        else:
            raise TypeError(f"unexpected event {event!r}")

    @staticmethod
    def parallel() -> bool:
        return True

    @staticmethod
    def leaderless() -> bool:
        return True

    @staticmethod
    def event_worker(event) -> str:
        """tempo.rs:1271-1276: clock-bump and send-detached run on the
        reserved clock-bump worker; GC on the GC worker."""
        return "gc" if event == GARBAGE_COLLECTION else "aux"

    def metrics(self):
        return self.bp.metrics

    # -- handlers -------------------------------------------------------

    def _handle_submit(
        self, dot: Optional[Dot], cmd: Command, target_shard: bool
    ) -> None:
        """tempo.rs:267-339."""
        dot = dot if dot is not None else self.bp.next_dot()

        partial.submit_actions(
            self.bp,
            dot,
            cmd,
            target_shard,
            lambda d, c: MForwardSubmit(d, c),
            self.to_processes_buf,
        )

        clock, process_votes = self.key_clocks.proposal(cmd, 0)
        shard_count = cmd.shard_count()

        if self.skip_fast_ack and shard_count == 1:
            coordinator_votes = process_votes
        else:
            info = self.cmds.get(dot)
            info.votes = process_votes
            coordinator_votes = Votes()

        self.to_processes_buf.append(
            ToSend(
                target=self.bp.all(),
                msg=MCollect(
                    dot, cmd, self.bp.fast_quorum(), clock, coordinator_votes
                ),
            )
        )

    def _handle_mcollect(self, from_, msg: MCollect, time: SysTime) -> None:
        """tempo.rs:341-459."""
        dot, cmd = msg.dot, msg.cmd
        info = self.cmds.get(dot)
        if info.status != Status.START:
            return

        if self.id() not in msg.quorum:
            # not in the fast quorum: save payload only
            if self.bp.config.tempo_clock_bump_interval_ms is not None:
                self.key_clocks.init_clocks(cmd)
            info.status = Status.PAYLOAD
            info.cmd = cmd
            buffered = self.buffered_mcommits.pop(dot, None)
            if buffered is not None:
                bfrom, bclock, bvotes = buffered
                self._handle_mcommit(bfrom, dot, bclock, bvotes)
            return

        message_from_self = from_ == self.bp.process_id
        if message_from_self:
            clock, process_votes = msg.clock, Votes()
        else:
            clock, process_votes = self.key_clocks.proposal(cmd, msg.clock)

        bump_to = self.buffered_mbumps.pop(dot, None)
        if bump_to is not None:
            self.key_clocks.detached(cmd, bump_to, self.detached)

        shard_count = cmd.shard_count()
        info.status = Status.COLLECT
        info.cmd = cmd
        info.quorum = set(msg.quorum)
        was_set = info.synod.set_if_not_accepted(lambda: clock)
        assert was_set

        if not message_from_self and self.skip_fast_ack and shard_count == 1:
            votes = msg.coordinator_votes
            votes.merge(process_votes)
            self._mcommit_actions(info, shard_count, dot, clock, votes)
        else:
            self._mcollect_actions(
                from_, dot, clock, process_votes, shard_count
            )

    def _handle_mcollectack(self, from_, msg: MCollectAck) -> None:
        """tempo.rs:461-554."""
        dot = msg.dot
        info = self.cmds.get(dot)
        if info.status != Status.COLLECT:
            return

        info.votes.merge(msg.process_votes)
        max_clock, max_count = info.quorum_clocks.add(from_, msg.clock)
        message_from_self = from_ == self.bp.process_id

        # optimization: bump keys to max_clock to avoid delaying this
        # command's execution (tempo.rs:497-514)
        cmd = info.cmd
        assert cmd is not None
        if not message_from_self:
            self.key_clocks.detached(cmd, max_clock, self.detached)

        if info.quorum_clocks.all():
            if max_count >= self.bp.config.f:
                self.bp.fast_path()
                votes, info.votes = info.votes, Votes()
                self._mcommit_actions(
                    info, cmd.shard_count(), dot, max_clock, votes
                )
            else:
                self.bp.slow_path()
                ballot = info.synod.skip_prepare()
                self.to_processes_buf.append(
                    ToSend(
                        target=self.bp.write_quorum(),
                        msg=MConsensus(dot, ballot, max_clock),
                    )
                )

    def _handle_mcommit(self, from_, dot: Dot, clock: int, votes: Votes) -> None:
        """tempo.rs:556-654."""
        info = self.cmds.get(dot)
        if info.status == Status.START:
            self.buffered_mcommits[dot] = (from_, clock, votes)
            return
        if info.status == Status.COMMIT:
            return

        cmd = info.cmd
        assert cmd is not None
        for key, ops in cmd.items(self.bp.shard_id):
            key_votes = votes.remove(key)
            self.to_executors_buf.append(
                AttachedVotes(
                    dot=dot,
                    clock=clock,
                    key=key,
                    rifl=cmd.rifl,
                    shard_to_keys={
                        s: list(keys) for s, keys in cmd.shard_to_ops.items()
                    },
                    ops=list(ops),
                    votes=key_votes,
                )
            )

        info.status = Status.COMMIT
        chosen_out = info.synod.handle(from_, (S_CHOSEN, clock))
        assert chosen_out is None

        if self.bp.config.tempo_clock_bump_interval_ms is not None:
            # real-time mode: just notify the clock-bump role
            self.to_processes_buf.append(ToForward(MCommitClock(clock)))
        else:
            self.key_clocks.detached(cmd, clock, self.detached)

        my_shard = dot.source in process_ids(
            self.bp.shard_id, self.bp.config.n
        )
        if self._gc_running() and my_shard:
            self.to_processes_buf.append(ToForward(MCommitDot(dot)))
        else:
            self.cmds.gc_single(dot)

    def _handle_mdetached(self, detached: Votes) -> None:
        """tempo.rs:703-716."""
        for key, key_votes in detached.items():
            self.to_executors_buf.append(DetachedVotes(key, key_votes))

    def _handle_mconsensus(self, from_, msg: MConsensus) -> None:
        """tempo.rs:718-773."""
        info = self.cmds.get(msg.dot)
        if info.cmd is not None:
            self.key_clocks.detached(info.cmd, msg.clock, self.detached)
        out = info.synod.handle(from_, (S_ACCEPT, msg.ballot, msg.clock))
        if out is None:
            return
        if out[0] == S_ACCEPTED:
            reply = MConsensusAck(msg.dot, out[1])
        elif out[0] == S_CHOSEN:
            # already-chosen: reply with an MCommit carrying known votes
            reply = MCommit(msg.dot, out[1], copy.deepcopy(info.votes))
        else:
            raise AssertionError(out)
        self.to_processes_buf.append(ToSend(target={from_}, msg=reply))

    def _handle_mconsensusack(self, from_, msg: MConsensusAck) -> None:
        """tempo.rs:775-812."""
        info = self.cmds.get(msg.dot)
        out = info.synod.handle(from_, (S_ACCEPTED, msg.ballot))
        if out is None:
            return
        assert out[0] == S_CHOSEN
        clock = out[1]
        votes, info.votes = info.votes, Votes()
        assert info.cmd is not None
        self._mcommit_actions(
            info, info.cmd.shard_count(), msg.dot, clock, votes
        )

    def _handle_mbump(self, msg: MBump) -> None:
        """tempo.rs:674-701."""
        info = self.cmds.get(msg.dot)
        if info.cmd is not None:
            self.key_clocks.detached(info.cmd, msg.clock, self.detached)
        else:
            current = self.buffered_mbumps.get(msg.dot, 0)
            self.buffered_mbumps[msg.dot] = max(current, msg.clock)

    def _handle_mshard_commit(self, from_, msg: MShardCommit) -> None:
        """tempo.rs:814-858."""
        info = self.cmds.get(msg.dot)
        assert info.cmd is not None
        shard_count = info.cmd.shard_count()
        partial.handle_mshard_commit(
            self.bp,
            info,
            shard_count,
            from_,
            msg.dot,
            msg.clock,
            lambda i, clock: i.add(clock),
            lambda dot, i: MShardAggregatedCommit(dot, i.max_clock),
            self.to_processes_buf,
            _ShardsCommitsInfo,
        )

    def _handle_mshard_aggregated_commit(
        self, msg: MShardAggregatedCommit
    ) -> None:
        """tempo.rs:860-895."""
        info = self.cmds.get(msg.dot)
        partial.handle_mshard_aggregated_commit(
            self.bp,
            info,
            msg.dot,
            msg.clock,
            lambda i: i.votes,
            lambda dot, clock, votes: MCommit(dot, clock, votes),
            self.to_processes_buf,
        )

    def _handle_mgc(self, from_, msg: MGarbageCollection) -> None:
        self.gc_track.update_clock_of(from_, msg.committed)
        stable = self.gc_track.stable()
        if stable:
            self.to_processes_buf.append(ToForward(MStable(stable)))

    # -- helpers --------------------------------------------------------

    def _mcollect_actions(
        self, from_, dot, clock, process_votes, shard_count
    ) -> None:
        """tempo.rs:1013-1049."""
        self.to_processes_buf.append(
            ToSend(target={from_}, msg=MCollectAck(dot, clock, process_votes))
        )
        if shard_count > 1:
            info = self.cmds.get(dot)
            assert info.cmd is not None
            for shard_id in info.cmd.shards():
                if shard_id != self.bp.shard_id:
                    self.to_processes_buf.append(
                        ToSend(
                            target={self.bp.closest_process(shard_id)},
                            msg=MBump(dot, clock),
                        )
                    )

    def _mcommit_actions(self, info, shard_count, dot, clock, votes) -> None:
        """tempo.rs:1051-1081."""
        partial.mcommit_actions(
            self.bp,
            info,
            shard_count,
            dot,
            clock,
            votes,
            lambda d, c, v: MCommit(d, c, v),
            lambda d, c: MShardCommit(d, c),
            lambda i, v: i.set_votes(v),
            self.to_processes_buf,
            _ShardsCommitsInfo,
        )

    def _gc_running(self) -> bool:
        return self.bp.config.gc_interval_ms is not None


class TempoAtomic(Tempo):
    """Tempo over the native lock-free AtomicKeyClocks — the
    ``tempo_atomic`` binary's variant (fantoch_ps/src/bin/
    tempo_atomic.rs; clock state in common/table/clocks/keys/
    atomic.rs:13-90). Byte-identical behavior to :class:`Tempo` under
    one worker; under thread-parallel workers the per-key CAS bumps
    interleave safely without the GIL."""

    from .table import NativeAtomicKeyClocks as KEY_CLOCKS  # noqa: N814
