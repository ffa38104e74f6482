"""Caesar protocol (DSN'17): timestamp + dependency consensus with a
wait condition.

Capability parity with ``fantoch_ps/src/protocol/caesar.rs``: the
coordinator proposes a logical clock for the command (caesar.rs:245-264)
and every process computes the command's predecessors (lower-clock
conflicts) and blockers (higher-clock conflicts, caesar.rs:266-510);
when blocked, the *wait condition* holds the reply until the blockers
reach safe clocks — accepting if this command appears in their deps,
rejecting otherwise (932-1096); the fast path commits when every
fast-quorum member replied ok (⌊3n/4⌋+1, config.rs:295-300), while any
rejection after a majority triggers an ``MRetry`` round through the
write quorum (560-822). Execution goes through the two-phase
predecessors executor, whose executed notifications drive the
all-processes-executed GC (824-891).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from ..core.command import Command
from ..core.config import Config
from ..core.ids import Dot, ProcessId, ShardId
from ..core.timing import SysTime
from ..executor.pred import PredecessorsExecutionInfo, PredecessorsExecutor
from .base import (
    BaseProcess,
    CommandsInfo,
    Message,
    Protocol,
    ProtocolMetrics,
    ProtocolMetricsKind,
    ToForward,
    ToSend,
)
from .pred import CaesarDeps, Clock, KeyClocks, QuorumClocks, QuorumRetries

# statuses (caesar.rs Status)
START, PROPOSE_BEGIN, PROPOSE_END, REJECT, ACCEPT, COMMIT = range(6)


# messages (caesar.rs:1232-1271)
@dataclass
class MPropose(Message):
    dot: Dot
    cmd: Command
    clock: Clock


@dataclass
class MProposeAck(Message):
    dot: Dot
    clock: Clock
    deps: CaesarDeps
    ok: bool


@dataclass
class MCommit(Message):
    dot: Dot
    clock: Clock
    deps: CaesarDeps


@dataclass
class MRetry(Message):
    dot: Dot
    clock: Clock
    deps: CaesarDeps


@dataclass
class MRetryAck(Message):
    dot: Dot
    deps: CaesarDeps


@dataclass
class MGarbageCollection(Message):
    WORKER = "gc"

    executed: List[Dot]


@dataclass
class MGCDot(Message):
    dot: Dot


GARBAGE_COLLECTION = "garbage_collection"


class BasicGCTrack:
    """Dot is stable once seen executed at all n processes
    (fantoch/src/protocol/gc/basic.rs)."""

    def __init__(self, n: int):
        self.n = n
        self.dot_to_count: Dict[Dot, int] = {}

    def add(self, dot: Dot) -> bool:
        count = self.dot_to_count.get(dot, 0) + 1
        if count == self.n:
            self.dot_to_count.pop(dot, None)
            return True
        self.dot_to_count[dot] = count
        return False


class _CaesarInfo:
    """Per-command lifecycle record (caesar.rs:1178-1230)."""

    def __init__(self, process_id: ProcessId, fast_quorum_size: int,
                 write_quorum_size: int):
        self.status = START
        self.cmd: Optional[Command] = None
        self.clock = Clock.zero(process_id)
        self.deps: CaesarDeps = set()
        self.blocking: Set[Dot] = set()
        self.blocked_by: Set[Dot] = set()
        self.quorum_clocks = QuorumClocks(
            process_id, fast_quorum_size, write_quorum_size
        )
        self.quorum_retries = QuorumRetries(write_quorum_size)
        self.start_time_ms: Optional[int] = None
        self.wait_start_time_ms: Optional[int] = None


class Caesar(Protocol):
    EXECUTOR = PredecessorsExecutor

    def __init__(self, process_id: ProcessId, shard_id: ShardId, config: Config):
        super().__init__(process_id, shard_id, config)
        fast_quorum_size, write_quorum_size = config.caesar_quorum_sizes()
        self.bp = BaseProcess(
            process_id, shard_id, config, fast_quorum_size, write_quorum_size
        )
        self.key_clocks = KeyClocks(process_id, shard_id)
        self.cmds: CommandsInfo[_CaesarInfo] = CommandsInfo(
            lambda: _CaesarInfo(process_id, fast_quorum_size,
                                write_quorum_size)
        )
        self.gc_track = BasicGCTrack(config.n)
        self.committed_dots = 0
        self.executed_dots = 0
        self.new_executed_dots: List[Dot] = []
        self.buffered_retries: Dict[Dot, Tuple[ProcessId, Clock, CaesarDeps]] = {}
        self.buffered_commits: Dict[Dot, Tuple[ProcessId, Clock, CaesarDeps]] = {}
        self.try_to_unblock_again: List[
            Tuple[Dot, Clock, CaesarDeps, Set[Dot]]
        ] = []
        self.wait_condition = config.caesar_wait_condition

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
        clock = self.key_clocks.clock_next()
        # sent to everyone: the fastest ok-replying fast quorum wins
        # (caesar.rs:252-257)
        self.to_processes_buf.append(
            ToSend(target=self.bp.all(), msg=MPropose(dot, cmd, clock))
        )

    def handle(self, from_, from_shard_id, msg, time) -> None:
        if isinstance(msg, MPropose):
            self._handle_mpropose(from_, msg, time)
        elif isinstance(msg, MProposeAck):
            self._handle_mproposeack(from_, msg)
        elif isinstance(msg, MCommit):
            self._handle_mcommit(from_, msg.dot, msg.clock, msg.deps, time)
        elif isinstance(msg, MRetry):
            self._handle_mretry(from_, msg.dot, msg.clock, msg.deps, time)
        elif isinstance(msg, MRetryAck):
            self._handle_mretryack(from_, msg)
        elif isinstance(msg, MGarbageCollection):
            for dot in msg.executed:
                self._gc_track_add(dot)
        elif isinstance(msg, MGCDot):
            self._gc_command(msg.dot)
            self.bp.stable(1)
        else:
            raise TypeError(f"unexpected message {msg!r}")
        # after every message, retry unblock attempts that found commands
        # still mid-propose (caesar.rs:177-183)
        again, self.try_to_unblock_again = self.try_to_unblock_again, []
        for dot, clock, deps, blocking in again:
            self._try_to_unblock(dot, clock, deps, blocking, time)

    def handle_event(self, event, time) -> None:
        assert event == GARBAGE_COLLECTION
        executed, self.new_executed_dots = self.new_executed_dots, []
        self.to_processes_buf.append(
            ToSend(
                target=self.bp.all_but_me(),
                msg=MGarbageCollection(executed),
            )
        )

    def handle_executed(self, committed_and_executed, time: SysTime) -> None:
        """Executor feedback: executed dots feed GC (caesar.rs:194-213)."""
        new_committed, new_executed = committed_and_executed
        for dot in new_executed:
            self._gc_track_add(dot)
        self.committed_dots += new_committed
        self.executed_dots += len(new_executed)
        self.new_executed_dots.extend(new_executed)

    @staticmethod
    def parallel() -> bool:
        # the reference's only Caesar variant is CaesarLocked
        # (LockedCommandsInfo); cooperative workers give the same
        # per-message atomicity with no locks
        return True

    @staticmethod
    def leaderless() -> bool:
        return True

    def metrics(self) -> ProtocolMetrics:
        return self.bp.metrics

    # -- handlers ------------------------------------------------------

    def _handle_mpropose(self, from_, msg: MPropose, time) -> None:
        dot, cmd, remote_clock = msg.dot, msg.cmd, msg.clock
        assert dot.source == from_
        self.key_clocks.clock_join(remote_clock)
        info = self.cmds.get(dot)
        if info.status != START:
            return
        info.start_time_ms = time.millis()

        blocked_by: Set[Dot] = set()
        deps = self.key_clocks.predecessors(dot, cmd, remote_clock, blocked_by)
        info.status = PROPOSE_BEGIN
        info.cmd = cmd
        info.deps = deps
        self._update_clock(dot, info, remote_clock)
        clock = info.clock
        info.blocked_by = set(blocked_by)

        # decide between ACCEPT / REJECT / WAIT (caesar.rs:326-494)
        ACCEPT_R, REJECT_R, WAIT_R = range(3)
        reply = WAIT_R
        blocked_by_to_ignore: Set[Dot] = set()
        if not blocked_by:
            reply = ACCEPT_R
        elif not self.wait_condition:
            reply = REJECT_R
        else:
            for blocked_by_dot in blocked_by:
                blocked_by_info = self.cmds.peek(blocked_by_dot)
                if blocked_by_info is not None:
                    has_safe_clock_and_deps = blocked_by_info.status in (
                        ACCEPT,
                        COMMIT,
                    )
                    if has_safe_clock_and_deps:
                        if self._safe_to_ignore(
                            dot, clock, blocked_by_info.clock,
                            blocked_by_info.deps,
                        ):
                            blocked_by_to_ignore.add(blocked_by_dot)
                        else:
                            reply = REJECT_R
                            break
                    else:
                        # blocked until the blocker reaches a safe state
                        blocked_by_info.blocking.add(dot)
                else:
                    # blocker already GC'd, thus executed everywhere
                    blocked_by_to_ignore.add(blocked_by_dot)
            if len(blocked_by_to_ignore) == len(blocked_by):
                assert reply == WAIT_R
                reply = ACCEPT_R

        info = self.cmds.peek(dot)
        assert info is not None and info.status == PROPOSE_BEGIN
        info.status = PROPOSE_END
        if reply == ACCEPT_R:
            self._accept_command(dot, info)
        elif reply == REJECT_R:
            self._reject_command(dot, info)
        else:
            info.blocked_by -= blocked_by_to_ignore
            assert info.blocked_by
            info.wait_start_time_ms = time.millis()

        buffered = self.buffered_retries.pop(dot, None)
        if buffered is not None:
            self._handle_mretry(buffered[0], dot, buffered[1], buffered[2],
                                time)
        buffered = self.buffered_commits.pop(dot, None)
        if buffered is not None:
            self._handle_mcommit(buffered[0], dot, buffered[1], buffered[2],
                                 time)

    def _handle_mproposeack(self, from_, msg: MProposeAck) -> None:
        info = self.cmds.get(msg.dot)
        # the coordinator can reject its own command (caesar.rs:536-547)
        if info.status not in (PROPOSE_END, REJECT):
            return
        assert not info.quorum_clocks.all(), (
            "already had all MProposeAck needed"
        )
        info.quorum_clocks.add(from_, msg.clock, msg.deps, msg.ok)
        if not info.quorum_clocks.all():
            return
        clock, deps, ok = info.quorum_clocks.aggregated()
        if ok:
            assert clock == info.clock
            self.bp.fast_path()
            self.to_processes_buf.append(
                ToSend(target=self.bp.all(), msg=MCommit(msg.dot, clock, deps))
            )
        else:
            self.bp.slow_path()
            # sent to everyone: the retry's safe clock may unblock waiting
            # commands anywhere (caesar.rs:593-596)
            self.to_processes_buf.append(
                ToSend(target=self.bp.all(), msg=MRetry(msg.dot, clock, deps))
            )

    def _handle_mcommit(self, from_, dot, clock, deps, time) -> None:
        self.key_clocks.clock_join(clock)
        info = self.cmds.get(dot)
        if info.status == START:
            self.buffered_commits[dot] = (from_, clock, set(deps))
            return
        if info.status == COMMIT:
            return
        if info.start_time_ms is not None:
            latency = time.millis() - info.start_time_ms
            info.start_time_ms = None
            self.bp.collect_metric(
                ProtocolMetricsKind.COMMIT_LATENCY, latency
            )
        self.bp.collect_metric(
            ProtocolMetricsKind.COMMITTED_DEPS_LEN, len(deps)
        )
        # a command may end up depending on itself; the executor assumes
        # otherwise (caesar.rs:665-668)
        deps = set(deps)
        deps.discard(dot)
        info.status = COMMIT
        info.deps = deps
        self._update_clock(dot, info, clock)
        assert info.cmd is not None
        self.to_executors_buf.append(
            PredecessorsExecutionInfo(dot, info.cmd, clock, set(deps))
        )
        blocking, info.blocking = info.blocking, set()
        self._try_to_unblock(dot, clock, info.deps, blocking, time)
        if not self._gc_running():
            self._gc_command(dot)

    def _handle_mretry(self, from_, dot, clock, deps, time) -> None:
        self.key_clocks.clock_join(clock)
        info = self.cmds.get(dot)
        if info.status == START:
            self.buffered_retries[dot] = (from_, clock, set(deps))
            return
        if info.status == COMMIT:
            return
        info.status = ACCEPT
        info.deps = set(deps)
        self._update_clock(dot, info, clock)
        assert info.cmd is not None
        new_deps = self.key_clocks.predecessors(dot, info.cmd, clock, None)
        new_deps |= deps
        self.to_processes_buf.append(
            ToSend(target={from_}, msg=MRetryAck(dot, new_deps))
        )
        blocking, info.blocking = info.blocking, set()
        self._try_to_unblock(dot, clock, info.deps, blocking, time)

    def _handle_mretryack(self, from_, msg: MRetryAck) -> None:
        info = self.cmds.get(msg.dot)
        # ignore stragglers once the MCommit went out (caesar.rs:785-798)
        if info.status != ACCEPT:
            return
        assert not info.quorum_retries.all(), (
            "already had all MRetryAck needed"
        )
        info.quorum_retries.add(from_, msg.deps)
        if info.quorum_retries.all():
            aggregated = info.quorum_retries.aggregated()
            self.to_processes_buf.append(
                ToSend(
                    target=self.bp.all(),
                    msg=MCommit(msg.dot, info.clock, aggregated),
                )
            )

    # -- wait condition (caesar.rs:932-1096) ---------------------------

    def _safe_to_ignore(
        self, my_dot: Dot, my_clock: Clock, their_clock: Clock,
        their_deps: CaesarDeps,
    ) -> bool:
        """A higher-clock blocker can be ignored only if we appear in its
        dependencies (clocks only increase, caesar.rs:932-956)."""
        assert my_clock < their_clock
        return my_dot in their_deps

    def _try_to_unblock(self, dot, clock, deps, blocking, time) -> None:
        at_propose_begin: Set[Dot] = set()
        for blocked_dot in blocking:
            blocked_info = self.cmds.peek(blocked_dot)
            if blocked_info is None:
                continue  # already GC'd
            if blocked_info.status == PROPOSE_BEGIN:
                at_propose_begin.add(blocked_dot)
            elif blocked_info.status == PROPOSE_END:
                end_of_wait = False
                if self._safe_to_ignore(
                    blocked_dot, blocked_info.clock, clock, deps
                ):
                    blocked_info.blocked_by.discard(dot)
                    if not blocked_info.blocked_by:
                        self._accept_command(blocked_dot, blocked_info)
                        end_of_wait = True
                else:
                    # reject ASAP (caesar.rs:1036-1050)
                    self._reject_command(blocked_dot, blocked_info)
                    end_of_wait = True
                if end_of_wait:
                    wait_start = blocked_info.wait_start_time_ms
                    assert wait_start is not None
                    blocked_info.wait_start_time_ms = None
                    self.bp.collect_metric(
                        ProtocolMetricsKind.WAIT_CONDITION_DELAY,
                        time.millis() - wait_start,
                    )
            # else: no longer at PROPOSE, nothing to do
        if at_propose_begin:
            self.try_to_unblock_again.append(
                (dot, clock, deps, at_propose_begin)
            )

    def _accept_command(self, dot: Dot, info: _CaesarInfo) -> None:
        self._send_mpropose_ack(dot, info.clock, set(info.deps), ok=True)

    def _reject_command(self, dot: Dot, info: _CaesarInfo) -> None:
        info.status = REJECT
        new_clock = self.key_clocks.clock_next()
        assert info.cmd is not None
        new_deps = self.key_clocks.predecessors(dot, info.cmd, new_clock, None)
        self._send_mpropose_ack(dot, new_clock, new_deps, ok=False)

    def _send_mpropose_ack(self, dot, clock, deps, ok) -> None:
        self.to_processes_buf.append(
            ToSend(target={dot.source}, msg=MProposeAck(dot, clock, deps, ok))
        )

    # -- clocks + GC ---------------------------------------------------

    def _update_clock(self, dot: Dot, info: _CaesarInfo, new_clock: Clock):
        """Swap the command's registered tentative clock
        (caesar.rs:893-918)."""
        assert info.cmd is not None
        if not info.clock.is_zero():
            self.key_clocks.remove(info.cmd, info.clock)
        self.key_clocks.add(dot, info.cmd, new_clock)
        info.clock = new_clock

    def _gc_track_add(self, dot: Dot) -> None:
        if self.gc_track.add(dot):
            self.to_processes_buf.append(ToForward(MGCDot(dot)))

    def _gc_command(self, dot: Dot) -> None:
        info = self.cmds.gc_single(dot)
        if info is None:
            # already removed (e.g. gc'd at commit when the periodic GC
            # is disabled; caesar.rs:921 tolerates this too)
            return
        assert info.cmd is not None
        if not info.clock.is_zero():
            self.key_clocks.remove(info.cmd, info.clock)

    def _gc_running(self) -> bool:
        return self.bp.config.gc_interval_ms is not None
