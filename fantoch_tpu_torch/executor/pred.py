"""Predecessors executor for Caesar.

Capability parity with ``fantoch_ps/src/executor/pred/``: committed
commands go through two readiness phases — phase one waits until every
dependency is *committed*; phase two waits until every dependency with a
*lower clock* is *executed* (mod.rs:104-339). Commands execute in clock
order as a result. The executor reports (committed count, executed dots)
back to the protocol via the periodic executed notification, feeding
Caesar's all-processes-executed GC (executor.rs:65-77).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from ..core.command import Command
from ..core.config import Config
from ..core.ids import Dot, ProcessId, ShardId
from ..core.intervals import IntervalSet
from ..core.kvs import ExecutionOrderMonitor, KVStore
from ..core.timing import SysTime
from ..protocol.pred import CaesarDeps, Clock
from .base import Executor, ExecutorMetricsKind, ExecutorResult

# (new committed count, newly executed dots) — protocol/mod.rs
# CommittedAndExecuted
CommittedAndExecuted = Tuple[int, List[Dot]]


@dataclass
class PredecessorsExecutionInfo:
    dot: Dot
    cmd: Command
    clock: Clock
    deps: CaesarDeps


@dataclass
class _Vertex:
    """index.rs Vertex: command + clock + deps + missing-deps counter."""

    dot: Dot
    cmd: Command
    clock: Clock
    deps: CaesarDeps
    start_time_ms: int
    missing_deps: int = 0


class PredecessorsExecutor(Executor):
    """executor.rs:17-98 + the PredecessorsGraph (mod.rs:27-384), fused
    since the oracle runs one executor per process."""

    def __init__(self, process_id: ProcessId, shard_id: ShardId, config: Config):
        super().__init__(process_id, shard_id, config)
        self.store = KVStore(monitor=config.executor_monitor_execution_order)
        self.committed_clock: Dict[ProcessId, IntervalSet] = {}
        self.executed_clock: Dict[ProcessId, IntervalSet] = {}
        self.vertex_index: Dict[Dot, _Vertex] = {}
        self.phase_one_pending: Dict[Dot, Set[Dot]] = {}
        self.phase_two_pending: Dict[Dot, Set[Dot]] = {}
        self.new_committed_dots = 0
        self.new_executed_dots: List[Dot] = []

    # -- Executor interface -------------------------------------------

    def handle(self, info: PredecessorsExecutionInfo, time: SysTime) -> None:
        self._add(info.dot, info.cmd, info.clock, set(info.deps), time)

    def executed(self, time: SysTime) -> CommittedAndExecuted:
        committed, self.new_committed_dots = self.new_committed_dots, 0
        executed, self.new_executed_dots = self.new_executed_dots, []
        return committed, executed

    @staticmethod
    def parallel() -> bool:
        return False

    def monitor(self) -> Optional[ExecutionOrderMonitor]:
        return self.store.monitor

    # -- graph (mod.rs:104-384) ----------------------------------------

    def _add(self, dot, cmd, clock, deps, time) -> None:
        self.new_committed_dots += 1
        added = self.committed_clock.setdefault(
            dot.source, IntervalSet()
        ).add(dot.sequence)
        assert added, "a command must only commit once"
        assert dot not in deps, "commands must not depend on themselves"

        if self.config.execute_at_commit:
            self._execute(dot, cmd)
            return
        assert dot not in self.vertex_index, "vertex added twice"
        self.vertex_index[dot] = _Vertex(dot, cmd, clock, deps, time.millis())
        # deps pending on this dot's commit can progress in phase one
        self._try_phase_one_pending(dot, time)
        self._move_to_phase_one(dot, time)

    def _committed(self, dot: Dot) -> bool:
        clock = self.committed_clock.get(dot.source)
        return clock is not None and clock.contains(dot.sequence)

    def _executed(self, dot: Dot) -> bool:
        clock = self.executed_clock.get(dot.source)
        return clock is not None and clock.contains(dot.sequence)

    def _move_to_phase_one(self, dot: Dot, time) -> None:
        """Wait until all deps are committed (mod.rs:154-204)."""
        vertex = self.vertex_index[dot]
        non_committed = 0
        for dep_dot in vertex.deps:
            if not self._committed(dep_dot):
                non_committed += 1
                self.phase_one_pending.setdefault(dep_dot, set()).add(dot)
        if non_committed > 0:
            vertex.missing_deps = non_committed
        else:
            self._move_to_phase_two(dot, time)

    def _move_to_phase_two(self, dot: Dot, time) -> None:
        """Wait until all lower-clock deps are executed
        (mod.rs:208-275)."""
        vertex = self.vertex_index[dot]
        non_executed = 0
        for dep_dot in vertex.deps:
            if not self._executed(dep_dot):
                # committed (phase one passed) but not executed: the dep
                # must still be indexed; only lower-clock deps gate us
                dep = self.vertex_index[dep_dot]
                if dep.clock < vertex.clock:
                    non_executed += 1
                    self.phase_two_pending.setdefault(dep_dot, set()).add(dot)
        if non_executed > 0:
            vertex.missing_deps = non_executed
        else:
            self._save_to_execute(dot, time)

    def _try_phase_one_pending(self, dot: Dot, time) -> None:
        for pending_dot in self.phase_one_pending.pop(dot, set()):
            vertex = self.vertex_index[pending_dot]
            vertex.missing_deps -= 1
            if vertex.missing_deps == 0:
                self._move_to_phase_two(pending_dot, time)

    def _try_phase_two_pending(self, dot: Dot, time) -> None:
        for pending_dot in self.phase_two_pending.pop(dot, set()):
            vertex = self.vertex_index[pending_dot]
            vertex.missing_deps -= 1
            if vertex.missing_deps == 0:
                self._save_to_execute(pending_dot, time)

    def _save_to_execute(self, dot: Dot, time) -> None:
        vertex = self.vertex_index.pop(dot)
        self.metrics_.collect(
            ExecutorMetricsKind.EXECUTION_DELAY,
            time.millis() - vertex.start_time_ms,
        )
        self._execute(dot, vertex.cmd)
        self._try_phase_two_pending(dot, time)

    def _execute(self, dot: Dot, cmd: Command) -> None:
        self.new_executed_dots.append(dot)
        added = self.executed_clock.setdefault(
            dot.source, IntervalSet()
        ).add(dot.sequence)
        assert added, "a command must only execute once"
        for key, ops in cmd.items(self.shard_id):
            partial = self.store.execute(key, list(ops), cmd.rifl)
            self.to_clients_buf.append(ExecutorResult(cmd.rifl, key, partial))
