"""Dependency-graph executor for Atlas/EPaxos.

Capability parity with ``fantoch_ps/src/executor/graph/``: committed
commands enter a dependency graph and execute SCC-by-SCC in topological
order — Tarjan's algorithm with executed-clock pruning (tarjan.rs:99-319),
a pending index that re-triggers searches when a missing dependency
executes (index.rs:146-211, mod.rs:558-644), and executor-to-executor
``Request``/``RequestReply`` traffic for vertices owned by remote shards
(mod.rs:279-408).

The reference's finder recurses (tarjan.rs:190); Python recursion on long
conflict chains would blow the stack, so the finder here is iterative
with an explicit frame stack — same visit order, same results.

Device-engine note: Tarjan is hostile to SIMT, so the array twin replaces
it with iterated masked relaxation to a fixed point ("execute when all
deps executed"), which is equivalent because SCC members share commit
status (SURVEY.md §7.1).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..core.command import Command
from ..core.config import Config
from ..core.ids import Dot, ProcessId, ShardId
from ..core.intervals import IntervalSet
from ..core.kvs import ExecutionOrderMonitor, KVStore
from ..core.timing import SysTime
from ..protocol.graph_deps import Dependency
from .base import Executor, ExecutorMetricsKind, ExecutorResult

# GraphExecutionInfo variants (executor.rs:197-232), as dataclasses.
# ``POOL_INDEX = (reserved, index)`` mirrors the reference's
# MessageIndex impl (executor.rs:234-253): Add/RequestReply go to the
# main executor 0 (runs the graph), Request/Executed to the secondary
# executor 1 (answers cross-shard requests) — the run layer's pool
# routing applies the reference's do_index formula (pool.rs:114-123).


@dataclass
class GraphAdd:
    POOL_INDEX = (0, 0)

    dot: Dot
    cmd: Command
    deps: Set[Dependency]


@dataclass
class GraphRequest:
    POOL_INDEX = (0, 1)

    from_shard: ShardId
    dots: Set[Dot]


@dataclass
class GraphRequestReply:
    POOL_INDEX = (0, 0)

    infos: List


@dataclass
class GraphExecuted:
    POOL_INDEX = (0, 1)

    dots: Set[Dot]


@dataclass
class ReplyInfo:
    dot: Dot
    cmd: Command
    deps: List[Dependency]


@dataclass
class ReplyExecuted:
    dot: Dot


@dataclass
class _Vertex:
    """tarjan.rs:322-358."""

    dot: Dot
    cmd: Command
    deps: List[Dependency]
    start_time_ms: int
    id: int = 0
    low: int = 0
    on_stack: bool = False


class _Finder:
    """Iterative Tarjan SCC finder with executed-clock pruning
    (tarjan.rs:26-319)."""

    FOUND = "found"
    NOT_FOUND = "not_found"
    MISSING = "missing"
    NOT_PENDING = "not_pending"

    def __init__(self, shard_count: int):
        self.shard_count = shard_count
        self.id = 0
        self.stack: List[Dot] = []
        self.sccs: List[List[Dot]] = []
        self.missing_deps: Set[Dependency] = set()

    def take_sccs(self) -> List[List[Dot]]:
        out, self.sccs = self.sccs, []
        return out

    def finalize(self, vertex_index: Dict[Dot, _Vertex]):
        """Reset ids of everything still on the stack; return (visited,
        missing deps) (tarjan.rs:63-96)."""
        self.id = 0
        visited: Set[Dot] = set()
        while self.stack:
            dot = self.stack.pop()
            vertex = vertex_index[dot]
            vertex.id = 0
            vertex.on_stack = False
            visited.add(dot)
        missing, self.missing_deps = self.missing_deps, set()
        return visited, missing

    def strong_connect(
        self,
        first_find: bool,
        root: Dot,
        vertex_index: Dict[Dot, _Vertex],
        executed_clock: Dict[ProcessId, IntervalSet],
        added_to_executed: Set[Dot],
        scc_counter: List[int],
    ):
        """Iterative DFS mirroring tarjan.rs:99-319. Each frame is
        (vertex, next-dep-index, missing-count); abort on the first
        missing dependency unless multi-shard first-find, where missing
        deps are gathered so one request fetches them all."""

        def executed(dot: Dot) -> bool:
            clock = executed_clock.get(dot.source)
            return clock is not None and clock.contains(dot.sequence)

        root_vertex = vertex_index.get(root)
        if root_vertex is None:
            return self.NOT_PENDING, None

        frames: List[List] = []  # [vertex, dep_idx, missing_count]

        def push(vertex: _Vertex):
            self.id += 1
            vertex.id = vertex.low = self.id
            vertex.on_stack = True
            self.stack.append(vertex.dot)
            frames.append([vertex, 0, 0])

        push(root_vertex)
        while frames:
            frame = frames[-1]
            vertex, dep_idx, _missing = frame
            if dep_idx < len(vertex.deps):
                frame[1] += 1
                dep = vertex.deps[dep_idx]
                dep_dot = dep.dot
                # ignore self-deps and executed deps (tarjan.rs:131-136)
                if dep_dot == vertex.dot or executed(dep_dot):
                    continue
                dep_vertex = vertex_index.get(dep_dot)
                if dep_vertex is None:
                    if self.shard_count == 1 or not first_find:
                        # give up on the first missing dep; the stack is
                        # left for finalize (tarjan.rs:157-160)
                        return self.MISSING, {dep}
                    self.missing_deps.add(dep)
                    frame[2] += 1
                elif dep_vertex.id == 0:
                    push(dep_vertex)
                elif dep_vertex.on_stack:
                    vertex.low = min(vertex.low, dep_vertex.id)
                continue

            # all neighbours visited: maybe pop an SCC (tarjan.rs:236-318)
            frames.pop()
            if frame[2] == 0 and vertex.id == vertex.low:
                scc: List[Dot] = []
                while True:
                    member_dot = self.stack.pop()
                    member = vertex_index[member_dot]
                    member.on_stack = False
                    scc_counter[0] += 1
                    scc.append(member_dot)
                    # eagerly mark executed so later deps in this same
                    # search are pruned (tarjan.rs:274-299)
                    executed_clock.setdefault(
                        member_dot.source, IntervalSet()
                    ).add(member_dot.sequence)
                    if self.shard_count > 1:
                        added_to_executed.add(member_dot)
                    if member_dot == vertex.dot:
                        break
                scc.sort()  # SCC members execute in dot order
                self.sccs.append(scc)
                if not frames:
                    return self.FOUND, None
            else:
                if frames:
                    parent = frames[-1]
                    parent[0].low = min(parent[0].low, vertex.low)
                    parent[2] += frame[2]
                else:
                    return self.NOT_FOUND, None
        raise AssertionError("unreachable")


class GraphExecutor(Executor):
    """mod.rs:46-689 + executor.rs:19-195.

    With a single executor (the oracle simulator, and the run layer at
    executors=1) one instance plays every role.  Behind a run-layer pool
    (``pool``) the reference's executor-0-runs-the-graph split applies
    (mod.rs:54-67): member 0 handles ``Add``/``RequestReply`` and runs
    Tarjan + execution; member 1 answers cross-shard ``Request`` traffic
    from the **shared** vertex index (the reference shares it between
    clones via ``Arc<SharedMap>``, index.rs:18-30) and keeps its own
    executed-clock copy in sync via ``Executed`` notifications
    (mod.rs:199-213).  Pool members past index 1 receive no graph
    traffic at all — the reference routes every variant to index 0 or 1
    (executor.rs:234-253)."""

    def __init__(self, process_id: ProcessId, shard_id: ShardId, config: Config):
        super().__init__(process_id, shard_id, config)
        self.store = KVStore(monitor=config.executor_monitor_execution_order)
        self.executed_clock: Dict[ProcessId, IntervalSet] = {}
        self.vertex_index: Dict[Dot, _Vertex] = {}
        self.pending_index: Dict[Dot, Set[Dot]] = {}
        self.finder = _Finder(config.shard_count)
        self.to_execute: List[Command] = []
        self.out_requests: Dict[ShardId, Set[Dot]] = {}
        self.added_to_executed: Set[Dot] = set()
        self.buffered_in_requests: Dict[ShardId, Set[Dot]] = {}
        # run-layer pool role (executor.rs:53-56 set_executor_index);
        # role_split stays False at executors=1 where one instance
        # handles every variant
        self.executor_index = 0
        self.role_split = False

    @classmethod
    def pool(cls, process_id: ProcessId, shard_id: ShardId, config: Config,
             count: int):
        members = [cls(process_id, shard_id, config) for _ in range(count)]
        if count > 1:
            for i, member in enumerate(members):
                member.executor_index = i
                member.role_split = True
                if i > 0:
                    # shared vertex store: secondaries answer requests
                    # from the vertices the main executor indexes
                    member.vertex_index = members[0].vertex_index
        return members

    # -- Executor interface -------------------------------------------

    def handle(self, info, time: SysTime) -> None:
        if isinstance(info, GraphAdd):
            assert not self.role_split or self.executor_index == 0, (
                "Add routed to a secondary executor"
            )
            if self.config.execute_at_commit:
                self._execute(info.cmd)
            else:
                self._handle_add(info.dot, info.cmd, sorted(info.deps,
                                                            key=lambda d: d.dot),
                                 time)
                self._fetch_actions(time)
        elif isinstance(info, GraphRequest):
            assert not self.role_split or self.executor_index > 0, (
                "Request routed to the main executor of a pool"
            )
            self.metrics_.aggregate(ExecutorMetricsKind.IN_REQUESTS, 1)
            self._process_requests(info.from_shard, info.dots)
            self._fetch_actions(time)
        elif isinstance(info, GraphRequestReply):
            assert not self.role_split or self.executor_index == 0, (
                "RequestReply routed to a secondary executor"
            )
            self._handle_request_reply(info.infos, time)
            self._fetch_actions(time)
        elif isinstance(info, GraphExecuted):
            # only secondaries need the catch-up (mod.rs:199-213); the
            # main executor already marked these during SCC save — the
            # add below is idempotent so the combined role keeps it
            for dot in info.dots:
                self.executed_clock.setdefault(dot.source, IntervalSet()).add(
                    dot.sequence
                )
        else:
            raise TypeError(f"unexpected execution info {info!r}")

    def cleanup(self, time: SysTime) -> None:
        if self.config.shard_count > 1:
            buffered, self.buffered_in_requests = (
                self.buffered_in_requests,
                {},
            )
            for from_shard, dots in buffered.items():
                self._process_requests(from_shard, dots)
            self._fetch_actions(time)

    @staticmethod
    def parallel() -> bool:
        return True

    def monitor(self) -> Optional[ExecutionOrderMonitor]:
        return self.store.monitor

    # -- graph (mod.rs) ------------------------------------------------

    def _handle_add(self, dot, cmd, deps: List[Dependency], time) -> None:
        assert dot not in self.vertex_index, "vertex added twice"
        self.vertex_index[dot] = _Vertex(dot, cmd, deps, time.millis())
        scc_counter = [0]
        result, payload = self._find_scc(True, dot, scc_counter, time)
        if result == _Finder.MISSING:
            dots, _visited, missing = payload
            self._index_pending(dot, missing)
            self._check_pending(dots, scc_counter, time)
        elif result == _Finder.FOUND:
            self._check_pending(payload, scc_counter, time)
        else:
            raise AssertionError("just-added dot must be pending")

    def _find_scc(self, first_find: bool, dot: Dot, scc_counter, time):
        """mod.rs:411-488: run the finder, save found SCCs, finalize."""
        result, abort_missing = self.finder.strong_connect(
            first_find,
            dot,
            self.vertex_index,
            self.executed_clock,
            self.added_to_executed,
            scc_counter,
        )
        dots: List[Dot] = []
        for scc in self.finder.take_sccs():
            self._save_scc(scc, dots, time)
        visited, gathered_missing = self.finder.finalize(self.vertex_index)
        if result == _Finder.FOUND:
            return _Finder.FOUND, dots
        if result == _Finder.MISSING:
            assert not gathered_missing
            return _Finder.MISSING, (dots, visited, abort_missing)
        if result == _Finder.NOT_PENDING:
            return _Finder.NOT_PENDING, None
        # NOT_FOUND: must have gathered missing deps (mod.rs:479-486)
        assert gathered_missing
        return _Finder.MISSING, (dots, visited, gathered_missing)

    def _save_scc(self, scc: List[Dot], dots: List[Dot], time) -> None:
        self.metrics_.collect(ExecutorMetricsKind.CHAIN_SIZE, len(scc))
        for dot in scc:
            vertex = self.vertex_index.pop(dot)
            dots.append(dot)
            self.metrics_.collect(
                ExecutorMetricsKind.EXECUTION_DELAY,
                time.millis() - vertex.start_time_ms,
            )
            self.to_execute.append(vertex.cmd)

    def _index_pending(self, dot: Dot, missing: Set[Dependency]) -> None:
        """index.rs:167-205: park ``dot`` under each missing dep; on the
        first sighting of a dep not replicated here, request it from its
        target shard."""
        requests = 0
        for dep in missing:
            children = self.pending_index.get(dep.dot)
            if children is None:
                self.pending_index[dep.dot] = {dot}
                assert dep.shards is not None, "noop deps unsupported"
                if self.shard_id not in dep.shards:
                    target = dep.dot.target_shard(self.config.n)
                    self.out_requests.setdefault(target, set()).add(dep.dot)
                    requests += 1
            else:
                children.add(dot)
        if requests:
            self.metrics_.aggregate(
                ExecutorMetricsKind.OUT_REQUESTS, requests
            )

    def _check_pending(self, dots: List[Dot], scc_counter, time) -> None:
        """mod.rs:558-644: executing a dot may unblock its children."""
        while dots:
            dot = dots.pop()
            pending = self.pending_index.pop(dot, None)
            if pending is None:
                continue
            visited: Set[Dot] = set()
            for child in pending:
                if child in visited:
                    continue
                result, payload = self._find_scc(False, child, scc_counter,
                                                 time)
                if result == _Finder.FOUND:
                    visited.clear()
                    dots.extend(payload)
                elif result == _Finder.MISSING:
                    new_dots, new_visited, missing = payload
                    self._index_pending(child, missing)
                    if new_dots:
                        visited.clear()
                    else:
                        # skip children visited by this failed search
                        # (mod.rs:626-631)
                        visited |= new_visited
                    dots.extend(new_dots)
                # NOT_PENDING: child already executed

    # -- partial replication (mod.rs:279-408) --------------------------

    def _process_requests(self, from_shard: ShardId, dots) -> None:
        # batch all replies to the requesting shard into one message
        # (mod.rs out_request_replies is keyed by shard and flushed as
        # one RequestReply per shard, executor.rs:169-182)
        replies: List = []
        for dot in dots:
            vertex = self.vertex_index.get(dot)
            if vertex is not None:
                replies.append(ReplyInfo(dot, vertex.cmd, list(vertex.deps)))
            elif (
                dot.source in self.executed_clock
                and self.executed_clock[dot.source].contains(dot.sequence)
            ):
                replies.append(ReplyExecuted(dot))
            else:
                self.buffered_in_requests.setdefault(from_shard, set()).add(
                    dot
                )
        if replies:
            self.to_executors_buf.append(
                (from_shard, GraphRequestReply(replies))
            )

    def _handle_request_reply(self, infos, time) -> None:
        for info in infos:
            if isinstance(info, ReplyInfo):
                self._handle_add(info.dot, info.cmd, info.deps, time)
            else:
                assert isinstance(info, ReplyExecuted)
                dot = info.dot
                self.executed_clock.setdefault(
                    dot.source, IntervalSet()
                ).add(dot.sequence)
                self.added_to_executed.add(dot)
                scc_counter = [0]
                self._check_pending([dot], scc_counter, time)

    # -- draining ------------------------------------------------------

    def _fetch_actions(self, time) -> None:
        to_execute, self.to_execute = self.to_execute, []
        for cmd in to_execute:
            self._execute(cmd)
        if self.config.shard_count > 1:
            if self.added_to_executed:
                added, self.added_to_executed = self.added_to_executed, set()
                self.to_executors_buf.append(
                    (self.shard_id, GraphExecuted(added))
                )
            out, self.out_requests = self.out_requests, {}
            for target, dots in out.items():
                self.to_executors_buf.append(
                    (target, GraphRequest(self.shard_id, dots))
                )

    def _execute(self, cmd: Command) -> None:
        for key, ops in cmd.items(self.shard_id):
            partial = self.store.execute(key, list(ops), cmd.rifl)
            self.to_clients_buf.append(
                ExecutorResult(cmd.rifl, key, partial)
            )
