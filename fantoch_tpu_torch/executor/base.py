"""Execution abstraction.

Capability parity with ``fantoch/src/executor/``: the ``Executor`` interface
(executor/mod.rs:27-89), per-key partial results (``ExecutorResult``,
mod.rs:160-178), client-side aggregation of partials (``AggregatePending``,
aggregate.rs:9-80), and the immediate ``BasicExecutor`` (basic.rs).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from enum import Enum
from typing import Dict, List, Optional, Tuple

from ..core.command import Command, CommandResult, CommandResultBuilder
from ..core.config import Config
from ..core.ids import ProcessId, Rifl, ShardId
from ..core.kvs import ExecutionOrderMonitor, Key, KVOp, KVOpResult, KVStore
from ..core.metrics import Metrics
from ..core.timing import SysTime


class ExecutorMetricsKind(Enum):
    """executor/mod.rs:121-146."""

    EXECUTION_DELAY = "execution_delay"
    CHAIN_SIZE = "chain_size"
    OUT_REQUESTS = "out_requests"
    IN_REQUESTS = "in_requests"
    IN_REQUEST_REPLIES = "in_request_replies"


ExecutorMetrics = Metrics


@dataclass
class ExecutorResult:
    """Per-key partial result (executor/mod.rs:160-178)."""

    rifl: Rifl
    key: Key
    partial_results: List[KVOpResult]


class Executor(ABC):
    """executor/mod.rs:27-89. ``handle`` consumes execution info produced
    by the protocol; ``to_clients`` drains per-key results;
    ``to_executors`` carries executor-to-executor traffic (partial
    replication); ``executed`` reports executed dots back to the protocol's
    GC role."""

    def __init__(self, process_id: ProcessId, shard_id: ShardId, config: Config):
        self.process_id = process_id
        self.shard_id = shard_id
        self.config = config
        self.metrics_: ExecutorMetrics = Metrics()
        self.to_clients_buf: List[ExecutorResult] = []
        self.to_executors_buf: List[Tuple[ShardId, object]] = []

    def cleanup(self, time: SysTime) -> None:
        pass

    @classmethod
    def pool(cls, process_id: ProcessId, shard_id: ShardId, config: Config,
             count: int):
        """``count`` pool members for key-hash routing (``MessageKey``,
        executor/mod.rs:148-167). Key-hash pools need per-key
        independence, so the default rejects count > 1 unless the class
        declares ``KEY_HASH_ROUTED``; executors with cross-key state
        override to share it between members (the reference shares via
        ``SharedMap``), e.g. the graph executor's
        executor-0-runs-the-graph role split over a shared vertex index
        (executor/graph/mod.rs:54-67, graph.py ``pool``)."""
        assert count == 1 or getattr(cls, "KEY_HASH_ROUTED", False), (
            f"{cls.__name__} does not support key-hash executor pools"
            " in this runtime"
        )
        return [cls(process_id, shard_id, config) for _ in range(count)]

    def monitor_pending(self, time: SysTime) -> None:
        pass

    @abstractmethod
    def handle(self, info: object, time: SysTime) -> None: ...

    def to_clients(self) -> List[ExecutorResult]:
        out, self.to_clients_buf = self.to_clients_buf, []
        return out

    def to_executors(self) -> List[Tuple[ShardId, object]]:
        out, self.to_executors_buf = self.to_executors_buf, []
        return out

    def executed(self, time: SysTime):
        """Returns committed-and-executed info for the protocol, if any."""
        return None

    @staticmethod
    def parallel() -> bool:
        return False

    def metrics(self) -> ExecutorMetrics:
        return self.metrics_

    def monitor(self) -> Optional[ExecutionOrderMonitor]:
        return None


class AggregatePending:
    """Merges per-key ``ExecutorResult`` partials into full
    ``CommandResult``s (aggregate.rs:9-80)."""

    def __init__(self, process_id: ProcessId, shard_id: ShardId):
        self.process_id = process_id
        self.shard_id = shard_id
        self.pending: Dict[Rifl, CommandResultBuilder] = {}

    def wait_for(self, cmd: Command) -> bool:
        rifl = cmd.rifl
        builder = CommandResultBuilder(rifl, cmd.key_count(self.shard_id))
        existed = rifl in self.pending
        self.pending[rifl] = builder
        return not existed

    def add_executor_result(
        self, executor_result: ExecutorResult
    ) -> Optional[CommandResult]:
        builder = self.pending.get(executor_result.rifl)
        if builder is None:
            # result for a command registered at another process; ignore
            return None
        builder.add_partial(executor_result.key, executor_result.partial_results)
        if builder.ready():
            del self.pending[executor_result.rifl]
            return builder.build()
        return None


@dataclass
class BasicExecutionInfo:
    rifl: Rifl
    key: Key
    ops: List[KVOp]


class BasicExecutor(Executor):
    """Execute ops immediately on arrival (executor/basic.rs)."""

    def __init__(self, process_id: ProcessId, shard_id: ShardId, config: Config):
        super().__init__(process_id, shard_id, config)
        self.store = KVStore(monitor=config.executor_monitor_execution_order)

    def handle(self, info: BasicExecutionInfo, time: SysTime) -> None:
        partial = self.store.execute(info.key, info.ops, info.rifl)
        self.to_clients_buf.append(
            ExecutorResult(info.rifl, info.key, partial)
        )

    # per-key independent: safe behind a key-hash executor pool
    # (MessageKey routing, executor/mod.rs:148-167)
    KEY_HASH_ROUTED = True

    @staticmethod
    def parallel() -> bool:
        return True

    def monitor(self) -> Optional[ExecutionOrderMonitor]:
        return self.store.monitor
