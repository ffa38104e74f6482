"""Execution layer of the host oracle (reference:
``fantoch/src/executor/`` and ``fantoch_ps/src/executor/``): the basic
executor (Basic), the slot executor (FPaxos), the table executor
(Tempo), the graph executor (Atlas, EPaxos) and the predecessors
executor (Caesar)."""

# the protocols import their executors' modules: load them first, so an
# import that starts here finds no module half initialized
from .. import protocol  # noqa: F401
from .base import (
    AggregatePending,
    BasicExecutionInfo,
    BasicExecutor,
    Executor,
    ExecutorMetrics,
    ExecutorMetricsKind,
    ExecutorResult,
)
from .graph import GraphAdd, GraphExecutor
from .pred import PredecessorsExecutionInfo, PredecessorsExecutor
from .slot import SlotExecutionInfo, SlotExecutor
from .table import (
    AttachedVotes,
    DetachedVotes,
    StableAtShard,
    TableExecutor,
)

__all__ = [
    "AggregatePending", "AttachedVotes", "BasicExecutionInfo",
    "BasicExecutor", "DetachedVotes", "Executor", "ExecutorMetrics",
    "ExecutorMetricsKind", "ExecutorResult", "GraphAdd", "GraphExecutor",
    "PredecessorsExecutionInfo", "PredecessorsExecutor",
    "SlotExecutionInfo", "SlotExecutor", "StableAtShard", "TableExecutor",
]
