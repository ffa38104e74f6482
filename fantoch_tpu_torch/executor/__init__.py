"""Execution layer of the host oracle (reference:
``fantoch/src/executor/`` and ``fantoch_ps/src/executor/``): the basic
and the slot executor, the ones Basic and FPaxos use."""

from .base import (
    AggregatePending,
    BasicExecutionInfo,
    BasicExecutor,
    Executor,
    ExecutorMetrics,
    ExecutorMetricsKind,
    ExecutorResult,
)
from .slot import SlotExecutionInfo, SlotExecutor

__all__ = [
    "AggregatePending", "BasicExecutionInfo", "BasicExecutor", "Executor",
    "ExecutorMetrics", "ExecutorMetricsKind", "ExecutorResult",
    "SlotExecutionInfo", "SlotExecutor",
]
