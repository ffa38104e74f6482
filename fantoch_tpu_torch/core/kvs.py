"""In-memory key-value store.

Capability parity with ``fantoch/src/kvs.rs``: string keys/values, ops
Get/Put/Delete returning the previous value (kvs.rs:13-64), with an optional
execution-order monitor hook used by the simulator's cross-replica
linearizability check (kvs.rs:40-51; executor/monitor.rs).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .ids import Rifl

Key = str
Value = str

# op kinds
GET = "GET"
PUT = "PUT"
DELETE = "DELETE"

KVOp = Tuple  # (GET,) | (PUT, value) | (DELETE,)
KVOpResult = Optional[Value]


@dataclass
class ExecutionOrderMonitor:
    """Records, per key, the order in which commands (rifls) were executed
    (executor/monitor.rs:8-50); compared across replicas by the simulator's
    cross-replica ordering check."""

    order: Dict[Key, List[Rifl]]

    def __init__(self) -> None:
        self.order = {}

    def add(self, key: Key, rifl: Rifl) -> None:
        self.order.setdefault(key, []).append(rifl)

    def keys(self):
        return self.order.keys()

    def get_order(self, key: Key) -> List[Rifl]:
        return self.order.get(key, [])


class KVStore:
    """String-keyed store executing op lists per key (kvs.rs:30-84)."""

    def __init__(self, monitor: bool = False):
        self.store: Dict[Key, Value] = {}
        self.monitor: Optional[ExecutionOrderMonitor] = (
            ExecutionOrderMonitor() if monitor else None
        )

    def execute(self, key: Key, ops: List[KVOp], rifl: Rifl) -> List[KVOpResult]:
        if self.monitor is not None:
            self.monitor.add(key, rifl)
        results = []
        for op in ops:
            kind = op[0]
            if kind == GET:
                results.append(self.store.get(key))
            elif kind == PUT:
                results.append(self.store.get(key))
                self.store[key] = op[1]
            elif kind == DELETE:
                results.append(self.store.pop(key, None))
            else:
                raise ValueError(f"unknown op {op!r}")
        return results
