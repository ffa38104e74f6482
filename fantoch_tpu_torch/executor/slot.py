"""Slot-ordered executor (FPaxos).

Capability parity with ``fantoch_ps/src/executor/slot.rs``: execute the
command at ``next_slot``, buffering out-of-order slots (slot.rs:17-103);
not parallel (slot.rs:76-78).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from ..core.command import Command
from ..core.config import Config
from ..core.ids import ProcessId, ShardId
from ..core.kvs import ExecutionOrderMonitor, KVStore
from ..core.timing import SysTime
from .base import Executor, ExecutorResult


@dataclass
class SlotExecutionInfo:
    slot: int
    cmd: Command


class SlotExecutor(Executor):
    def __init__(self, process_id: ProcessId, shard_id: ShardId, config: Config):
        super().__init__(process_id, shard_id, config)
        self.store = KVStore(monitor=config.executor_monitor_execution_order)
        self.next_slot = 1
        self.to_execute: Dict[int, Command] = {}

    def handle(self, info: SlotExecutionInfo, time: SysTime) -> None:
        assert info.slot >= self.next_slot
        if self.config.execute_at_commit:
            self._execute(info.cmd)
            return
        assert info.slot not in self.to_execute
        self.to_execute[info.slot] = info.cmd
        self._try_next_slot()

    def _try_next_slot(self) -> None:
        while self.next_slot in self.to_execute:
            cmd = self.to_execute.pop(self.next_slot)
            self._execute(cmd)
            self.next_slot += 1

    def _execute(self, cmd: Command) -> None:
        for key, ops in cmd.items(self.shard_id):
            partial = self.store.execute(key, ops, cmd.rifl)
            self.to_clients_buf.append(ExecutorResult(cmd.rifl, key, partial))

    @staticmethod
    def parallel() -> bool:
        return False

    def monitor(self) -> Optional[ExecutionOrderMonitor]:
        return self.store.monitor
