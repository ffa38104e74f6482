"""Closed-loop synthetic client.

Capability parity with ``fantoch/src/client/``: a client generates the next
workload command when the previous one completes (client/mod.rs:91-137),
tracks pending request start times (``Pending``, client/pending.rs), and
records a latency/throughput series (``ClientData``, client/data.rs).
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

from ..core.command import Command
from ..core.ids import ClientId, ProcessId, Rifl, RiflGen, ShardId
from ..core.timing import SysTime
from .workload import Workload


class Pending:
    """Pending rifl -> start time (micros) (client/pending.rs)."""

    def __init__(self) -> None:
        self._start: Dict[Rifl, int] = {}

    def start(self, rifl: Rifl, time: SysTime) -> None:
        assert rifl not in self._start
        self._start[rifl] = time.micros()

    def end(self, rifl: Rifl, time: SysTime) -> Tuple[int, int]:
        """Returns (latency_micros, end_time_micros)."""
        start = self._start.pop(rifl)
        end = time.micros()
        return end - start, end

    def is_empty(self) -> bool:
        return not self._start


class ClientData:
    """Latency (micros) and throughput series (client/data.rs)."""

    def __init__(self) -> None:
        self.latencies_us: List[int] = []
        self.end_times_ms: List[int] = []

    def record(self, latency_us: int, end_time_us: int) -> None:
        self.latencies_us.append(latency_us)
        self.end_times_ms.append(end_time_us // 1000)

    def latency_data(self) -> List[int]:
        return list(self.latencies_us)

    def throughput_data(self) -> List[Tuple[int, int]]:
        counts: Dict[int, int] = {}
        for ms in self.end_times_ms:
            counts[ms] = counts.get(ms, 0) + 1
        return sorted(counts.items())


class Client:
    """client/mod.rs:27-158."""

    def __init__(
        self,
        client_id: ClientId,
        workload: Workload,
        status_frequency: Optional[int] = None,
        rng: Optional[random.Random] = None,
    ):
        self.client_id = client_id
        self.processes: Dict[ShardId, ProcessId] = {}
        self.rifl_gen = RiflGen(client_id)
        # each client owns an independent workload instance (Copy in Rust)
        self.workload = Workload(**{**workload.__dict__, "command_count": 0})
        self.key_gen_state = workload.initial_state(client_id, rng)
        self.pending = Pending()
        self.data = ClientData()
        self.status_frequency = status_frequency

    def id(self) -> ClientId:
        return self.client_id

    def connect(self, processes: Dict[ShardId, ProcessId]) -> None:
        self.processes = processes

    def shard_process(self, shard_id: ShardId) -> ProcessId:
        return self.processes[shard_id]

    def cmd_send(self, time: SysTime) -> Optional[Tuple[ShardId, Command]]:
        nxt = self.workload.next_cmd(self.rifl_gen, self.key_gen_state)
        if nxt is None:
            return None
        target_shard, cmd = nxt
        self.pending.start(cmd.rifl, time)
        return target_shard, cmd

    def cmd_recv(self, rifl: Rifl, time: SysTime) -> None:
        latency, end_time = self.pending.end(rifl, time)
        self.data.record(latency, end_time)

    def workload_finished(self) -> bool:
        return self.workload.finished()

    def finished(self) -> bool:
        return self.workload.finished() and self.pending.is_empty()

    def issued_commands(self) -> int:
        return self.workload.issued_commands()
