"""Simulation state: processes, executors, clients and the simulated clock.

Capability parity with ``fantoch/src/sim/simulation.rs``: holds every
process (protocol, executor, aggregate-pending) and client, delivers
messages synchronously, and exposes ``start_clients`` /
``forward_to_client`` used by the runner loop.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..client.client import Client
from ..core.command import Command, CommandResult
from ..core.ids import ClientId, ProcessId
from ..core.timing import SimTime
from ..executor.base import AggregatePending, Executor
from ..protocol.base import Protocol


class Simulation:
    def __init__(self) -> None:
        self.time = SimTime()
        self.processes: Dict[
            ProcessId, Tuple[Protocol, Executor, AggregatePending]
        ] = {}
        self.clients: Dict[ClientId, Client] = {}

    def register_process(self, process: Protocol, executor: Executor) -> None:
        process_id = process.id()
        assert process_id not in self.processes
        pending = AggregatePending(process_id, process.shard_id())
        self.processes[process_id] = (process, executor, pending)

    def register_client(self, client: Client) -> None:
        assert client.id() not in self.clients
        self.clients[client.id()] = client

    def start_clients(self) -> List[Tuple[ClientId, ProcessId, Command]]:
        out = []
        for client in self.clients.values():
            nxt = client.cmd_send(self.time)
            assert nxt is not None, "clients should submit at least one command"
            target_shard, cmd = nxt
            out.append((client.id(), client.shard_process(target_shard), cmd))
        return out

    def forward_to_client(
        self, cmd_result: CommandResult
    ) -> Optional[Tuple[ProcessId, Command]]:
        client = self.clients[cmd_result.rifl.source]
        client.cmd_recv(cmd_result.rifl, self.time)
        nxt = client.cmd_send(self.time)
        if nxt is None:
            return None
        target_shard, cmd = nxt
        return client.shard_process(target_shard), cmd

    def get_process(
        self, process_id: ProcessId
    ) -> Tuple[Protocol, Executor, AggregatePending, SimTime]:
        process, executor, pending = self.processes[process_id]
        return process, executor, pending, self.time

    def get_client(self, client_id: ClientId) -> Tuple[Client, SimTime]:
        return self.clients[client_id], self.time
