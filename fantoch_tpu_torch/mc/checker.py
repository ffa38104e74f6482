"""Bounded explicit-state exploration of protocol interleavings (the
port's copy of the JAX package's ``mc/checker.py``, over the port's host
oracle: ``protocol/``, ``executor/``, ``client/`` and ``core/``; it runs
on the host and launches no kernel).

The system under check is the reference's actor shape
(fantoch_mc/src/lib.rs:14-82): each process is an actor whose state is
its ``Protocol`` + ``Executor`` pair; the environment is a multiset of
in-flight messages plus the clients' remaining submissions. A step
delivers any pending message (or injects any pending submit) — the
network reorders arbitrarily, which subsumes the DES's random-delay
perturbation. Exploration is depth-first over delivery choices with
``deepcopy`` branch points, bounded by ``max_states``.

Checked properties (asserted at every quiescent leaf, i.e. no pending
messages and all submissions delivered):

1. **agreement** — every process records the same per-key execution
   order (the run/sim layers' ``check_monitors``);
2. **exactly-once** — each process executes each command at most once
   per key, and at quiescence exactly once;
3. **progress** — quiescence is reachable on every branch (no state
   where a command is stuck with an empty network).

Periodic events (GC, detached-vote sends) are fired at quiescence in a
fixed order until they produce no new messages, so executors drain the
same way the DES's extra_sim_time tail does.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Type

from ..client.key_gen import ConflictPool
from ..client.workload import Workload
from ..core.command import Command
from ..core.config import Config
from ..core.ids import ProcessId, RiflGen
from ..core.timing import SimTime
from ..executor.base import Executor
from ..protocol.base import Protocol, ToForward, ToSend


@dataclass
class CheckResult:
    states: int
    quiescent: int
    truncated: bool
    violation: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.violation is None


@dataclass
class _World:
    """One node of the exploration tree."""

    processes: Dict[ProcessId, Tuple[Protocol, Executor]]
    # in-flight: (to, from, from_shard, msg); list order is irrelevant —
    # every element is a branch
    network: List[Tuple[ProcessId, ProcessId, int, object]]
    # submissions not yet injected: (target process, command)
    submits: List[Tuple[ProcessId, Command]]
    depth: int = 0


class ModelChecker:
    """Explore all interleavings of a tiny workload.

    ``clients`` submit ``commands_per_client`` single-key writes to a
    conflicting key pool of size 1 — the densest possible conflict
    structure, which is where ordering bugs live.
    """

    def __init__(
        self,
        protocol_cls: Type[Protocol],
        config: Config,
        clients: int = 2,
        commands_per_client: int = 1,
        max_states: int = 200_000,
    ):
        self.protocol_cls = protocol_cls
        self.config = config.with_(
            executor_monitor_execution_order=True,
            gc_interval_ms=config.gc_interval_ms or 1000,
        )
        self.clients = clients
        self.commands_per_client = commands_per_client
        self.max_states = max_states
        self.time = SimTime()  # stays at 0: the MC has no clock

    # -- world construction -------------------------------------------

    def _initial(self) -> _World:
        n = self.config.n
        executor_cls = self.protocol_cls.EXECUTOR  # type: ignore
        processes = {}
        sorted_ids = [(pid, 0) for pid in range(1, n + 1)]
        for pid in range(1, n + 1):
            p = self.protocol_cls(pid, 0, self.config)
            rotated = [(pid, 0)] + [x for x in sorted_ids if x[0] != pid]
            ok, _ = p.discover(rotated)
            assert ok
            e = executor_cls(pid, 0, self.config)
            processes[pid] = (p, e)

        workload = Workload(
            shard_count=1,
            key_gen=ConflictPool(conflict_rate=100, pool_size=1),
            keys_per_command=1,
            commands_per_client=self.commands_per_client,
            payload_size=0,
        )
        submits = []
        for c in range(1, self.clients + 1):
            rifl_gen = RiflGen(c)
            state = workload.initial_state(c, None)
            wl = Workload(**{**workload.__dict__, "command_count": 0})
            target = 1 + (c - 1) % n  # spread clients over processes
            while True:
                nxt = wl.next_cmd(rifl_gen, state)
                if nxt is None:
                    break
                _, cmd = nxt
                submits.append((target, cmd))
        return _World(processes, [], submits)

    # -- state transitions --------------------------------------------

    def _drain(self, world: _World, pid: ProcessId) -> None:
        """Route a process's outputs into the world (the runner's
        send_to_processes_and_executors, minus time)."""
        p, e = world.processes[pid]
        while True:
            actions = p.to_processes()
            infos = p.to_executors()
            if not actions and not infos:
                break
            for info in infos:
                e.handle(info, self.time)
            for action in actions:
                if isinstance(action, ToForward):
                    p.handle(pid, 0, action.msg, self.time)
                    continue
                assert isinstance(action, ToSend)
                targets = sorted(action.target)
                for i, to in enumerate(targets):
                    msg = (
                        action.msg
                        if i == len(targets) - 1
                        else copy.deepcopy(action.msg)
                    )
                    if to == pid:
                        p.handle(pid, 0, msg, self.time)
                    else:
                        world.network.append((to, pid, 0, msg))
            # executor outputs (client results) are latency-only; drop
            e.to_clients()
            e.to_executors()

    def _deliver(self, world: _World, choice: int) -> None:
        ns = len(world.submits)
        if choice < ns:
            target, cmd = world.submits.pop(choice)
            p, _ = world.processes[target]
            p.submit(None, cmd, self.time)
            self._drain(world, target)
        else:
            to, frm, shard, msg = world.network.pop(choice - ns)
            p, _ = world.processes[to]
            p.handle(frm, shard, msg, self.time)
            self._drain(world, to)
        world.depth += 1

    def _quiesce_periodics(self, world: _World) -> None:
        """At a quiescent leaf, fire periodic events round-robin and
        deliver all resulting traffic FIFO until nothing moves — the
        extra_sim_time tail that lets executors/GC finish."""
        for _ in range(20):
            for pid, (p, e) in sorted(world.processes.items()):
                for event, _ms in p.periodic_events():
                    p.handle_event(event, self.time)
                executed = e.executed(self.time)
                if executed is not None:
                    p.handle_executed(executed, self.time)
                self._drain(world, pid)
            if not world.network:
                return
            while world.network:
                to, frm, shard, msg = world.network.pop(0)
                p, _ = world.processes[to]
                p.handle(frm, shard, msg, self.time)
                self._drain(world, to)

    # -- properties ----------------------------------------------------

    def _check_quiescent(self, world: _World) -> Optional[str]:
        total = self.clients * self.commands_per_client
        monitors = {}
        for pid, (p, e) in world.processes.items():
            m = e.monitor()
            if m is None:
                return f"process {pid}: no execution monitor"
            monitors[pid] = m
        items = sorted(monitors.items())
        pid_a, mon_a = items[0]
        orders_a = {k: mon_a.get_order(k) for k in mon_a.keys()}
        count_a = sum(len(v) for v in orders_a.values())
        if count_a != total:
            return (
                f"process {pid_a} executed {count_a} != {total} commands"
            )
        for key, order in orders_a.items():
            if len(set(order)) != len(order):
                return f"process {pid_a} key {key!r}: duplicate execution"
        for pid_b, mon_b in items[1:]:
            orders_b = {k: mon_b.get_order(k) for k in mon_b.keys()}
            if orders_a != orders_b:
                return (
                    f"execution orders diverge: {pid_a}={orders_a} "
                    f"{pid_b}={orders_b}"
                )
        return None

    # -- exploration ---------------------------------------------------

    def run(self) -> CheckResult:
        states = 0
        quiescent = 0
        truncated = False
        stack = [self._initial()]
        while stack:
            world = stack.pop()
            states += 1
            if states > self.max_states:
                truncated = True
                break
            n_choices = len(world.submits) + len(world.network)
            if n_choices == 0:
                self._quiesce_periodics(world)
                violation = self._check_quiescent(world)
                quiescent += 1
                if violation is not None:
                    return CheckResult(
                        states, quiescent, truncated, violation
                    )
                continue
            # branch on every pending delivery; reuse the original
            # world for the last branch to halve the deepcopies
            for choice in range(n_choices - 1):
                branch = copy.deepcopy(world)
                self._deliver(branch, choice)
                stack.append(branch)
            self._deliver(world, n_choices - 1)
            stack.append(world)
        return CheckResult(states, quiescent, truncated, None)
