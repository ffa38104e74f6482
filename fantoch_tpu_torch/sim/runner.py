"""Deterministic discrete-event simulation runner (the oracle).

Capability parity with ``fantoch/src/sim/runner.rs``: wires planet + config
+ workload into processes/executors/clients (runner.rs:64-190), runs the
event loop over submit/send/periodic actions (runner.rs:233-313), models
message delay as half the ping latency (runner.rs:575-595) with optional
symmetric distances and random reordering (×U(0,10), runner.rs:520-524),
and reports per-process protocol/executor metrics, execution-order
monitors, and per-region latency histograms (runner.rs:597-681).

This host runner advances ONE configuration at a time and is the
differential-test oracle for the batched device engine in
``fantoch_tpu_torch.engine``, which advances thousands of configurations in
lockstep, one lane a configuration.
"""

from __future__ import annotations

import copy
import random
from typing import Dict, List, Optional, Tuple, Type

from ..client.client import Client
from ..client.workload import Workload
from ..core.command import Command, CommandResult, CommandResultBuilder
from ..core.config import Config
from ..core.ids import ClientId, ProcessId, ShardId
from ..core.metrics import Histogram
from ..core.planet import Planet
from ..core.trace import trace, tracer
from ..core.util import closest_process_per_shard, sort_processes_by_distance
from ..engine.faults import FaultPlan
from ..executor.base import Executor
from ..protocol.base import Protocol, ToForward, ToSend
from .schedule import KIND_MESSAGE, Schedule
from .simulation import Simulation

# schedule action kinds
_log = tracer("sim.runner")

# sentinel crash time for processes that never crash
_NO_CRASH = 1 << 60

_SUBMIT = 0
_SEND = 1
_TO_CLIENT = 2
_PERIODIC = 3
_EXECUTED_NOTIFICATION = 4
_EXECUTOR_INFO = 5       # cross-shard executor-to-executor message
_TO_CLIENT_PARTIAL = 6   # per-key result partial (multi-shard mode)
_EXECUTOR_CLEANUP = 7    # periodic executor cleanup tick (multi-shard)

# the seeded drop/jitter tables cover channel emission indices below
# _WIRE_K0 at first and double on demand, up to the plans' own bound
_WIRE_K0 = 256
_WIRE_KMAX = 1 << 14

# client src keys rank after every process src key in same-instant
# message tie-breaks (the engine encodes clients as N + client)
_CLIENT_SRC_OFFSET = 1 << 20


def _action_process(kind: int, action) -> Optional[int]:
    """The process a scheduled action targets (None for client-bound
    actions) — the crash-stop skip's dispatch map."""
    if kind == _SEND:
        return action[3]
    if kind in (
        _SUBMIT,
        _PERIODIC,
        _EXECUTED_NOTIFICATION,
        _EXECUTOR_INFO,
        _EXECUTOR_CLEANUP,
    ):
        return action[1]
    return None


class Runner:
    def __init__(
        self,
        protocol_cls: Type[Protocol],
        planet: Planet,
        config: Config,
        workload: Workload,
        clients_per_process: int,
        process_regions: List[str],
        client_regions: List[str],
        seed: int = 0,
        fault_plan: Optional[FaultPlan] = None,
        traffic=None,
        arrivals=None,
        arrival_load: int = 100,
        arrival_gap_ms: int = 4,
        open_window: int = 4,
    ):
        assert len(process_regions) == config.n
        assert config.gc_interval_ms is not None

        # traffic-schedule mirror (traffic/schedule.py): the oracle adds
        # each command's epoch think delay to its SUBMIT's distance —
        # the bit-exact twin of the engine's `done_t + think` submit
        # base (engine/core.py step 5). Key/read-mix mirroring rides in
        # the workload's DeviceStream(traffic=...) generator; pass the
        # SAME schedule in both places for differential runs.
        self._traffic = traffic

        # open-loop arrival mirror (traffic/schedule.py ArrivalSchedule,
        # docs/TRAFFIC.md "Open-loop arrivals"): the oracle builds the
        # SAME seeded arrival table the engine ships as ctx["ol_arrival"]
        # (engine/spec.py make_lane) and replays the engine's two
        # staging triggers — at-SUBMIT-pop (trigger 1) and
        # gate-crossing-completion (trigger 2) — so command s's SUBMIT
        # reaches its attach process at exactly R(s) + d_sub on both
        # sides, with R(s) = max(A(s), F(s), R(s-1)). Latency is
        # queue-delay-inclusive: completion #k of client c records
        # t - A(c, k) into Runner-owned records (count-based
        # attribution, the engine's step-5 contract), bypassing the
        # closed-loop Client bookkeeping for reporting.
        from ..traffic.schedule import resolve_arrivals

        arrivals = resolve_arrivals(
            arrivals, mean_gap_ms=arrival_gap_ms,
            commands=workload.commands_per_client,
            load_pct=arrival_load,
        )
        self._arrivals = arrivals
        self._ol_table = None
        if arrivals is not None:
            assert config.shard_count == 1, (
                "open-loop arrivals are single-shard (make_lane asserts"
                " the same)"
            )
            assert traffic is None or all(
                p.think_ms == 0 for p in traffic.phases
            ), "open-loop lanes own the issue clock; think must be 0"
            assert open_window >= 1, open_window
            self._ol_window = int(open_window)
            self._ol_budget = int(workload.commands_per_client)
            self._ol_table = arrivals.arrival_table(
                seed=seed,
                clients=clients_per_process * len(client_regions),
                commands=workload.commands_per_client,
            )
            # per-client open-loop state (registered clients only):
            # completion count, completion times in completion order
            # (the engine's ring, unbounded host-side), the monotone
            # release clamp R(s-1), and the latency records (ms)
            self._ol_completed: Dict[int, int] = {}
            self._ol_comp_times: Dict[int, List[int]] = {}
            self._ol_last_rel: Dict[int, int] = {}
            self._ol_lat: Dict[int, List[int]] = {}

        # fault-plan mirror (engine/faults.py): the oracle applies the
        # exact crash/window/drop model the device engine applies, so
        # the differential tests extend to faulty schedules. Process
        # rows in the plan are 0-based; oracle pids are 1-based.
        if fault_plan is not None and fault_plan.is_noop():
            fault_plan = None
        self._fault = fault_plan
        self._crash_ms: Dict[int, int] = {}
        self._drop_table = None
        self._jitter_table = None
        self._wire_k = 0  # channel indices the seeded tables cover
        self._n = config.n
        self._horizon: Optional[int] = None
        doomed_pids: set = set()
        if fault_plan is not None:
            assert config.shard_count == 1, (
                "fault plans are single-shard for now"
            )
            self._crash_ms = {
                row + 1: ms for row, ms in fault_plan.crashes.items()
            }
            doomed_pids = set(self._crash_ms)
            # seeded drops and schedule jitter: the same (src, dst,
            # channel emission index)-keyed verdicts and multipliers the
            # device draws in-loop (engine/faults.py drop_draw,
            # jitter_draw)
            self._grow_wire_tables(0)
            self._horizon = fault_plan.horizon_ms

        self.planet = planet
        self.simulation = Simulation()
        self.schedule: Schedule = Schedule()
        self.process_to_region: Dict[ProcessId, str] = {}
        self.client_to_region: Dict[ClientId, str] = {}
        self.make_distances_symmetric = False
        self.reorder_messages = False
        self.rng = random.Random(seed)
        # per-(src, dst) channel emission counters for the schedule
        # tie-break key
        self._chan_seq: Dict[Tuple[int, int], int] = {}

        # the reference's sim is single-shard (runner.rs:84-85) and
        # exercises partial replication only through its TCP run-layer
        # tests (fantoch/src/run/mod.rs:575-849); here shard_count > 1
        # places one process per (shard, region) — the run_test layout —
        # with client-side result aggregation and WAN-delayed cross-
        # shard executor messages
        self.shard_count = config.shard_count
        if self.shard_count > 1:
            # only Tempo and Atlas implement the partial-replication
            # paths (partial.rs's MForwardSubmit aggregation); anything
            # else would hang waiting for the other shard's partials
            assert getattr(protocol_cls, "PARTIAL_REPLICATION", False), (
                f"{protocol_cls.__name__} does not support shard_count > 1"
            )
        from ..core.ids import process_ids

        to_discover = [
            (process_id, shard, region)
            for shard in range(self.shard_count)
            for region, process_id in zip(
                process_regions, process_ids(shard, config.n)
            )
        ]
        self.process_to_region = {
            pid: region for pid, _, region in to_discover
        }

        periodic: List[Tuple[ProcessId, object, int]] = []
        executed_notifications: List[Tuple[ProcessId, int]] = []
        # per-process closest process of each shard (discovery view) —
        # used to route cross-shard executor messages
        self._closest: Dict[ProcessId, Dict[ShardId, ProcessId]] = {}
        # multi-shard client-side aggregation (the run layer's
        # task/client/pending.rs): rifl → partial-result builder
        self._client_pending: Dict[object, object] = {}

        executor_cls = protocol_cls.EXECUTOR  # type: ignore[attr-defined]
        for process_id, shard, region in to_discover:
            process = protocol_cls(process_id, shard, config)
            for event, delay in process.periodic_events():
                periodic.append((process_id, event, delay))
            executed_notifications.append(
                (process_id, config.executor_executed_notification_interval_ms)
            )
            sorted_ = sort_processes_by_distance(
                region, planet, to_discover
            )
            # discovery keeps all same-shard processes (in distance
            # order) plus the closest process of each other shard
            seen_shards = set()
            filtered = []
            for pid, sid in sorted_:
                if sid == shard:
                    filtered.append((pid, sid))
                elif sid not in seen_shards:
                    seen_shards.add(sid)
                    filtered.append((pid, sid))
            if doomed_pids:
                # recovery-free crash model: doomed processes rank last
                # in every discovery order so quorum selection never
                # includes them — identical to the device engine's
                # sorted-index reorder (engine/faults.py)
                filtered = [
                    x for x in filtered if x[0] not in doomed_pids
                ] + [x for x in filtered if x[0] in doomed_pids]
            connect_ok, closest = process.discover(filtered)
            assert connect_ok
            self._closest[process_id] = closest
            executor = executor_cls(process_id, shard, config)
            self.simulation.register_process(process, executor)

        leader_doomed = (
            config.leader is not None and config.leader in doomed_pids
        )
        client_id = 0
        registered = 0
        for region in client_regions:
            for _ in range(clients_per_process):
                client_id += 1
                # consume the seed draw even for halted clients so the
                # surviving clients' streams match a fault-free run
                client_rng = random.Random(self.rng.randrange(2**63))
                closest = closest_process_per_shard(
                    region, planet, to_discover
                )
                # clients attached to a doomed process — or any client
                # under a doomed leader — are halted: they never issue
                # (replica death takes its clients with it; no
                # reconnection protocol, matching the device engine's
                # zeroed budgets). Ids keep counting so the surviving
                # clients' tie-break order matches the device's.
                if leader_doomed or closest.get(0) in doomed_pids:
                    continue
                client = Client(client_id, workload, rng=client_rng)
                client.connect(closest)
                self.simulation.register_client(client)
                self.client_to_region[client_id] = region
                registered += 1
        self.client_count = registered
        if self._ol_table is not None:
            for cid in self.client_to_region:
                self._ol_completed[cid] = 0
                self._ol_comp_times[cid] = []
                # R(0) seeds at the first arrival (the engine's
                # ol_last_rel init, engine/core.py init_lane_state)
                self._ol_last_rel[cid] = int(self._ol_table[cid - 1, 1])
                self._ol_lat[cid] = []

        for process_id, event, delay in periodic:
            self._schedule_periodic(process_id, event, delay)
        for process_id, delay in executed_notifications:
            self._schedule_executed_notification(process_id, delay)
        if self.shard_count > 1:
            # periodic executor cleanup retries buffered cross-shard
            # requests (the run layer's cleanup tick,
            # task/server/executor.rs:281-330); skip executors whose
            # cleanup is the base-class no-op (e.g. Tempo's table)
            for process_id in self.process_to_region:
                _, executor, _, _ = self.simulation.get_process(process_id)
                if type(executor).cleanup is Executor.cleanup:
                    continue
                self._schedule_executor_cleanup(
                    process_id, config.executor_cleanup_interval_ms
                )

    # ------------------------------------------------------------------

    def _grow_wire_tables(self, kcnt: int) -> None:
        """(Re)build the seeded wire tables to cover channel index
        ``kcnt``, doubling. Every entry is a counter-based draw of its
        own (src, dst, k), so a table is the prefix of any longer one;
        past ``_WIRE_KMAX`` the plan's own bound check fires."""
        k = max(self._wire_k * 2, _WIRE_K0)
        while k <= kcnt:
            k *= 2
        k = min(k, _WIRE_KMAX)
        if self._fault.drop_bp:
            self._drop_table = self._fault.drop_table(self._n, k)
        if self._fault.jitter_max > 1:
            self._jitter_table = self._fault.jitter_table(self._n, k)
        self._wire_k = k

    def _think_ms(self, seq: int) -> int:
        return 0 if self._traffic is None else self._traffic.think_ms(seq)

    def run(
        self, extra_sim_time_ms: Optional[int] = None
    ) -> Tuple[dict, dict, Dict[str, Tuple[int, Histogram]]]:
        if self._ol_table is not None:
            # open-loop schedules own the issue clock; the legacy
            # reorder perturbation would scale the release-pinned
            # submit distances (make_lane asserts the same)
            assert not self.reorder_messages
        for client_id, process_id, cmd in self.simulation.start_clients():
            # every first command is seq 1 (the engine arms the first
            # SUBMIT at client_delay + think(1) identically); open loop:
            # it leaves at its arrival time A(c, 1) instead
            extra = self._think_ms(1)
            if self._ol_table is not None:
                extra = int(self._ol_table[client_id - 1, 1])
            self._schedule_submit(
                ("client", client_id), process_id, cmd,
                extra_delay=extra,
            )

        self._simulation_loop(extra_sim_time_ms)

        return (
            self._metrics(),
            self._executors_monitors(),
            self._clients_latencies(),
        )

    def _simulation_loop(self, extra_sim_time_ms: Optional[int]) -> None:
        clients_done = 0
        final_time: Optional[int] = None
        time = self.simulation.time
        if self.client_count == 0:
            # every client halted by the fault plan (e.g. a doomed
            # leader): run periodics for the grace window, like the
            # device lane's immediately-done + extra_time coda
            final_time = extra_sim_time_ms or 0
        while True:
            if self._horizon is not None:
                # fault-plan horizon: never handle an event at or past
                # it (the device masks the same events out of
                # qualification)
                nt = self.schedule.peek_millis()
                if nt is None or nt >= self._horizon:
                    return
            action = self.schedule.next_action(time)
            assert action is not None, (
                "there should be a new action since stability is always"
                " running"
            )
            kind = action[0]
            if self._crash_ms:
                target = _action_process(kind, action)
                if target is not None and time.millis() >= (
                    self._crash_ms.get(target, _NO_CRASH)
                ):
                    # crash-stop: the process handles nothing at or
                    # past its crash time; its periodic events are
                    # also not rescheduled (its timers die with it)
                    continue
            if kind == _PERIODIC:
                _, process_id, event, delay = action
                self._handle_periodic(process_id, event, delay)
            elif kind == _EXECUTED_NOTIFICATION:
                _, process_id, delay = action
                self._handle_executed_notification(process_id, delay)
            elif kind == _SUBMIT:
                _, process_id, cmd = action
                self._handle_submit(process_id, cmd)
            elif kind == _SEND:
                _, from_, from_shard_id, process_id, msg = action
                self._handle_send(from_, from_shard_id, process_id, msg)
            elif kind == _EXECUTOR_INFO:
                _, process_id, info = action
                self._handle_executor_info(process_id, info)
            elif kind == _EXECUTOR_CLEANUP:
                _, process_id, delay = action
                _, executor, _, _time = self.simulation.get_process(
                    process_id
                )
                executor.cleanup(_time)
                for schedule in self._drain_executor(process_id):
                    schedule()
                self._schedule_executor_cleanup(process_id, delay)
            elif kind == _TO_CLIENT_PARTIAL:
                _, client_id, executor_result = action
                cmd_result = self._aggregate_partial(executor_result)
                if cmd_result is not None:
                    kind = _TO_CLIENT
                    action = (_TO_CLIENT, client_id, cmd_result)
            if kind == _TO_CLIENT:
                _, client_id, cmd_result = action
                if self._ol_table is not None:
                    if self._ol_to_client(client_id, cmd_result):
                        clients_done += 1
                        if clients_done == self.client_count:
                            if extra_sim_time_ms is None:
                                return
                            final_time = time.millis() + extra_sim_time_ms
                    if final_time is not None and time.millis() > final_time:
                        return
                    continue
                submit = self.simulation.forward_to_client(cmd_result)
                if submit is not None:
                    process_id, cmd = submit
                    extra = 0
                    if self._traffic is not None:
                        # the workload counter was just bumped by
                        # cmd_send, so it IS the new command's seq
                        client, _ = self.simulation.get_client(client_id)
                        extra = self._think_ms(
                            client.workload.issued_commands()
                        )
                    self._schedule_submit(
                        ("client", client_id), process_id, cmd,
                        extra_delay=extra,
                    )
                else:
                    clients_done += 1
                    if clients_done == self.client_count:
                        if extra_sim_time_ms is None:
                            return
                        final_time = time.millis() + extra_sim_time_ms
            if final_time is not None and time.millis() > final_time:
                return

    def _aggregate_partial(self, executor_result):
        """Client-side partial-result aggregation (the run layer's
        task/client/pending.rs): complete once every key across every
        shard reported."""
        builder = self._client_pending.get(executor_result.rifl)
        assert builder is not None, "partial for unregistered command"
        builder.add_partial(
            executor_result.key, executor_result.partial_results
        )
        if builder.ready():
            del self._client_pending[executor_result.rifl]
            return builder.build()
        return None

    # -- action handlers (runner.rs:315-377) ----------------------------

    def _handle_periodic(self, process_id, event, delay) -> None:
        process, _, _, time = self.simulation.get_process(process_id)
        process.handle_event(event, time)
        self._send_to_processes_and_executors(process_id)
        self._schedule_periodic(process_id, event, delay)

    def _handle_executed_notification(self, process_id, delay) -> None:
        process, executor, _, time = self.simulation.get_process(process_id)
        executed = executor.executed(time)
        if executed is not None:
            process.handle_executed(executed, time)
            self._send_to_processes_and_executors(process_id)
        self._schedule_executed_notification(process_id, delay)

    def _handle_submit(self, process_id: ProcessId, cmd: Command) -> None:
        process, _executor, pending, time = self.simulation.get_process(
            process_id
        )
        if self._ol_table is not None:
            self._ol_trigger1(cmd)
        if self.shard_count == 1:
            # process-side aggregation (runner.rs:351-362); multi-shard
            # registers client-side at submit-schedule time instead
            pending.wait_for(cmd)
        process.submit(None, cmd, time)
        self._send_to_processes_and_executors(process_id)

    # -- open-loop arrival staging (docs/TRAFFIC.md) --------------------

    def _ol_arrival_ms(self, client_id: int, seq: int) -> int:
        """A(c, seq) from the shared seeded table (seqs 1-based; the
        last column extends, mirroring the engine's clamped gather)."""
        row = self._ol_table[client_id - 1]
        return int(row[min(seq, len(row) - 1)])

    def _ol_trigger1(self, cmd: Command) -> None:
        """Trigger 1 — staging at SUBMIT pop (engine/core.py step 4):
        popping client c's latest SUBMIT s stages command q = s+1 at
        release R(q) = max(A(q), F(q), R(s)) when the in-flight window
        already admits it; window-full commands wait for trigger 2."""
        client_id = cmd.rifl.source
        seq = cmd.rifl.sequence
        client, time = self.simulation.get_client(client_id)
        if seq != client.issued_commands():
            return  # an older command's SUBMIT; q was already staged
        q = seq + 1
        if q > self._ol_budget:
            return
        done = self._ol_completed[client_id]
        if done + self._ol_window < q:
            return  # window full: the gate-crossing completion stages q
        # F(q): completion time of command q - W (0 before W completions)
        f_gate = (
            self._ol_comp_times[client_id][q - self._ol_window - 1]
            if q > self._ol_window
            else 0
        )
        rel = max(
            self._ol_arrival_ms(client_id, q),
            f_gate,
            self._ol_last_rel[client_id],
        )
        self._ol_stage(client_id, rel)

    def _ol_to_client(self, client_id: int, cmd_result) -> bool:
        """Open-loop TO_CLIENT: count-based completion accounting plus
        trigger 2 (engine/core.py step 5). Returns True when this
        completion finishes the client's budget. Latency is
        queue-delay-inclusive — t - A(c, k) for completion #k — and
        lands in Runner-owned records; the closed-loop auto-resubmit
        (forward_to_client) is bypassed."""
        client, time = self.simulation.get_client(client_id)
        client.cmd_recv(cmd_result.rifl, time)
        t = time.millis()
        k = self._ol_completed[client_id] + 1
        self._ol_completed[client_id] = k
        self._ol_comp_times[client_id].append(t)
        self._ol_lat[client_id].append(
            t - self._ol_arrival_ms(client_id, k)
        )
        # trigger 2 — gate-crossing completion: command pend = issued+1
        # was window-blocked at its predecessor's SUBMIT pop and this
        # completion just admitted it (gate crosses exactly once, at
        # #(pend - W)); F(pend) = t by construction
        pend = client.issued_commands() + 1
        if (
            pend <= self._ol_budget
            and k + self._ol_window >= pend
            and not ((k - 1) + self._ol_window >= pend)
        ):
            rel = max(
                self._ol_arrival_ms(client_id, pend),
                t,
                self._ol_last_rel[client_id],
            )
            self._ol_stage(client_id, rel)
        return k == self._ol_budget

    def _ol_stage(self, client_id: int, rel: int) -> None:
        """Issue the client's next command with its SUBMIT pinned to
        arrive at the attach process at rel + d_sub — the engine's
        delay-override emission row. ``extra_delay`` may be negative
        (rel can precede now by up to d_sub on trigger 1); the total
        scheduled distance rel - R(s) stays >= 0 because releases are
        monotone."""
        client, time = self.simulation.get_client(client_id)
        nxt = client.cmd_send(time)
        assert nxt is not None, "staged past the command budget"
        target_shard, cmd = nxt
        self._ol_last_rel[client_id] = rel
        self._schedule_submit(
            ("client", client_id),
            client.shard_process(target_shard),
            cmd,
            extra_delay=rel - time.millis(),
        )

    def _handle_send(self, from_, from_shard_id, process_id, msg) -> None:
        process, _, _, time = self.simulation.get_process(process_id)
        trace(
            _log, "t=%s p%s <- p%s: %s",
            time.millis(), process_id, from_, msg,
        )
        process.handle(from_, from_shard_id, msg, time)
        self._send_to_processes_and_executors(process_id)

    def _handle_executor_info(self, process_id, info) -> None:
        """Cross-shard executor message delivery (the run layer's
        executor-to-executor channel, graph/mod.rs:279-330)."""
        _, executor, _, time = self.simulation.get_process(process_id)
        executor.handle(info, time)
        for schedule in self._drain_executor(process_id):
            schedule()

    def _drain_executor(self, process_id: ProcessId):
        """Deliver an executor's pending outputs: same-shard infos
        inline, cross-shard infos and client results as *deferred*
        schedule thunks — the caller flushes them after protocol
        actions, preserving runner.rs:395-441's scheduling order."""
        process, executor, pending, time = self.simulation.get_process(
            process_id
        )
        shard_id = process.shard_id()
        deferred = []
        while True:
            infos = executor.to_executors()
            results = executor.to_clients()
            if not infos and not results:
                break
            for to_shard, info in infos:
                if to_shard == shard_id:
                    executor.handle(info, time)
                else:
                    target = self._closest[process_id][to_shard]
                    deferred.append(
                        lambda t=target, i=info: self._schedule_message(
                            ("process", process_id),
                            ("process", t),
                            (_EXECUTOR_INFO, t, i),
                        )
                    )
            for executor_result in results:
                if self.shard_count == 1:
                    cmd_result = pending.add_executor_result(executor_result)
                    if cmd_result is not None:
                        deferred.append(
                            lambda r=cmd_result: self._schedule_to_client(
                                ("process", process_id), r
                            )
                        )
                else:
                    # only the client's connected process of this shard
                    # reports (run/prelude.rs:35-40 registration)
                    client_id = executor_result.rifl.source
                    client, _ = self.simulation.get_client(client_id)
                    if client.shard_process(shard_id) == process_id:
                        deferred.append(
                            lambda c=client_id, er=executor_result:
                            self._schedule_message(
                                ("process", process_id),
                                ("client", c),
                                (_TO_CLIENT_PARTIAL, c, er),
                            )
                        )
        return deferred

    def _send_to_processes_and_executors(self, process_id: ProcessId) -> None:
        """runner.rs:395-441."""
        process, executor, pending, time = self.simulation.get_process(
            process_id
        )
        shard_id = process.shard_id()

        protocol_actions = process.to_processes()

        deferred = []
        for info in process.to_executors():
            executor.handle(info, time)
            deferred.extend(self._drain_executor(process_id))

        self._schedule_protocol_actions(
            process_id, shard_id, ("process", process_id), protocol_actions
        )
        # client results and cross-shard infos schedule after protocol
        # actions (runner.rs:421-440)
        for schedule in deferred:
            schedule()

    def _schedule_protocol_actions(
        self, process_id, shard_id, from_region, actions
    ) -> None:
        """runner.rs:444-488; self-messages and ToForward are delivered
        immediately (recursively)."""
        for action in actions:
            if isinstance(action, ToSend):
                # targets before the last get their own copy of the
                # message, the last gets the original — the reference
                # clones n-1 times and moves (runner.rs:455-471); copies
                # matter because handlers mutate message contents (e.g.
                # Tempo consumes votes out of MCommit)
                targets = list(action.target)
                for i, to in enumerate(targets):
                    msg = (
                        action.msg
                        if i == len(targets) - 1
                        else copy.deepcopy(action.msg)
                    )
                    if to == process_id:
                        self._handle_send(
                            process_id, shard_id, process_id, msg
                        )
                    else:
                        self._schedule_message(
                            from_region,
                            ("process", to),
                            (_SEND, process_id, shard_id, to, msg),
                        )
            elif isinstance(action, ToForward):
                self._handle_send(process_id, shard_id, process_id, action.msg)
            else:
                raise TypeError(f"unsupported action {action!r}")

    # -- scheduling (runner.rs:379-557) ---------------------------------

    def _schedule_submit(self, from_region, process_id, cmd,
                         extra_delay: int = 0) -> None:
        if self.shard_count > 1:
            # client-side aggregation registers before the submit leaves
            # (client_server_task Register, run/task/server/client.rs)
            self._client_pending[cmd.rifl] = CommandResultBuilder(
                cmd.rifl, cmd.total_key_count()
            )
        self._schedule_message(
            from_region, ("process", process_id),
            (_SUBMIT, process_id, cmd), extra_delay=extra_delay,
        )

    def _schedule_to_client(self, from_region, cmd_result) -> None:
        client_id = cmd_result.rifl.source
        self._schedule_message(
            from_region,
            ("client", client_id),
            (_TO_CLIENT, client_id, cmd_result),
        )

    def _schedule_message(self, from_region, to_region, action,
                          extra_delay: int = 0) -> None:
        from_ = self._compute_region(from_region)
        to = self._compute_region(to_region)
        distance = self._distance(from_, to)
        if self.reorder_messages:
            distance = int(distance * self.rng.uniform(0.0, 10.0))
        # traffic think delay (submits only): added AFTER the reorder
        # scaling, exactly like the engine adds think to the submit's
        # unscaled base time rather than to its wire delay
        distance += extra_delay
        # tie-break key: (message, src, emission index on the (src, dst)
        # channel), src-major — the same total order the device engine
        # computes without a global heap. The counter is per channel so
        # its values are only ever compared between messages both sides
        # enumerate in the same order (FIFO per channel), whatever the
        # global interleaving of handler invocations looks like.
        src_key = self._region_key(from_region)
        chan = (src_key, self._region_key(to_region))
        chan_seq = self._chan_seq.get(chan, 0) + 1
        self._chan_seq[chan] = chan_seq
        if (
            self._fault is not None
            and from_region[0] == "process"
            and to_region[0] == "process"
            and from_region[1] != to_region[1]
        ):
            # fault wire model, after the channel counter ticked: lost
            # messages keep their emission index, exactly like the
            # device's emission choke point (engine/faults.py)
            if chan_seq >= self._wire_k and self._wire_k < _WIRE_KMAX:
                self._grow_wire_tables(chan_seq)
            distance, lost = self._fault.wire(
                from_region[1] - 1,
                to_region[1] - 1,
                self.simulation.time.millis(),
                distance,
                chan_seq,
                self._drop_table,
                self._jitter_table,
            )
            if lost:
                return
        self.schedule.schedule(
            self.simulation.time,
            distance,
            action,
            key=(KIND_MESSAGE, src_key, chan_seq),
        )

    @staticmethod
    def _region_key(message_region) -> int:
        kind, ident = message_region
        return ident if kind == "process" else _CLIENT_SRC_OFFSET + ident

    def _schedule_periodic(self, process_id, event, delay) -> None:
        self.schedule.schedule(
            self.simulation.time, delay, (_PERIODIC, process_id, event, delay)
        )

    def _schedule_executor_cleanup(self, process_id, delay) -> None:
        self.schedule.schedule(
            self.simulation.time,
            delay,
            (_EXECUTOR_CLEANUP, process_id, delay),
        )

    def _schedule_executed_notification(self, process_id, delay) -> None:
        self.schedule.schedule(
            self.simulation.time,
            delay,
            (_EXECUTED_NOTIFICATION, process_id, delay),
        )

    def _compute_region(self, message_region) -> str:
        kind, id_ = message_region
        if kind == "process":
            return self.process_to_region[id_]
        return self.client_to_region[id_]

    def _distance(self, from_: str, to: str) -> int:
        """Half the ping latency (runner.rs:575-595)."""
        from_to = self.planet.ping_latency(from_, to)
        assert from_to is not None
        if self.make_distances_symmetric:
            to_from = self.planet.ping_latency(to, from_)
            assert to_from is not None
            ping = (from_to + to_from) // 2
        else:
            ping = from_to
        return ping // 2

    # -- outputs (runner.rs:597-681) ------------------------------------

    def _metrics(self) -> dict:
        out = {}
        for process_id in self.process_to_region:
            process, executor, _, _ = self.simulation.get_process(process_id)
            out[process_id] = (process.metrics(), executor.metrics())
        return out

    def _executors_monitors(self) -> dict:
        out = {}
        for process_id in self.process_to_region:
            _, executor, _, _ = self.simulation.get_process(process_id)
            out[process_id] = executor.monitor()
        return out

    def _clients_latencies(self) -> Dict[str, Tuple[int, Histogram]]:
        out: Dict[str, Tuple[int, Histogram]] = {}
        for client_id, region in self.client_to_region.items():
            client, _ = self.simulation.get_client(client_id)
            issued, histogram = out.get(region, (0, Histogram()))
            issued += client.issued_commands()
            if self._ol_table is not None:
                # open loop: queue-delay-inclusive ms records owned by
                # the runner (see _ol_to_client) — the Client-side
                # submit-to-response data would omit the arrival wait
                for latency_ms in self._ol_lat[client_id]:
                    histogram.increment(latency_ms)
            else:
                for latency_us in client.data.latency_data():
                    histogram.increment(latency_us // 1000)
            out[region] = (issued, histogram)
        return out
