"""The batched device event loop, in PyTorch over an explicit lane axis.

A conservative-lookahead parallel DES, step for step the reference's
(``fantoch_tpu/engine/core.py``):

  1. every process p finds its earliest local event time e_p and
     qualifies whenever e_p < min_q(e_q + lookahead[q, p]) or e_p is the
     lane-wide minimum;
  2. each qualifying process pops its earliest message (prio
     self-messages first, then the lowest (src, channel emission index)
     key) — 1 and 2 are the ``qualify_pop`` kernel;
  3. the protocol's readiness gate, periodic timers and handlers run,
     each process at its event time (``protocol.handlers``: the
     ``basic_handle``, ``fpaxos_handle``, ``tempo_handle`` or
     ``graphdep_handle`` kernel);
  4. emissions are flattened; TO_CLIENT messages are rewritten into the
     client's next SUBMIT (closed loop, after a traffic schedule's think
     delay; open-loop clients also stage a SUBMIT when one pops and the
     window admits the next), latency is recorded, channel
     counters advance, and the fault plan's wire faults (link windows,
     jitter, drops) and the reorder draws apply; with the termination
     bookkeeping this is the ``emit_rewrite`` kernel;
  5. the delivered emissions land in free pool slots (``land_emissions``
     kernel).

The batch's fault flags and the reorder switch are fixed for a run, as
they are trace-time in the reference: they reach K1, K6 and K2 as one
integer (``faults.flag_bits``; every kernel's run predicate reads its
horizon bit through the step's ``Cap``), and each fault branch runs
only under its flag, so a fault-free batch runs exactly the fault-free
step.

``monitor_keys > 0`` runs the safety monitors (``engine/monitor.py``):
the lane state gains the monitor planes, the handler kernels record
every execution at their executor's choke point, K6 folds the guard
bits into the lane's violation word under ``FLAG_MONITOR`` (a monitored
step is still four launches), and the ``mon_finalize`` kernel reduces
the planes once per batch when the run loop ends. At 0 the state tree,
the launches and the results are an unmonitored run's.

State and ctx are dicts of tensors with a leading ``[L]`` lane axis.
As under the reference's vmapped ``lax.while_loop``, a lane whose
predicate is false (or whose step count reached the segment's limit) is
frozen (it keeps its state), so a finished lane is a fixed point. Here
that select is a contract of the step's kernels, not a kernel: under
its cap (:func:`frozen_step` hands every kernel the step's ``Cap``;
without one every lane runs) a step writes every plane of a frozen lane
as it was, and the ``land_emissions`` kernel reports the predicate as
``running`` (``kernels/lane_freeze.py``).

A step consumes its input state, like a donated buffer in JAX: the
``land_emissions`` kernel writes the pool, every protocol's handler
(Basic, FPaxos, Tempo, Atlas/EPaxos, Caesar, Tempo partial and Atlas
partial) its process state (with the monitor planes), and the
``emit_rewrite`` kernel the
clients, metrics, channel counts and timers, in place, on the lanes
whose predicate holds at the step's start, and return the very
tensors; the ``[L]`` lane words, the clock and, under the crash flag,
the masked timers are written out of place, a frozen lane's rows as
they were. The ``qualify_pop`` and ``emit_rewrite`` kernels read
nothing of a frozen lane's pool or outboxes and give it defined
outputs. No runner consumes its caller's state: each clones
it once, at entry. The runners (the reference's
``build_runner``, ``build_segment_runner``, ``build_window_runner`` and
``finish_segmented``) run the loop on the device: on the card one window
of W segments is one launch of a CUDA graph whose while node repeats a
captured body of :data:`STEPS_PER_BODY` steps until the ``loop_ctl``
kernel finds no lane active (``kernels/step_loop.py``); on the CPU its
twin runs the same control on the host. :func:`build_eager_runner` is
the host loop of wrapper calls, named, for callers that hold each call
of a kernel against its twin.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from ..kernels.emit_rewrite import emit_rewrite
from ..kernels.land_emissions import land_emissions
from ..kernels.lane_freeze import Cap
from ..kernels.loop_ctl import CTL_ALIVE, CTL_MAXS, CTL_W, loop_ctl, new_ctl
from ..kernels.mon_finalize import mon_finalize
from ..kernels.qualify_pop import qualify_pop
from ..kernels.step_loop import (
    STEPS_PER_BODY, DeviceLoop, HostLoop, clone_tree, device_loop, link,
    live_planes, tree_device, tree_signature,
)
from . import monitor
from .dims import (
    ERR_TRUNCATED, INF, PA, PDST, PKC, PKS, PMT, POOL_FIELDS, PPAY, PSRC,
    EngineDims,
)
from .faults import NO_FAULTS, FaultFlags, flag_bits

I32 = torch.int32

# per-client latency-log depth (debugging aid for differential tests)
LAT_LOG = 64

# handled-message log depth of the reference (always off here: its state
# plane keeps the reference's [N, 1, 6] shape)
DEBUG_LOG = 0


# ----------------------------------------------------------------------
# outbox helpers (used by protocol handler modules); every tensor has the
# batch's leading axes ``lead`` (``[L, N]`` in the handlers)
# ----------------------------------------------------------------------

def empty_outbox(dims: EngineDims, lead, device, slots: int | None = None):
    f = dims.F if slots is None else slots
    shape = tuple(lead) + (f,)
    return {
        "valid": torch.zeros(shape, dtype=torch.bool, device=device),
        "dst": torch.zeros(shape, dtype=I32, device=device),
        "mtype": torch.zeros(shape, dtype=I32, device=device),
        "payload": torch.zeros(shape + (dims.P,), dtype=I32, device=device),
        # -1 = engine-assigned WAN delay; >= 0 overrides it (requeues)
        "delay": torch.full(shape, -1, dtype=I32, device=device),
        # -1 = the emitting process; >= 0 preserves an original sender
        "src": torch.full(shape, -1, dtype=I32, device=device),
    }


def write_running(ps, step, cap, dims: EngineDims):
    """The in-place contract of a handler twin (every handler, K4, K5,
    K8, K9, K10, K11 and K12) from its
    out-of-place step ``step = (rdy, new state, periodic outbox, handler
    outbox)``: the running lanes' rows (of ``cap``; every lane without
    one) of the new state are copied into ``ps``, in place, as the
    kernel writes them; returns ``(rdy, ps, pout, hout)`` with a frozen
    lane's ``rdy`` false and its outboxes empty (valid false, zero
    words)."""
    from ..kernels.lane_freeze import cap_running

    rdy, new, pout, hout = step
    running = cap_running(cap)
    for k, v in new.items():
        if v is ps[k]:
            continue
        if running is None:
            ps[k].copy_(v)
        else:  # a select, not a masked index: no sync with the card
            lead = running.reshape((-1,) + (1,) * (v.dim() - 1))
            ps[k].copy_(torch.where(lead, v, ps[k]))
    if running is None:
        return rdy, ps, pout, hout
    empty = empty_outbox(dims, rdy.shape, rdy.device)
    pout, hout = (
        {k: torch.where(
            running.reshape((-1,) + (1,) * (v.dim() - 1)), v, empty[k])
         for k, v in ob.items()}
        for ob in (pout, hout))
    return rdy & running[:, None], ps, pout, hout


def emit(outbox, i: int, dst, mtype, words, valid):
    """Write one message into outbox slot ``i`` of every row (functional):
    ``words`` ``[*lead, k]`` fill the first k payload words."""
    ob = {k: v.clone() for k, v in outbox.items()}
    ob["valid"][..., i] = valid
    ob["dst"][..., i] = dst
    ob["mtype"][..., i] = mtype
    ob["payload"][..., i, :] = 0
    ob["payload"][..., i, : words.shape[-1]] = words
    ob["delay"][..., i] = -1
    ob["src"][..., i] = -1
    return ob


def emit_broadcast(outbox, mtype, words, n, me=None, exclude_me=False,
                   base=None):
    """Fill every slot f with a message to process ``base + f``, valid
    for f < n (the reference's ``ToSend{target: all()}``;
    ``all_but_me()`` with ``exclude_me``; ``base`` > 0 targets one
    shard's block of process rows). ``n`` is ``[L]`` (or the outbox's
    first leading axis), ``me``, ``base`` and ``words`` carry the
    outbox's leading axes (``words`` ``[*lead, k]``)."""
    valid = outbox["valid"]
    f = valid.shape[-1]
    slots = torch.arange(f, dtype=I32, device=valid.device)
    ok = slots < n.reshape(n.shape + (1,) * (valid.dim() - 1))
    ok = ok.expand(valid.shape)
    procs = slots if base is None else slots + base[..., None]
    if exclude_me:
        ok = ok & (procs != me[..., None])
    payload = torch.zeros_like(outbox["payload"])
    payload[..., : words.shape[-1]] = words[..., None, :]
    return {
        "valid": ok,
        "dst": procs.expand(valid.shape).clone(),
        "mtype": torch.full_like(outbox["dst"], mtype),
        "payload": payload,
        "delay": torch.full_like(outbox["dst"], -1),
        "src": torch.full_like(outbox["dst"], -1),
    }


# ----------------------------------------------------------------------
# lane state
# ----------------------------------------------------------------------

def init_lane_state(protocol, dims: EngineDims, ctx_np: Dict[str, np.ndarray],
                    first_keys: np.ndarray, monitor_keys: int = 0):
    """One lane's initial state (numpy, host side): every live client's
    first SUBMIT in the pool (runner.rs:211-220) and the periodic timers
    armed at t = interval. ``first_keys`` ([C]) are the clients' first
    command keys (column 1 of the lane's key table). ``monitor_keys >
    0`` adds the safety monitors' planes with that key capacity; it must
    match the runner's."""
    N, C, M, P, R = dims.N, dims.C, dims.M, dims.P, dims.R
    pool = np.zeros((M, POOL_FIELDS + P), np.int32)
    pool[:, PA] = INF
    budget = ctx_np["cmd_budget"]
    if "cmd_target" in ctx_np:
        # partial replication: each client's first SUBMIT goes to its
        # connected process of the first command's target shard
        attach = ctx_np["client_attach_s"][
            np.arange(C), ctx_np["cmd_target"][:, 1]
        ]
    else:
        attach = ctx_np["client_attach"]
    live = budget > 0
    assert live.sum() <= M, "pool must hold the initial submit wave"
    # a traffic schedule's first SUBMIT leaves after the first command's
    # epoch think delay; an open-loop client's at its first arrival
    if "traffic_think" in ctx_np:
        think0 = int(
            ctx_np["traffic_think"][int(ctx_np["traffic_seq_epoch"][1])]
        )
    else:
        think0 = 0
    open_loop = "ol_arrival" in ctx_np
    slot = 0
    for c in range(C):
        if not live[c]:
            continue
        release0 = int(ctx_np["ol_arrival"][c, 1]) if open_loop else think0
        pool[slot, PA] = ctx_np["client_delay"][c, attach[c]] + release0
        # each client's first SUBMIT is emission #1 on its channel
        pool[slot, PKS] = N + c
        pool[slot, PKC] = 1
        pool[slot, PSRC] = N + c
        pool[slot, PDST] = attach[c]
        pool[slot, PMT] = protocol.SUBMIT
        pool[slot, PPAY + 0] = c
        pool[slot, PPAY + 1] = 1
        pool[slot, PPAY + 2] = first_keys[c]
        slot += 1

    intervals = ctx_np["periodic_intervals"]
    next_periodic = np.broadcast_to(
        np.where(intervals >= INF, INF, intervals), (N, R)
    ).astype(np.int32).copy()
    # timers run only on live process rows (every shard's rows)
    next_periodic[int(ctx_np["rows"]):, :] = INF
    mon = monitor.mon_init(dims, monitor_keys) if monitor_keys else {}
    clients = {
        "issued": live.astype(np.int32),
        "completed": np.zeros((C,), np.int32),
        "start_time": np.zeros((C,), np.int32),
        "parts": np.zeros((C,), np.int32),
        "part_max": np.zeros((C,), np.int32),
    }
    if open_loop:
        # the ring of the last W completion times (completion #k at slot
        # (k - 1) mod W) and the monotone release clamp, seeded at the
        # first arrival
        clients["ol_comp_t"] = np.zeros(
            (C, int(ctx_np["ol_window"])), np.int32
        )
        clients["ol_last_rel"] = ctx_np["ol_arrival"][:, 1].astype(np.int32)
    return {
        **mon,
        "pool": pool,
        "ps": protocol.init_state(dims, ctx_np),
        "next_periodic": next_periodic,
        "clients": clients,
        "metrics": {
            "hist": np.zeros((dims.RR, dims.H), np.int32),
            "lat_sum": np.zeros((dims.RR,), np.int32),
            "lat_count": np.zeros((dims.RR,), np.int32),
            "lat_log": np.full((C, LAT_LOG), -1, np.int32),
        },
        "now": np.int32(0),
        "pair_cnt": np.zeros((N, N), np.int32),
        "steps": np.int32(0),
        "pool_peak": np.int32(int(live.sum())),
        "fault_dropped": np.int32(0),
        "requeues": np.int32(0),
        "max_completion": np.int32(0),
        "done_time": np.int32(INF),
        "err": np.zeros((), np.int32),
        "hlog": np.full((N, max(DEBUG_LOG, 1), 6), -1, np.int32),
        "hlog_n": np.zeros((N,), np.int32),
    }


# ----------------------------------------------------------------------
# the step
# ----------------------------------------------------------------------

def lane_step(protocol, dims: EngineDims, st, ctx, reorder: bool = False,
              faults: FaultFlags = NO_FAULTS, monitor_keys: int = 0,
              cap: "Cap | None" = None):
    """One engine step of every lane under the batch's ``faults`` flags
    and ``reorder`` switch; ``monitor_keys > 0`` on a state built with the
    monitor planes. Open-loop lanes (ctx ``ol_arrival``) and traffic
    schedules (ctx ``traffic_think``) set their flag bits. The step
    consumes ``st``: the pool (K2), the process state of every protocol
    (K4, K5, K8, K9, K10, K11, K12) and the clients, metrics, channel
    counts and timers (K6) are updated in place, on the lanes ``cap``
    lets run (every lane without one); every plane it writes out of
    place keeps a lane ``cap`` freezes as it was, so the new state of a
    frozen lane is its old one. Returns the new state
    (:func:`frozen_step` also returns K2's ``running``)."""
    return _step(protocol, dims, st, ctx, reorder, faults, monitor_keys,
                 cap)[0]


def _step(protocol, dims: EngineDims, st, ctx, reorder: bool,
          faults: FaultFlags, monitor_keys: int, cap):
    """:func:`lane_step` and K2's ``running``: ``(state, running)``."""
    pool = st["pool"]
    flags = flag_bits(faults, reorder, monitor=monitor_keys > 0,
                      open_loop="ol_arrival" in ctx,
                      think="traffic_think" in ctx)

    # 0-2. the crash cut-off, qualification, the horizon and the pop
    # (kernel K1); the crash-masked arrivals and timers are written back
    arrival, ep, now, _active, fire, slot, has, rows, timers = qualify_pop(
        pool, st["next_periodic"], ctx["lookahead"], ctx["fault_crash_t"],
        ctx["fault_horizon"], flags, cap,
    )

    # 3. readiness gate, periodic timers and handlers, each process at
    # its event time ep (protocol kernel); the monitor planes ride in ps
    ps_in = monitor.merge_mon(st) if monitor_keys else st["ps"]
    rdy, ps, pout, outbox = protocol.handlers(
        ps_in, has, rows, fire, ep, ctx, dims, cap
    )
    mon = {}
    if monitor_keys:
        ps, mon = monitor.strip_mon(ps)

    # 4-5 and 7. the emission tail, the wire faults, the termination
    # bookkeeping and the monitors' step fold (kernel K6), the clients,
    # metrics, channel counts and timers in place; fired timers re-arm
    # from the masked ones (under the crash flag K1's copy, which holds
    # a frozen lane's timers as they were)
    st_in = st if timers is st["next_periodic"] else dict(
        st, next_periodic=timers)
    new_rows, deliver, upd = emit_rewrite(
        st_in, ctx, ep, fire, has, rdy, rows, pout, outbox,
        protocol.error(ps), dims, protocol.SUBMIT, flags,
        mon.get("mon_flags"), cap,
    )

    # 6. land the delivered emissions in free pool slots, in place
    # (kernel K2), which also raises ERR_POOL on overflow and reports
    # the run predicate
    new_pool, _overflow, pool_peak, err, running = land_emissions(
        pool, arrival, deliver, new_rows, st["pool_peak"], upd["err"], slot,
        has, flags, cap
    )
    out = {
        **mon,
        **upd,
        "pool": new_pool,
        "ps": ps,
        "now": now,
        "pool_peak": pool_peak,
        "hlog": st["hlog"],
        "hlog_n": st["hlog_n"],
        "err": err,
    }
    if monitor_keys:
        # the digest is derived once, at the run's end (mon_finalize)
        out["cov"] = st["cov"]
    return out, running


def frozen_step(protocol, dims: EngineDims, st, ctx, lim,
                reorder: bool = False, faults: FaultFlags = NO_FAULTS,
                monitor_keys: int = 0):
    """One step of the run loop: ``(state, running)``. The lanes whose
    predicate is false on ``st``, or whose step count reached ``lim``
    (an int, or on the card the device loop's limit word), keep their
    state, as under the reference's vmapped ``lax.while_loop``: the step
    runs under that ``Cap``, so every kernel writes a frozen lane's
    planes as they were, and ``running`` is the predicate as K2 (the
    step's last kernel) evaluated it. The step consumes ``st``."""
    cap = Cap(st, ctx, lim, flag_bits(faults, reorder))
    return _step(protocol, dims, st, ctx, reorder, faults, monitor_keys,
                 cap)


def check_monitorable(protocol, monitor_keys: int) -> None:
    """Refuse monitors on a protocol without ``mon_exec`` hooks with the
    reference's error and message (``_check_monitorable``), also under
    ``python -O``."""
    if monitor_keys and not getattr(protocol, "MONITORED", False):
        name = (protocol.__name__ if isinstance(protocol, type)
                else type(protocol).__name__)
        raise AssertionError(
            f"{name} has no monitor hooks (mon_exec at its executor choke "
            "point); fuzzing it would report every lane as "
            "missing-execution"
        )


class WindowRunner:
    """``runner(state, ctx, untils) -> (state, any_alive)``: the batch
    through one window, the ladder ``untils`` of segment ends (ints, at
    least one; values past ``max_steps`` clamp to it), as the
    reference's ``build_window_runner`` runner. ``any_alive`` is the
    window's liveness word (int32 ``[1]`` on the state's device): the
    last segment's any(running). On the card the state returned is the
    device loop's resident buffers, which the next window overwrites (as
    a donated state is consumed); passing them back skips the copy in.
    ``loop`` is the loop of the last call and ``made`` whether that call
    captured it; ``it_start`` the loop's body counter before this
    runner's first call, ``captures`` how many loops its calls captured
    and ``capture_s`` the seconds those took (capture, warm-up and
    instantiate).

    ``step(st, ctx, lim) -> st`` is one step of the run loop under the
    flag word ``flags``; ``key`` names it among the cached device loops
    (with the body length and the trees' layouts)."""

    def __init__(self, key, step, flags: int, max_steps, steps_per_body):
        self.key, self.step, self.flags = key, step, int(flags)
        self.max_steps, self.steps_per_body = max_steps, steps_per_body
        self.loop, self.made, self._host = None, False, None
        self.it_start, self.captures, self.capture_s = None, 0, 0.0

    def __call__(self, state, ctx, untils):
        untils = [int(u) for u in np.asarray(untils).reshape(-1)]
        if tree_device(state).type == "cpu":
            if self._host is None:
                self._host = HostLoop(self.step, self.steps_per_body or 1,
                                      self.flags)
            self.loop, self.made = self._host, False
            if self.it_start is None:
                self.it_start = self.loop.iterations()
            return self._host.run(state, ctx, untils, self.max_steps)
        G = self.steps_per_body or STEPS_PER_BODY
        key = self.key + (G, tree_signature(state), tree_signature(ctx))
        self.loop, self.made = device_loop(
            key, lambda: DeviceLoop(self.step, state, ctx, G, self.flags))
        if self.made:
            self.captures += 1
            self.capture_s += self.loop.capture_s
        if self.it_start is None:
            self.it_start = 0 if self.made else self.loop.iterations()
        alive = self.loop.run(state, ctx, untils, self.max_steps)
        return self.loop.state, alive

    def bodies(self) -> int:
        """Bodies this runner's loop ran since its first call (reads the
        device)."""
        return self.loop.iterations() - self.it_start

    def alive(self, state, ctx):
        """``any(running)`` of a (resumed) state under ``max_steps``, as
        the liveness word ``[1]`` (K14 on a one-rung ladder)."""
        st, cx = live_planes(link(state), link(ctx))
        ctl, iters, ladder = new_ctl(st["now"].device)
        ctl[CTL_W], ctl[CTL_MAXS] = 1, self.max_steps
        ladder[0] = self.max_steps
        loop_ctl(st, cx, ladder, ctl, iters, self.flags)
        return ctl[CTL_ALIVE:CTL_ALIVE + 1]


def build_window_runner(protocol, dims: EngineDims, max_steps: int = 1 << 22,
                        reorder: bool = False, faults: FaultFlags = NO_FAULTS,
                        monitor_keys: int = 0,
                        steps_per_body: "int | None" = None):
    """``(runner, alive)``, the reference's contract: ``runner(state,
    ctx, untils) -> (state, any_alive)`` advances the batch through the
    ``[W]`` ladder of segment ends in one host dispatch
    (:class:`WindowRunner`); ``alive(state, ctx)`` is any lane's
    liveness. On the card the loop runs as a CUDA graph whose body is
    ``steps_per_body`` steps (default :data:`STEPS_PER_BODY`); on the
    CPU its twin runs the same control on the host, a body of
    ``steps_per_body`` steps (default 1: a body costs nothing to
    dispatch there). The body length changes no result, only how many
    frozen steps a batch runs past a segment's end. ``reorder`` and
    ``faults`` are the batch's (``driver.batch_reorder_flag``,
    ``faults.batch_fault_flags``); ``monitor_keys > 0`` runs the safety
    monitors (their end-of-run reduction is :func:`finish_run`'s)."""
    check_monitorable(protocol, monitor_keys)

    def step(st, ctx, lim):
        return frozen_step(protocol, dims, st, ctx, lim, reorder, faults,
                           monitor_keys)[0]

    runner = WindowRunner((protocol, dims, reorder, faults, monitor_keys),
                          step, flag_bits(faults, reorder), max_steps,
                          steps_per_body)
    return runner, runner.alive


def build_segment_runner(protocol, dims: EngineDims,
                         max_steps: int = 1 << 22, reorder: bool = False,
                         faults: FaultFlags = NO_FAULTS,
                         monitor_keys: int = 0,
                         steps_per_body: "int | None" = None):
    """``(runner, alive)``, the reference's contract: ``runner(state,
    ctx, until) -> (state, any_alive)`` advances every running lane to
    at most ``until`` steps (a window of one segment,
    :func:`build_window_runner`)."""
    window, alive = build_window_runner(protocol, dims, max_steps, reorder,
                                        faults, monitor_keys, steps_per_body)

    def runner(state, ctx, until):
        return window(state, ctx, [until])

    runner.window = window
    return runner, alive


def build_runner(protocol, dims: EngineDims, max_steps: int = 1 << 22,
                 reorder: bool = False, faults: FaultFlags = NO_FAULTS,
                 monitor_keys: int = 0) -> Callable[[Any, Any], Any]:
    """The batched runner: (state, ctx) → final state, one window whose
    ladder ends at ``max_steps`` (one host dispatch on the card). A lane
    cut by ``max_steps`` before finishing reports ``ERR_TRUNCATED``.
    ``reorder`` and ``faults`` are the batch's
    (``driver.batch_reorder_flag``, ``faults.batch_fault_flags``).
    ``monitor_keys > 0`` runs the safety monitors and reduces them once
    at the end (kernel ``mon_finalize``). The final state is the
    batch's own (on the card a copy of the resident buffers)."""
    window, _alive = build_window_runner(protocol, dims, max_steps, reorder,
                                         faults, monitor_keys)

    def run(state, ctx):
        st, _any = window(state, ctx, [max_steps])
        if st is getattr(window.loop, "state", None):
            st = clone_tree(st)
        return finish_run(protocol, st, ctx, max_steps, reorder, faults,
                          monitor_keys)

    return run


def build_eager_runner(protocol, dims: EngineDims, max_steps: int = 1 << 22,
                       reorder: bool = False,
                       faults: FaultFlags = NO_FAULTS,
                       monitor_keys: int = 0) -> Callable[[Any, Any], Any]:
    """The eager runner: (state, ctx) → final state through the host
    loop of :func:`frozen_step` calls, each kernel launched by its
    wrapper, liveness read every :data:`STEPS_PER_BODY` steps. Results
    equal :func:`build_runner`'s; callers that hold each launch against
    its twin (each call passes through the wrappers) drive it by name.
    The caller's state is cloned once, at entry (the steps consume
    theirs)."""
    check_monitorable(protocol, monitor_keys)

    def run(state, ctx):
        st = clone_tree(state)
        while True:
            for _ in range(STEPS_PER_BODY):
                st, running = frozen_step(protocol, dims, st, ctx, max_steps,
                                          reorder, faults, monitor_keys)
            if not bool(running.any()):
                break
        return finish_run(protocol, st, ctx, max_steps, reorder, faults,
                          monitor_keys)

    return run


def finish_segmented(state, max_steps: int):
    """Apply the truncation error bit after a segmented run: a lane cut
    by ``max_steps`` before finishing reports ``ERR_TRUNCATED``."""
    truncated = (state["steps"] >= max_steps) & (state["done_time"] >= INF)
    return dict(state, err=state["err"] | ERR_TRUNCATED * truncated.to(I32))


def finish_run(protocol, st, ctx, max_steps: int, reorder: bool = False,
               faults: FaultFlags = NO_FAULTS, monitor_keys: int = 0):
    """A batch's state once no lane runs: :func:`finish_segmented`, and
    with the monitors on the ``mon_finalize`` kernel sets every lane's
    violation word, first violating step and coverage digest (once per
    batch: the reference re-runs it at every segment end, where it
    leaves a running lane's words as they are and re-derives a finished
    lane's, so its last run is the only one the results read)."""
    st = finish_segmented(st, max_steps)
    if monitor_keys:
        viol, viol_step, cov = mon_finalize(
            st, ctx, flag_bits(faults, reorder),
            getattr(protocol, "MONITOR_ORDER", True),
        )
        st = dict(st, viol=viol, viol_step=viol_step, cov=cov)
    return st
