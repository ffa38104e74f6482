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
     client's next SUBMIT (closed loop), latency is recorded, channel
     counters advance, and the fault plan's wire faults (link windows,
     jitter, drops) and the reorder draws apply; with the termination
     bookkeeping this is the ``emit_rewrite`` kernel;
  5. the delivered emissions land in free pool slots (``land_emissions``
     kernel).

The batch's fault flags and the reorder switch are fixed for a run, as
they are trace-time in the reference: they reach K1, K6 and K7 as one
integer (``faults.flag_bits``), and each fault branch runs only under
its flag, so a fault-free batch runs exactly the fault-free step.

``monitor_keys > 0`` runs the safety monitors (``engine/monitor.py``):
the lane state gains the monitor planes, the handler kernels record
every execution at their executor's choke point, K6 folds the guard
bits into the lane's violation word under ``FLAG_MONITOR`` (a monitored
step is still five launches), and the ``mon_finalize`` kernel reduces
the planes once per batch when the run loop ends. At 0 the state tree,
the launches and the results are an unmonitored run's.

State and ctx are dicts of tensors with a leading ``[L]`` lane axis.
:func:`build_runner` runs the step until every lane ends: as under the
reference's vmapped ``lax.while_loop``, a lane whose predicate is false
is frozen (its new state is discarded; the ``lane_freeze`` kernel), so
a finished lane is a fixed point and the host checks liveness only every
:data:`CHECK_EVERY` steps.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from ..kernels.emit_rewrite import emit_rewrite
from ..kernels.land_emissions import land_emissions
from ..kernels.lane_freeze import lane_freeze
from ..kernels.mon_finalize import mon_finalize
from ..kernels.qualify_pop import qualify_pop
from . import monitor
from .dims import (
    ERR_TRUNCATED, INF, PA, PDST, PKC, PKS, PMT, POOL_FIELDS, PPAY, PSRC,
    EngineDims,
)
from .faults import NO_FAULTS, FaultFlags, flag_bits

I32 = torch.int32

# per-client latency-log depth (debugging aid for differential tests)
LAT_LOG = 64

# steps between the run loop's host reads of lane liveness
CHECK_EVERY = 64

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
    slot = 0
    for c in range(C):
        if not live[c]:
            continue
        pool[slot, PA] = ctx_np["client_delay"][c, attach[c]]
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
    return {
        **mon,
        "pool": pool,
        "ps": protocol.init_state(dims, ctx_np),
        "next_periodic": next_periodic,
        "clients": {
            "issued": live.astype(np.int32),
            "completed": np.zeros((C,), np.int32),
            "start_time": np.zeros((C,), np.int32),
            "parts": np.zeros((C,), np.int32),
            "part_max": np.zeros((C,), np.int32),
        },
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
              faults: FaultFlags = NO_FAULTS, monitor_keys: int = 0):
    """One engine step of every lane (closed loop) under the batch's
    ``faults`` flags and ``reorder`` switch; ``monitor_keys > 0`` on a
    state built with the monitor planes."""
    pool = st["pool"]
    flags = flag_bits(faults, reorder, monitor=monitor_keys > 0)

    # 0-2. the crash cut-off, qualification, the horizon and the pop
    # (kernel K1); the crash-masked arrivals and timers are written back
    arrival, ep, now, _active, fire, _slot, has, rows, timers = qualify_pop(
        pool, st["next_periodic"], ctx["lookahead"], ctx["fault_crash_t"],
        ctx["fault_horizon"], flags,
    )

    # 3. readiness gate, periodic timers and handlers, each process at
    # its event time ep (protocol kernel); the monitor planes ride in ps
    ps_in = monitor.merge_mon(st) if monitor_keys else st["ps"]
    rdy, ps, pout, outbox = protocol.handlers(
        ps_in, has, rows, fire, ep, ctx, dims
    )
    mon = {}
    if monitor_keys:
        ps, mon = monitor.strip_mon(ps)

    # 4-5 and 7. the emission tail, the wire faults, the termination
    # bookkeeping and the monitors' step fold (kernel K6); fired timers
    # re-arm from the masked ones
    st_in = st if timers is st["next_periodic"] else dict(
        st, next_periodic=timers)
    new_rows, deliver, upd = emit_rewrite(
        st_in, ctx, ep, fire, has, rdy, rows, pout, outbox,
        protocol.error(ps), dims, protocol.SUBMIT, flags,
        *([mon["mon_flags"]] if monitor_keys else []),
    )

    # 6. land the delivered emissions in free pool slots (kernel K2),
    # which also raises ERR_POOL on overflow
    new_pool, _overflow, pool_peak, err = land_emissions(
        pool, arrival, deliver, new_rows, st["pool_peak"], upd["err"]
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
    return out


def frozen_step(protocol, dims: EngineDims, st, ctx, max_steps: int,
                reorder: bool = False, faults: FaultFlags = NO_FAULTS,
                monitor_keys: int = 0):
    """One step of the run loop: ``(state, running)``. The lanes whose
    predicate is false on ``st`` keep their state, as under the
    reference's vmapped ``lax.while_loop`` (kernel K7)."""
    return lane_freeze(
        lane_step(protocol, dims, st, ctx, reorder, faults, monitor_keys),
        st, ctx, max_steps, flag_bits(faults, reorder),
    )


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


def build_runner(protocol, dims: EngineDims, max_steps: int = 1 << 22,
                 reorder: bool = False, faults: FaultFlags = NO_FAULTS,
                 monitor_keys: int = 0) -> Callable[[Any, Any], Any]:
    """The batched runner: (state, ctx) → final state. Every step
    freezes the lanes whose predicate is false; once every
    :data:`CHECK_EVERY` steps the host reads whether any lane was still
    running at the last step. A lane cut by ``max_steps`` before
    finishing reports ``ERR_TRUNCATED``. ``reorder`` and ``faults`` are
    the batch's (``driver.batch_reorder_flag``,
    ``faults.batch_fault_flags``). ``monitor_keys > 0`` runs the safety
    monitors and reduces them once at the end (kernel
    ``mon_finalize``)."""
    check_monitorable(protocol, monitor_keys)

    def run(state, ctx):
        st = state
        while True:
            for _ in range(CHECK_EVERY):
                st, running = frozen_step(protocol, dims, st, ctx, max_steps,
                                          reorder, faults, monitor_keys)
            if not bool(running.any()):
                break
        return finish_run(protocol, st, ctx, max_steps, reorder, faults,
                          monitor_keys)

    return run


def finish_run(protocol, st, ctx, max_steps: int, reorder: bool = False,
               faults: FaultFlags = NO_FAULTS, monitor_keys: int = 0):
    """A batch's state once no lane runs: a lane cut by ``max_steps``
    before finishing gets ``ERR_TRUNCATED``, and with the monitors on
    the ``mon_finalize`` kernel sets every lane's violation word, first
    violating step and coverage digest."""
    truncated = (st["steps"] >= max_steps) & (st["done_time"] >= INF)
    st = dict(st, err=st["err"] | ERR_TRUNCATED * truncated.to(I32))
    if monitor_keys:
        viol, viol_step, cov = mon_finalize(
            st, ctx, flag_bits(faults, reorder),
            getattr(protocol, "MONITOR_ORDER", True),
        )
        st = dict(st, viol=viol, viol_step=viol_step, cov=cov)
    return st
