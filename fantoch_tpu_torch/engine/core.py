"""The batched device event loop, in PyTorch over an explicit lane axis.

A conservative-lookahead parallel DES, step for step the reference's
(``fantoch_tpu/engine/core.py``):

  1. every process p finds its earliest local event time e_p and
     qualifies whenever e_p < min_q(e_q + lookahead[q, p]) or e_p is the
     lane-wide minimum;
  2. each qualifying process pops its earliest message (prio
     self-messages first, then the lowest (src, channel emission index)
     key) — 1 and 2 are the ``qualify_pop`` kernel;
  3. the protocol's readiness gate, periodic timers and handlers run
     (``protocol.handlers``; Basic's is the ``basic_handle`` kernel);
  4. emissions are flattened; TO_CLIENT messages are rewritten into the
     client's next SUBMIT (closed loop), latency is recorded, channel
     counters advance;
  5. the delivered emissions land in free pool slots (``land_emissions``
     kernel);
  6. termination bookkeeping.

State and ctx are dicts of tensors with a leading ``[L]`` lane axis.
:func:`build_runner` runs the step until every lane ends: as under the
reference's vmapped ``lax.while_loop``, a lane whose predicate is false
is frozen (its new state is discarded), so a finished lane is a fixed
point and the host checks liveness only every :data:`CHECK_EVERY` steps.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from ..kernels.land_emissions import land_emissions
from ..kernels.qualify_pop import qualify_pop
from .dims import (
    ERR_POOL,
    ERR_STUCK,
    ERR_TRUNCATED,
    INF,
    PKC,
    PMT,
    POOL_FIELDS,
    PPAY,
    PRQ,
    PSRC,
    REQUEUE_LIMIT,
    EngineDims,
    PA,
    PDST,
    PKS,
)

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


def emit_broadcast(outbox, mtype, words, n, me=None, exclude_me=False):
    """Fill every slot f with a message to process f, valid for f < n
    (the reference's ``ToSend{target: all()}``; ``all_but_me()`` with
    ``exclude_me``). ``n`` is ``[L]``, ``me`` and ``words`` carry the
    outbox's leading axes (``words`` ``[*lead, k]``)."""
    valid = outbox["valid"]
    f = valid.shape[-1]
    procs = torch.arange(f, dtype=I32, device=valid.device)
    ok = procs < n.reshape(n.shape + (1,) * (valid.dim() - 1))
    ok = ok.expand(valid.shape)
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


def merge_emissions(n: int, f2: int, *parts):
    """Flatten per-process emission blocks ``[L, N, *, ...]`` into one
    ``[L, N*F2, ...]`` wire batch, each process's rows contiguous in the
    order of ``parts``."""
    out = {}
    for k in parts[0]:
        cat = torch.cat([p[k] for p in parts], dim=2)
        out[k] = cat.reshape((cat.shape[0], n * f2) + tuple(cat.shape[3:]))
    return out


# ----------------------------------------------------------------------
# lane state
# ----------------------------------------------------------------------

def init_lane_state(protocol, dims: EngineDims, ctx_np: Dict[str, np.ndarray],
                    first_keys: np.ndarray):
    """One lane's initial state (numpy, host side): every live client's
    first SUBMIT in the pool (runner.rs:211-220) and the periodic timers
    armed at t = interval. ``first_keys`` ([C]) are the clients' first
    command keys (column 1 of the lane's key table)."""
    N, C, M, P, R = dims.N, dims.C, dims.M, dims.P, dims.R
    pool = np.zeros((M, POOL_FIELDS + P), np.int32)
    pool[:, PA] = INF
    budget = ctx_np["cmd_budget"]
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
    next_periodic[int(ctx_np["rows"]):, :] = INF
    return {
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

def _take(table, idx):
    """``table[l, idx[l, e]]`` for ``table [L, K]``, ``idx [L, E]``."""
    return torch.gather(table, 1, idx.long())


def _take2(table, i, j):
    """``table[l, i, j]`` for ``table [L, A, B]`` and index ``[L, E]``
    tensors (or an ``[E]`` row index broadcast over lanes)."""
    L, _, B = table.shape
    i = i.expand(j.shape) if i.dim() < j.dim() else i
    j = j.expand(i.shape) if j.dim() < i.dim() else j
    return torch.gather(table.reshape(L, -1), 1, (i * B + j).long())


def _scatter_drop(flat, idx, keep, val, add: bool):
    """``flat[l, idx] (+)= val`` where ``keep``; other entries drop (the
    reference's ``mode="drop"``) into a spare column cut off after."""
    L, K = flat.shape
    ext = torch.cat([flat, flat.new_zeros((L, 1))], dim=1)
    where = torch.where(keep, idx, torch.full_like(idx, K)).long()
    if add:
        ext.scatter_add_(1, where, val)
    else:
        ext.scatter_(1, where, val)
    return ext[:, :K]


def lane_step(protocol, dims: EngineDims, st, ctx):
    """One engine step of every lane (closed loop, fault-free)."""
    N, C, F = dims.N, dims.C, dims.F
    pool = st["pool"]
    L = pool.shape[0]
    dev = pool.device
    procs = torch.arange(N, dtype=I32, device=dev)

    # 1-2. qualification and pop (kernel K1)
    arrival, ep, now, _active, fire, _slot, has, rows = qualify_pop(
        pool, st["next_periodic"], ctx["lookahead"]
    )

    # 3. readiness gate, periodic timers and handlers (protocol kernel)
    rdy, ps, pout, outbox = protocol.handlers(
        st["ps"], has, rows, fire, ctx, dims
    )
    requeued = has & ~rdy
    rq_next = torch.where(requeued, rows[..., PRQ] + 1, 0)
    stuck = (rq_next > REQUEUE_LIMIT).any(1)
    next_periodic = torch.where(
        fire, ep[..., None] + ctx["periodic_intervals"][:, None, :],
        st["next_periodic"],
    )

    # 4. flatten emissions: [periodic F | handler F | requeue 1] per
    # process; the requeue row re-emits a message the gate bounced
    rq = {
        "valid": requeued[..., None],
        "dst": procs.expand(L, N)[..., None],
        "mtype": torch.where(requeued, rows[..., PMT], 0)[..., None],
        "payload": rows[:, :, None, PPAY:],
        "delay": torch.ones((L, N, 1), dtype=I32, device=dev),
        "src": rows[..., PSRC, None],
    }
    F2 = 2 * F + 1
    out = merge_emissions(N, F2, pout, outbox, rq)
    E = N * F2
    emitter = procs.repeat_interleave(F2)                     # [E]
    row_idx = torch.arange(E, dtype=I32, device=dev)
    is_rq = (row_idx % F2) == F2 - 1
    valid, dst = out["valid"], out["dst"]

    # 5. client rewrite: TO_CLIENT → latency record + next SUBMIT
    ep_e = ep[:, emitter.long()]
    is_client = valid & (dst >= N)
    c = torch.where(is_client, dst - N, 0)
    cc = c.clamp(0, C - 1)  # the reference's gathers clamp
    t_arr = ep_e + _take2(ctx["client_delay"], cc, emitter)
    cl = st["clients"]
    iota_c = torch.arange(C, dtype=I32, device=dev)
    oh_done = is_client[..., None] & (c[..., None] == iota_c)  # [L, E, C]
    arrivals = oh_done.sum(1, dtype=I32)
    parts_new = cl["parts"] + arrivals
    part_max = torch.maximum(
        cl["part_max"], torch.where(oh_done, t_arr[..., None], 0).amax(1)
    )
    complete_c = (arrivals > 0) & (parts_new >= 1)
    completed = cl["completed"] + complete_c.to(I32)
    parts = torch.where(complete_c, 0, parts_new)
    done_t = part_max
    latency_c = done_t - cl["start_time"]
    part_max = torch.where(complete_c, 0, part_max)
    last_row = torch.where(oh_done, row_idx[:, None], -1).amax(1)  # [L, C]
    is_completing = (
        is_client & (row_idx == _take(last_row, cc))
        & _take(complete_c, cc)
    )
    more = _take(cl["issued"], cc) < _take(ctx["cmd_budget"], cc)
    issue = is_completing & more
    oh_issue = (
        oh_done & (row_idx[:, None] == last_row[:, None, :])
        & complete_c[:, None, :] & more[..., None]
    )
    issued = cl["issued"] + oh_issue.sum(1, dtype=I32)
    st_new = torch.where(oh_issue.any(1), done_t, -1)
    start_time = torch.where(st_new >= 0, st_new, cl["start_time"])
    next_seq = _take(cl["issued"], cc) + 1
    t_keys = ctx["key_table"].shape[2]
    key = _take2(ctx["key_table"], cc, next_seq.clamp(max=t_keys - 1))
    sub_payload = torch.zeros_like(out["payload"])
    sub_payload[..., 0] = c
    sub_payload[..., 1] = next_seq
    sub_payload[..., 2] = key

    # metrics on completion only
    latency = _take(latency_c, cc)
    rec = is_completing
    row = torch.where(rec, _take(ctx["client_region_row"], cc), dims.RR)
    bucket = latency.clamp(0, dims.H - 1)
    m = st["metrics"]
    hist = _scatter_drop(
        m["hist"].reshape(L, -1), row * dims.H + bucket,
        (row >= 0) & (row < dims.RR), torch.ones_like(row), add=True,
    ).reshape(m["hist"].shape)
    oh_row = row[..., None] == torch.arange(dims.RR, dtype=I32, device=dev)
    lat_sum = m["lat_sum"] + torch.where(
        oh_row, latency[..., None], 0
    ).sum(1, dtype=I32)
    lat_count = m["lat_count"] + oh_row.sum(1, dtype=I32)
    log_src = _take(cl["completed"], cc)
    lat_log = _scatter_drop(
        m["lat_log"].reshape(L, -1), c * LAT_LOG + log_src,
        rec & (c < C) & (log_src < LAT_LOG), latency, add=False,
    ).reshape(m["lat_log"].shape)

    # rewrite entries in place
    attach = _take(ctx["client_attach"], cc)
    dst = torch.where(issue, attach, dst)
    mtype = torch.where(issue, protocol.SUBMIT, out["mtype"])
    payload = torch.where(issue[..., None], sub_payload, out["payload"])
    src = torch.where(is_client, N + c, emitter)
    src = torch.where(out["src"] >= 0, out["src"], src)
    base = torch.where(issue, _take(done_t, cc), ep_e)
    overridden = out["delay"] >= 0
    delay = torch.where(
        issue,
        _take2(ctx["client_delay"], cc, attach),
        _take2(ctx["delay_pp"], emitter, dst.clamp(0, N - 1)),
    )
    delay = torch.where(overridden, out["delay"], delay)
    valid = valid & (~is_client | issue)
    msg_arrival = base + delay
    prio = ~is_client & (dst == emitter) & ~overridden

    # sequence keys: kcnt counts emissions per (src, dst) channel; a
    # requeue row keeps its original key, a rewritten SUBMIT carries the
    # client's submit number
    counted = valid & ~is_client & ~is_rq
    dst_b = dst.reshape(L, N, F2)
    same = (dst_b[:, :, None, :] == dst_b[:, :, :, None]) & counted.reshape(
        L, N, 1, F2
    )
    rows_f = torch.arange(F2, device=dev)
    earlier = rows_f[None, :] < rows_f[:, None]               # [a, b]: b < a
    rank_b = (same & earlier).sum(-1, dtype=I32).reshape(L, E)
    safe_dst = dst.clamp(0, N - 1)
    orig_kcnt = torch.zeros((L, N, F2), dtype=I32, device=dev)
    orig_kcnt[..., F2 - 1] = rows[..., PKC]
    kcnt = torch.where(
        issue, next_seq, _take2(st["pair_cnt"], emitter, safe_dst) + rank_b + 1
    )
    kcnt = torch.where(is_rq, orig_kcnt.reshape(L, E), kcnt)
    pair_cnt = _scatter_drop(
        st["pair_cnt"].reshape(L, -1), emitter * N + dst,
        counted & (dst >= 0) & (dst < N), counted.to(I32), add=True,
    ).reshape(L, N, N)

    # 6. land the delivered emissions in free pool slots (kernel K2)
    rq_arr = torch.zeros((L, N, F2), dtype=I32, device=dev)
    rq_arr[..., F2 - 1] = rq_next
    new_rows = torch.cat(
        [
            torch.stack(
                [msg_arrival, src, kcnt, src, dst, mtype,
                 rq_arr.reshape(L, E), prio.to(I32)],
                dim=-1,
            ),
            payload,
        ],
        dim=-1,
    )
    new_pool, pool_overflow, pool_peak = land_emissions(
        pool, arrival, valid, new_rows, st["pool_peak"]
    )

    # 7. termination bookkeeping
    live = ctx["cmd_budget"] > 0
    all_done = (~live | (completed >= ctx["cmd_budget"])).all(1)
    max_completion = torch.maximum(
        st["max_completion"],
        torch.where(is_completing, _take(done_t, cc), 0).amax(1),
    )
    done_time = torch.where(
        (st["done_time"] == INF) & all_done, max_completion,
        st["done_time"],
    )
    perr = protocol.error(ps)
    folded = torch.zeros_like(st["err"])
    for p in range(N):
        folded = folded | perr[:, p]
    err = (
        st["err"]
        | ERR_POOL * pool_overflow.to(I32)
        | ERR_STUCK * stuck.to(I32)
        | (folded & 0xFF)  # the reference's fold keeps the 8 ERR_* bits
    )
    return {
        "pool": new_pool,
        "ps": ps,
        "next_periodic": next_periodic,
        "clients": {
            "issued": issued,
            "completed": completed,
            "start_time": start_time,
            "parts": parts,
            "part_max": part_max,
        },
        "metrics": {
            "hist": hist,
            "lat_sum": lat_sum,
            "lat_count": lat_count,
            "lat_log": lat_log,
        },
        "now": now,
        "pair_cnt": pair_cnt,
        "pool_peak": pool_peak,
        "fault_dropped": st["fault_dropped"],
        "requeues": st["requeues"] + requeued.sum(1, dtype=I32),
        "max_completion": max_completion,
        "steps": st["steps"] + 1,
        "hlog": st["hlog"],
        "hlog_n": st["hlog_n"],
        "done_time": done_time,
        "err": err,
    }


def lane_running(st, ctx, max_steps: int):
    """Per-lane loop predicate ``[L]`` (reference ``_lane_running``)."""
    done = st["done_time"]
    end = torch.where(done >= INF, INF, done + ctx["extra_time"])
    finished = (done < INF) & (st["now"] >= end)
    idle = st["now"] >= INF
    return ~(finished | idle | (st["err"] != 0)) & (st["steps"] < max_steps)


def tree_where(mask, new, old):
    """Per-lane select over two state trees: ``new`` where ``mask``."""
    if isinstance(new, dict):
        return {k: tree_where(mask, new[k], old[k]) for k in new}
    return torch.where(
        mask.reshape(mask.shape + (1,) * (new.dim() - 1)), new, old
    )


def frozen_step(protocol, dims: EngineDims, st, ctx, max_steps: int):
    """One step of the run loop: the lanes whose predicate is false keep
    their state, as under the reference's vmapped ``lax.while_loop``."""
    running = lane_running(st, ctx, max_steps)
    return tree_where(running, lane_step(protocol, dims, st, ctx), st)


def build_runner(protocol, dims: EngineDims,
                 max_steps: int = 1 << 22) -> Callable[[Any, Any], Any]:
    """The batched runner: (state, ctx) → final state. Every step
    freezes the lanes whose predicate is false; the host reads whether
    any lane still runs once every :data:`CHECK_EVERY` steps. A lane cut by
    ``max_steps`` before finishing reports ``ERR_TRUNCATED``."""

    def run(state, ctx):
        st = state
        while True:
            for _ in range(CHECK_EVERY):
                st = frozen_step(protocol, dims, st, ctx, max_steps)
            if not bool(lane_running(st, ctx, max_steps).any()):
                break
        truncated = (st["steps"] >= max_steps) & (st["done_time"] >= INF)
        return dict(st, err=st["err"] | ERR_TRUNCATED * truncated.to(I32))

    return run
