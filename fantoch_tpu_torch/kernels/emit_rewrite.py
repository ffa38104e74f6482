"""K6 ``emit_rewrite``: a step's emission tail, from the handlers'
outboxes to the pool rows that K2 lands, and the lane's termination
bookkeeping.

Replaces ``fantoch_tpu/engine/core.py`` ``_lane_step`` §4 (:941, the
requeue row and ``merge_emissions`` :399), §5 (:1042, the closed-loop,
fault-free, no-reorder branch: ``emitter_times`` :252, the TO_CLIENT →
SUBMIT rewrite, latency metrics, channel ranks and ``pair_cnt``; with
partial replication's parts counting and target-shard SUBMIT,
:1177-1182, 1218-1224, 1273-1279) and §7
(:1494-1563, with ``fold_health`` :215 and ``fold_count`` :244). CUDA
source: ``csrc/emit_rewrite.cu`` (bound by bytes, :func:`work`).
:func:`emit_rewrite_plain` is its plain PyTorch twin, used for tensors
on the CPU.

Both read the handlers' outboxes as ``valid``, ``dst``, ``mtype`` and
``payload`` only: a protocol handler never sets ``delay`` or ``src``
(the reference's ``empty_outbox``/``emit`` defaults, -1), so they are
taken as -1; the requeue row alone overrides both.
"""

from __future__ import annotations

import torch

from ..engine.dims import (
    ERR_STUCK, INF, PKC, PMT, PPAY, PRQ, PSRC, REQUEUE_LIMIT, EngineDims,
)
from . import build, cost

I32 = torch.int32

CLIENT_KEYS = ("issued", "completed", "start_time", "parts", "part_max")
METRIC_KEYS = ("hist", "lat_sum", "lat_count", "lat_log")
LANE_KEYS = ("requeues", "max_completion", "done_time", "err", "steps")
OUTBOX_KEYS = ("valid", "dst", "mtype", "payload")


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


def _merge(n: int, f2: int, *parts):
    """Flatten per-process emission blocks ``[L, N, *, ...]`` into one
    ``[L, N*F2, ...]`` wire batch, each process's rows contiguous in the
    order of ``parts`` (the reference's ``merge_emissions``)."""
    out = {}
    for k in parts[0]:
        cat = torch.cat([p[k] for p in parts], dim=2)
        out[k] = cat.reshape((cat.shape[0], n * f2) + tuple(cat.shape[3:]))
    return out


def emit_rewrite_plain(st, ctx, ep, fire, has, rdy, rows, pout, hout, perr,
                       dims: EngineDims, submit: int):
    """``(new_rows [L, E, W], valid [L, E], upd)``: the pool rows of the
    step's emissions in K2's layout, which of them land, and the lane's
    new ``clients``, ``metrics``, ``pair_cnt``, ``next_periodic`` and
    scalars (``err`` without the pool-overflow bit, which K2 adds).
    ``st`` is the lane state the step started from; ``perr`` the
    handlers' new per-process error words."""
    N, C, F = dims.N, dims.C, dims.F
    L = rows.shape[0]
    dev = rows.device
    procs = torch.arange(N, dtype=I32, device=dev)
    requeued = has & ~rdy
    rq_next = torch.where(requeued, rows[..., PRQ] + 1, 0)
    stuck = (rq_next > REQUEUE_LIMIT).any(1)
    next_periodic = torch.where(
        fire, ep[..., None] + ctx["periodic_intervals"][:, None, :],
        st["next_periodic"],
    )

    # §4 flatten emissions: [periodic F | handler F | requeue 1] per
    # process; the requeue row re-emits a message the gate bounced
    minus = torch.full((L, N, F), -1, dtype=I32, device=dev)
    ob = [{k: o[k] for k in OUTBOX_KEYS} | {"delay": minus, "src": minus}
          for o in (pout, hout)]
    rq = {
        "valid": requeued[..., None],
        "dst": procs.expand(L, N)[..., None],
        "mtype": torch.where(requeued, rows[..., PMT], 0)[..., None],
        "payload": rows[:, :, None, PPAY:],
        "delay": torch.ones((L, N, 1), dtype=I32, device=dev),
        "src": rows[..., PSRC, None],
    }
    F2 = 2 * F + 1
    out = _merge(N, F2, *ob, rq)
    E = N * F2
    emitter = procs.repeat_interleave(F2)                     # [E]
    row_idx = torch.arange(E, dtype=I32, device=dev)
    is_rq = (row_idx % F2) == F2 - 1
    valid, dst = out["valid"], out["dst"]

    # §5 client rewrite: TO_CLIENT → latency record + next SUBMIT
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
    if "cmd_parts" in ctx:
        # partial replication: a command completes when all its key
        # parts arrived (the table's column clamped to its last)
        t_parts = ctx["cmd_parts"].shape[2]
        need = _take2(ctx["cmd_parts"], iota_c[None, :],
                      cl["issued"].clamp(max=t_parts - 1))
    else:
        need = 1
    complete_c = (arrivals > 0) & (parts_new >= need)
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
    log_depth = m["lat_log"].shape[2]
    log_src = _take(cl["completed"], cc)
    lat_log = _scatter_drop(
        m["lat_log"].reshape(L, -1), c * log_depth + log_src,
        rec & (c < C) & (log_src < log_depth), latency, add=False,
    ).reshape(m["lat_log"].shape)

    # rewrite entries in place; under partial replication the next
    # SUBMIT goes to the client's connected process of the command's
    # target shard (the shard of its first key)
    if "cmd_target" in ctx:
        t_tgt = ctx["cmd_target"].shape[2]
        shard = _take2(ctx["cmd_target"], cc, next_seq.clamp(max=t_tgt - 1))
        attach = _take2(ctx["client_attach_s"], cc, shard)
    else:
        attach = _take(ctx["client_attach"], cc)
    dst = torch.where(issue, attach, dst)
    mtype = torch.where(issue, submit, out["mtype"])
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

    # §7 termination bookkeeping
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
    folded = torch.zeros_like(st["err"])
    for p in range(N):
        folded = folded | perr[:, p]
    err = (
        st["err"]
        | ERR_STUCK * stuck.to(I32)
        | (folded & 0xFF)  # the reference's fold keeps the 8 ERR_* bits
    )
    upd = {
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
        "pair_cnt": pair_cnt,
        "requeues": st["requeues"] + requeued.sum(1, dtype=I32),
        "max_completion": max_completion,
        "done_time": done_time,
        "err": err,
        "steps": st["steps"] + 1,
    }
    return new_rows, valid, upd



def _flat_upd(upd):
    """The new state planes of ``upd`` in the kernel's argument order."""
    return ([upd["clients"][k] for k in CLIENT_KEYS]
            + [upd["metrics"][k] for k in METRIC_KEYS]
            + [upd["pair_cnt"], upd["next_periodic"]]
            + [upd[k] for k in LANE_KEYS])


def work(st, ctx, ep, fire, has, rdy, rows, pout, hout, perr,
         dims: EngineDims, submit: int, out):
    """``(bytes, ops)`` the region needs on these inputs (``out`` is its
    result). It reads every process's flags, time and error word, the
    outboxes' valid flags and the words of their valid rows, a requeued
    message's type, keys and payload, the lane's client, channel, timer
    and scalar planes, the small per-client ctx planes, one client
    delay per TO_CLIENT row, one process delay per other valid row, a
    key and a delay per issued SUBMIT (and under partial replication
    each client's part count, each SUBMIT's target shard and connected
    process), and the histogram words it increments. It writes the rows that land, every ``valid`` flag and
    the state words that change."""
    del submit
    new_rows, valid, upd = out
    L, E, W = new_rows.shape
    N, C, F, P = dims.N, dims.C, dims.F, dims.P
    F2 = 2 * F + 1
    old, new = _flat_upd(st), _flat_upd(upd)
    requeued = has & ~rdy
    ob_valid = [o["valid"] for o in (pout, hout)]
    to_client = sum(int((o["valid"] & (o["dst"] >= N)).sum())
                    for o in (pout, hout))
    n_valid = sum(int(v.sum()) for v in ob_valid)
    # a rewritten SUBMIT is the one landing row from a client that is
    # not a requeue row
    not_rq = (torch.arange(E, device=valid.device) % F2) != F2 - 1
    n_issue = int((valid & not_rq & (new_rows[..., PSRC] >= N)).sum())
    hist_changed = int((upd["metrics"]["hist"]
                        != st["metrics"]["hist"]).sum())
    read = (
        cost.nbytes(has, rdy, fire, ep, perr, *ob_valid, *old,
                    ctx["cmd_budget"], ctx["periodic_intervals"],
                    ctx["client_region_row"], ctx["client_attach"])
        - cost.nbytes(st["metrics"]["hist"], st["metrics"]["lat_log"])
        + 4 * (2 + P) * n_valid + 4 * (4 + P) * int(requeued.sum())
        + 4 * to_client + 4 * (n_valid - to_client) + 8 * n_issue
        + 4 * hist_changed
    )
    if "cmd_parts" in ctx:
        # a part count per client; a target shard and its connected
        # process per issued SUBMIT
        read += 4 * L * C + 8 * n_issue
    write = 4 * W * int(valid.sum()) + cost.nbytes(valid)
    for a, b in zip(old, new):
        write += int((a != b).sum()) * a.element_size()
    ops = L * E * (F2 + 2 * C + dims.RR + 32)
    return read + write, ops


def emit_rewrite(st, ctx, ep, fire, has, rdy, rows, pout, hout, perr,
                 dims: EngineDims, submit: int):
    """K6 on CUDA tensors, :func:`emit_rewrite_plain` on CPU tensors."""
    if rows.device.type == "cpu":
        return emit_rewrite_plain(st, ctx, ep, fire, has, rdy, rows, pout,
                                  hout, perr, dims, submit)
    L, N, W = rows.shape
    C, F, P, R = dims.C, dims.F, dims.P, fire.shape[2]
    RR, H = dims.RR, dims.H
    T = ctx["key_table"].shape[2]
    LOG = st["metrics"]["lat_log"].shape[2]
    F2 = 2 * F + 1
    E = N * F2
    dev = rows.device
    if N != dims.N or W != 8 + P or P < 3:
        raise ValueError(f"emit_rewrite: N={N}, W={W} do not fit {dims}")
    if max(E, C, N * N, RR, N * R) > 1024:
        raise ValueError(f"emit_rewrite: a lane's rows exceed one block")
    chk = build.check
    for name, ob in (("pout", pout), ("hout", hout)):
        chk(f"{name}/valid", ob["valid"], torch.bool, (L, N, F), dev)
        chk(f"{name}/dst", ob["dst"], I32, (L, N, F), dev)
        chk(f"{name}/mtype", ob["mtype"], I32, (L, N, F), dev)
        chk(f"{name}/payload", ob["payload"], I32, (L, N, F, P), dev)
    chk("has", has, torch.bool, (L, N), dev)
    chk("rdy", rdy, torch.bool, (L, N), dev)
    chk("rows", rows, I32, (L, N, W), dev)
    chk("ep", ep, I32, (L, N), dev)
    chk("fire", fire, torch.bool, (L, N, R), dev)
    chk("perr", perr, I32, (L, N), dev)
    shapes = {
        "issued": (L, C), "completed": (L, C), "start_time": (L, C),
        "parts": (L, C), "part_max": (L, C), "hist": (L, RR, H),
        "lat_sum": (L, RR), "lat_count": (L, RR), "lat_log": (L, C, LOG),
        "pair_cnt": (L, N, N), "next_periodic": (L, N, R),
    }
    old = _flat_upd(st)
    names = list(CLIENT_KEYS) + list(METRIC_KEYS) + [
        "pair_cnt", "next_periodic"] + list(LANE_KEYS)
    for name, t in zip(names, old):
        chk(f"st/{name}", t, I32, shapes.get(name, (L,)), dev)
    ctx_shapes = {
        "client_delay": (L, C, N), "delay_pp": (L, N, N),
        "key_table": (L, C, T), "cmd_budget": (L, C),
        "client_attach": (L, C), "client_region_row": (L, C),
        "periodic_intervals": (L, R),
    }
    for name, shape in ctx_shapes.items():
        chk(f"ctx/{name}", ctx[name], I32, shape, dev)
    # partial replication's tables, or null pointers (single-shard lanes)
    S = TP = TT = 0
    partial = [None, None, None]
    if "cmd_parts" in ctx:
        S = ctx["client_attach_s"].shape[2]
        TP = ctx["cmd_parts"].shape[2]
        TT = ctx["cmd_target"].shape[2]
        chk("ctx/cmd_parts", ctx["cmd_parts"], I32, (L, C, TP), dev)
        chk("ctx/cmd_target", ctx["cmd_target"], I32, (L, C, TT), dev)
        chk("ctx/client_attach_s", ctx["client_attach_s"], I32, (L, C, S),
            dev)
        partial = [ctx[k] for k in ("cmd_parts", "cmd_target",
                                    "client_attach_s")]
    new_rows = torch.empty((L, E, W), dtype=I32, device=dev)
    valid = torch.empty((L, E), dtype=torch.bool, device=dev)
    new = [torch.empty_like(t) for t in old]
    tensors = (
        [pout[k] for k in OUTBOX_KEYS] + [hout[k] for k in OUTBOX_KEYS]
        + [has, rdy, rows, ep, fire, perr] + old
        + [ctx[k] for k in ctx_shapes] + partial + [new_rows, valid] + new
    )
    fn = build.c_function("fantoch_emit_rewrite", len(tensors), 15)
    build.launch(
        fn, [0 if t is None else t.data_ptr() for t in tensors],
        [L, N, F, P, C, R, RR, H, T, LOG, W, submit, S, TP, TT],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    emit_rewrite.launches += 1
    upd = dict(zip(names, new))
    upd = {
        "next_periodic": upd["next_periodic"],
        "clients": {k: upd[k] for k in CLIENT_KEYS},
        "metrics": {k: upd[k] for k in METRIC_KEYS},
        "pair_cnt": upd["pair_cnt"],
        **{k: upd[k] for k in LANE_KEYS},
    }
    return new_rows, valid, upd


emit_rewrite.launches = 0
