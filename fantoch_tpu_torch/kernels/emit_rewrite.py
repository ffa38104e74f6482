"""K6 ``emit_rewrite``: a step's emission tail, from the handlers'
outboxes to the pool rows that K2 lands, and the lane's termination
bookkeeping.

Replaces ``fantoch_tpu/engine/core.py`` ``_lane_step`` §4 (:941, the
requeue row and ``merge_emissions`` :399), §5 (:1042, the closed-loop
branch: ``emitter_times`` :252, the TO_CLIENT → SUBMIT rewrite, latency
metrics, channel ranks and ``pair_cnt``; with partial replication's
parts counting and target-shard SUBMIT, :1177-1182, 1218-1224,
1273-1279), the fault plan's wire faults and the reorder draws (each
under its flag of the step's flag word: the reorder scaling :1043-1057,
:1305-1311, the horizon on client results :1077-1081, link windows
:1313-1349, jitter :1417-1436, drops :1438-1453), under
``FLAG_OPEN_LOOP`` the open-loop client (:954-1041 the stage row of
trigger 1, :1084-1175 the count-based completions, the ring of
completion times, trigger 2 and the release clamp, :1232-1256 the
latency from arrival, :1291-1297 the release-time base, :1376-1409 the
stage row kept out of channel counting), under ``FLAG_THINK`` the
traffic schedule's think delay on the next SUBMIT (:1298-1302), §7 (:1494-1563,
with ``fold_health`` :215, ``fold_count`` :244 and ``ERR_UNAVAIL``
under the crash flag :1516-1520) and, under ``FLAG_MONITOR``, the safety
monitors' step fold (``fantoch_tpu/engine/monitor.py`` ``step_viol``
:199, called at ``core.py:919-921``). CUDA source: ``csrc/emit_rewrite.cu``
(bound by bytes, :func:`work`). :func:`emit_rewrite_plain` is its plain
PyTorch twin, used for tensors on the CPU.

Both read the handlers' outboxes as ``valid``, ``dst``, ``mtype`` and
``payload`` only: a protocol handler never sets ``delay`` or ``src``
(the reference's ``empty_outbox``/``emit`` defaults, -1), so they are
taken as -1; the requeue row alone overrides both.

Both update the lane's ``clients``, ``metrics``, ``pair_cnt`` and
``next_periodic`` planes in place, on the lanes the step's run cap lets
run (``lane_freeze.Cap``), and return those very tensors; the ``[L]``
lane words stay out of place, since every kernel of the step reads its
run predicate from them. A frozen lane gets zero rows, none of which
lands, and its lane words as they were.
"""

from __future__ import annotations

import ctypes

import torch

from .. import random as rnd
from ..engine.dims import (
    ERR_STUCK, ERR_UNAVAIL, INF, PKC, PMT, PPAY, PRQ, PSRC, REQUEUE_LIMIT,
    EngineDims,
)
from ..engine.faults import (
    FLAG_CRASH, FLAG_DROPS, FLAG_HORIZON, FLAG_JITTER, FLAG_MONITOR,
    FLAG_OPEN_LOOP, FLAG_REORDER, FLAG_THINK, FLAG_WINDOWS, MAX_WINDOWS,
    drop_draw, jitter_draw,
)
from ..engine.monitor import step_viol
from . import build, cost
from .key_table import THREEFRY_OPS
from .lane_freeze import cap_args, cap_running

I32 = torch.int32

CLIENT_KEYS = ("issued", "completed", "start_time", "parts", "part_max")
# the lane-state planes besides clients and metrics that K6 updates in
# place
IN_PLACE_KEYS = ("pair_cnt", "next_periodic")
# the open-loop client's planes: the ring of completion times [L, C, W]
# and the release clamp [L, C]
OPEN_LOOP_KEYS = ("ol_comp_t", "ol_last_rel")
METRIC_KEYS = ("hist", "lat_sum", "lat_count", "lat_log")
LANE_KEYS = ("requeues", "max_completion", "done_time", "err", "steps")
OUTBOX_KEYS = ("valid", "dst", "mtype", "payload")
# the fault planes K6 reads; windows: src, dst, t0, t1, mul, ovr
WINDOW_KEYS = ("fault_win_src", "fault_win_dst", "fault_win_t0",
               "fault_win_t1", "fault_win_mul", "fault_win_ovr")
# the flags under which rows can be lost on the wire
WIRE_FLAGS = FLAG_WINDOWS | FLAG_DROPS | FLAG_JITTER


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


def _key_words(key):
    """``[L, 2]`` uint32 keys → two ``[L, 1]`` int64 words."""
    k = key.view(torch.int32).to(torch.int64) & rnd.MASK
    return k[:, :1], k[:, 1:]


def reorder_draws(reorder_key, steps, E: int):
    """``[L, 3, E]`` float32: each lane's per-step reorder multipliers,
    ``jax.random.uniform(fold_in(reorder_key, steps), (3, E),
    maxval=10.0)``; row 0 scales the TO_CLIENT return, row 1 the next
    SUBMIT, row 2 the process send."""
    k0, k1 = _key_words(reorder_key)
    k0, k1 = rnd.fold_in2(k0, k1, steps.to(torch.int64)[:, None] & rnd.MASK)
    i = torch.arange(3 * E, dtype=torch.int64, device=steps.device)
    bits = rnd.bits_at(k0, k1, i[None, :] + k0 * 0)
    f = ((bits >> 9) | 0x3F800000).to(I32).view(torch.float32) - 1.0
    u = torch.maximum(f * 10.0 + 0.0, torch.zeros_like(f))
    return u.reshape(-1, 3, E)


def _scale(d, u):
    """``(d * u).astype(int32)``: int32 → float32, a float32 product,
    truncated toward zero."""
    return (d.to(torch.float32) * u).to(I32)


def rows_per_process(F: int, flags: int = 0) -> int:
    """F2, a process's rows of the merged wire batch: its periodic and
    handler outboxes and the requeue row, and on open-loop lanes the
    stage row before the requeue row."""
    return 2 * F + (2 if flags & FLAG_OPEN_LOOP else 1)


def _open_stage(st, ctx, rdy, has, rows, ep, dims: EngineDims, submit: int):
    """Open-loop trigger 1, per process: when it pops client ``sc``'s
    SUBMIT of command s and the window admits q = s + 1, the SUBMIT of q
    is staged at once, released at R(q) = max(A(q), F(q), R(s)) (the
    arrival, the window gate's completion time, the clamp). Returns the
    stage row ``[L, N, 1]`` (a delay override puts its arrival at R(q)
    plus the client's submit delay), and ``stage1``, ``sc``, ``q``,
    ``rel1`` ``[L, N]`` for the client fold."""
    N, C = dims.N, dims.C
    cl = st["clients"]
    A = ctx["ol_arrival"]
    TA = A.shape[2]
    Wd = cl["ol_comp_t"].shape[2]
    src = rows[..., PSRC]
    sc = (src - N).clamp(0, C - 1)
    s_seq = rows[..., PPAY + 1]
    q = s_seq + 1
    stage1 = (
        has & rdy & (rows[..., PMT] == submit) & (src >= N)
        & (s_seq == _take(cl["issued"], sc))
        & (q <= _take(ctx["cmd_budget"], sc))
        & (_take(cl["completed"], sc) + Wd >= q)
    )
    f_gate = torch.where(
        q > Wd,
        _take2(cl["ol_comp_t"], sc, torch.remainder(q - Wd - 1, Wd)),
        0,
    )
    rel1 = torch.maximum(
        torch.maximum(_take2(A, sc, q.clamp(0, TA - 1)), f_gate),
        _take(cl["ol_last_rel"], sc),
    )
    attach1 = _take(ctx["client_attach"], sc)
    d_sub1 = _take2(ctx["client_delay"], sc, attach1)
    t_keys = ctx["key_table"].shape[2]
    key1 = _take2(ctx["key_table"], sc, q.clamp(0, t_keys - 1))
    payload = torch.zeros(rows.shape[:2] + (dims.P,), dtype=I32,
                          device=rows.device)
    payload[..., 0] = sc
    payload[..., 1] = q
    payload[..., 2] = key1
    stage = {
        "valid": stage1[..., None],
        "dst": attach1[..., None],
        "mtype": torch.full_like(attach1, submit)[..., None],
        "payload": payload[:, :, None, :],
        "delay": torch.where(stage1, rel1 + d_sub1 - ep, 0)[..., None],
        "src": (N + sc)[..., None],
    }
    return stage, stage1, sc, q, rel1


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
                       dims: EngineDims, submit: int, flags: int = 0,
                       mon_flags=None, cap=None):
    """:func:`emit_out_of_place`, then the in-place contract: its new
    ``clients``, ``metrics``, ``pair_cnt`` and ``next_periodic`` planes
    are copied into ``st``'s on the lanes ``cap`` lets run (every lane
    without one), as the kernel writes them, and ``upd`` holds ``st``'s
    tensors; a frozen lane's rows are zero, none lands, and its lane
    words are ``st``'s."""
    new_rows, deliver, upd = emit_out_of_place(
        st, ctx, ep, fire, has, rdy, rows, pout, hout, perr, dims, submit,
        flags, mon_flags)
    running = cap_running(cap)

    def put(old, new):
        if new is not old:
            if running is not None:  # a select: no sync with the card
                lead = running.reshape((-1,) + (1,) * (new.dim() - 1))
                new = torch.where(lead, new, old)
            old.copy_(new)
        return old

    for group in ("clients", "metrics"):
        upd[group] = {k: put(st[group][k], v) for k, v in upd[group].items()}
    for k in IN_PLACE_KEYS:
        upd[k] = put(st[k], upd[k])
    if running is None:
        return new_rows, deliver, upd
    for k in LANE_KEYS + ("fault_dropped", "viol", "viol_step"):
        if k in upd and upd[k] is not st[k]:
            upd[k] = torch.where(running, upd[k], st[k])
    new_rows = torch.where(running[:, None, None], new_rows, 0)
    return new_rows, deliver & running[:, None], upd


def emit_out_of_place(st, ctx, ep, fire, has, rdy, rows, pout, hout, perr,
                      dims: EngineDims, submit: int, flags: int = 0,
                      mon_flags=None):
    """``(new_rows [L, E, W], deliver [L, E], upd)``: the pool rows of
    the step's emissions in K2's layout, which of them land (valid and
    not lost on the wire), and the lane's new ``clients``, ``metrics``,
    ``pair_cnt``, ``next_periodic``, ``fault_dropped`` and scalars
    (``err`` without the pool-overflow bit, which K2 adds). ``st`` is the
    lane state the step started from, with the crash-masked timers;
    ``perr`` the handlers' new per-process error words; ``flags`` the
    step's flag word (``faults.flag_bits``). Without a wire-fault flag
    ``fault_dropped`` is ``st``'s own tensor. Under ``FLAG_MONITOR``
    ``upd`` also holds the lane's new ``viol`` and ``viol_step``, folded
    from the handlers' new guard bits ``mon_flags`` ``[L, N]``. Under
    ``FLAG_OPEN_LOOP`` the clients are open-loop (each process's rows gain
    the stage row, the clients' new ``ol_comp_t`` and ``ol_last_rel`` are
    in ``upd``); under ``FLAG_THINK`` the next SUBMIT leaves after its
    command's epoch think delay."""
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
    open_loop = bool(flags & FLAG_OPEN_LOOP)
    F2 = rows_per_process(F, flags)
    if open_loop:
        stage, stage1, sc, q_next, rel1 = _open_stage(
            st, ctx, rdy, has, rows, ep, dims, submit)
        out = _merge(N, F2, *ob, stage, rq)
    else:
        out = _merge(N, F2, *ob, rq)
    E = N * F2
    emitter = procs.repeat_interleave(F2)                     # [E]
    row_idx = torch.arange(E, dtype=I32, device=dev)
    is_rq = (row_idx % F2) == F2 - 1
    # the stage row sits just before the requeue row
    is_stage = ((row_idx % F2) == F2 - 2) & open_loop
    valid, dst = out["valid"], out["dst"]

    # §5 client rewrite: TO_CLIENT → latency record + next SUBMIT; under
    # reorder each hop's delay scales by its row of the step's draws
    if flags & FLAG_REORDER:
        u = reorder_draws(ctx["reorder_key"], st["steps"], E)

        def scaled(d, hop):
            return _scale(d, u[:, hop])
    else:

        def scaled(d, hop):
            return d
    ep_e = ep[:, emitter.long()]
    is_client = valid & (dst >= N)
    c = torch.where(is_client, dst - N, 0)
    cc = c.clamp(0, C - 1)  # the reference's gathers clamp
    t_arr = ep_e + scaled(_take2(ctx["client_delay"], cc, emitter), 0)
    cl = st["clients"]
    iota_c = torch.arange(C, dtype=I32, device=dev)
    if flags & FLAG_HORIZON:
        # a result reaching its client at or past the horizon is never
        # delivered: it completes and issues nothing
        is_client_done = is_client & (t_arr < ctx["fault_horizon"][:, None])
    else:
        is_client_done = is_client
    oh_done = is_client_done[..., None] & (c[..., None] == iota_c)
    arrivals = oh_done.sum(1, dtype=I32)
    last_row = torch.where(oh_done, row_idx[:, None], -1).amax(1)  # [L, C]
    ol_upd = {}
    if open_loop:
        # every TO_CLIENT completes one command, several of one client
        # can land in a step (all at one t_c), attributed by count; the
        # ring takes their completion times at slots (k0 .. k0 +
        # arrivals - 1) mod W
        k0 = cl["completed"]
        Wd = cl["ol_comp_t"].shape[2]
        completed = k0 + arrivals
        t_c = torch.where(oh_done, t_arr[..., None], 0).amax(1)
        w_iota = torch.arange(Wd, dtype=I32, device=dev)
        in_ring = (torch.remainder(w_iota - k0[..., None], Wd)
                   < arrivals[..., None])                     # [L, C, W]
        ol_comp_t = torch.where(in_ring, t_c[..., None], cl["ol_comp_t"])
        parts, part_max = cl["parts"], cl["part_max"]
        start_time = cl["start_time"]
        done_t = t_c
        is_completing = (
            is_client & (row_idx == _take(last_row, cc))
            & (_take(arrivals, cc) > 0)
        )
        # trigger 2: this step's completions admit the window-blocked
        # command pend = issued + 1; the last completing row becomes its
        # SUBMIT, released at max(A(pend), t_c, R(pend - 1))
        pend = cl["issued"] + 1
        more_c = cl["issued"] < ctx["cmd_budget"]
        trigger2 = ((arrivals > 0) & more_c & (completed + Wd >= pend)
                    & ~(k0 + Wd >= pend))
        issue = is_completing & _take(trigger2, cc)
        oh_issue = (oh_done & (row_idx[:, None] == last_row[:, None, :])
                    & trigger2[:, None, :])
        A = ctx["ol_arrival"]
        rel2 = torch.maximum(
            torch.maximum(
                _take2(A, iota_c[None, :], pend.clamp(0, A.shape[2] - 1)),
                t_c),
            cl["ol_last_rel"],
        )
        # trigger 1 folded per client (at most one SUBMIT of a client
        # pops per step)
        oh_t1 = stage1[..., None] & (sc[..., None] == iota_c)  # [L, N, C]
        staged1 = oh_t1.any(1)
        rel1_c = torch.where(oh_t1, rel1[..., None], 0).sum(1, dtype=I32)
        issued = (cl["issued"] + oh_issue.sum(1, dtype=I32)
                  + staged1.to(I32))
        ol_last_rel = torch.maximum(
            cl["ol_last_rel"],
            torch.where(staged1, rel1_c,
                        torch.where(trigger2, rel2, cl["ol_last_rel"])),
        )
        ol_upd = {"ol_comp_t": ol_comp_t, "ol_last_rel": ol_last_rel}
    else:
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

    if open_loop:
        # latency from arrival, one record per delivered TO_CLIENT row:
        # completion #(k0 + the row's rank among its client's rows this
        # step) closes arrival #k
        same_cd = (c[:, :, None] == c[:, None, :]) & is_client_done[:, None, :]
        rank_e = (same_cd & (row_idx[None, :] <= row_idx[:, None])).sum(
            -1, dtype=I32)
        k_i = _take(cl["completed"], cc) + rank_e
        A = ctx["ol_arrival"]
        latency = t_arr - _take2(A, cc, k_i.clamp(0, A.shape[2] - 1))
        rec = is_client_done
        log_src = k_i - 1
    else:
        # metrics on completion only
        latency = _take(latency_c, cc)
        rec = is_completing
        log_src = _take(cl["completed"], cc)
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
    lat_log = _scatter_drop(
        m["lat_log"].reshape(L, -1), c * log_depth + log_src,
        rec & (c < C) & (log_src >= 0) & (log_src < log_depth), latency,
        add=False,
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
    if open_loop:
        # a trigger-2 SUBMIT leaves at its staged release time
        base = torch.where(issue, _take(rel2, cc), ep_e)
    elif flags & FLAG_THINK:
        # the next command's epoch think delay
        tbl = ctx["traffic_seq_epoch"]
        e_next = _take(tbl, next_seq.clamp(0, tbl.shape[1] - 1))
        think = _take(ctx["traffic_think"], e_next)
        base = torch.where(issue, _take(done_t, cc) + think, ep_e)
    else:
        base = torch.where(issue, _take(done_t, cc), ep_e)
    overridden = out["delay"] >= 0
    delay = torch.where(
        issue,
        scaled(_take2(ctx["client_delay"], cc, attach), 1),
        scaled(_take2(ctx["delay_pp"], emitter, dst.clamp(0, N - 1)), 2),
    )
    delay = torch.where(overridden, out["delay"], delay)

    # wire faults touch process → process sends only: not client hops,
    # requeues (deferred deliveries) or self-messages
    wired = valid & ~is_client & ~is_rq & ~overridden & (dst != emitter)
    lost = torch.zeros_like(wired)
    inf = torch.full_like(delay, INF)
    if flags & FLAG_WINDOWS:
        # link windows by the emitter's send time; an effective delay at
        # or past INF partitions (the row keeps its channel count)
        w = {k: ctx[k][:, None, :] for k in WINDOW_KEYS}
        wm = (
            (w["fault_win_src"] == emitter[:, None])
            & (w["fault_win_dst"] == dst[..., None])
            & (w["fault_win_t0"] <= ep_e[..., None])
            & (ep_e[..., None] < w["fault_win_t1"])
            & wired[..., None]
        )                                                     # [L, E, W]
        w_hit = wm.any(-1)
        # windows of one pair never overlap: masked sums select
        w_mul = torch.where(wm, w["fault_win_mul"], 0).sum(-1, dtype=I32)
        w_ovr = torch.where(wm, w["fault_win_ovr"], 0).sum(-1, dtype=I32)
        w_mul = w_mul.clamp(min=1)
        # mul > INF // delay is exactly delay * mul > INF (no wraparound)
        mul_cap = torch.div(inf, delay.clamp(min=1), rounding_mode="floor")
        eff = torch.where(w_mul > mul_cap, inf, delay * w_mul)
        eff = torch.where(w_ovr >= 0, w_ovr, eff)
        lost = w_hit & (eff >= INF)
        delay = torch.where(w_hit & ~lost, eff, delay)
    valid = valid & (~is_client | issue)
    prio = ~is_client & (dst == emitter) & ~overridden

    # sequence keys: kcnt counts emissions per (src, dst) channel; a
    # requeue row keeps its original key, a rewritten or staged SUBMIT
    # carries the client's submit number
    counted = valid & ~is_client & ~is_rq & ~is_stage
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
    if open_loop:
        stage_seq = torch.zeros((L, N, F2), dtype=I32, device=dev)
        stage_seq[..., F2 - 2] = q_next
        kcnt = torch.where(is_stage, stage_seq.reshape(L, E), kcnt)
    pair_cnt = _scatter_drop(
        st["pair_cnt"].reshape(L, -1), emitter * N + dst,
        counted & (dst >= 0) & (dst < N), counted.to(I32), add=True,
    ).reshape(L, N, N)

    if flags & FLAG_JITTER:
        # every wire hop's delay × a threefry draw in [1, jitter_max],
        # keyed on (src, dst, channel emission index)
        k0, k1 = _key_words(ctx["fault_jitter_key"])
        jm = jitter_draw(
            k0, k1, emitter.to(torch.int64) + k0 * 0,
            safe_dst.to(torch.int64), kcnt.to(torch.int64),
            ctx["fault_jitter_num"].to(torch.int64)[:, None],
        )
        j_cap = torch.div(inf, delay.clamp(min=1), rounding_mode="floor")
        j_eff = torch.where(jm > j_cap, inf, delay * jm.to(I32))
        j_lost = wired & (j_eff >= INF)
        delay = torch.where(wired & ~j_lost, j_eff, delay)
        lost = lost | j_lost
    msg_arrival = base + delay
    if flags & FLAG_DROPS:
        # the drop verdict, keyed as jitter; a lost row keeps its count
        k0, k1 = _key_words(ctx["fault_drop_key"])
        draw = drop_draw(k0, k1, emitter.to(torch.int64) + k0 * 0,
                         safe_dst.to(torch.int64), kcnt.to(torch.int64))
        lost = lost | (wired & (draw < ctx["fault_drop_num"][:, None]))
    if flags & WIRE_FLAGS:
        deliver = valid & ~lost
        fault_dropped = st["fault_dropped"] + (valid & lost).sum(
            1, dtype=I32)
    else:
        deliver = valid
        fault_dropped = st["fault_dropped"]

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
    if flags & FLAG_CRASH:
        # crashes beyond what the protocol tolerates end the lane now
        err = err | ERR_UNAVAIL * (ctx["fault_unavail"] != 0).to(I32)
    upd = {
        "next_periodic": next_periodic,
        "clients": {
            "issued": issued,
            "completed": completed,
            "start_time": start_time,
            "parts": parts,
            "part_max": part_max,
            **ol_upd,
        },
        "metrics": {
            "hist": hist,
            "lat_sum": lat_sum,
            "lat_count": lat_count,
            "lat_log": lat_log,
        },
        "pair_cnt": pair_cnt,
        "fault_dropped": fault_dropped,
        "requeues": st["requeues"] + requeued.sum(1, dtype=I32),
        "max_completion": max_completion,
        "done_time": done_time,
        "err": err,
        "steps": st["steps"] + 1,
    }
    if flags & FLAG_MONITOR:
        upd["viol"], upd["viol_step"] = step_viol(st, mon_flags)
    return new_rows, deliver, upd


def _flat_upd(upd):
    """The new state planes of ``upd`` in the kernel's argument order
    (the open-loop planes last, when the clients have them)."""
    return ([upd["clients"][k] for k in CLIENT_KEYS]
            + [upd["metrics"][k] for k in METRIC_KEYS]
            + [upd["pair_cnt"], upd["next_periodic"]]
            + [upd[k] for k in LANE_KEYS]
            + [upd["clients"][k] for k in OPEN_LOOP_KEYS
               if k in upd["clients"]])


def _wired_rows(pout, hout, N: int) -> int:
    """Valid outbox rows to another process: the wire hops."""
    me = torch.arange(N, device=pout["dst"].device)[None, :, None]
    return sum(int((o["valid"] & (o["dst"] >= 0) & (o["dst"] < N)
                    & (o["dst"] != me)).sum()) for o in (pout, hout))


def work(st, ctx, ep, fire, has, rdy, rows, pout, hout, perr,
         dims: EngineDims, submit: int, flags: int, *tail):
    """``(bytes, ops)`` the region needs on these inputs: ``tail`` is
    ``(out,)``, ``(mon_flags, out)`` or ``(mon_flags, cap, out)`` (the
    wrapper's arguments, then its result); ``st`` is the state before
    the call (a snapshot: the call updates it in place). It reads every
    process's flags, time and error word, the
    outboxes' valid flags and the words of their valid rows, a requeued
    message's type, keys and payload, the lane's client, channel, timer
    and scalar planes, the small per-client ctx planes, one client
    delay per TO_CLIENT row, one process delay per other valid row, a
    key and a delay per issued SUBMIT (and under partial replication
    each client's part count, each SUBMIT's target shard and connected
    process), and the histogram words it increments; under the fault
    flags the plan's words of each lane it needs (the horizon, the
    windows, a key and a rate, the unavailability word), under reorder
    the lane's key and step count, and the lost count's word. It writes
    the rows that land, every ``valid`` flag and the state words that
    change. Its operations add, per wire hop, the window compares and the
    threefry blocks of the jitter and drop draws (3 fold-ins and a
    randint of 4), and under reorder one block per valid row and per
    issued SUBMIT and one per lane. Under the monitor flag it reads the
    processes' guard bits and the lane's violation word and step, and
    writes the words that change. Under the open-loop flag it also reads
    each process's popped type, sender and seq, a staged SUBMIT's
    arrival, gate slot, key, connected process and delay, each delivered
    result's arrival and each trigger-2 SUBMIT's arrival, and compares
    each result row with the rows before it (its rank); under the think
    flag each issued SUBMIT's epoch and think delay."""
    del submit
    *rest, out = tail
    mon_flags = rest[0] if rest else None
    new_rows, valid, upd = out
    L, E, W = new_rows.shape
    N, C, F, P = dims.N, dims.C, dims.F, dims.P
    F2 = rows_per_process(F, flags)
    old, new = _flat_upd(st), _flat_upd(upd)
    requeued = has & ~rdy
    ob_valid = [o["valid"] for o in (pout, hout)]
    to_client = sum(int((o["valid"] & (o["dst"] >= N)).sum())
                    for o in (pout, hout))
    n_valid = sum(int(v.sum()) for v in ob_valid)
    # a rewritten SUBMIT is the one landing row from a client that is
    # not a requeue row (nor a stage row)
    j = torch.arange(E, device=valid.device) % F2
    stage = (j == F2 - 2) if flags & FLAG_OPEN_LOOP else j < 0
    client_src = valid & (new_rows[..., PSRC] >= N)
    n_issue = int((client_src & (j != F2 - 1) & ~stage).sum())
    n_stage = int((client_src & stage).sum())
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
    wired = _wired_rows(pout, hout, N)
    if flags & FLAG_HORIZON:
        read += cost.nbytes(ctx["fault_horizon"])
    if flags & FLAG_CRASH:
        read += cost.nbytes(ctx["fault_unavail"])
    if flags & FLAG_WINDOWS:
        read += cost.nbytes(*(ctx[k] for k in WINDOW_KEYS))
        ops += wired * MAX_WINDOWS * 8
    for flag, keys in ((FLAG_JITTER, ("fault_jitter_key", "fault_jitter_num")),
                       (FLAG_DROPS, ("fault_drop_key", "fault_drop_num"))):
        if flags & flag:
            read += cost.nbytes(*(ctx[k] for k in keys))
            ops += wired * 7 * THREEFRY_OPS
    if flags & WIRE_FLAGS:
        read += cost.nbytes(st["fault_dropped"])
        write += int((upd["fault_dropped"] != st["fault_dropped"]).sum()) * 4
    if flags & FLAG_REORDER:
        read += cost.nbytes(ctx["reorder_key"])
        ops += (n_valid + n_issue + L) * THREEFRY_OPS
    if flags & FLAG_OPEN_LOOP:
        read += 12 * L * N + 20 * n_stage + 4 * to_client + 4 * n_issue
        ops += to_client * E + L * C * st["clients"]["ol_comp_t"].shape[2]
    if flags & FLAG_THINK:
        read += 8 * n_issue
    if flags & FLAG_MONITOR:
        read += cost.nbytes(mon_flags, st["viol"], st["viol_step"])
        for k in ("viol", "viol_step"):
            write += int((upd[k] != st[k]).sum()) * 4
        ops += L * (mon_flags.shape[1] + 4)
    return read + write, ops


def smem_bytes(N: int, F: int, C: int, flags: int = 0) -> int:
    """The shared memory one lane's block of the kernel takes: eleven
    words (a pool row's eight header words, the client, the arrival, the
    payload's offset) and three bytes (two flags, the payload's source) a
    row, nine words a client, seven a process (the open-loop stage), four
    a lane."""
    E = N * rows_per_process(F, flags)
    return (11 * E + 9 * C + 7 * N + 4) * 4 + 3 * E


# the most shared memory a block can opt into on Hopper
SMEM_LIMIT = 232_448
# the fault planes the kernel reads, in its argument order
FAULT_KEYS = ("fault_unavail", "fault_horizon", *WINDOW_KEYS,
              "fault_drop_num", "fault_drop_key", "fault_jitter_num",
              "fault_jitter_key", "reorder_key")


def emit_rewrite(st, ctx, ep, fire, has, rdy, rows, pout, hout, perr,
                 dims: EngineDims, submit: int, flags: int = 0,
                 mon_flags=None, cap=None):
    """K6 on CUDA tensors, :func:`emit_rewrite_plain` on CPU tensors.
    ``st``'s ``clients``, ``metrics``, ``pair_cnt`` and
    ``next_periodic`` are updated in place on the lanes ``cap`` lets run
    (every lane without one) and returned in ``upd`` (the same
    tensors)."""
    if rows.device.type == "cpu":
        return emit_rewrite_plain(st, ctx, ep, fire, has, rdy, rows, pout,
                                  hout, perr, dims, submit, flags,
                                  mon_flags, cap)
    L, N, W = rows.shape
    C, F, P, R = dims.C, dims.F, dims.P, fire.shape[2]
    RR, H = dims.RR, dims.H
    T = ctx["key_table"].shape[2]
    LOG = st["metrics"]["lat_log"].shape[2]
    E = N * rows_per_process(F, flags)
    dev = rows.device
    if N != dims.N or W != 8 + P or P < 3:
        raise ValueError(f"emit_rewrite: N={N}, W={W} do not fit {dims}")
    smem = smem_bytes(N, F, C, flags)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"emit_rewrite: {E} rows and {C} clients need "
            f"{smem} bytes of shared memory > {SMEM_LIMIT}"
        )
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
        "ol_last_rel": (L, C),
    }
    open_loop = bool(flags & FLAG_OPEN_LOOP)
    if open_loop != ("ol_comp_t" in st["clients"]):
        raise ValueError("emit_rewrite: FLAG_OPEN_LOOP and the open-loop "
                         "client planes go together")
    planes = _flat_upd(st)
    names = (list(CLIENT_KEYS) + list(METRIC_KEYS) + list(IN_PLACE_KEYS)
             + list(LANE_KEYS))
    # the open-loop arrival table and client planes, or null pointers; the
    # traffic schedule's seq → epoch index and think delays under
    # FLAG_THINK
    TA = WD = TE = EP = 0
    if open_loop:
        names += list(OPEN_LOOP_KEYS)
        TA, WD = ctx["ol_arrival"].shape[2], st["clients"]["ol_comp_t"].shape[2]
        shapes["ol_comp_t"] = (L, C, WD)
        chk("ctx/ol_arrival", ctx["ol_arrival"], I32, (L, C, TA), dev)
    for name, t in zip(names, planes):
        chk(f"st/{name}", t, I32, shapes.get(name, (L,)), dev)
    chk("st/fault_dropped", st["fault_dropped"], I32, (L,), dev)
    ctx_shapes = {
        "client_delay": (L, C, N), "delay_pp": (L, N, N),
        "key_table": (L, C, T), "cmd_budget": (L, C),
        "client_attach": (L, C), "client_region_row": (L, C),
        "periodic_intervals": (L, R),
    }
    for name, shape in ctx_shapes.items():
        chk(f"ctx/{name}", ctx[name], I32, shape, dev)
    for name in FAULT_KEYS:
        key = name.endswith("_key")
        chk(f"ctx/{name}", ctx[name], torch.uint32 if key else I32,
            (L, 2) if key else ((L, MAX_WINDOWS) if name in WINDOW_KEYS
                                else (L,)), dev)
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
    # the monitors' step fold: the guard bits and the lane's violation
    # word and step, or null pointers
    monitored = bool(flags & FLAG_MONITOR)
    mon = [None] * 5
    if monitored:
        chk("mon_flags", mon_flags, I32, (L, N), dev)
        chk("st/viol", st["viol"], I32, (L,), dev)
        chk("st/viol_step", st["viol_step"], I32, (L,), dev)
        mon = [mon_flags, st["viol"], st["viol_step"],
               torch.empty_like(st["viol"]), torch.empty_like(st["viol_step"])]
    think = [None, None]
    if flags & FLAG_THINK:
        TE = ctx["traffic_seq_epoch"].shape[1]
        EP = ctx["traffic_think"].shape[1]
        chk("ctx/traffic_seq_epoch", ctx["traffic_seq_epoch"], I32, (L, TE),
            dev)
        chk("ctx/traffic_think", ctx["traffic_think"], I32, (L, EP), dev)
        think = [ctx["traffic_seq_epoch"], ctx["traffic_think"]]
    new_rows = torch.empty((L, E, W), dtype=I32, device=dev)
    valid = torch.empty((L, E), dtype=torch.bool, device=dev)
    n_in = len(CLIENT_KEYS) + len(METRIC_KEYS) + len(IN_PLACE_KEYS)
    lanes = planes[n_in:n_in + len(LANE_KEYS)]
    lanes_o = [torch.empty_like(t) for t in lanes]
    ol = ([ctx["ol_arrival"]] + planes[n_in + len(LANE_KEYS):] if open_loop
          else [None] * (1 + len(OPEN_LOOP_KEYS)))
    # the lost count is a new plane only under a wire-fault flag
    dropped = (torch.empty_like(st["fault_dropped"]) if flags & WIRE_FLAGS
               else st["fault_dropped"])
    tab, cap_flags = cap_args(cap, L, dev)
    tensors = (
        [pout[k] for k in OUTBOX_KEYS] + [hout[k] for k in OUTBOX_KEYS]
        + [has, rdy, rows, ep, fire, perr] + planes[:n_in] + lanes
        + [st["fault_dropped"]] + [ctx[k] for k in ctx_shapes] + partial
        + [ctx[k] for k in FAULT_KEYS] + [new_rows, valid] + lanes_o
        + [dropped if flags & WIRE_FLAGS else None] + mon + ol + think
    )
    fn = build.c_function("fantoch_emit_rewrite", len(tensors) + 1, 21)
    build.launch(
        fn, [0 if t is None else t.data_ptr() for t in tensors]
        + [ctypes.addressof(tab)],
        [L, N, F, P, C, R, RR, H, T, LOG, W, submit, S, TP, TT, flags, TA,
         WD, TE, EP, cap_flags],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    emit_rewrite.launches += 1
    upd = {
        "next_periodic": st["next_periodic"],
        "clients": dict(st["clients"]),
        "metrics": dict(st["metrics"]),
        "pair_cnt": st["pair_cnt"],
        "fault_dropped": dropped,
        **dict(zip(LANE_KEYS, lanes_o)),
    }
    if monitored:
        upd["viol"], upd["viol_step"] = mon[3], mon[4]
    return new_rows, valid, upd


emit_rewrite.launches = 0
