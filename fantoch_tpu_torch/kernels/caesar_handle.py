"""K10 ``caesar_handle``: Caesar's readiness gate, periodic timers,
message handlers, predecessors executor and wait condition for every
(lane, process).

Replaces ``fantoch_tpu/engine/core.py`` ``run_handlers`` (:422) and the
``ready``/``periodic`` calls (:890-918) with ``CaesarDev.ready`` (:239),
``.periodic`` (:309) and ``.handle`` (:270) of
``fantoch_tpu/engine/protocols/caesar.py``: its ten handlers
(:780-1282), the key clock table (``_kc_add`` :348, ``_kc_remove`` :369,
``_predecessors`` :390, ``_pack_deps`` :401), the dep unions
(``_agg_union`` :888, ``_agg_broadcast`` :947), the GC loops
(``_drain_executed_notification`` :740, ``_gc_count`` :688,
``_apply_freed`` :726, ``_mgc`` :1217), the hoisted predecessors
executor ``_exec_scan`` (:587) and wait scan ``_wait_scan`` (:498, with
``_blocker_verdicts`` :423), and both sides of
``fantoch_tpu/engine/iset.py`` (``iset_add`` :68,
``iset_contains_gathered`` :92), and on monitored steps the safety
monitors' ``mon_exec`` in the exec scan (:640-646). CUDA source:
``csrc/caesar_handle.cu``
with ``csrc/iset.cuh`` (bound by bytes, :func:`work`).
:func:`caesar_handle_plain` is its plain PyTorch twin (the batched
handlers of ``engine/protocols/caesar.py``), used for tensors on the
CPU.
"""

from __future__ import annotations

import ctypes

import torch

from ..engine.dims import PMT, PPAY, EngineDims
from . import build, cost

I32 = torch.int32

# per-process state planes in the kernel's order (csrc/caesar_handle.cu
# Plane), the order of CaesarDev.init_state
STATE_KEYS = (
    "kc_src", "kc_seq", "kc_cseq", "kc_cpid", "clk_counter", "pseq",
    "status", "key_of", "client_of", "clk_seq", "clk_pid", "dep_src",
    "dep_seq", "bb_src", "bb_seq", "own_seq", "qa_cnt", "qa_ok", "qa_done",
    "qa_cseq", "qa_cpid", "ag_src", "ag_seq", "qr_cnt", "ex_front",
    "ex_gaps", "eb_src", "eb_seq", "eb_n", "gb_src", "gb_seq", "gb_n",
    "gb_gc", "gc_cnt", "m_fast", "m_slow", "m_stable", "err",
)
BOOL_KEYS = ("qa_ok", "qa_done")
OUTBOX_KEYS = ("valid", "dst", "mtype", "payload")
CTX_KEYS = ("n", "fq_size", "wq_size", "wait_condition", "client_attach")
THREADS = 256
# shared memory a block may use (above 48 KB the launch opts in)
SMEM_MAX = 227 * 1024


def caesar_handle_plain(ps, has, rows, fire, ctx, dims: EngineDims):
    """``(rdy, ps, periodic outbox, handler outbox)``."""
    from ..engine.protocols.caesar import CaesarDev

    return CaesarDev.step_plain(ps, has, rows, fire, ctx, dims)


def sizes(ps):
    """``(K, S, DEP, BB, G, EB)`` of a state tree."""
    K, S = ps["kc_src"].shape[2:4]
    return (K, S, ps["dep_src"].shape[4], ps["bb_src"].shape[4],
            ps["ex_gaps"].shape[3], ps["eb_src"].shape[2])


def _state_shapes(L, dims: EngineDims, K, S, DEP, BB, G, EB):
    N, D = dims.N, dims.D
    shapes = {
        "ex_front": (L, N, N), "ex_gaps": (L, N, N, G, 2),
    }
    for k in ("kc_src", "kc_seq", "kc_cseq", "kc_cpid"):
        shapes[k] = (L, N, K, S)
    for k in ("pseq", "status", "key_of", "client_of", "clk_seq", "clk_pid",
              "gc_cnt"):
        shapes[k] = (L, N, N, D)
    for k in ("dep_src", "dep_seq"):
        shapes[k] = (L, N, N, D, DEP)
    for k in ("bb_src", "bb_seq"):
        shapes[k] = (L, N, N, D, BB)
    for k in ("qa_cnt", "qa_ok", "qa_done", "qa_cseq", "qa_cpid", "qr_cnt"):
        shapes[k] = (L, N, D)
    for k in ("ag_src", "ag_seq"):
        shapes[k] = (L, N, D, DEP)
    for k in ("eb_src", "eb_seq", "gb_src", "gb_seq"):
        shapes[k] = (L, N, EB)
    for k in ("clk_counter", "own_seq", "eb_n", "gb_n", "gb_gc", "m_fast",
              "m_slow", "m_stable", "err"):
        shapes[k] = (L, N)
    return {k: (shapes[k], torch.bool if k in BOOL_KEYS else I32)
            for k in STATE_KEYS}


def smem_bytes(dims: EngineDims, G: int, EB: int) -> int:
    """Dynamic shared memory of one block (csrc/caesar_handle.cu): the
    two staged outboxes, a payload row, the GC drain's shift buffer, the
    executed sets, the argmin scratch and a few counters (int32), then
    three byte flags per ``[N, D]`` dot (freed, exec-ready, wait
    verdict)."""
    N, D, F, P = dims.N, dims.D, dims.F, dims.P
    ints = (2 * (3 * F + F * P) + P + 2 * EB + N * (1 + 2 * G)
            + 2 * THREADS + 8)
    return 4 * ints + 3 * N * D


def work(ps, has, rows, fire, ctx, dims: EngineDims, out):
    """``(bytes, ops)`` the region needs on these inputs (``out`` is its
    result). Every (lane, process) reads its ``has`` and timer flags, a
    popped message's type, source and payload, and the state words its
    branch reads: the gated types their dot words (MPropose and MCommit/
    MRetry one, MGC one per advertised dot); SUBMIT its sequence and
    clock; MPropose the dot word, the clock, the key row's four words
    and each blocker's dot words and dep row; MProposeAck the dot's
    status and quorum words, its union row and the lane's quorum sizes;
    MCommit and MRetry the dot's words and the key row; MRetryAck the
    dot's status, count, clock and union row; MGC, per advertised dot,
    its words and the key row's clocks; GC_DRAIN the GC buffer. The GC
    timer reads the buffer count, the notification timer the executed
    buffer and, per buffered dot, what MGC reads per dot. The two scans,
    which every process runs, read the ``[N, D]`` statuses and the
    executed sets; the exec scan each committed dot's clock and its deps'
    cells, the wait scan each proposed dot's blocker row and, for each
    present blocker of a waiting dot, its cell and dep row; the picks a
    client and attach entry, and a valid reply its dot's dep row. It
    writes ``rdy``, both outboxes and the state words that change.
    Operations: the scans' dep checks and the two argmins. The scans are
    counted on the incoming state."""
    from ..engine.protocols.caesar import (
        ST_COMMIT, ST_PROPOSE_END, CaesarDev as X,
    )

    rdy, new_ps, pout, hout = out
    L, N, W = rows.shape
    P, D, F = dims.P, dims.D, dims.F
    K, S, DEP, BB, G, EB = sizes(ps)
    dpm = (P - 1) // 2
    mtype = torch.where(has, rows[..., PMT], -1)
    done = has & rdy
    per_dot = 4 * (5 + 2 * S)                   # a GC sighting's reads
    gc_dots = rows[..., PPAY].clamp(0, dpm)
    handled = {
        X.SUBMIT: 4 * 2,
        X.MPROPOSE: 4 * (2 + 4 * S + BB * (2 + 2 * DEP)),
        X.MPROPOSEACK: 4 * (4 + 2 * DEP + 2) + 2,
        X.MCOMMIT: 4 * (6 + 4 * S),
        X.MRETRY: 4 * (6 + 4 * S),
        X.MRETRYACK: 4 * (5 + 2 * DEP),
        X.WAIT_DRAIN: 0,
        X.EXEC_DRAIN: 0,
        X.GC_DRAIN: 4 * (2 + 2 * EB),
    }
    read = (
        cost.nbytes(has, fire)
        + 4 * (2 + P) * int(has.sum())
        + sum(b * int((done & (mtype == t)).sum())
              for t, b in handled.items())
        + per_dot * int(gc_dots[done & (mtype == X.MGC)].sum())
        + 4 * int((has & ~rdy & ((mtype == X.MPROPOSE) | (mtype == X.MCOMMIT)
                                 | (mtype == X.MRETRY))).sum())
        + 4 * int(gc_dots[has & ~rdy & (mtype == X.MGC)].sum())
        + 4 * int(fire[..., 0].sum())
        + 4 * int(fire[..., 1].sum())
        + (4 * 2 + per_dot) * int(ps["eb_n"].clamp(0, EB)[fire[..., 1]].sum())
        + L * N * (4 * N * D + 4 * N * (1 + 2 * G) + 4 * 2)
    )
    status = ps["status"]
    committed = status == ST_COMMIT
    proposed = status == ST_PROPOSE_END
    present = (ps["bb_seq"] > 0) & proposed[..., None]
    waiting = present.any(-1)
    blockers = int((present & waiting[..., None]).sum())
    read += (int(committed.sum()) * 4 * (2 + 6 * DEP)
             + int(proposed.sum()) * 4 * BB
             + blockers * 4 * (3 + 2 * DEP)
             + int(hout["valid"][..., F - 2].sum()) * 4 * (3 + 2 * DEP))
    write = cost.nbytes(rdy, *(ob[k] for ob in (pout, hout)
                               for k in OUTBOX_KEYS))
    for k in STATE_KEYS:
        write += int((new_ps[k] != ps[k]).sum()) * ps[k].element_size()
    ops = (
        40 * L * N
        + int(committed.sum()) * DEP * (2 * G + 8)
        + blockers * DEP * 4
        + L * N * 2 * N * D
    )
    return read + write + cost.monitor_bytes(ps, new_ps), ops


def caesar_handle(ps, has, rows, fire, ctx, dims: EngineDims):
    """K10 on CUDA tensors, :func:`caesar_handle_plain` on CPU tensors.
    The kernel's outboxes carry the planes ``valid``, ``dst``,
    ``mtype`` and ``payload``; a protocol handler's ``delay``/``src``
    are always -1, which ``emit_rewrite`` assumes."""
    if rows.device.type == "cpu":
        return caesar_handle_plain(ps, has, rows, fire, ctx, dims)
    L, N, W = rows.shape
    R = fire.shape[2]
    F, P, D = dims.F, dims.P, dims.D
    C = ctx["client_attach"].shape[1]
    K, S, DEP, BB, G, EB = sizes(ps)
    dev = rows.device
    if (N != dims.N or N > 32 or R != 2 or F < N + 5
            or P < max(5 + 2 * DEP, N) or W != PPAY + P):
        raise ValueError(f"caesar_handle: N={N}, DEP={DEP}, R={R} do not "
                         f"fit {dims}")
    smem = smem_bytes(dims, G, EB)
    if smem > SMEM_MAX:
        raise ValueError(f"caesar_handle: {smem} bytes of shared memory "
                         f"per block exceed {SMEM_MAX} (N * D too large)")
    shapes = _state_shapes(L, dims, K, S, DEP, BB, G, EB)
    for k in STATE_KEYS:
        build.check(f"ps/{k}", ps[k], shapes[k][1], shapes[k][0], dev)
    build.check("has", has, torch.bool, (L, N), dev)
    build.check("rows", rows, I32, (L, N, W), dev)
    build.check("fire", fire, torch.bool, (L, N, R), dev)
    for k in ("n", "fq_size", "wq_size"):
        build.check(k, ctx[k], I32, (L,), dev)
    build.check("wait_condition", ctx["wait_condition"], torch.bool, (L,),
                dev)
    build.check("client_attach", ctx["client_attach"], I32, (L, C), dev)
    rdy = torch.empty((L, N), dtype=torch.bool, device=dev)
    new_ps = {
        k: torch.empty(shapes[k][0], dtype=shapes[k][1], device=dev)
        for k in STATE_KEYS
    }

    def outbox():
        return {
            "valid": torch.empty((L, N, F), dtype=torch.bool, device=dev),
            "dst": torch.empty((L, N, F), dtype=I32, device=dev),
            "mtype": torch.empty((L, N, F), dtype=I32, device=dev),
            "payload": torch.empty((L, N, F, P), dtype=I32, device=dev),
        }

    pout, hout = outbox(), outbox()
    n_planes = len(STATE_KEYS)
    ins = (ctypes.c_void_p * n_planes)(*[ps[k].data_ptr()
                                         for k in STATE_KEYS])
    outs = (ctypes.c_void_p * n_planes)(*[new_ps[k].data_ptr()
                                          for k in STATE_KEYS])
    tensors = (
        [has, rows, fire] + [ctx[k] for k in CTX_KEYS] + [rdy]
        + [pout[k] for k in OUTBOX_KEYS] + [hout[k] for k in OUTBOX_KEYS]
    )
    mon_ptrs, KM, mon_new = build.mon_planes(ps, L, N, dev)
    fn = build.c_function("fantoch_caesar_handle", 8 + len(tensors), 15)
    build.launch(
        fn,
        [ctypes.addressof(ins), ctypes.addressof(outs)]
        + [t.data_ptr() for t in tensors] + mon_ptrs,
        [L, N, D, F, P, W, C, K, S, DEP, BB, G, EB, smem, KM],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    caesar_handle.launches += 1
    return rdy, {**new_ps, **mon_new}, pout, hout


caesar_handle.launches = 0
