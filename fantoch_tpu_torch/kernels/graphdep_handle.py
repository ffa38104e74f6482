"""K9 ``graphdep_handle``: Atlas's and EPaxos's readiness gate, periodic
timer, message handlers and graph-executor drain for every (lane,
process).

Replaces ``fantoch_tpu/engine/core.py`` ``run_handlers`` (:422) and the
``ready``/``periodic`` calls (:890-918) with ``_DepDev.ready`` (:215),
``.periodic`` (:265) and ``.handle`` (:236) of
``fantoch_tpu/engine/protocols/graphdep.py``: its eight handlers
(:471-728), ``_qd_add`` (:316), ``_commit_broadcast`` (:344), the hoisted
drain ``_drain`` (:374, the greatest fixed point that replaces Tarjan),
and both sides of ``fantoch_tpu/engine/iset.py`` (``iset_add`` :68,
``iset_contains_gathered`` :92), and on monitored steps the safety
monitors' ``mon_exec`` at the drain's pick (:415-433). CUDA source:
``csrc/graphdep_handle.cu`` with ``csrc/iset.cuh`` (bound by bytes,
:func:`work`). :func:`graphdep_handle_plain` is its plain PyTorch twin
(the batched handlers of ``engine/protocols/graphdep.py``), used for
tensors on the CPU. One kernel serves both protocols: the lane ctx
carries what differs.
"""

from __future__ import annotations

import ctypes

import torch

from ..engine.dims import PMT, EngineDims
from . import build, cost

I32 = torch.int32

# per-process state planes in the kernel's order (csrc/graphdep_handle.cu
# Plane), the order of _DepDev.init_state
STATE_KEYS = (
    "latest_src", "latest_seq", "seq_in_slot", "key_of", "client_of",
    "own_seq", "ack_cnt", "qd_src", "qd_seq", "qd_cnt", "slow_acks",
    "vx_committed", "vx_seq", "vx_key", "vx_client", "vx_nd", "vx_dep_src",
    "vx_dep_seq", "exec_front", "exec_gaps", "comm_front", "comm_gaps",
    "others_frontier", "seen", "prev_stable", "m_fast", "m_slow",
    "m_stable", "err",
)
BOOL_KEYS = ("vx_committed", "seen")
OUTBOX_KEYS = ("valid", "dst", "mtype", "payload")
CTX_KEYS = ("n", "f", "fast_quorum", "write_quorum", "expected_acks",
            "fp_mode", "ack_self", "client_attach")
THREADS = 128
# shared memory a block may use (above 48 KB the launch opts in)
SMEM_MAX = 227 * 1024


def graphdep_handle_plain(ps, has, rows, fire, ctx, dims: EngineDims):
    """``(rdy, ps, periodic outbox, handler outbox)``."""
    from ..engine.protocols.graphdep import _DepDev

    return _DepDev.step_plain(ps, has, rows, fire, ctx, dims)


def _state_shapes(L, dims: EngineDims, K, Q, G):
    N, D = dims.N, dims.D
    shapes = {
        "latest_src": (L, N, K), "latest_seq": (L, N, K),
        "exec_front": (L, N, N), "exec_gaps": (L, N, N, G, 2),
        "comm_front": (L, N, N), "comm_gaps": (L, N, N, G, 2),
        "others_frontier": (L, N, N, N), "seen": (L, N, N),
        "prev_stable": (L, N, N),
    }
    for k in ("seq_in_slot", "key_of", "client_of", "vx_committed",
              "vx_seq", "vx_key", "vx_client", "vx_nd"):
        shapes[k] = (L, N, N, D)
    for k in ("vx_dep_src", "vx_dep_seq"):
        shapes[k] = (L, N, N, D, Q)
    for k in ("qd_src", "qd_seq", "qd_cnt"):
        shapes[k] = (L, N, D, Q)
    for k in ("ack_cnt", "slow_acks"):
        shapes[k] = (L, N, D)
    for k in ("own_seq", "m_fast", "m_slow", "m_stable", "err"):
        shapes[k] = (L, N)
    return {k: (shapes[k], torch.bool if k in BOOL_KEYS else I32)
            for k in STATE_KEYS}


def smem_bytes(dims: EngineDims, G: int) -> int:
    """Dynamic shared memory of one block (csrc/graphdep_handle.cu): the
    two staged outboxes and a payload row, the executed sets, the
    argmin scratch and a few counters (int32), then the drain's
    per-vertex flags (a byte per ``[N, D]`` vertex)."""
    N, D, F, P = dims.N, dims.D, dims.F, dims.P
    ints = 2 * (3 * F + F * P) + P + N * (1 + 2 * G) + 2 * THREADS + 8
    return 4 * ints + N * D


def work(ps, has, rows, fire, ctx, dims: EngineDims, out):
    """``(bytes, ops)`` the region needs on these inputs (``out`` is its
    result). Every (lane, process) reads its ``has`` and timer flags, a
    popped message's type, source and payload, and the state words its
    branch reads: the gated types their dot words (MCollect two, MCommit
    one); SUBMIT its sequence and the key's latest dot; MCollect the
    dot words, its quorum flag and the key's latest dot; MCollectAck the
    dot's report table, ack count, key, client, the lane's quorum sizes
    and its write-quorum row; MCommit the dot words and the source's
    committed set; MConsensusAck the dot's count, key, client and report
    table; MGC the frontier table, seen flags, committed and stable
    clocks and the ``[N, D]`` dot words. The drain, which every process
    runs, reads the ``[N, D]`` committed flags, the executed sets and
    each committed vertex's sequence, deps and its deps' vertex words,
    and the picked vertex's client and attach entry. A firing GC timer
    reads the committed clock. It writes ``rdy``, both outboxes and the
    state words that change. Operations: the relaxation's dep checks on
    committed vertices, for the passes these inputs need."""
    from ..engine.protocols.graphdep import _DepDev as X
    from ..engine.protocols.graphdep import _relax

    rdy, new_ps, pout, hout = out
    L, N, W = rows.shape
    P, D = dims.P, dims.D
    Q, G = ps["qd_src"].shape[3], ps["exec_gaps"].shape[3]
    mtype = torch.where(has, rows[..., PMT], -1)
    done = has & rdy
    handled = {
        X.SUBMIT: 4 * 3,
        X.MCOLLECT: 4 * 4 + 2,
        X.MCOLLECTACK: 4 * (3 * Q + 6) + N,
        X.MCOMMIT: 4 * (3 + 2 * G),
        X.MCONSENSUS: 0,
        X.MCONSENSUSACK: 4 * (4 + 2 * Q),
        X.MGC: 4 * N * N + N + 4 * 2 * N + 4 * N * D,
        X.MDRAIN: 0,
    }
    count = {t: int((done & (mtype == t)).sum()) for t in handled}
    committed = ps["vx_committed"].flatten(2).sum(-1)
    _ok, _ready, passes = _relax(ps, N, D)
    n_committed = int(committed.sum())
    read = (
        cost.nbytes(has, fire)
        + 4 * (2 + P) * int(has.sum())
        + sum(b * count[t] for t, b in handled.items())
        + 4 * 2 * int((has & ~rdy & (mtype == X.MCOLLECT)).sum())
        + 4 * int((has & ~rdy & (mtype == X.MCOMMIT)).sum())
        + 4 * N * int(fire[..., 0].sum())
        + L * N * (N * D + 4 * N * (1 + 2 * G) + 4 * 2)
        + n_committed * 4 * (1 + 3 * Q)
    )
    write = cost.nbytes(rdy, *(ob[k] for ob in (pout, hout)
                               for k in OUTBOX_KEYS))
    for k in STATE_KEYS:
        write += int((new_ps[k] != ps[k]).sum()) * ps[k].element_size()
    ops = (
        40 * L * N
        + count[X.MGC] * (2 * N * D + 3 * N * N)
        + L * N * 2 * N * D
        + int((committed * Q * (2 * G + 6)).sum())
        + int((committed * passes * Q * 3).sum())
    )
    return read + write + cost.monitor_bytes(ps, new_ps), ops


def graphdep_handle(ps, has, rows, fire, ctx, dims: EngineDims):
    """K9 on CUDA tensors, :func:`graphdep_handle_plain` on CPU tensors.
    The kernel's outboxes carry the planes ``valid``, ``dst``,
    ``mtype`` and ``payload``; a protocol handler's ``delay``/``src``
    are always -1, which ``emit_rewrite`` assumes."""
    if rows.device.type == "cpu":
        return graphdep_handle_plain(ps, has, rows, fire, ctx, dims)
    L, N, W = rows.shape
    R = fire.shape[2]
    F, P, D = dims.F, dims.P, dims.D
    C = ctx["client_attach"].shape[1]
    K = ps["latest_src"].shape[2]
    Q, G = ps["qd_src"].shape[3], ps["exec_gaps"].shape[3]
    dev = rows.device
    if (N != dims.N or N > 32 or Q != N + 1 or F < N + 3
            or P < max(5 + 2 * Q, N)):
        raise ValueError(f"graphdep_handle: N={N}, Q={Q} do not fit {dims}")
    smem = smem_bytes(dims, G)
    if smem > SMEM_MAX:
        raise ValueError(f"graphdep_handle: {smem} bytes of shared memory "
                         f"per block exceed {SMEM_MAX} (N * D too large)")
    shapes = _state_shapes(L, dims, K, Q, G)
    for k in STATE_KEYS:
        build.check(f"ps/{k}", ps[k], shapes[k][1], shapes[k][0], dev)
    build.check("has", has, torch.bool, (L, N), dev)
    build.check("rows", rows, I32, (L, N, W), dev)
    build.check("fire", fire, torch.bool, (L, N, R), dev)
    for k in ("n", "f", "expected_acks", "fp_mode"):
        build.check(k, ctx[k], I32, (L,), dev)
    build.check("ack_self", ctx["ack_self"], torch.bool, (L,), dev)
    for k in ("fast_quorum", "write_quorum"):
        build.check(k, ctx[k], torch.bool, (L, N, N), dev)
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
    fn = build.c_function("fantoch_graphdep_handle", 8 + len(tensors), 13)
    build.launch(
        fn,
        [ctypes.addressof(ins), ctypes.addressof(outs)]
        + [t.data_ptr() for t in tensors] + mon_ptrs,
        [L, N, D, F, P, R, W, C, K, Q, G, smem, KM],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    graphdep_handle.launches += 1
    return rdy, {**new_ps, **mon_new}, pout, hout


graphdep_handle.launches = 0
