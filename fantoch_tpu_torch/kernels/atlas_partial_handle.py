"""K12 ``atlas_partial_handle``: Atlas's partial-replication readiness
gate, periodic timers and message handlers for every (lane, process),
with the shard-union deps, the graph-executor drain and its cross-shard
requests.

Replaces ``fantoch_tpu/engine/core.py`` ``run_handlers`` (:422) and the
``ready``/``periodic`` calls (:890-918) with ``AtlasPartialDev.ready``
(:219), ``.periodic`` (:260) and ``.handle`` (:236) of
``fantoch_tpu/engine/protocols/graphdep_partial.py``: its fourteen
handlers (:447-1129), the dep-table helpers (:284-386), the graph drain
``_g_drain`` (:858, the greatest fixed point that replaces Tarjan, with
its one-request-per-drain missing-dep path), the request answers
``_g_answer`` (:1012) and the cleanup tick ``_g_cleanup`` (:1107), and
both sides of ``fantoch_tpu/engine/iset.py`` (:29, :68, :72, :92). CUDA
source: ``csrc/atlas_partial_handle.cu`` with ``csrc/iset.cuh`` (bound by
bytes, :func:`work`). :func:`atlas_partial_handle_plain` is its plain
PyTorch twin (``AtlasPartialDev.step_plain``), used for tensors on the
CPU.
"""

from __future__ import annotations

import ctypes

import torch

from ..engine.dims import PMT, EngineDims
from . import build, cost

I32 = torch.int32
THREADS = 256  # csrc/atlas_partial_handle.cu THREADS
# shards and keys per command thread 0 holds in registers
# (csrc/atlas_partial_handle.cu MAXS, MAXKPC)
MAX_SHARDS = MAX_KEYS_PER_CMD = 8
# shared memory a block may use (above 48 KB the launch opts in)
SMEM_MAX = 227 * 1024

# per-process state planes in the kernel's order
# (csrc/atlas_partial_handle.cu Plane), the order of
# AtlasPartialDev.init_state
STATE_KEYS = (
    "latest_src", "latest_seq", "latest_km", "seq_in_slot", "client_of",
    "cseq_of", "own_seq", "ack_cnt", "slow_acks", "qd_src", "qd_seq",
    "qd_km", "qd_cnt", "sh_cnt", "sh_src", "sh_seq", "sh_km",
    "vx_committed", "vx_seq", "vx_client", "vx_cseq", "vx_nd", "vx_dep_src",
    "vx_dep_seq", "vx_dep_km", "req_seq", "breq_from", "breq_src",
    "breq_seq", "exec_front", "exec_gaps", "comm_front", "comm_gaps",
    "others_frontier", "seen", "prev_stable", "m_fast", "m_slow",
    "m_stable", "err",
)
BOOL_KEYS = ("vx_committed", "seen")
OUTBOX_KEYS = ("valid", "dst", "mtype", "payload")
CTX_KEYS = ("n", "f", "expected_acks", "fp_mode", "ack_self",
            "fast_quorum", "write_quorum", "shard_of", "closest",
            "client_attach_s", "cmd_kmask", "cmd_skey")


def _protocol(ps, ctx):
    """The AtlasPartialDev whose tables ``ps`` and ``ctx`` hold."""
    from ..engine.protocols.graphdep_partial import AtlasPartialDev

    return AtlasPartialDev(
        keys=ps["latest_src"].shape[2], shards=ctx["closest"].shape[2],
        keys_per_cmd=ctx["cmd_skey"].shape[4],
        gap_slots=ps["exec_gaps"].shape[3],
        req_buffer=ps["breq_from"].shape[2],
    )


def atlas_partial_handle_plain(ps, has, rows, fire, ctx, dims: EngineDims):
    """``(rdy, ps, periodic outbox, handler outbox)``."""
    return _protocol(ps, ctx).step_plain(ps, has, rows, fire, ctx, dims)


def _state_shapes(L, dims: EngineDims, K, Q, QS, G, BB):
    N, D = dims.N, dims.D
    shapes = {
        "exec_front": (L, N, N), "exec_gaps": (L, N, N, G, 2),
        "comm_front": (L, N, N), "comm_gaps": (L, N, N, G, 2),
        "others_frontier": (L, N, N, N), "seen": (L, N, N),
        "prev_stable": (L, N, N), "sh_cnt": (L, N, D),
    }
    for k in ("latest_src", "latest_seq", "latest_km"):
        shapes[k] = (L, N, K)
    for k in ("seq_in_slot", "client_of", "cseq_of", "ack_cnt", "slow_acks",
              "vx_committed", "vx_seq", "vx_client", "vx_cseq", "vx_nd",
              "req_seq"):
        shapes[k] = (L, N, N, D)
    for k in ("qd_src", "qd_seq", "qd_km", "qd_cnt"):
        shapes[k] = (L, N, N, D, Q)
    for k in ("sh_src", "sh_seq", "sh_km"):
        shapes[k] = (L, N, D, QS)
    for k in ("vx_dep_src", "vx_dep_seq", "vx_dep_km"):
        shapes[k] = (L, N, N, D, QS)
    for k in ("breq_from", "breq_src", "breq_seq"):
        shapes[k] = (L, N, BB)
    for k in ("own_seq", "m_fast", "m_slow", "m_stable", "err"):
        shapes[k] = (L, N)
    return {k: (shapes[k], torch.bool if k in BOOL_KEYS else I32)
            for k in STATE_KEYS}


def smem_bytes(dims: EngineDims, G: int, Q: int) -> int:
    """Dynamic shared memory of one block (csrc/atlas_partial_handle.cu):
    the two staged outboxes and a payload row, the executed sets, the
    argmin scratch, a few counters and a zero report row (int32), then
    the drain's per-vertex flags (a byte per ``[N, D]`` vertex)."""
    N, D, F, P = dims.N, dims.D, dims.F, dims.P
    ints = (2 * (3 * F + F * P) + P + N * (1 + 2 * G) + 2 * THREADS + 8
            + 4 * Q)
    return 4 * ints + N * D


def work(ps, has, rows, fire, ctx, dims: EngineDims, out):
    """``(bytes, ops)`` the region needs on these inputs (``out`` is its
    result). Every (lane, process) reads its ``has`` and timer flags, a
    popped message's type, source and payload, its buffered-request
    table when the cleanup tick fires (and, per buffered request, the
    dot's vertex words, dep rows and the source's executed set), and
    the state and ctx words its branch reads: a dot's cell and counters,
    the command's table row (mask and keys), the local keys' latest
    deps; MCollectAck and MConsensusAck the dot's ``[Q]`` report rows,
    MShardCommit the slot's ``[QS]`` union rows, MCommit and GReply the
    vertex cell, GReq the vertex words and dep rows and the request
    buffer, MGC the frontier table and the ``[N, D]`` dot words. The
    drain (MCommit, MDrain, GReply, GReplyExec) reads the ``[N, D]``
    committed flags, the executed sets, each committed vertex's
    sequence, dep rows and its deps' vertex and request words, and the
    picked vertex's words and client row. It writes ``rdy``, both
    outboxes and the state words that change. Operations: per draining
    process the relaxation's dep checks for the passes these inputs
    need, the missing-dep scan and the two argmins."""
    from ..engine.protocols.graphdep_partial import AtlasPartialDev as X

    rdy, new_ps, pout, hout = out
    L, N, W = rows.shape
    P, D = dims.P, dims.D
    Q, QS = ps["qd_src"].shape[4], ps["vx_dep_src"].shape[4]
    G, BB = ps["exec_gaps"].shape[3], ps["breq_from"].shape[2]
    S, KPC = ctx["closest"].shape[2], ctx["cmd_skey"].shape[4]
    mtype = torch.where(has, rows[..., PMT], -1)
    done = has & rdy
    cmd = 4 * (1 + S * KPC)                  # the command's table row
    dot = 4 * 4                              # a dot's cell, client, cseq
    keys = 4 * 3 * KPC                       # latest (src, seq, km) per key
    iset = 4 * (1 + 2 * G)
    vertex = 4 * (5 + 3 * QS)
    handled = {
        X.SUBMIT: 4 * 3 + cmd + keys,
        X.MFWDSUBMIT: cmd + keys,
        X.MCOLLECT: dot + 4 + cmd + keys + 4,
        X.MCOLLECTACK: dot + 4 * (4 * Q + 4) + cmd + N,
        X.MCOMMIT: dot + 4 + iset,
        X.MCONSENSUS: 0,
        X.MCONSENSUSACK: dot + 4 * (3 * Q + 2) + cmd,
        X.MGC: 4 * N * N + N + 4 * 2 * N + 4 * N * D,
        X.MDRAIN: 0,
        X.MSHARDCOMMIT: 4 * (3 * QS + 1) + dot + cmd,
        X.MSHARDAGG: dot,
        X.GREQ: vertex + iset + 4 * 3 * BB + 4,
        X.GREPLY: 4,
        X.GREPLYEXEC: iset,
    }
    count = {t: int((done & (mtype == t)).sum()) for t in handled}
    gated = (X.MCOLLECT, X.MCOMMIT, X.MSHARDCOMMIT, X.MSHARDAGG)
    cleanup = fire[..., 1]
    buffered = int(((ps["breq_from"] >= 0) & cleanup[..., None]).sum())
    draining = done & ((mtype == X.MCOMMIT) | (mtype == X.MDRAIN)
                       | (mtype == X.GREPLY) | (mtype == X.GREPLYEXEC))
    committed = ps["vx_committed"].flatten(2).sum(-1)
    n_committed = int(committed[draining].sum())
    n_drains = int(draining.sum())
    read = (
        cost.nbytes(has, fire)
        + 4 * (2 + P) * int(has.sum())
        + sum(b * count[t] for t, b in handled.items())
        + sum(4 * 2 * int((has & ~rdy & (mtype == t)).sum()) for t in gated)
        + 4 * N * int(fire[..., 0].sum())
        + 4 * BB * int(cleanup.sum()) + (vertex + iset) * buffered
        + n_drains * (N * D + 4 * N * (1 + 2 * G) + vertex + cmd)
        + n_committed * 4 * (1 + 3 * QS + 2 * QS)
    )
    write = cost.nbytes(rdy, *(ob[k] for ob in (pout, hout)
                               for k in OUTBOX_KEYS))
    for k in STATE_KEYS:
        write += int((new_ps[k] != ps[k]).sum()) * ps[k].element_size()
    passes = _passes(ps, draining, dims)
    ops = (
        40 * L * N
        + count[X.MGC] * (2 * N * D + 3 * N * N)
        + (count[X.MCOLLECTACK] + count[X.MCONSENSUSACK]) * 2 * KPC * Q
        + count[X.MSHARDCOMMIT] * Q * QS
        + buffered * 4 * QS
        + n_drains * 4 * N * D
        + n_committed * QS * (2 * G + 12)
        + int((committed * passes * QS * 3)[draining].sum())
    )
    return read + write, ops


def _passes(ps, draining, dims: EngineDims):
    """``[L, N]``: the relaxation passes each draining (lane, process)
    needs on these inputs (the last one changes nothing)."""
    from ..engine.protocols.graphdep import _relax

    li, pi = draining.nonzero(as_tuple=True)
    out = torch.zeros(draining.shape, dtype=torch.int64,
                      device=draining.device)
    if li.numel():
        rows = {k: ps[k][li, pi][:, None] for k in
                ("vx_committed", "vx_dep_src", "vx_dep_seq", "exec_front",
                 "exec_gaps", "vx_seq")}
        out[li, pi] = _relax(rows, dims.N, dims.D)[2][:, 0]
    return out


def atlas_partial_handle(ps, has, rows, fire, ctx, dims: EngineDims):
    """K12 on CUDA tensors, :func:`atlas_partial_handle_plain` on CPU
    tensors. The kernel's outboxes carry the planes ``valid``, ``dst``,
    ``mtype`` and ``payload``; a protocol handler's ``delay``/``src``
    are always -1, which ``emit_rewrite`` assumes."""
    if rows.device.type == "cpu":
        return atlas_partial_handle_plain(ps, has, rows, fire, ctx, dims)
    L, N, W = rows.shape
    R = fire.shape[2]
    F, P, D, C = dims.F, dims.P, dims.D, dims.C
    K = ps["latest_src"].shape[2]
    Q, QS = ps["qd_src"].shape[4], ps["vx_dep_src"].shape[4]
    G, BB = ps["exec_gaps"].shape[3], ps["breq_from"].shape[2]
    S, KPC = ctx["closest"].shape[2], ctx["cmd_skey"].shape[4]
    T1 = ctx["cmd_kmask"].shape[2]
    dev = rows.device
    if (N != dims.N or R != 2 or S > MAX_SHARDS or KPC > MAX_KEYS_PER_CMD
            or F < max(N + BB + 2, N + S + 2, KPC + 3)
            or P < max(5 + 3 * QS, 3 + 3 * Q, N)):
        raise ValueError(
            f"atlas_partial_handle: N={N}, S={S}, KPC={KPC}, Q={Q}, "
            f"QS={QS}, B={BB} do not fit {dims}")
    smem = smem_bytes(dims, G, Q)
    if smem > SMEM_MAX:
        raise ValueError(f"atlas_partial_handle: {smem} bytes of shared "
                         f"memory per block exceed {SMEM_MAX}")
    shapes = _state_shapes(L, dims, K, Q, QS, G, BB)
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
    build.check("shard_of", ctx["shard_of"], I32, (L, N), dev)
    build.check("closest", ctx["closest"], I32, (L, N, S), dev)
    build.check("client_attach_s", ctx["client_attach_s"], I32, (L, C, S),
                dev)
    build.check("cmd_kmask", ctx["cmd_kmask"], I32, (L, C, T1), dev)
    build.check("cmd_skey", ctx["cmd_skey"], I32, (L, C, T1, S, KPC), dev)
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
    ints = [L, N, D, F, P, W, C, K, G, KPC, S, T1, Q, QS, BB, smem]
    fn = build.c_function("fantoch_atlas_partial_handle", 2 + len(tensors),
                          len(ints))
    build.launch(
        fn,
        [ctypes.addressof(ins), ctypes.addressof(outs)]
        + [t.data_ptr() for t in tensors],
        ints,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    atlas_partial_handle.launches += 1
    return rdy, new_ps, pout, hout


atlas_partial_handle.launches = 0
