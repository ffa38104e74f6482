"""K8 ``tempo_handle``: Tempo's readiness gate, periodic timers and
message handlers for every (lane, process), with the table executor's
interval sets and drain.

Replaces ``fantoch_tpu/engine/core.py`` ``run_handlers`` (:422) and the
``ready``/``periodic`` calls (:890-918) with ``TempoDev.ready`` (:226),
``.periodic`` (:266) and ``.handle`` (:246) of
``fantoch_tpu/engine/protocols/tempo.py``: its ten handlers (:498-941),
the clock, vote and drain helpers (:308-490) and the add side of
``fantoch_tpu/engine/iset.py`` (:29, :68), and on monitored steps the
safety monitors' ``mon_exec`` in the drain (:434-453). CUDA source:
``csrc/tempo_handle.cu`` with ``csrc/iset.cuh`` (bound by bytes,
:func:`work`). :func:`tempo_handle_plain` is its plain PyTorch twin (the
batched handlers of ``engine/protocols/tempo.py``), used for tensors on
the CPU.

The process state (with the monitor planes) is updated in place, on
the lanes whose run predicate holds at the step's start (``cap``,
:class:`lane_freeze.Cap`; every lane without one), and returned as the
very tensors given: the step consumes its input, a frozen lane keeps
its rows (no select follows the step), and the device loop's
write-back skips them. A frozen
lane's ``rdy`` is false and its outboxes are empty.
"""

from __future__ import annotations

import ctypes

import torch

from ..engine.dims import PMT, EngineDims
from . import build, cost
from .lane_freeze import cap_args

I32 = torch.int32

# per-process state planes in the kernel's order (csrc/tempo_handle.cu
# Plane), the order of TempoDev.init_state
STATE_KEYS = (
    "clocks", "det", "max_commit_clock", "seq_in_slot", "key_of",
    "client_of", "own_seq", "ack_cnt", "max_clock", "max_cnt", "slow_acks",
    "votes_n", "votes_by", "votes_s", "votes_e", "vote_front", "vote_gaps",
    "pend_clock", "pend_src", "pend_seq", "pend_client", "comm_front",
    "comm_gaps", "others_frontier", "seen", "prev_stable", "m_fast",
    "m_slow", "m_stable", "err",
)
OUTBOX_KEYS = ("valid", "dst", "mtype", "payload")
CTX_KEYS = ("n", "f", "fast_quorum", "write_quorum", "fq_size", "wq_size",
            "threshold", "clock_bump_mode", "skip_fast_ack", "client_attach")


def _protocol(ps, skip_capable: bool):
    """The TempoDev whose tables ``ps`` holds."""
    from ..engine.protocols.tempo import TempoDev

    K, R = ps["det"].shape[2:4]
    return TempoDev(keys=K, pending_per_key=ps["pend_clock"].shape[3],
                    detached_slots=R, gap_slots=ps["comm_gaps"].shape[3],
                    skip_capable=skip_capable)


def tempo_handle_plain(ps, has, rows, fire, now, ctx, dims: EngineDims,
                       skip_capable: bool, cap=None):
    """``(rdy, ps, periodic outbox, handler outbox)``, ``ps`` updated in
    place on the lanes ``cap`` lets run."""
    return _protocol(ps, skip_capable).step_plain(ps, has, rows, fire, now,
                                                  ctx, dims, cap)


def _state_shapes(L, dims: EngineDims, K, PK, DS, G):
    N, D = dims.N, dims.D
    shapes = {
        "clocks": (L, N, K), "det": (L, N, K, DS, 2),
        "seq_in_slot": (L, N, N, D), "key_of": (L, N, N, D),
        "client_of": (L, N, N, D),
        "votes_by": (L, N, D, N), "votes_s": (L, N, D, N),
        "votes_e": (L, N, D, N), "vote_front": (L, N, K, N),
        "vote_gaps": (L, N, K, N, G, 2), "comm_front": (L, N, N),
        "comm_gaps": (L, N, N, G, 2), "others_frontier": (L, N, N, N),
        "seen": (L, N, N), "prev_stable": (L, N, N),
    }
    for k in ("ack_cnt", "max_clock", "max_cnt", "slow_acks", "votes_n"):
        shapes[k] = (L, N, D)
    for k in ("pend_clock", "pend_src", "pend_seq", "pend_client"):
        shapes[k] = (L, N, K, PK)
    for k in ("max_commit_clock", "own_seq", "m_fast", "m_slow", "m_stable",
              "err"):
        shapes[k] = (L, N)
    return {k: (shapes[k], torch.bool if k == "seen" else I32)
            for k in STATE_KEYS}


def work(ps, has, rows, fire, now, ctx, dims: EngineDims,
         skip_capable: bool, *rest):
    """``(bytes, ops)`` the region needs on these inputs (``ps`` a
    snapshot taken before the call, which updates it in place; the last
    argument is the call's result, one before it may be the cap). Every
    (lane, process) reads its ``has`` flag, timer flags
    and event time, a popped message's type, source and payload, and the
    state words its branch reads: the gated types one dot word; SUBMIT
    its sequence and the key's clock; MCollect the dot word, the clock
    and its quorum flag; MCollectAck the dot's quorum counters, key,
    client and votes, the key's clock and detached row, the quorum sizes
    and its write-quorum row; MCommit the dot word, the key's clock,
    detached row, voter frontiers and gap sets, the pending table of the
    key and the source's committed set, then the drain; MDetached the
    (key, voter) set and the drain; MConsensus the dot's key and word,
    the clock and detached row; MConsensusAck the dot's counters and
    votes; MGC the frontier table, seen flags, committed and stable
    clocks and the ``[N, D]`` dot words; MDrain the drain (the key's
    voter frontiers and pending table); DETACH_DRAIN the detached
    table. A firing GC timer reads the committed clock; a clock bump the
    keys' clocks and detached table; a detached kick-off the detached
    table. It writes ``rdy``, both outboxes and the state words that
    change."""
    from ..engine.protocols.tempo import TempoDev as X

    rdy, new_ps, pout, hout = rest[-1]
    L, N, W = rows.shape
    P, D = dims.P, dims.D
    K, DS = ps["det"].shape[2:4]
    PK, G = ps["pend_clock"].shape[3], ps["comm_gaps"].shape[3]
    mtype = torch.where(has, rows[..., PMT], -1)
    done = has & rdy
    det_row = 4 * (1 + 2 * DS)                       # clock + detached row
    drain = 4 * (N + 4 * PK + 1)                     # fronts, pending, attach
    handled = {
        X.SUBMIT: 4 * 2,
        X.MCOLLECT: 4 * 2 + 1,
        X.MCOLLECTACK: 4 * (6 + 3 * N + 3) + N + det_row,
        X.MCOMMIT: 4 * (2 + N * (1 + 2 * G) + 1 + 2 * G) + det_row + drain,
        X.MDETACHED: 4 * (1 + 2 * G) + drain,
        X.MCONSENSUS: 4 * 2 + det_row,
        X.MCONSENSUSACK: 4 * (5 + 3 * N + 1),
        X.MGC: 4 * N * N + N + 4 * 2 * N + 4 * N * D,
        X.MDRAIN: drain,
        X.DETACH_DRAIN: 4 * K * DS * 2,
    }
    gated = (X.MCOLLECT, X.MCOMMIT, X.MCONSENSUS)
    count = {t: int((done & (mtype == t)).sum()) for t in handled}
    read = (
        cost.nbytes(has, fire, now)
        + 4 * (2 + P) * int(has.sum())
        + sum(b * count[t] for t, b in handled.items())
        + sum(4 * int((has & ~rdy & (mtype == t)).sum()) for t in gated)
        + 4 * N * int(fire[..., 0].sum())
        + (4 * (1 + K) + 4 * K * DS * 2) * int(fire[..., 1].sum())
        + 4 * K * DS * int(fire[..., 2].sum())
    )
    write = cost.nbytes(rdy, *(ob[k] for ob in (pout, hout)
                               for k in OUTBOX_KEYS))
    for k in STATE_KEYS:
        write += int((new_ps[k] != ps[k]).sum()) * ps[k].element_size()
    ops = (
        40 * L * N
        + count[X.MGC] * (2 * N * D + 3 * N * N)
        + (count[X.MCOMMIT] * N + count[X.MDETACHED] * (P - 2) // 2)
        * 4 * G * G
        + (count[X.MCOMMIT] + count[X.MDETACHED] + count[X.MDRAIN])
        * (N * N + 6 * PK)
        + count[X.DETACH_DRAIN] * 2 * K * DS
        + int(fire[..., 1].sum()) * K * DS
    )
    return read + write + cost.monitor_bytes(ps, new_ps), ops


def tempo_handle(ps, has, rows, fire, now, ctx, dims: EngineDims,
                 skip_capable: bool, cap=None):
    """K8 on CUDA tensors, :func:`tempo_handle_plain` on CPU tensors.
    ``now`` ``[L, N]`` is each process's event time (the clock bump
    reads it); ``skip_capable`` gates the skip_fast_ack paths, which then
    run on the lanes whose ``ctx["skip_fast_ack"]`` holds. ``ps`` is
    updated in place on the lanes ``cap`` lets run and returned (the
    same tensors). The kernel's outboxes carry the planes ``valid``,
    ``dst``, ``mtype`` and ``payload``; a protocol handler's
    ``delay``/``src`` are always -1, which ``emit_rewrite`` assumes."""
    if rows.device.type == "cpu":
        return tempo_handle_plain(ps, has, rows, fire, now, ctx, dims,
                                  skip_capable, cap)
    L, N, W = rows.shape
    R = fire.shape[2]
    F, P, D = dims.F, dims.P, dims.D
    C = ctx["client_attach"].shape[1]
    K, DS = ps["det"].shape[2:4]
    PK, G = ps["pend_clock"].shape[3], ps["comm_gaps"].shape[3]
    dev = rows.device
    if N != dims.N or N > 32 or F < max(N + 1, 2) or P < max(6 + 3 * N, 12):
        raise ValueError(f"tempo_handle: N={N} does not fit {dims}")
    shapes = _state_shapes(L, dims, K, PK, DS, G)
    for k in STATE_KEYS:
        build.check(f"ps/{k}", ps[k], shapes[k][1], shapes[k][0], dev)
    build.check("has", has, torch.bool, (L, N), dev)
    build.check("rows", rows, I32, (L, N, W), dev)
    build.check("fire", fire, torch.bool, (L, N, R), dev)
    build.check("now", now, I32, (L, N), dev)
    for k in ("n", "f", "fq_size", "wq_size", "threshold"):
        build.check(k, ctx[k], I32, (L,), dev)
    for k in ("clock_bump_mode", "skip_fast_ack"):
        build.check(k, ctx[k], torch.bool, (L,), dev)
    for k in ("fast_quorum", "write_quorum"):
        build.check(k, ctx[k], torch.bool, (L, N, N), dev)
    build.check("client_attach", ctx["client_attach"], I32, (L, C), dev)
    rdy = torch.empty((L, N), dtype=torch.bool, device=dev)

    def outbox():
        return {
            "valid": torch.empty((L, N, F), dtype=torch.bool, device=dev),
            "dst": torch.empty((L, N, F), dtype=I32, device=dev),
            "mtype": torch.empty((L, N, F), dtype=I32, device=dev),
            "payload": torch.empty((L, N, F, P), dtype=I32, device=dev),
        }

    pout, hout = outbox(), outbox()
    planes = (ctypes.c_void_p * len(STATE_KEYS))(
        *[ps[k].data_ptr() for k in STATE_KEYS])
    tab, cap_flags = cap_args(cap, L, dev)
    tensors = (
        [has, rows, fire, now] + [ctx[k] for k in CTX_KEYS] + [rdy]
        + [pout[k] for k in OUTBOX_KEYS] + [hout[k] for k in OUTBOX_KEYS]
    )
    mon_ptrs, KM = build.mon_planes(ps, L, N, dev)
    fn = build.c_function("fantoch_tempo_handle", 5 + len(tensors), 15)
    build.launch(
        fn,
        [ctypes.addressof(planes), ctypes.addressof(tab)]
        + [t.data_ptr() for t in tensors] + mon_ptrs,
        [L, N, D, F, P, R, W, C, K, PK, DS, G, int(bool(skip_capable)), KM,
         cap_flags],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    tempo_handle.launches += 1
    return rdy, ps, pout, hout


tempo_handle.launches = 0
