"""K11 ``tempo_partial_handle``: Tempo's partial-replication readiness
gate, periodic timers and message handlers for every (lane, process),
with the per-shard table executor and the StableAtShard buffering.

Replaces ``fantoch_tpu/engine/core.py`` ``run_handlers`` (:422) and the
``ready``/``periodic`` calls (:890-918) with ``TempoPartialDev.ready``
(:198), ``.periodic`` (:242) and ``.handle`` (:217) of
``fantoch_tpu/engine/protocols/tempo_partial.py``: its fifteen handlers
(:441-1211), the shard helpers (:279-430), the per-shard table executor
(``_p_drain`` :1115, ``_p_execute`` :1091, ``_stable_clock_p`` :785,
``_pend_insert_p`` :820, ``_vote_add_p`` :808) and the add side of
``fantoch_tpu/engine/iset.py`` (:29, :68). CUDA source:
``csrc/tempo_partial_handle.cu`` with ``csrc/iset.cuh`` (bound by bytes,
:func:`work`). :func:`tempo_partial_handle_plain` is its plain PyTorch
twin (``TempoPartialDev.step_plain``), used for tensors on the CPU.

The process state is updated in place, on the lanes whose run predicate
holds at the step's start (``cap``, :class:`lane_freeze.Cap`; every
lane without one), and returned as the very tensors given: the step
consumes its input, a frozen lane keeps its rows (no select follows
the step), and the device loop's write-back skips them. A frozen lane's ``rdy`` is false and its
outboxes are empty.
"""

from __future__ import annotations

import ctypes

import torch

from ..engine.dims import PMT, EngineDims
from . import build, cost
from .lane_freeze import cap_args

I32 = torch.int32
THREADS = 32  # csrc/tempo_partial_handle.cu THREADS: a warp a process
# shards and keys per command thread 0 holds in registers
# (csrc/tempo_partial_handle.cu MAXS, MAXKPC)
MAX_SHARDS = MAX_KEYS_PER_CMD = 8

# per-process state planes in the kernel's order
# (csrc/tempo_partial_handle.cu Plane), the order of
# TempoPartialDev.init_state
STATE_KEYS = (
    "clocks", "det", "max_commit_clock", "seq_in_slot", "client_of",
    "cseq_of", "own_seq", "ack_cnt", "max_clock", "max_cnt", "slow_acks",
    "votes_n", "votes_by", "votes_s", "votes_e", "shag_cnt", "shag_max",
    "mbump_buf", "vote_front", "vote_gaps", "pend_clock", "pend_src",
    "pend_seq", "pend_client", "pend_cseq", "pend_kmask", "pend_missing",
    "pend_phase", "stable_cnt", "stable_cnt_seq", "buf_cnt", "buf_seq",
    "comm_front", "comm_gaps", "others_frontier", "seen", "prev_stable",
    "m_fast", "m_slow", "m_stable", "err",
)
OUTBOX_KEYS = ("valid", "dst", "mtype", "payload")
CTX_KEYS = ("n", "f", "fast_quorum", "write_quorum", "fq_size", "wq_size",
            "threshold", "clock_bump_mode", "shard_of", "closest",
            "client_attach_s", "cmd_kmask", "cmd_skey")


def _protocol(ps, ctx):
    """The TempoPartialDev whose tables ``ps`` and ``ctx`` hold."""
    from ..engine.protocols.tempo_partial import TempoPartialDev

    K, R = ps["det"].shape[2:4]
    return TempoPartialDev(
        keys=K, shards=ctx["closest"].shape[2],
        keys_per_cmd=ps["votes_s"].shape[4],
        pending_per_key=ps["pend_clock"].shape[3], detached_slots=R,
        gap_slots=ps["comm_gaps"].shape[3],
    )


def tempo_partial_handle_plain(ps, has, rows, fire, now, ctx,
                               dims: EngineDims, cap=None):
    """``(rdy, ps, periodic outbox, handler outbox)``, ``ps`` updated in
    place on the lanes ``cap`` lets run."""
    return _protocol(ps, ctx).step_plain(ps, has, rows, fire, now, ctx,
                                         dims, cap)


def _state_shapes(L, dims: EngineDims, K, PK, DS, G, KPC):
    N, D, C = dims.N, dims.D, dims.C
    shapes = {
        "clocks": (L, N, K), "det": (L, N, K, DS, 2),
        "votes_by": (L, N, N, D, N), "votes_s": (L, N, N, D, KPC, N),
        "votes_e": (L, N, N, D, KPC, N), "shag_cnt": (L, N, D),
        "shag_max": (L, N, D), "vote_front": (L, N, K, N),
        "vote_gaps": (L, N, K, N, G, 2), "stable_cnt": (L, N, C),
        "stable_cnt_seq": (L, N, C), "buf_cnt": (L, N, K, C),
        "buf_seq": (L, N, K, C), "comm_front": (L, N, N),
        "comm_gaps": (L, N, N, G, 2), "others_frontier": (L, N, N, N),
        "seen": (L, N, N), "prev_stable": (L, N, N),
    }
    for k in ("seq_in_slot", "client_of", "cseq_of", "ack_cnt", "max_clock",
              "max_cnt", "slow_acks", "votes_n", "mbump_buf"):
        shapes[k] = (L, N, N, D)
    for k in STATE_KEYS:
        if k.startswith("pend_"):
            shapes[k] = (L, N, K, PK)
    for k in ("max_commit_clock", "own_seq", "m_fast", "m_slow", "m_stable",
              "err"):
        shapes[k] = (L, N)
    return {k: (shapes[k], torch.bool if k == "seen" else I32)
            for k in STATE_KEYS}


def work(ps, has, rows, fire, now, ctx, dims: EngineDims, *rest):
    """``(bytes, ops)`` the region needs on these inputs (``ps`` a snapshot
    taken before the call, which updates it in place; the last argument is
    the call's result, one before it may be the cap). Every (lane, process)
    reads its ``has`` flag, timer flags and event time, a popped message's
    type, source and payload, and the state and ctx words its branch reads:
    a dot's cell and counters, the command's table row (mask and keys), the
    local keys' clocks and detached rows, and for the branches that reach
    them the dot's votes (MCollectAck, MConsensusAck and MShardAgg read the
    ``[KPC, N]`` rows), the voters' frontiers and gap sets of the local keys
    and a pending table per key (MCommit), a key's pending table and
    frontiers (the drains), the frontier table and the ``[N, D]`` dot words
    (MGC), the detached table (DETACH_DRAIN). A firing GC timer reads the
    committed clock; a clock bump the keys' clocks and detached table; a
    detached kick-off the detached table. It writes ``rdy``, both outboxes
    and the state words that change."""
    from ..engine.protocols.tempo_partial import TempoPartialDev as X

    rdy, new_ps, pout, hout = rest[-1]
    L, N, W = rows.shape
    P, D = dims.P, dims.D
    K, DS = ps["det"].shape[2:4]
    PK, G = ps["pend_clock"].shape[3], ps["comm_gaps"].shape[3]
    KPC = ps["votes_s"].shape[4]
    S = ctx["closest"].shape[2]
    mtype = torch.where(has, rows[..., PMT], -1)
    done = has & rdy
    keys = KPC * 4 * (1 + 2 * DS)            # clock + detached row per key
    cmd = 4 * (1 + S * KPC)                  # the command's table row
    dot = 4 * 4                              # a dot's cell, client, cseq
    votes = 4 * (1 + N + 2 * KPC * N)
    pend = 4 * 8 * PK
    drain = 4 * (N + pend // 4 + 4) + cmd
    handled = {
        X.SUBMIT: 4 * 3 + cmd + keys,
        X.MFWDSUBMIT: cmd + keys,
        X.MCOLLECT: dot + 4 + cmd + keys,
        X.MBUMP: dot + cmd + keys,
        X.MCOLLECTACK: dot + 4 * 4 + votes + cmd + keys + N,
        X.MCOMMIT: (dot + cmd + keys + 4 * 2 * (1 + 2 * G)
                    + KPC * (4 * N * (1 + 2 * G) + pend)),
        X.MDETACHED: 4 * (1 + 2 * G) + drain,
        X.MCONSENSUS: dot + cmd + keys,
        X.MCONSENSUSACK: dot + 4 * 2 + votes + cmd,
        X.MGC: 4 * N * N + N + 4 * 2 * N + 4 * N * D,
        X.MDRAIN: drain,
        X.DETACH_DRAIN: 4 * K * DS * 2,
        X.MSHARDCOMMIT: 4 * 4 + cmd,
        X.MSHARDAGG: dot + votes,
        X.STABLEAT: pend + 4 * 2,
    }
    gated = (X.MCOLLECT, X.MCOMMIT, X.MCONSENSUS, X.MSHARDAGG,
             X.MSHARDCOMMIT)
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
        + (count[X.MCOMMIT] * KPC * N + count[X.MDETACHED] * (P - 2) // 2)
        * 4 * G * G
        + (count[X.MDETACHED] + count[X.MDRAIN]) * (N * N + 8 * PK)
        + count[X.STABLEAT] * 4 * PK
        + count[X.DETACH_DRAIN] * 2 * K * DS
        + int(fire[..., 1].sum()) * K * DS
    )
    return read + write, ops


def tempo_partial_handle(ps, has, rows, fire, now, ctx, dims: EngineDims,
                         cap=None):
    """K11 on CUDA tensors, :func:`tempo_partial_handle_plain` on CPU
    tensors. ``now`` ``[L, N]`` is each process's event time (the clock
    bump reads it). ``ps`` is updated in place on the lanes ``cap`` lets
    run and returned (the same tensors). The kernel's outboxes carry the planes ``valid``,
    ``dst``, ``mtype`` and ``payload``; a protocol handler's
    ``delay``/``src`` are always -1, which ``emit_rewrite`` assumes."""
    if rows.device.type == "cpu":
        return tempo_partial_handle_plain(ps, has, rows, fire, now, ctx,
                                          dims, cap)
    L, N, W = rows.shape
    R = fire.shape[2]
    F, P, D, C = dims.F, dims.P, dims.D, dims.C
    K, DS = ps["det"].shape[2:4]
    PK, G = ps["pend_clock"].shape[3], ps["comm_gaps"].shape[3]
    KPC = ps["votes_s"].shape[4]
    S = ctx["closest"].shape[2]
    T1 = ctx["cmd_kmask"].shape[2]
    dev = rows.device
    if (N != dims.N or R != 3 or F < max(N + S + 2, 3 + S * KPC)
            or P < 6 + N + 2 * KPC * N or S > MAX_SHARDS
            or KPC > MAX_KEYS_PER_CMD):
        raise ValueError(
            f"tempo_partial_handle: N={N}, S={S}, KPC={KPC} do not fit "
            f"{dims}")
    shapes = _state_shapes(L, dims, K, PK, DS, G, KPC)
    for k in STATE_KEYS:
        build.check(f"ps/{k}", ps[k], shapes[k][1], shapes[k][0], dev)
    build.check("has", has, torch.bool, (L, N), dev)
    build.check("rows", rows, I32, (L, N, W), dev)
    build.check("fire", fire, torch.bool, (L, N, R), dev)
    build.check("now", now, I32, (L, N), dev)
    for k in ("n", "f", "fq_size", "wq_size", "threshold"):
        build.check(k, ctx[k], I32, (L,), dev)
    build.check("clock_bump_mode", ctx["clock_bump_mode"], torch.bool, (L,),
                dev)
    for k in ("fast_quorum", "write_quorum"):
        build.check(k, ctx[k], torch.bool, (L, N, N), dev)
    build.check("shard_of", ctx["shard_of"], I32, (L, N), dev)
    build.check("closest", ctx["closest"], I32, (L, N, S), dev)
    build.check("client_attach_s", ctx["client_attach_s"], I32, (L, C, S),
                dev)
    build.check("cmd_kmask", ctx["cmd_kmask"], I32, (L, C, T1), dev)
    build.check("cmd_skey", ctx["cmd_skey"], I32, (L, C, T1, S, KPC), dev)
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
    fn = build.c_function("fantoch_tempo_partial_handle", 2 + len(tensors),
                          15)
    build.launch(
        fn,
        [ctypes.addressof(planes), ctypes.addressof(tab)]
        + [t.data_ptr() for t in tensors],
        [L, N, D, F, P, W, C, K, PK, DS, G, KPC, S, T1, cap_flags],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    tempo_partial_handle.launches += 1
    return rdy, ps, pout, hout


tempo_partial_handle.launches = 0
