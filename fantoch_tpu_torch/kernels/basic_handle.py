"""K4 ``basic_handle``: Basic's readiness gate, periodic timer and
message handler for every (lane, process).

Replaces ``fantoch_tpu/engine/core.py`` ``run_handlers`` (:422) and the
``ready``/``periodic`` calls (:890-918) with ``BasicDev.ready/handle/
periodic`` (``protocols/basic.py:119-320``), with the safety monitors'
``mon_exec`` at the commit apply (:176-180) on monitored steps. CUDA
source: ``csrc/basic_handle.cu``, one warp per (lane, process) (bound by
bytes, :func:`work`). :func:`basic_handle_plain` is its plain PyTorch
twin (the batched handlers of ``engine/protocols/basic.py``), used for
tensors on the CPU.

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

# per-process state planes in the kernel's argument order
STATE_KEYS = (
    "seq_in_slot", "buffered_commit", "committed_cnt", "acks", "client_of",
    "own_seq", "others_frontier", "seen", "prev_stable", "m_fast_path",
    "m_stable", "err",
)
OUTBOX_KEYS = ("valid", "dst", "mtype", "payload")


def basic_handle_plain(ps, has, rows, fire, ctx, dims: EngineDims,
                       cap=None):
    """``(rdy, ps, periodic outbox, handler outbox)``, ``ps`` updated in
    place on the lanes ``cap`` lets run."""
    from ..engine.protocols.basic import BasicDev

    return BasicDev.step_plain(
        ps, has, rows, fire, ctx["n"], ctx["quorum"], ctx["q_size"], dims,
        cap,
    )


def _state_shapes(L, dims: EngineDims):
    N, D = dims.N, dims.D
    return {
        "seq_in_slot": ((L, N, N, D), I32),
        "buffered_commit": ((L, N, N, D), torch.bool),
        "committed_cnt": ((L, N, N), I32),
        "acks": ((L, N, D), I32),
        "client_of": ((L, N, D), I32),
        "own_seq": ((L, N), I32),
        "others_frontier": ((L, N, N, N), I32),
        "seen": ((L, N, N), torch.bool),
        "prev_stable": ((L, N, N), I32),
        "m_fast_path": ((L, N), I32),
        "m_stable": ((L, N), I32),
        "err": ((L, N), I32),
    }


def work(ps, has, rows, fire, ctx, dims: EngineDims, *rest):
    """``(bytes, ops)`` the region needs on these inputs (``ps`` a snapshot
    taken before the call, which updates it in place; the last argument is
    the call's result, one before it may be the cap). Every (lane, process)
    reads its ``has`` and timer flags, a popped message's type, source and
    payload, and the state words its branch reads: the own seq (SUBMIT); the
    dot slot, buffered flag, source frontier, client and quorum bit (MStore,
    or the slot alone when the gate refuses it); the ack count and fast-path
    count (MStoreAck); the source frontier, slot, buffered flag and client
    (MCommit, or the frontier alone when refused); the frontiers, seen
    flags, stable clocks and the ``[N, D]`` dot slots (MGC); its own
    frontier for a firing GC timer. It writes ``rdy``, both outboxes and the
    state words that change."""
    from ..engine.protocols.basic import BasicDev as B

    rdy, new_ps, pout, hout = rest[-1]
    L, N, W = rows.shape
    P, D = dims.P, dims.D
    mtype = torch.where(has, rows[..., PMT], -1)
    done = has & rdy
    handled = {
        B.SUBMIT: 4,
        B.MSTORE: 4 + 1 + 4 + 4 + 1,
        B.MSTOREACK: 4 + 4,
        B.MCOMMIT: 4 + 4 + 1 + 4,
        B.MGC: 4 * N * N + N + 4 * N + 4 * N + 4 + 4 * N * D,
    }
    refused = {B.MSTORE: 4, B.MCOMMIT: 4}
    n_gc = int((done & (mtype == B.MGC)).sum())
    read = (
        cost.nbytes(has, fire, ctx["n"], ctx["q_size"])
        + 4 * (2 + P) * int(has.sum())
        + sum(b * int((done & (mtype == t)).sum())
              for t, b in handled.items())
        + sum(b * int((has & ~rdy & (mtype == t)).sum())
              for t, b in refused.items())
        + 4 * N * int((fire[..., 0] & ~(done & (mtype == B.MGC))).sum())
    )
    write = cost.nbytes(rdy, *(ob[k] for ob in (pout, hout)
                               for k in OUTBOX_KEYS))
    for k in STATE_KEYS:
        write += int((new_ps[k] != ps[k]).sum()) * ps[k].element_size()
    ops = 30 * L * N + n_gc * (2 * N * D + 3 * N * N)
    return read + write + cost.monitor_bytes(ps, new_ps), ops


def basic_handle(ps, has, rows, fire, ctx, dims: EngineDims, cap=None):
    """K4 on CUDA tensors, :func:`basic_handle_plain` on CPU tensors.
    ``ps`` is updated in place on the lanes ``cap`` lets run and
    returned (the same tensors). The kernel's outboxes carry the planes
    ``valid``, ``dst``, ``mtype`` and ``payload``; a protocol handler's
    ``delay``/``src`` are always -1, which ``emit_rewrite`` assumes."""
    if rows.device.type == "cpu":
        return basic_handle_plain(ps, has, rows, fire, ctx, dims, cap)
    L, N, W = rows.shape
    R = fire.shape[2]
    F, P, D = dims.F, dims.P, dims.D
    dev = rows.device
    if N != dims.N or P < N:
        raise ValueError(f"basic_handle: N={N}, P={P} do not fit {dims}")
    shapes = _state_shapes(L, dims)
    for k in STATE_KEYS:
        build.check(f"ps/{k}", ps[k], shapes[k][1], shapes[k][0], dev)
    build.check("has", has, torch.bool, (L, N), dev)
    build.check("rows", rows, I32, (L, N, W), dev)
    build.check("fire", fire, torch.bool, (L, N, R), dev)
    build.check("n", ctx["n"], I32, (L,), dev)
    build.check("quorum", ctx["quorum"], torch.bool, (L, N, N), dev)
    build.check("q_size", ctx["q_size"], I32, (L,), dev)
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
        [has, rows, fire, ctx["n"], ctx["quorum"], ctx["q_size"], rdy]
        + [pout[k] for k in OUTBOX_KEYS] + [hout[k] for k in OUTBOX_KEYS]
    )
    mon_ptrs, KM = build.mon_planes(ps, L, N, dev)
    fn = build.c_function("fantoch_basic_handle", 5 + len(tensors), 9)
    build.launch(
        fn,
        [ctypes.addressof(planes), ctypes.addressof(tab)]
        + [t.data_ptr() for t in tensors] + mon_ptrs,
        [L, N, D, F, P, R, W, KM, cap_flags],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    basic_handle.launches += 1
    return rdy, ps, pout, hout


basic_handle.launches = 0
