"""K4 ``basic_handle``: Basic's readiness gate, periodic timer and
message handler for every (lane, process).

Replaces ``fantoch_tpu/engine/core.py`` ``run_handlers`` (:422) and the
``ready``/``periodic`` calls (:890-918) with ``BasicDev.ready/handle/
periodic`` (``protocols/basic.py:119-320``), with the safety monitors'
``mon_exec`` at the commit apply (:176-180) on monitored steps. CUDA source:
``csrc/basic_handle.cu`` (bound by bytes, :func:`work`). :func:`basic_handle_plain` is its plain PyTorch twin
(the batched handlers of ``engine/protocols/basic.py``), used for tensors
on the CPU.
"""

from __future__ import annotations

import torch

from ..engine.dims import PMT, EngineDims
from . import build, cost

I32 = torch.int32

# per-process state planes in the kernel's argument order
STATE_KEYS = (
    "seq_in_slot", "buffered_commit", "committed_cnt", "acks", "client_of",
    "own_seq", "others_frontier", "seen", "prev_stable", "m_fast_path",
    "m_stable", "err",
)
OUTBOX_KEYS = ("valid", "dst", "mtype", "payload")


def basic_handle_plain(ps, has, rows, fire, ctx, dims: EngineDims):
    """``(rdy, ps, periodic outbox, handler outbox)``."""
    from ..engine.protocols.basic import BasicDev

    return BasicDev.step_plain(
        ps, has, rows, fire, ctx["n"], ctx["quorum"], ctx["q_size"], dims
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


def work(ps, has, rows, fire, ctx, dims: EngineDims, out):
    """``(bytes, ops)`` the region needs on these inputs (``out`` is its
    result). Every (lane, process) reads its ``has`` and timer flags,
    a popped message's type, source and payload, and the state words its
    branch reads: the own seq (SUBMIT); the dot slot, buffered flag,
    source frontier, client and quorum bit (MStore, or the slot alone
    when the gate refuses it); the ack count and fast-path count
    (MStoreAck); the source frontier, slot, buffered flag and client
    (MCommit, or the frontier alone when refused); the frontiers, seen
    flags, stable clocks and the ``[N, D]`` dot slots (MGC); its own
    frontier for a firing GC timer. It writes ``rdy``, both outboxes
    and the state words that change."""
    from ..engine.protocols.basic import BasicDev as B

    rdy, new_ps, pout, hout = out
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


def basic_handle(ps, has, rows, fire, ctx, dims: EngineDims):
    """K4 on CUDA tensors, :func:`basic_handle_plain` on CPU tensors.
    The kernel's outboxes carry the planes ``valid``, ``dst``, ``mtype``
    and ``payload``; a protocol handler's ``delay``/``src`` are always
    -1, which ``emit_rewrite`` assumes."""
    if rows.device.type == "cpu":
        return basic_handle_plain(ps, has, rows, fire, ctx, dims)
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
    mon_ptrs, KM, mon_new = build.mon_planes(ps, L, N, dev)
    tensors = (
        [ps[k] for k in STATE_KEYS]
        + [has, rows, fire, ctx["n"], ctx["quorum"], ctx["q_size"], rdy]
        + [new_ps[k] for k in STATE_KEYS]
        + [pout[k] for k in OUTBOX_KEYS] + [hout[k] for k in OUTBOX_KEYS]
    )
    fn = build.c_function("fantoch_basic_handle", len(tensors) + 6, 8)
    build.launch(
        fn, [t.data_ptr() for t in tensors] + mon_ptrs,
        [L, N, D, F, P, R, W, KM],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    basic_handle.launches += 1
    return rdy, {**new_ps, **mon_new}, pout, hout


basic_handle.launches = 0
