"""K5 ``fpaxos_handle``: FPaxos's readiness gate, periodic timer and
message handler for every (lane, process).

Replaces ``fantoch_tpu/engine/core.py`` ``run_handlers`` (:422) and the
``ready``/``periodic`` calls (:890-918) with ``FPaxosDev.ready`` (:128),
``.periodic`` (:160) and ``.handle`` (:143) of
``fantoch_tpu/engine/protocols/fpaxos.py``, with the safety monitors'
``mon_exec`` at the slot executor's frontier (:282-291) on monitored
steps. CUDA source:
``csrc/fpaxos_handle.cu``, one warp per (lane, process) (bound by bytes,
:func:`work`). :func:`fpaxos_handle_plain` is its plain PyTorch twin (the
batched handlers of ``engine/protocols/fpaxos.py``), used for tensors on
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

# per-process state planes in the kernel's argument order
STATE_KEYS = (
    "last_slot", "cmd_slot", "acc_count", "acc_slot", "exec_frontier",
    "others_committed", "seen", "m_stable", "err",
)
OUTBOX_KEYS = ("valid", "dst", "mtype", "payload")


def fpaxos_handle_plain(ps, has, rows, fire, ctx, dims: EngineDims,
                        cap=None):
    """``(rdy, ps, periodic outbox, handler outbox)``, ``ps`` updated in
    place on the lanes ``cap`` lets run."""
    from ..engine.protocols.fpaxos import FPaxosDev

    return FPaxosDev.step_plain(ps, has, rows, fire, ctx, dims, cap)


def _state_shapes(L, dims: EngineDims):
    N, D = dims.N, dims.D
    return {
        "last_slot": ((L, N), I32),
        "cmd_slot": ((L, N, D), I32),
        "acc_count": ((L, N, D), I32),
        "acc_slot": ((L, N, D), I32),
        "exec_frontier": ((L, N), I32),
        "others_committed": ((L, N, N), I32),
        "seen": ((L, N, N), torch.bool),
        "m_stable": ((L, N), I32),
        "err": ((L, N), I32),
    }


def work(ps, has, rows, fire, ctx, dims: EngineDims, *rest):
    """``(bytes, ops)`` the region needs on these inputs (``ps`` a
    snapshot taken before the call, which updates it in place; the last
    argument is the call's result, one before it may be the cap). Every
    (lane, process) reads its ``has`` and timer flags, a popped message's
    type, source and payload, and the state words its
    branch reads: the leader id, own last slot and commander entry, and
    the write quorum where it leads (SUBMIT, MFORWARD); the acceptor
    entry (MAccept, also when the gate refuses it); the commander entry,
    its count and the quorum size (MAccepted); the frontier and the
    client's attach (MChosen; the frontier alone when refused); the
    frontiers, seen flags, own frontier and the ``[D]`` acceptor window
    (MGC); its frontier for a firing GC timer. It writes ``rdy``, both
    outboxes and the state words that change."""
    from ..engine.protocols.fpaxos import FPaxosDev as X

    rdy, new_ps, pout, hout = rest[-1]
    L, N, W = rows.shape
    P, D = dims.P, dims.D
    mtype = torch.where(has, rows[..., PMT], -1)
    done = has & rdy
    me = torch.arange(N, device=rows.device, dtype=I32)
    leads = me == ctx["leader"][:, None]
    handled = {
        X.MACCEPT: 4,
        X.MACCEPTED: 4 + 4 + 4,
        X.MCHOSEN: 4 + 4,
        X.MGC: 4 * N + N + 4 + 4 * D + 4,
    }
    refused = {X.MACCEPT: 4, X.MCHOSEN: 4}
    submit = done & ((mtype == X.SUBMIT) | (mtype == X.MFORWARD))
    n_gc = int((done & (mtype == X.MGC)).sum())
    read = (
        cost.nbytes(has, fire, ctx["n"])
        + 4 * (2 + P) * int(has.sum())
        + 4 * int(submit.sum()) + (4 + 4 + N) * int((submit & leads).sum())
        + sum(b * int((done & (mtype == t)).sum())
              for t, b in handled.items())
        + sum(b * int((has & ~rdy & (mtype == t)).sum())
              for t, b in refused.items())
        + 4 * int((fire[..., 0] & ~(done & (mtype == X.MGC))).sum())
    )
    write = cost.nbytes(rdy, *(ob[k] for ob in (pout, hout)
                               for k in OUTBOX_KEYS))
    for k in STATE_KEYS:
        write += int((new_ps[k] != ps[k]).sum()) * ps[k].element_size()
    ops = 30 * L * N + n_gc * (2 * D + 3 * N)
    return read + write + cost.monitor_bytes(ps, new_ps), ops


def fpaxos_handle(ps, has, rows, fire, ctx, dims: EngineDims, cap=None):
    """K5 on CUDA tensors, :func:`fpaxos_handle_plain` on CPU tensors.
    ``ps`` is updated in place on the lanes ``cap`` lets run and
    returned (the same tensors). The kernel's outboxes carry the planes
    ``valid``, ``dst``, ``mtype`` and ``payload``; a protocol handler's
    ``delay``/``src`` are always -1, which ``emit_rewrite`` assumes."""
    if rows.device.type == "cpu":
        return fpaxos_handle_plain(ps, has, rows, fire, ctx, dims, cap)
    L, N, W = rows.shape
    R = fire.shape[2]
    F, P, D = dims.F, dims.P, dims.D
    C = ctx["client_attach"].shape[1]
    dev = rows.device
    if N != dims.N or F < N + 1 or P < 3:
        raise ValueError(f"fpaxos_handle: N={N} does not fit {dims}")
    shapes = _state_shapes(L, dims)
    for k in STATE_KEYS:
        build.check(f"ps/{k}", ps[k], shapes[k][1], shapes[k][0], dev)
    build.check("has", has, torch.bool, (L, N), dev)
    build.check("rows", rows, I32, (L, N, W), dev)
    build.check("fire", fire, torch.bool, (L, N, R), dev)
    build.check("n", ctx["n"], I32, (L,), dev)
    build.check("leader", ctx["leader"], I32, (L,), dev)
    build.check("write_quorum", ctx["write_quorum"], torch.bool, (L, N), dev)
    build.check("q_size", ctx["q_size"], I32, (L,), dev)
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
    mon_ptrs, KM = build.mon_planes(ps, L, N, dev)
    tensors = (
        [has, rows, fire, ctx["n"], ctx["leader"], ctx["write_quorum"],
         ctx["q_size"], ctx["client_attach"], rdy]
        + [pout[k] for k in OUTBOX_KEYS] + [hout[k] for k in OUTBOX_KEYS]
    )
    fn = build.c_function("fantoch_fpaxos_handle", 5 + len(tensors), 10)
    build.launch(
        fn,
        [ctypes.addressof(planes), ctypes.addressof(tab)]
        + [t.data_ptr() for t in tensors] + mon_ptrs,
        [L, N, D, F, P, R, W, C, KM, cap_flags],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    fpaxos_handle.launches += 1
    return rdy, ps, pout, hout


fpaxos_handle.launches = 0
