"""Device twin of FPaxos (fantoch_ps/src/protocol/fpaxos.rs), batched over
``[L, N]`` (lane, process): the counterpart of the reference's
``fantoch_tpu/engine/protocols/fpaxos.py``.

Semantics: submits at non-leaders forward to the leader; the leader
assigns the next slot and sends ``MAccept`` to the f+1 write quorum; on
exactly f+1 ``MAccepted`` the slot is chosen and broadcast; every process
executes slots in order (a frontier counter: with constant per-pair
delays the leader's ``MChosen`` stream arrives in slot order) and the
process a client is attached to reports the result. Stable slots are
freed by the committed-frontier exchange (synod/gc.rs). Slots live in a
window of D recycled entries; a dirty entry raises ``ERR_DOT``.

State (per process): ``last_slot``, the commander window ``cmd_slot``/
``acc_count [D]`` (``cmd_slot`` 0 = free), the acceptor window
``acc_slot [D]``, ``exec_frontier``, and the GC tracker
``others_committed``/``seen [N]``.

:meth:`FPaxosDev.ready_plain`, :meth:`FPaxosDev.periodic_plain` and
:meth:`FPaxosDev.handle_plain` are the plain PyTorch twin of the
``fpaxos_handle`` CUDA kernel (``kernels/fpaxos_handle.py``): like the
reference's ``lax.switch`` under ``vmap`` the twin computes every branch
and selects one with masks; the kernel runs only the branch of each
(lane, process).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core import emit, emit_broadcast, empty_outbox, write_running
from ..dims import (
    ERR_DOT, ERR_PROTO, INF, PMT, PPAY, PSRC, EngineDims, dot_slot,
)
from ..monitor import mon_exec
from .identity import DevIdentity
from .masked import put, select, take

I32 = torch.int32


class FPaxosDev(DevIdentity):
    SUBMIT = 0
    MFORWARD = 1
    MACCEPT = 2
    MACCEPTED = 3
    MCHOSEN = 4
    MGC = 5
    NUM_TYPES = 6
    TO_CLIENT = 7

    PERIODIC_ROWS = 1  # garbage collection
    MONITORED = True  # mon_exec hook at the slot executor's frontier

    # -- host-side builders -------------------------------------------

    @staticmethod
    def payload_width(n: int) -> int:
        return 3  # [slot, client, key]

    @staticmethod
    def periodic_intervals(config, dims: EngineDims):
        gc = config.gc_interval_ms
        return [gc if gc is not None else INF]

    @staticmethod
    def min_live(config) -> int:
        """f+1 write-quorum members (the leader included). A crashed
        leader is not unavailability: it halts every client (no election
        is modelled, engine/faults.py)."""
        return config.fpaxos_quorum_size()

    @staticmethod
    def lane_ctx(config, dims: EngineDims, sorted_idx: np.ndarray):
        """Write quorum = first f+1 processes in the leader's discovery
        order (fpaxos_quorum_size, config.rs:270-272)."""
        assert config.leader is not None, "FPaxos needs an initial leader"
        leader = config.leader - 1  # ids are 1-based, device is 0-based
        q = config.fpaxos_quorum_size()
        wq = np.zeros((dims.N,), bool)
        for member in sorted_idx[leader][:q]:
            wq[member] = True
        return {
            "leader": np.int32(leader),
            "write_quorum": wq,
            "q_size": np.int32(q),
        }

    @staticmethod
    def init_state(dims: EngineDims, ctx_np) -> Dict[str, np.ndarray]:
        N, D = dims.N, dims.D
        return {
            "last_slot": np.zeros((N,), np.int32),
            "cmd_slot": np.zeros((N, D), np.int32),
            "acc_count": np.zeros((N, D), np.int32),
            "acc_slot": np.zeros((N, D), np.int32),
            "exec_frontier": np.zeros((N,), np.int32),
            "others_committed": np.zeros((N, N), np.int32),
            "seen": np.zeros((N, N), bool),
            "m_stable": np.zeros((N,), np.int32),
            "err": np.zeros((N,), np.int32),
        }

    @staticmethod
    def error(ps):
        return ps["err"]

    @staticmethod
    def metrics(ps_np) -> Dict[str, np.ndarray]:
        return {"stable": ps_np["m_stable"]}

    # -- the handler step ----------------------------------------------

    @staticmethod
    def handlers(ps, has, rows, fire, ep, ctx, dims: EngineDims,
                 cap=None):
        """Readiness gate, periodic timer and message handler of every
        (lane, process): ``(rdy, ps, periodic outbox, handler outbox)``
        (the event times ``ep`` are not read). ``ps`` is updated in
        place on the lanes ``cap`` lets run (every lane without one) and
        returned as the same tensors. Runs the ``fpaxos_handle`` kernel
        on CUDA tensors."""
        from ...kernels.fpaxos_handle import fpaxos_handle

        return fpaxos_handle(ps, has, rows, fire, ctx, dims, cap)

    @staticmethod
    def step_plain(ps, has, rows, fire, ctx, dims: EngineDims, cap=None):
        """The plain twin of the kernel, in the reference's order
        (core.py:890-918): ``ready`` on the incoming state, ``periodic``,
        then ``handle`` on the state ``periodic`` returned, out of place;
        then the running lanes' rows (of ``cap``; every lane without
        one) are copied into ``ps``, in place, as the kernel writes them
        (``core.write_running``)."""
        none = torch.full_like(rows[..., PMT], FPaxosDev.NUM_TYPES)
        mtype0 = torch.where(has, rows[..., PMT], none)
        rdy = FPaxosDev.ready_plain(ps, rows, mtype0, dims)
        valid = has & rdy
        mtype = torch.where(valid, mtype0, none)
        pout = FPaxosDev.periodic_plain(ps, fire, ctx["n"], dims)
        new, hout = FPaxosDev.handle_plain(ps, valid, mtype, rows, ctx, dims)
        return write_running(ps, (rdy, new, pout, hout), cap, dims)

    @staticmethod
    def ready_plain(ps, rows, mtype, dims: EngineDims):
        """MAccept needs a free acceptor window entry; MChosen executes
        in slot order (executor/slot.rs:17-69)."""
        slot = rows[..., PPAY]
        free = take(ps["acc_slot"], dot_slot(slot, dims.D)) == 0
        ok = torch.where(mtype == FPaxosDev.MACCEPT, free,
                         torch.ones_like(free))
        in_order = slot == ps["exec_frontier"] + 1
        return torch.where(mtype == FPaxosDev.MCHOSEN, in_order, ok)

    @staticmethod
    def periodic_plain(ps, fire, n, dims: EngineDims):
        """GARBAGE_COLLECTION: broadcast my committed (== executed)
        frontier to all-but-me (fpaxos.rs:343-357)."""
        L, N = fire.shape[:2]
        me = torch.arange(N, device=fire.device, dtype=I32).expand(L, N)
        frontier = ps["exec_frontier"]
        zero = torch.zeros_like(frontier)
        ob = emit_broadcast(
            empty_outbox(dims, (L, N), fire.device), FPaxosDev.MGC,
            torch.stack([frontier, zero, zero], -1), n, me, exclude_me=True,
        )
        ob["valid"] = ob["valid"] & fire[..., 0:1]
        return ob

    @staticmethod
    def handle_plain(ps, valid, mtype, rows, ctx, dims: EngineDims):
        """Every branch of the message switch, selected by type."""
        L, N, D, F = valid.shape[0], dims.N, dims.D, dims.F
        dev = valid.device
        n = ctx["n"]
        me = torch.arange(N, device=dev, dtype=I32).expand(L, N)
        src, pay = rows[..., PSRC], rows[..., PPAY:]
        p0, p1, p2 = pay[..., 0], pay[..., 1], pay[..., 2]
        zero = torch.zeros_like(p0)
        idx = mtype.clamp(0, FPaxosDev.NUM_TYPES)
        zero_ob = empty_outbox(dims, (L, N), dev)

        # 0/1 SUBMIT, MFORWARD: a non-leader forwards to the leader; the
        # leader takes the next slot, spawns its commander and sends
        # MAccept to the write quorum (fpaxos.rs:165-238)
        leader = ctx["leader"][:, None].expand(L, N)
        is_leader = me == leader
        do = valid & is_leader
        slot0 = ps["last_slot"] + 1
        ix0 = dot_slot(slot0, D)
        dirty0 = take(ps["cmd_slot"], ix0) != 0
        park = torch.where(do, ix0, torch.full_like(ix0, D))
        st0 = dict(
            ps,
            err=ps["err"] | ERR_DOT * (do & dirty0).to(I32),
            last_slot=torch.where(do, slot0, ps["last_slot"]),
            cmd_slot=put(ps["cmd_slot"], park, slot0),
            acc_count=put(ps["acc_count"], park, zero),
        )
        # outbox slot 0 forwards [client, 0, key]; slots 1..N are the
        # MAccept fan-out masked to the write quorum (F >= N + 1)
        ob0 = emit(zero_ob, 0, leader, FPaxosDev.MFORWARD,
                   torch.stack([p0, zero, p2], -1), valid & ~is_leader)
        procs = torch.arange(N, device=dev, dtype=I32)
        fan = (
            do[..., None] & ctx["write_quorum"][:, None, :]
            & (procs < n[:, None])[:, None, :]
        )                                                     # [L, N, N]
        ob0["valid"][..., 1:N + 1] = fan
        ob0["dst"][..., 1:N + 1] = procs
        ob0["mtype"][..., 1:N + 1] = FPaxosDev.MACCEPT
        ob0["payload"][..., 1:N + 1, :3] = torch.stack(
            [slot0, p0, p2], -1
        )[..., None, :]

        # 2 MACCEPT: the acceptor stores the slot and replies MAccepted
        # to the sender (fpaxos.rs:240-262)
        ix2 = dot_slot(p0, D)
        dirty2 = take(ps["acc_slot"], ix2) != 0
        st2 = dict(
            ps,
            err=ps["err"] | ERR_DOT * dirty2.to(I32),
            acc_slot=put(ps["acc_slot"], ix2, p0),
        )
        ob2 = emit(zero_ob, 0, src, FPaxosDev.MACCEPTED,
                   torch.stack([p0, p1, zero], -1), torch.ones_like(valid))

        # 3 MACCEPTED: the commander counts accepts; on exactly f+1 the
        # slot is chosen, broadcast, and the commander retired; a stale
        # accept (slot mismatch) is a protocol error (fpaxos.rs:264-315)
        ix3 = dot_slot(p0, D)
        occupant = take(ps["cmd_slot"], ix3)
        stale = occupant != p0
        cnt = take(ps["acc_count"], ix3) + 1
        chosen = ~stale & (cnt == ctx["q_size"][:, None])
        st3 = dict(
            ps,
            err=ps["err"] | ERR_PROTO * stale.to(I32),
            acc_count=put(ps["acc_count"], ix3,
                          torch.where(chosen, zero, cnt)),
            cmd_slot=put(ps["cmd_slot"], ix3,
                         torch.where(chosen, zero, occupant)),
        )
        ob3 = emit_broadcast(zero_ob, FPaxosDev.MCHOSEN,
                             torch.stack([p0, p1, zero], -1), n)
        ob3["valid"] = ob3["valid"] & chosen[..., None]

        # 4 MCHOSEN: execute in slot order; the client's attached
        # process reports (executor/slot.rs:17-69). A client out of
        # range reads process 0 (oh_get)
        in_order = p0 == ps["exec_frontier"] + 1
        # safety monitor (engine/monitor.py): FPaxos executes one total
        # order, so every execution hashes into key 0, identified by
        # its slot (src 0)
        st4 = mon_exec(ps, 0, 0, p0, in_order)
        st4 = dict(
            st4,
            err=ps["err"] | ERR_PROTO * (~in_order).to(I32),
            exec_frontier=ps["exec_frontier"] + in_order.to(I32),
        )
        attach = ctx["client_attach"][:, None, :].expand(L, N, -1)
        mine = take(attach, p1) == me
        ob4 = emit(zero_ob, 0, N + p1, FPaxosDev.TO_CLIENT, p0[..., None],
                   in_order & mine)

        # 5 MGC: join the sender's committed frontier; the stable slot is
        # the min over all frontiers; free the acceptor entries up to it
        # (synod/gc.rs, acceptor.gc)
        oc = put(ps["others_committed"], src,
                 torch.maximum(take(ps["others_committed"], src), p0))
        seen = put(ps["seen"], src, torch.ones_like(valid))
        others = (procs < n[:, None])[:, None, :] & (
            procs != me[..., None]
        )                                                     # [L, N, N]
        ready = torch.all(seen | ~others, dim=-1)
        min_others = torch.where(others, oc, torch.full_like(oc, INF)).amin(-1)
        stable = torch.minimum(ps["exec_frontier"], min_others)
        stable = torch.where(ready, stable, zero)
        acc = ps["acc_slot"]
        freed = (acc > 0) & (acc <= stable[..., None])
        st5 = dict(
            ps,
            others_committed=oc,
            seen=seen,
            m_stable=ps["m_stable"] + freed.sum(-1, dtype=I32),
            acc_slot=torch.where(freed, torch.zeros_like(acc), acc),
        )

        masks = [idx == k for k in range(FPaxosDev.NUM_TYPES)]
        states = [st0, st0, st2, st3, st4, st5, ps]
        outs = [ob0, ob0, ob2, ob3, ob4, zero_ob, zero_ob]
        new_ps = {k: select(masks, [s[k] for s in states]) for k in ps}
        new_ob = {k: select(masks, [o[k] for o in outs]) for k in zero_ob}
        return new_ps, new_ob
