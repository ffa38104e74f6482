"""Device twin of the ``Basic`` protocol (fantoch/src/protocol/basic.rs),
batched over ``[L, N]`` (lane, process).

Semantics: coordinator broadcasts MStore; the f+1 fast-quorum members
ack; on the f+1'th ack the coordinator broadcasts MCommit; commits feed
the committed-clock GC flow (periodic MGarbageCollection frontier
exchange → stable dots; gc/clock.rs:10-171). 100% fast path.

State encoding (per process, fixed shapes):
- ``seq_in_slot[N, D]``  — which command sequence occupies each dot slot
  per source (0 = free); slots recycle modulo D after GC;
- ``committed_cnt[N]``   — per-source committed frontier;
- ``acks[D]``/``client_of[D]``/``own_seq`` — coordinator bookkeeping;
- ``others_frontier[N, N]``/``seen[N]``/``prev_stable[N]`` — the GC
  tracker: stable = meet of all advertised frontiers.

:meth:`BasicDev.ready_plain`, :meth:`BasicDev.periodic_plain` and
:meth:`BasicDev.handle_plain` are the plain PyTorch twin of the
``basic_handle`` CUDA kernel (``kernels/basic_handle.py``). Under the
reference's ``vmap`` its ``lax.switch`` computes every branch and selects
one; the twin does the same with masks, the kernel runs only the branch
of each (lane, process).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core import emit, emit_broadcast, empty_outbox
from ..dims import (
    ERR_DOT, ERR_PROTO, INF, PMT, PPAY, PSRC, EngineDims, dot_slot,
)
from ..monitor import mon_exec
from .identity import DevIdentity
from .masked import put, put2, select, take

I32 = torch.int32


class BasicDev(DevIdentity):
    SUBMIT = 0
    MSTORE = 1
    MSTOREACK = 2
    MCOMMIT = 3
    MGC = 4
    NUM_TYPES = 5
    TO_CLIENT = 6  # any id ≥ NUM_TYPES; routing is by dst ≥ N

    PERIODIC_ROWS = 1  # garbage collection
    MONITORED = True  # mon_exec hook at the commit apply
    # Basic's executor applies commits in arrival order and guarantees
    # no cross-process order, so only the exactly-once counters are
    # checked (all executions share monitor key 0)
    MONITOR_ORDER = False

    # -- host-side builders -------------------------------------------

    @staticmethod
    def payload_width(n: int) -> int:
        return max(n, 3)  # MGC carries an n-wide frontier

    @staticmethod
    def periodic_intervals(config, dims: EngineDims):
        gc = config.gc_interval_ms
        return [gc if gc is not None else INF]

    @staticmethod
    def min_live(config) -> int:
        """f+1 store-quorum members must ack every MStore (deeper crash
        plans end the lane with ERR_UNAVAIL, engine/faults.py)."""
        return config.basic_quorum_size()

    @staticmethod
    def lane_ctx(config, dims: EngineDims, sorted_idx: np.ndarray):
        """Fast quorum = first f+1 processes in each process's discovery
        order (base.rs:107-131 with basic_quorum_size, config.rs:265)."""
        N = dims.N
        q = config.basic_quorum_size()
        quorum = np.zeros((N, N), bool)
        for p in range(config.n):
            for member in sorted_idx[p][:q]:
                quorum[p, member] = True
        return {"quorum": quorum, "q_size": np.int32(q)}

    @staticmethod
    def init_state(dims: EngineDims, ctx_np) -> Dict[str, np.ndarray]:
        N, D = dims.N, dims.D
        return {
            "seq_in_slot": np.zeros((N, N, D), np.int32),
            "buffered_commit": np.zeros((N, N, D), bool),
            "committed_cnt": np.zeros((N, N), np.int32),
            "acks": np.zeros((N, D), np.int32),
            "client_of": np.zeros((N, D), np.int32),
            "own_seq": np.zeros((N,), np.int32),
            "others_frontier": np.zeros((N, N, N), np.int32),
            "seen": np.zeros((N, N), bool),
            "prev_stable": np.zeros((N, N), np.int32),
            "m_fast_path": np.zeros((N,), np.int32),
            "m_stable": np.zeros((N,), np.int32),
            "err": np.zeros((N,), np.int32),
        }

    @staticmethod
    def error(ps):
        return ps["err"]

    @staticmethod
    def metrics(ps_np) -> Dict[str, np.ndarray]:
        return {
            "fast_path": ps_np["m_fast_path"],
            "stable": ps_np["m_stable"],
        }

    # -- the handler step ----------------------------------------------

    @staticmethod
    def handlers(ps, has, rows, fire, ep, ctx, dims: EngineDims):
        """Readiness gate, periodic timer and message handler of every
        (lane, process): ``(rdy, ps, periodic outbox, handler outbox)``
        (the event times ``ep`` are not read).
        Runs the ``basic_handle`` kernel on CUDA tensors."""
        from ...kernels.basic_handle import basic_handle

        return basic_handle(ps, has, rows, fire, ctx, dims)

    @staticmethod
    def step_plain(ps, has, rows, fire, n, quorum, q_size, dims):
        """The plain twin of the kernel, in the reference's order
        (core.py:890-918): ``ready`` on the incoming state, ``periodic``,
        then ``handle`` on the state ``periodic`` returned."""
        mtype0 = torch.where(
            has, rows[..., PMT], torch.full_like(has, BasicDev.NUM_TYPES, dtype=I32)
        )
        rdy = BasicDev.ready_plain(ps, rows, mtype0, dims)
        valid = has & rdy
        mtype = torch.where(
            valid, mtype0, torch.full_like(mtype0, BasicDev.NUM_TYPES)
        )
        pout = BasicDev.periodic_plain(ps, fire, n, dims)
        ps, hout = BasicDev.handle_plain(
            ps, valid, mtype, rows, n, quorum, q_size, dims
        )
        return rdy, ps, pout, hout

    @staticmethod
    def ready_plain(ps, rows, mtype, dims: EngineDims):
        """MStore needs a free dot slot; commits apply in per-source
        order (committed_cnt is a frontier counter)."""
        src, pay = rows[..., PSRC], rows[..., PPAY:]
        store_slot = dot_slot(pay[..., 0], dims.D)
        store_ok = take(take(ps["seq_in_slot"], src), store_slot) == 0
        in_order = pay[..., 1] == take(ps["committed_cnt"], pay[..., 0]) + 1
        ok = torch.where(
            mtype == BasicDev.MSTORE, store_ok, torch.ones_like(store_ok)
        )
        return torch.where(mtype == BasicDev.MCOMMIT, in_order, ok)

    @staticmethod
    def periodic_plain(ps, fire, n, dims: EngineDims):
        """GARBAGE_COLLECTION: broadcast my committed frontier to
        all-but-me (basic.rs handle_event)."""
        L, N = fire.shape[:2]
        me = torch.arange(N, device=fire.device, dtype=I32).expand(L, N)
        ob = emit_broadcast(
            empty_outbox(dims, (L, N), fire.device), BasicDev.MGC,
            ps["committed_cnt"], n, me, exclude_me=True,
        )
        ob["valid"] = ob["valid"] & fire[..., 0:1]
        return ob

    @staticmethod
    def handle_plain(ps, valid, mtype, rows, n, quorum, q_size, dims):
        """Every branch of the message switch, selected by type."""
        L, N, D = valid.shape[0], dims.N, dims.D
        dev = valid.device
        me = torch.arange(N, device=dev, dtype=I32).expand(L, N)
        src, pay = rows[..., PSRC], rows[..., PPAY:]
        p0, p1, p2 = pay[..., 0], pay[..., 1], pay[..., 2]
        idx = mtype.clamp(0, BasicDev.NUM_TYPES)
        zero_ob = empty_outbox(dims, (L, N), dev)

        def broadcast(mt, words, ok):
            ob = emit_broadcast(zero_ob, mt, torch.stack(words, -1), n)
            ob["valid"] = ob["valid"] & ok[..., None]
            return ob

        def apply_commit(st, s, seq, do, ob, ob_slot):
            # safety monitor (engine/monitor.py): count-only, key 0
            st = mon_exec(st, 0, s, seq, do)
            expected = take(st["committed_cnt"], s) + 1
            st = dict(
                st,
                err=st["err"] | ERR_PROTO * (do & (seq != expected)).to(I32),
                committed_cnt=put(
                    st["committed_cnt"], s,
                    take(st["committed_cnt"], s) + do.to(I32),
                ),
            )
            client = take(st["client_of"], dot_slot(seq, D))
            ob = emit(
                ob, ob_slot, N + client, BasicDev.TO_CLIENT, seq[..., None],
                do & (me == s),
            )
            return st, ob

        # 0 SUBMIT: next dot, MStore to all (basic.rs:113-129)
        seq0 = ps["own_seq"] + 1
        slot0 = dot_slot(seq0, D)
        st0 = dict(
            ps,
            own_seq=seq0,
            client_of=put(ps["client_of"], slot0, p0),
            acks=put(ps["acks"], slot0, torch.zeros_like(p0)),
        )
        ob0 = broadcast(BasicDev.MSTORE, [seq0, p2], valid)

        # 1 MSTORE: store payload; quorum members ack; apply a buffered
        # commit (basic.rs:152-162)
        slot1 = dot_slot(p0, D)
        dirty = take(take(ps["seq_in_slot"], src), slot1) != 0
        st1 = dict(
            ps,
            err=ps["err"] | ERR_DOT * dirty.to(I32),
            seq_in_slot=put2(ps["seq_in_slot"], src, slot1, p0),
        )
        s_ok = (src >= 0) & (src < N)
        q_me = quorum[
            torch.arange(L, device=dev)[:, None],
            src.clamp(0, N - 1).long(),
            me.long(),
        ]
        ob1 = emit(
            zero_ob, 0, src, BasicDev.MSTOREACK, p0[..., None], s_ok & q_me
        )
        buffered = take(take(ps["buffered_commit"], src), slot1)
        st1, ob1 = apply_commit(st1, src, p0, buffered, ob1, 1)
        st1["buffered_commit"] = put2(
            st1["buffered_commit"], src, slot1, torch.zeros_like(buffered)
        )

        # 2 MSTOREACK: count acks; on exactly f+1, commit everywhere
        # (basic.rs:163-169)
        slot2 = dot_slot(p0, D)
        cnt = take(ps["acks"], slot2) + 1
        reached = cnt == q_size[:, None]
        st2 = dict(
            ps,
            acks=put(ps["acks"], slot2, cnt),
            m_fast_path=ps["m_fast_path"] + reached.to(I32),
        )
        ob2 = broadcast(BasicDev.MCOMMIT, [me, p0], reached)

        # 3 MCOMMIT: apply if the payload has arrived, else buffer
        # (basic.rs:171-186)
        slot3 = dot_slot(p1, D)
        have = take(take(ps["seq_in_slot"], p0), slot3) == p1
        st3, ob3 = apply_commit(ps, p0, p1, have, zero_ob, 0)
        st3["buffered_commit"] = put2(
            st3["buffered_commit"], p0, slot3,
            take(take(st3["buffered_commit"], p0), slot3) | ~have,
        )

        # 4 MGC: join the sender's frontier; recompute the stable clock
        # and free newly stable dot slots (gc/clock.rs:51-120)
        frontier = pay[..., :N]
        of = put(
            ps["others_frontier"], src,
            torch.maximum(take(ps["others_frontier"], src), frontier),
        )
        seen = put(ps["seen"], src, torch.ones_like(valid))
        procs = torch.arange(N, device=dev, dtype=I32)
        nmask = procs[None, :] < n[:, None]                    # [L, N]
        others = nmask[:, None, :] & (procs[None, None, :] != me[..., None])
        ready = torch.all(seen | ~others, dim=-1)              # [L, N]
        min_others = torch.where(
            others[..., None], of, torch.full_like(of, INF)
        ).amin(dim=2)                                          # [L, N, N]
        stable = torch.minimum(ps["committed_cnt"], min_others)
        stable = torch.where(
            ready[..., None] & nmask[:, None, :], stable,
            torch.zeros_like(stable),
        )
        delta = (stable - ps["prev_stable"]).clamp(min=0)
        prev_stable = torch.maximum(ps["prev_stable"], stable)
        freed = (ps["seq_in_slot"] > 0) & (
            ps["seq_in_slot"] <= prev_stable[..., None]
        )
        st4 = dict(
            ps,
            others_frontier=of,
            seen=seen,
            prev_stable=prev_stable,
            m_stable=ps["m_stable"] + delta.sum(dim=-1, dtype=I32),
            seq_in_slot=torch.where(
                freed, torch.zeros_like(ps["seq_in_slot"]), ps["seq_in_slot"]
            ),
            buffered_commit=ps["buffered_commit"] & ~freed,
        )

        masks = [idx == k for k in range(BasicDev.NUM_TYPES)]
        states = [st0, st1, st2, st3, st4, ps]
        outs = [ob0, ob1, ob2, ob3, zero_ob, zero_ob]
        new_ps = {k: select(masks, [s[k] for s in states]) for k in ps}
        new_ob = {k: select(masks, [o[k] for o in outs]) for k in zero_ob}
        return new_ps, new_ob
