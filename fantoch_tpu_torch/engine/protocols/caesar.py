"""Device twin of Caesar (fantoch_ps/src/protocol/caesar.rs), batched
over ``[L, N]`` (lane, process): the counterpart of the reference's
``fantoch_tpu/engine/protocols/caesar.py``, timestamp + dependency
consensus with the wait condition.

Flow: the coordinator proposes a logical clock and broadcasts MPropose
to everyone; the fastest ⌊3n/4⌋+1 repliers form the fast quorum. Every
receiver computes the command's predecessors (lower-clock conflicts on
the key) and blockers (higher-clock conflicts); with blockers present
the wait condition holds the reply until each blocker reaches a safe
clock, accepting if the command is in the blocker's deps and rejecting
otherwise. All-ok replies commit on the fast path; a rejection once a
majority replied starts an MRetry round through the write quorum whose
acks aggregate the final dep set. The predecessors executor runs a
command once every dep is committed and every lower-clock dep executed,
in clock order. GC frees a command once all n processes report it
executed (the executed notification buffer and the MGC broadcast).

Equivalences the reference relies on, kept here: waiting commands are
re-evaluated after every MCommit/MRetry (ignore-ability is monotone);
one command executes per zero-delay drain step (the lower-clock
relation is acyclic); a rejected proposal's recomputed deps include its
own old-clock registration.

State (per process, fixed shapes; the reference's ``init_state``): the
per-key clock table ``kc_* [K, S]``; the per-dot lifecycle of every
source ``[N, D]`` with its deps ``[N, D, DEP]`` and blockers ``[N, D,
BB]``; the coordinator's quorum aggregation ``[D]`` and dep union
``ag_* [D, DEP]``; the executed set per source (an interval set,
``engine/iset.py``); the executed and GC buffers ``[EB]``; the GC
sighting counts ``[N, D]``.

:meth:`CaesarDev.ready_plain`, :meth:`CaesarDev.periodic_plain` and
:meth:`CaesarDev.handle_plain`, composed by :meth:`CaesarDev.step_plain`,
are the plain PyTorch twin of the ``caesar_handle`` CUDA kernel
(``kernels/caesar_handle.py``): like the reference's ``lax.switch`` under
``vmap`` the twin computes branches over the whole batch and selects
with masks (skipping the branches no (lane, process) takes), then runs
the two hoisted scans on every (lane, process), enabled where the
branch asks for them. The scans look only at the dots that can act
(committed dots for the executor, waiting dots for the wait condition),
which gives the reference's result: no other dot is ready or
actionable.

On a monitored step the exec scan records every execution
(``engine/monitor.py`` ``mon_exec``, the reference's
``caesar.py:640-646``); Caesar keeps no committed set independent of the
status table that gates the scan, so it has no execute-before-commit
guard, as in the reference. Not here: the narrowed metric planes
(``NARROW_METRICS``, ROADMAP Queue A item 5). Like the reference,
recovery is not modeled.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core import emit, emit_broadcast, empty_outbox
from ..dims import (
    ERR_CAPACITY, ERR_DOT, ERR_PROTO, ERR_SEQ, INF, PMT, PPAY, PSRC,
    SEQ_BOUND, EngineDims, dot_slot,
)
from ..iset import first_true, iset_add, iset_contains_gathered
from ..monitor import mon_exec
from .identity import DevIdentity
from .masked import (
    bcast, compact_order, gather_cell, hit, match_take, pack_pairs, put,
    put2, take, take2, take_words,
)

I32 = torch.int32

# statuses (caesar.rs Status; PROPOSE_BEGIN is transient host-side only)
ST_PROPOSE_END = 2
ST_REJECT = 3
ST_ACCEPT = 4
ST_COMMIT = 5
ST_EXECUTED = 6


class CaesarDev(DevIdentity):
    SUBMIT = 0
    MPROPOSE = 1
    MPROPOSEACK = 2
    MCOMMIT = 3
    MRETRY = 4
    MRETRYACK = 5
    MGC = 6
    WAIT_DRAIN = 7
    EXEC_DRAIN = 8
    GC_DRAIN = 9
    NUM_TYPES = 10
    TO_CLIENT = 11

    PERIODIC_ROWS = 2  # [garbage collection, executed notification]
    MONITORED = True  # mon_exec hook at the predecessors-executor scan
    # the hoisted scans fill the last four outbox slots, beyond the n + 1
    # a branch itself may fill (the GC drain's broadcast and chain)
    EXTRA_SLOTS = 4

    def __init__(self, keys: int, key_slots: int = 32, dep_slots: int = 64,
                 blocker_slots: int = 16, gap_slots: int = 8,
                 exec_buffer: int = 128):
        self.K = keys
        self.S = key_slots       # (dot, clock) registrations per key
        self.DEP = dep_slots     # deps per dot / per message
        self.BB = blocker_slots  # blockers per waiting dot
        self.G = gap_slots
        self.EB = exec_buffer    # executed-dot buffers (notify + GC)

    @classmethod
    def for_load(cls, keys: int, clients: int) -> "CaesarDev":
        """Capacity bounds scaled to the client count, as the
        reference's: DEP = max(64, 8 × clients), BB = max(16, DEP / 4)."""
        dep = max(64, 8 * clients)
        return cls(keys=keys, dep_slots=dep, blocker_slots=max(16, dep // 4))

    # -- host-side builders -------------------------------------------

    def payload_width(self, n: int) -> int:
        # MCOMMIT/MRETRY: [dsrc, dseq, cseq, cpid, nd] + (src, seq) * DEP
        return max(5 + 2 * self.DEP, n)

    @staticmethod
    def gc_per_msg(dims: EngineDims) -> int:
        return (dims.P - 1) // 2

    def periodic_intervals(self, config, dims: EngineDims):
        gc = config.gc_interval_ms
        return [
            gc if gc is not None else INF,
            config.executor_executed_notification_interval_ms,
        ]

    @staticmethod
    def min_live(config) -> int:
        """A proposal needs ⌊3n/4⌋+1 replies and a retry ⌊n/2⌋+1."""
        fq_size, wq_size = config.caesar_quorum_sizes()
        return max(fq_size, wq_size)

    def lane_ctx(self, config, dims: EngineDims, sorted_idx: np.ndarray):
        fq_size, wq_size = config.caesar_quorum_sizes()
        return {
            "fq_size": np.int32(fq_size),
            "wq_size": np.int32(wq_size),
            "wait_condition": np.bool_(config.caesar_wait_condition),
        }

    def init_state(self, dims: EngineDims, ctx_np) -> Dict[str, np.ndarray]:
        N, D = dims.N, dims.D
        K, S, DEP, BB, G, EB = (
            self.K, self.S, self.DEP, self.BB, self.G, self.EB,
        )
        z = np.zeros
        return {
            "kc_src": z((N, K, S), np.int32),
            "kc_seq": z((N, K, S), np.int32),
            "kc_cseq": z((N, K, S), np.int32),
            "kc_cpid": z((N, K, S), np.int32),
            "clk_counter": z((N,), np.int32),
            "pseq": z((N, N, D), np.int32),
            "status": z((N, N, D), np.int32),
            "key_of": z((N, N, D), np.int32),
            "client_of": z((N, N, D), np.int32),
            "clk_seq": z((N, N, D), np.int32),
            "clk_pid": z((N, N, D), np.int32),
            "dep_src": z((N, N, D, DEP), np.int32),
            "dep_seq": z((N, N, D, DEP), np.int32),
            "bb_src": z((N, N, D, BB), np.int32),
            "bb_seq": z((N, N, D, BB), np.int32),
            "own_seq": z((N,), np.int32),
            "qa_cnt": z((N, D), np.int32),
            "qa_ok": np.ones((N, D), bool),
            "qa_done": z((N, D), bool),
            "qa_cseq": z((N, D), np.int32),
            "qa_cpid": z((N, D), np.int32),
            "ag_src": z((N, D, DEP), np.int32),
            "ag_seq": z((N, D, DEP), np.int32),
            "qr_cnt": z((N, D), np.int32),
            "ex_front": z((N, N), np.int32),
            "ex_gaps": z((N, N, G, 2), np.int32),
            "eb_src": z((N, EB), np.int32),
            "eb_seq": z((N, EB), np.int32),
            "eb_n": z((N,), np.int32),
            "gb_src": z((N, EB), np.int32),
            "gb_seq": z((N, EB), np.int32),
            "gb_n": z((N,), np.int32),
            "gb_gc": z((N,), np.int32),
            "gc_cnt": z((N, N, D), np.int32),
            "m_fast": z((N,), np.int32),
            "m_slow": z((N,), np.int32),
            "m_stable": z((N,), np.int32),
            "err": z((N,), np.int32),
        }

    @staticmethod
    def error(ps):
        return ps["err"]

    @staticmethod
    def metrics(ps_np) -> Dict[str, np.ndarray]:
        return {
            "fast_path": ps_np["m_fast"],
            "slow_path": ps_np["m_slow"],
            "stable": ps_np["m_stable"],
        }

    # -- the handler step ----------------------------------------------

    @staticmethod
    def handlers(ps, has, rows, fire, ep, ctx, dims: EngineDims):
        """Readiness gate, periodic timers, message handler and the two
        hoisted scans of every (lane, process): ``(rdy, ps, periodic
        outbox, handler outbox)`` (the event times ``ep`` are not read).
        Runs the ``caesar_handle`` kernel on CUDA tensors."""
        from ...kernels.caesar_handle import caesar_handle

        return caesar_handle(ps, has, rows, fire, ctx, dims)

    @staticmethod
    def step_plain(ps, has, rows, fire, ctx, dims: EngineDims):
        """The plain twin of the kernel, in the reference's order
        (core.py:890-918): ``ready`` on the incoming state, ``periodic``,
        then ``handle`` (the branch, the exec scan, the wait scan)."""
        X = CaesarDev
        none = torch.full_like(rows[..., PMT], X.NUM_TYPES)
        mtype0 = torch.where(has, rows[..., PMT], none)
        rdy = X.ready_plain(ps, rows, mtype0, dims)
        mtype = torch.where(has & rdy, mtype0, none)
        ps, pout = X.periodic_plain(ps, fire, ctx, dims)
        ps, hout = X.handle_plain(ps, mtype, rows, ctx, dims)
        return rdy, ps, pout, hout

    @staticmethod
    def ready_plain(ps, rows, mtype, dims: EngineDims):
        """MPropose needs a free dot slot; MCommit and MRetry need the
        MPropose payload; MGC counts only dots whose MPropose has
        arrived (caesar.py:239)."""
        X = CaesarDev
        D = dims.D
        src, pay = rows[..., PSRC], rows[..., PPAY:]
        pseq = ps["pseq"]
        prop_ok = take2(pseq, src, dot_slot(pay[..., 0], D)) == 0
        seq = pay[..., 1]
        have = take2(pseq, pay[..., 0], dot_slot(seq, D)) == seq
        idx = torch.arange(X.gc_per_msg(dims), device=rows.device,
                           dtype=I32)
        gsrc = take_words(pay, 1 + 2 * idx)
        gseq = take_words(pay, 2 + 2 * idx)
        en = idx < pay[..., 0:1]
        gc_ok = (~en | (gather_cell(pseq, gsrc, dot_slot(gseq, D))
                        == gseq)).all(-1)
        ok = torch.where(mtype == X.MPROPOSE, prop_ok,
                         torch.ones_like(prop_ok))
        ok = torch.where((mtype == X.MCOMMIT) | (mtype == X.MRETRY), have, ok)
        return torch.where(mtype == X.MGC, gc_ok, ok)

    @staticmethod
    def periodic_plain(ps, fire, ctx, dims: EngineDims):
        """Row 0: GC, kick the GC_DRAIN chain for the dots buffered
        before this instant's notification drain. Row 1: the executed
        notification, into the GC flow (caesar.py:309)."""
        L, N = fire.shape[:2]
        B = _Batch(ps, None, ctx, dims, L)
        pre_n = ps["gb_n"]
        ps = _drain_executed_notification(B, ps, fire[..., 1])
        ps = dict(ps, gb_gc=torch.where(fire[..., 0], pre_n, ps["gb_gc"]))
        ob = emit(B.empty(), 0, B.me, CaesarDev.GC_DRAIN, B.zero_word(),
                  fire[..., 0] & (pre_n > 0))
        return ps, ob

    @staticmethod
    def handle_plain(ps, mtype, rows, ctx, dims: EngineDims):
        """The message switch (each branch that some (lane, process)
        takes, computed over the batch and selected by type), then the
        exec scan into slots F - 4/F - 3 and the wait scan into slots
        F - 2/F - 1 on every (lane, process) (caesar.py:270)."""
        X = CaesarDev
        B = _Batch(ps, rows, ctx, dims, rows.shape[0])
        idx = mtype.clamp(0, X.NUM_TYPES)
        B.idx = idx
        branches = [_submit, _mpropose, _mproposeack, _mcommit, _mretry,
                    _mretryack, _mgc, _wait_drain, _exec_drain, _gc_drain]
        new_ps, new_ob = dict(ps), B.empty()
        copied = set()
        do_exec = torch.zeros_like(idx, dtype=torch.bool)
        do_wait = torch.zeros_like(do_exec)
        for k, fn in enumerate(branches):
            mask = idx == k
            # a branch no (lane, process) takes is never selected; the
            # masks are disjoint, and the noop keeps ps and an empty
            # outbox with both scans off
            if not bool(mask.any()):
                continue
            st, ob, ex, wt = fn(B, ps)
            for name, v in st.items():
                if v is not ps[name]:
                    if name not in copied:
                        new_ps[name] = ps[name].clone()
                        copied.add(name)
                    new_ps[name][mask] = v[mask]
            for name, v in ob.items():
                new_ob[name] = torch.where(bcast(mask, v), v, new_ob[name])
            do_exec = torch.where(mask, ex, do_exec)
            do_wait = torch.where(mask, wt, do_wait)
        F = dims.F
        ps, ob = _exec_scan(B, new_ps, new_ob, F - 4, F - 3, do_exec)
        return _wait_scan(B, ps, ob, F - 2, F - 1, do_wait)


class _Batch:
    """What every branch reads: the sizes, the popped messages and the
    lane ctx, with ``[L, N]`` leading axes."""

    def __init__(self, ps, rows, ctx, dims, L):
        self.dims = dims
        self.L, self.N, self.D, self.P = L, dims.N, dims.D, dims.P
        self.K, self.S = ps["kc_src"].shape[2:4]
        self.DEP = ps["dep_src"].shape[4]
        self.BB = ps["bb_src"].shape[4]
        self.EB = ps["eb_src"].shape[2]
        self.dev = ps["err"].device
        self.me = torch.arange(self.N, device=self.dev,
                               dtype=I32).expand(L, self.N)
        if rows is not None:
            self.src = rows[..., PSRC]
            self.pay = rows[..., PPAY:]
        self.ctx = ctx
        self.n = ctx["n"]
        self.clk_max = INF // (self.N + 1) - 1

    def lane(self, key):
        """A per-lane ctx scalar as ``[L, 1]``."""
        return self.ctx[key][:, None]

    def empty(self):
        return empty_outbox(self.dims, (self.L, self.N), self.dev)

    def zeros(self, *shape):
        return torch.zeros((self.L, self.N) + shape, dtype=I32,
                           device=self.dev)

    def zero_word(self):
        return self.zeros(1)

    def iota(self, n):
        return torch.arange(n, device=self.dev, dtype=I32)

    def off(self):
        return torch.zeros((self.L, self.N), dtype=torch.bool,
                           device=self.dev)


def _err(ps, code, cond):
    return ps["err"] | code * cond.to(I32)


def _put_rows(arr, val, i, j=None):
    """``put``/``put2`` for the wide planes (``[N, D, DEP]`` deps and
    blockers, ``[D, DEP]`` unions): write ``val`` at ``arr[l, p, i(, j)]``
    only for the (lane, process) rows whose indices are in range, on a
    copy; with no such row the plane itself comes back (unchanged), so a
    branch that writes nothing leaves nothing to select."""
    ok = (i >= 0) & (i < arr.shape[2])
    if j is not None:
        ok = ok & (j >= 0) & (j < arr.shape[3])
    rows = ok.nonzero(as_tuple=True)
    if not rows[0].numel():
        return arr
    out = arr.clone()
    at = rows + (i[rows].long(),) + (() if j is None else (j[rows].long(),))
    out[at] = val[rows]
    return out


def _clk_lt(a_seq, a_pid, b_seq, b_pid):
    """Lexicographic clock order (clocks/mod.rs:27-60)."""
    return (a_seq < b_seq) | ((a_seq == b_seq) & (a_pid < b_pid))


# ----------------------------------------------------------------------
# key-clock helpers (caesar.py:348-414)
# ----------------------------------------------------------------------

def _kc_add(B, ps, key, src, seq, cseq, cpid, enable):
    """Register (dot, clock) on the key; a duplicate clock raises
    ERR_PROTO, a full row ERR_CAPACITY."""
    row_cseq, row_cpid = take(ps["kc_cseq"], key), take(ps["kc_cpid"], key)
    do = enable
    dup = ((row_cseq == cseq[..., None]) & (row_cpid == cpid[..., None])
           & (row_cseq > 0)).any(-1)
    free = row_cseq == 0
    slot = first_true(free)
    overflow = do & ~free.any(-1)
    widx = torch.where(do & ~overflow & ~dup, slot, B.S)
    return dict(
        ps,
        kc_src=put2(ps["kc_src"], key, widx, src),
        kc_seq=put2(ps["kc_seq"], key, widx, seq),
        kc_cseq=put2(ps["kc_cseq"], key, widx, cseq),
        kc_cpid=put2(ps["kc_cpid"], key, widx, cpid),
        err=_err(ps, ERR_CAPACITY, overflow) | ERR_PROTO * (do & dup).to(I32),
    )


def _kc_remove(B, ps, key, cseq, cpid, enable):
    """Unregister the clock from the key; a missing entry raises
    ERR_PROTO."""
    row_cseq, row_cpid = take(ps["kc_cseq"], key), take(ps["kc_cpid"], key)
    match = ((row_cseq == cseq[..., None]) & (row_cpid == cpid[..., None])
             & (row_cseq > 0))
    found = match.any(-1)
    widx = torch.where(enable & found, first_true(match), B.S)
    zero = torch.zeros_like(cseq)
    return dict(
        ps,
        kc_src=put2(ps["kc_src"], key, widx, zero),
        kc_seq=put2(ps["kc_seq"], key, widx, zero),
        kc_cseq=put2(ps["kc_cseq"], key, widx, zero),
        kc_cpid=put2(ps["kc_cpid"], key, widx, zero),
        err=_err(ps, ERR_PROTO, enable & ~found),
    )


def _predecessors(ps, key, cseq, cpid):
    """``(pred_mask, blocker_mask)`` ``[L, N, S]`` over the key row
    relative to the clock (cseq, cpid)."""
    row_cseq, row_cpid = take(ps["kc_cseq"], key), take(ps["kc_cpid"], key)
    present = row_cseq > 0
    c, p = cseq[..., None], cpid[..., None]
    return (present & _clk_lt(row_cseq, row_cpid, c, p),
            present & _clk_lt(c, p, row_cseq, row_cpid))


def _pack_deps(B, ps, key, pred_mask, base, pay):
    """Compact the masked key-row dots into payload pairs after word
    ``base``, which gets their count: ``(pay, nd, overflow)``."""
    order, nd = compact_order(pred_mask, B.DEP)
    lo = base + 1 + 2 * order.clamp(max=B.P)
    pay = pay.clone()
    pay[..., base] = nd
    pay = pack_pairs(pay, lo, take(ps["kc_src"], key), take(ps["kc_seq"], key))
    return pay, nd, nd > B.DEP


# ----------------------------------------------------------------------
# the reply of a decided proposal (caesar.py:528)
# ----------------------------------------------------------------------

def _propose_reply(B, ps, ob, wsrc, wslot, wseq, accept, i, enable):
    """MProposeAck into outbox slot ``i``: accept echoes the registered
    clock and deps; reject takes a fresh clock and recomputes the deps
    at it (this dot's own old registration included)."""
    N, DEP = B.N, B.DEP
    do = enable
    rej = do & ~accept
    key = take2(ps["key_of"], wsrc, wslot)
    new_cseq = ps["clk_counter"] + 1
    ps = dict(
        ps,
        err=_err(ps, ERR_SEQ, rej & (new_cseq >= INF // (N + 1))),
        clk_counter=torch.where(rej, new_cseq, ps["clk_counter"]),
        status=put2(ps["status"], torch.where(rej, wsrc, N), wslot,
                    torch.full_like(wsrc, ST_REJECT)),
        bb_seq=_put_rows(ps["bb_seq"], B.zeros(B.BB),
                         torch.where(do & ~rej, wsrc, N), wslot),
    )
    rpay = B.zeros(B.P)
    rpay[..., 0] = wseq
    rpay[..., 1] = new_cseq
    rpay[..., 2] = B.me
    pred_mask, _ = _predecessors(ps, key, new_cseq, B.me)
    rpay, _nd, roverflow = _pack_deps(B, ps, key, pred_mask, 4, rpay)

    my_src = take2(ps["dep_src"], wsrc, wslot)                 # [L, N, DEP]
    my_seq = take2(ps["dep_seq"], wsrc, wslot)
    apay = B.zeros(B.P)
    apay[..., 0] = wseq
    apay[..., 1] = take2(ps["clk_seq"], wsrc, wslot)
    apay[..., 2] = take2(ps["clk_pid"], wsrc, wslot)
    apay[..., 3] = 1
    apay[..., 4] = (my_seq > 0).sum(-1, dtype=I32)
    apay = pack_pairs(apay, 5 + 2 * B.iota(DEP).expand_as(my_src), my_src,
                      my_seq)

    pay = torch.where(rej[..., None], rpay, apay)
    ps = dict(ps, err=_err(ps, ERR_CAPACITY, rej & roverflow))
    return ps, emit(ob, i, wsrc, CaesarDev.MPROPOSEACK, pay, do)


# ----------------------------------------------------------------------
# the wait-condition scan (caesar.py:423-525)
# ----------------------------------------------------------------------

def _blocker_member(ps, lp, dots, bsrc, bslot, N, D):
    """``member [M, BB]``: for each listed dot (``lp`` its flat (lane,
    process), ``dots`` its flat (source, slot) index) whether each
    blocker's dep row holds it as a live dep.

    The reference builds a relation R[q, e, p, d] = "dot (q, e)'s dep
    list has an entry j with dep_live_j at (p, d)" with one scatter
    (``.max`` at index (dsrc_j, dot_slot(dseq_j)), where ``dep_live_j``
    is ``dseq_j > 0 and pseq[dsrc_j, dot_slot(dseq_j)] == dseq_j`` under
    the plain gather) and gathers R at (clamped ``bsrc``, ``bslot``, p,
    d) (caesar.py:449-467). The scatter normalizes a negative source
    by + N and drops one still out of range, so the gathered bit is
    exactly: the dep row at (clamped ``bsrc``, ``bslot``) has an entry
    j with ``dseq_j > 0``, ``-N <= dsrc_j < N``, normalized ``dsrc_j ==
    p``, ``dot_slot(dseq_j) == d`` and ``pseq[p, d] == dseq_j``. This
    reads BB dep rows per listed dot instead of the ``[N, D, N, D]``
    relation."""
    M, BB = bsrc.shape
    fl = lambda k: ps[k].flatten(0, 1)                  # noqa: E731
    bs = torch.where(bsrc < 0, bsrc + N, bsrc).clamp(0, N - 1)
    cell = (bs * D + bslot).long()                      # [M, BB]
    lpx = lp[:, None].expand(M, BB)
    dsrc = fl("dep_src").flatten(1, 2)[lpx, cell]       # [M, BB, DEP]
    dseq = fl("dep_seq").flatten(1, 2)[lpx, cell]
    in_range = (dsrc >= -N) & (dsrc < N)
    s = torch.where(dsrc < 0, dsrc + N, dsrc).clamp(0, N - 1)
    dslot = dot_slot(dseq, D)
    target = (s * D + dslot).long()
    live = fl("pseq").flatten(1, 2)[lpx[..., None].expand_as(target),
                                    target] == dseq
    hit_ = (dseq > 0) & in_range & live & (target == dots[:, None, None])
    return hit_.any(-1)


def _wait_scan(B, ps, ob, ack_slot, chain_slot, enable):
    """Find the waiting dot with the lowest (source, sequence) whose wait
    condition resolves, reply its MProposeAck, and chain while more
    remain. Every (lane, process) runs it; a disabled scan still writes
    both slots (invalid)."""
    N, D = B.N, B.D
    status, bb_seq = ps["status"], ps["bb_seq"]
    waiting = (status == ST_PROPOSE_END) & (bb_seq > 0).any(-1)
    w_rej = torch.zeros_like(waiting)
    w_acc = torch.zeros_like(waiting)
    vert = waiting.flatten().nonzero().squeeze(1)
    if vert.numel():
        lp, dots = vert // (N * D), vert % (N * D)
        bsrc = ps["bb_src"].flatten(0, 3)[vert]                 # [M, BB]
        bseq = bb_seq.flatten(0, 3)[vert]
        bslot = dot_slot(bseq, D)
        present = bseq > 0
        bs = torch.where(bsrc < 0, bsrc + N, bsrc).clamp(0, N - 1)
        cell = lp[:, None] * (N * D) + bs * D + bslot
        valid = ps["pseq"].flatten()[cell] == bseq
        gcd = present & ~valid                # freed ⇒ executed everywhere
        safe = present & valid & (status.flatten()[cell] >= ST_ACCEPT)
        member = _blocker_member(ps, lp, dots, bsrc, bslot, N, D)
        reject = safe & ~member
        resolved = ~present | gcd | (safe & member)
        rej_v = reject.any(-1)
        w_rej.view(-1)[vert] = rej_v
        w_acc.view(-1)[vert] = resolved.all(-1) & ~rej_v
    actionable = w_rej | w_acc
    num = actionable.flatten(2).sum(-1, dtype=I32)
    srcs = B.iota(N)[:, None]
    packed = srcs * SEQ_BOUND + ps["pseq"]
    flat = torch.where(actionable, packed, INF).flatten(2).argmin(-1).to(I32)
    wsrc, wslot = flat // D, flat % D
    wseq = take2(ps["pseq"], wsrc, wslot)
    is_rej = take2(w_rej, wsrc, wslot)
    do = enable & (num > 0)
    ps, ob = _propose_reply(B, ps, ob, wsrc, wslot, wseq, ~is_rej, ack_slot,
                            do)
    ob = emit(ob, chain_slot, B.me, CaesarDev.WAIT_DRAIN, B.zero_word(),
              do & (num > 1))
    return ps, ob


# ----------------------------------------------------------------------
# the predecessors executor (caesar.py:587-680)
# ----------------------------------------------------------------------

def _exec_scan(B, ps, ob, client_slot, chain_slot, enable):
    """Execute the committed dot with the lowest clock whose deps are
    committed and whose lower-clock deps are executed; TO_CLIENT in
    ``client_slot`` if its client is attached here, EXEC_DRAIN to self
    in ``chain_slot`` after every execution. Every (lane, process) runs
    it; a disabled scan still writes both slots (invalid) and runs the
    executed set's absorption passes at its pick."""
    N, D = B.N, B.D
    status = ps["status"]
    committed = status == ST_COMMIT
    ready = torch.zeros_like(committed)
    vert = committed.flatten().nonzero().squeeze(1)
    if vert.numel():
        lp = vert // (N * D)
        dsrc = ps["dep_src"].flatten(0, 3)[vert]                # [M, DEP]
        dseq = ps["dep_seq"].flatten(0, 3)[vert]
        dslot = dot_slot(dseq, D)
        ds = torch.where(dsrc < 0, dsrc + N, dsrc).clamp(0, N - 1)
        cell = lp[:, None] * (N * D) + ds * D + dslot
        live = ps["pseq"].flatten()[cell] == dseq
        st_g = status.flatten()[cell]
        # a dead dep (slot empty or recycled) was GC'd, so executed here,
        # or never proposed here, so neither committed nor executed: the
        # executed set decides both bits (caesar.py:597-607)
        dead_done = iset_contains_gathered(
            ps["ex_front"].flatten(0, 1)[lp], ps["ex_gaps"].flatten(0, 1)[lp],
            dsrc, dseq)
        dep_committed = torch.where(live, st_g >= ST_COMMIT, dead_done)
        dep_executed = torch.where(live, st_g == ST_EXECUTED, dead_done)
        lower = _clk_lt(ps["clk_seq"].flatten()[cell],
                        ps["clk_pid"].flatten()[cell],
                        ps["clk_seq"].flatten()[vert][:, None],
                        ps["clk_pid"].flatten()[vert][:, None])
        ok = (dseq == 0) | (dep_committed & (dep_executed | ~lower))
        ready.view(-1)[vert] = ok.all(-1)
    num = ready.flatten(2).sum(-1, dtype=I32)
    packed = (ps["clk_seq"].clamp(max=B.clk_max) * (N + 1) + ps["clk_pid"])
    flat = torch.where(ready, packed, INF).flatten(2).argmin(-1).to(I32)
    esrc, eslot = flat // D, flat % D
    eseq = take2(ps["pseq"], esrc, eslot)
    client = take2(ps["client_of"], esrc, eslot)
    do = enable & (num > 0)
    # safety monitor (no execute-before-commit guard: see above)
    ps = mon_exec(ps, take2(ps["key_of"], esrc, eslot), esrc, eseq, do)
    front, gaps, overflow = iset_add(take(ps["ex_front"], esrc),
                                     take(ps["ex_gaps"], esrc), eseq, do)
    eb_n = ps["eb_n"]
    eb_overflow = do & (eb_n >= B.EB)
    widx = torch.where(do & ~eb_overflow, eb_n, B.EB)
    ps = dict(
        ps,
        ex_front=put(ps["ex_front"], esrc, front),
        ex_gaps=put(ps["ex_gaps"], esrc, gaps),
        status=put2(status, torch.where(do, esrc, N), eslot,
                    torch.full_like(esrc, ST_EXECUTED)),
        eb_src=put(ps["eb_src"], widx, esrc),
        eb_seq=put(ps["eb_seq"], widx, eseq),
        eb_n=eb_n + (do & ~eb_overflow).to(I32),
        err=_err(ps, ERR_CAPACITY, overflow | eb_overflow),
    )
    attach = B.ctx["client_attach"][:, None, :].expand(B.L, N, -1)
    ob = emit(ob, client_slot, N + client, CaesarDev.TO_CLIENT,
              B.zero_word(), do & (take(attach, client) == B.me))
    ob = emit(ob, chain_slot, B.me, CaesarDev.EXEC_DRAIN, B.zero_word(), do)
    return ps, ob


# ----------------------------------------------------------------------
# GC (caesar.py:688-772)
# ----------------------------------------------------------------------

def _gc_count(B, ps, freed, src, seq, enable):
    """BasicGCTrack.add for one dot: at n sightings unregister its clock
    and mark it in ``freed`` (cleared once after the caller's loop)."""
    N, D = B.N, B.D
    slot = dot_slot(seq, D)
    do = enable & (seq > 0)
    valid = take2(ps["pseq"], src, slot) == seq
    cnt = take2(ps["gc_cnt"], src, slot) + 1
    full = do & valid & (cnt == B.n[:, None])
    ps = dict(
        ps,
        err=_err(ps, ERR_PROTO, do & ~valid),
        gc_cnt=put2(ps["gc_cnt"], torch.where(do & valid, src, N), slot, cnt),
    )
    key = take2(ps["key_of"], src, slot)
    ps = _kc_remove(B, ps, key, take2(ps["clk_seq"], src, slot),
                    take2(ps["clk_pid"], src, slot), full)
    fsrc = torch.where(full, src, N)
    h = hit(fsrc, N)[..., :, None] & hit(slot, D)[..., None, :]
    ps = dict(ps, m_stable=ps["m_stable"] + full.to(I32))
    return ps, freed | h


def _apply_freed(ps, freed):
    """Clear every freed dot's lifecycle state in one masked write (a
    write of nothing leaves the planes as they are)."""
    if not bool(freed.any()):
        return ps
    out = dict(ps)
    for k in ("pseq", "status", "gc_cnt", "dep_seq", "bb_seq"):
        out[k] = ps[k].clone()
        out[k][freed] = 0
    return out


def _no_freed(B):
    return torch.zeros((B.L, B.N, B.N, B.D), dtype=torch.bool,
                       device=B.dev)


def _drain_executed_notification(B, ps, enable):
    """handle_executed (caesar.rs:194-213): move the executed dots into
    the MGC buffer and count my own sighting of each. The reference
    loops over all EB entries; an entry past every (lane, process)'s
    count changes nothing, so the loop ends there."""
    n_dots = torch.where(enable, ps["eb_n"], 0)
    freed = _no_freed(B)
    for i in range(B.EB):
        take_ = i < n_dots
        if not bool(take_.any()):
            break
        src, seq = ps["eb_src"][..., i], ps["eb_seq"][..., i]
        gb_n = ps["gb_n"]
        overflow = take_ & (gb_n >= B.EB)
        widx = torch.where(take_ & ~overflow, gb_n, B.EB)
        ps = dict(
            ps,
            gb_src=put(ps["gb_src"], widx, src),
            gb_seq=put(ps["gb_seq"], widx, seq),
            gb_n=gb_n + (take_ & ~overflow).to(I32),
            err=_err(ps, ERR_CAPACITY, overflow),
        )
        ps, freed = _gc_count(B, ps, freed, src, seq, take_)
    ps = _apply_freed(ps, freed)
    return dict(ps, eb_n=torch.where(enable, 0, ps["eb_n"]))


# ----------------------------------------------------------------------
# handlers (caesar.py:780-1282); each returns (ps, outbox, exec, wait)
# ----------------------------------------------------------------------

def _submit(B, ps):
    """Next dot + fresh clock, MPropose to everyone."""
    client, key = B.pay[..., 0], B.pay[..., 2]
    seq = ps["own_seq"] + 1
    slot = dot_slot(seq, B.D)
    cseq = ps["clk_counter"] + 1
    zero = torch.zeros_like(seq)
    ps = dict(
        ps,
        err=_err(ps, ERR_SEQ,
                 (seq >= SEQ_BOUND) | (cseq >= INF // (B.N + 1))),
        own_seq=seq,
        clk_counter=cseq,
        qa_cnt=put(ps["qa_cnt"], slot, zero),
        qa_ok=put(ps["qa_ok"], slot, torch.ones_like(seq, dtype=torch.bool)),
        qa_done=put(ps["qa_done"], slot,
                    torch.zeros_like(seq, dtype=torch.bool)),
        qa_cseq=put(ps["qa_cseq"], slot, zero),
        qa_cpid=put(ps["qa_cpid"], slot, zero),
        qr_cnt=put(ps["qr_cnt"], slot, zero),
        ag_src=_put_rows(ps["ag_src"], B.zeros(B.DEP), slot),
        ag_seq=_put_rows(ps["ag_seq"], B.zeros(B.DEP), slot),
    )
    ob = emit_broadcast(B.empty(), CaesarDev.MPROPOSE,
                        torch.stack([seq, key, client, cseq], -1), B.n)
    return ps, ob, B.off(), B.off()


def _compact_rows(order, row, width):
    """``out[..., q] = row[..., s]`` where ``order[..., s] == q``."""
    oh = order[..., :, None] == torch.arange(width, device=order.device,
                                             dtype=I32)
    return match_take(oh, row)


def _mpropose(B, ps):
    """Join the clock, compute predecessors and blockers, register the
    proposal, and accept, reject or wait (caesar.py:816)."""
    N, D = B.N, B.D
    s = B.src
    seq, key, client = B.pay[..., 0], B.pay[..., 1], B.pay[..., 2]
    cseq = B.pay[..., 3].clamp(0, B.clk_max)
    cpid = s.clamp(0, N)
    slot = dot_slot(seq, D)
    dirty = take2(ps["pseq"], s, slot) != 0
    ps = dict(
        ps,
        clk_counter=torch.maximum(ps["clk_counter"], cseq),
        err=_err(ps, ERR_DOT, dirty),
        pseq=put2(ps["pseq"], s, slot, seq),
        key_of=put2(ps["key_of"], s, slot, key),
        client_of=put2(ps["client_of"], s, slot, client),
        clk_seq=put2(ps["clk_seq"], s, slot, cseq),
        clk_pid=put2(ps["clk_pid"], s, slot, cpid),
        status=put2(ps["status"], s, slot,
                    torch.full_like(s, ST_PROPOSE_END)),
    )
    pred_mask, block_mask = _predecessors(ps, key, cseq, cpid)
    row_src, row_seq = take(ps["kc_src"], key), take(ps["kc_seq"], key)
    order, nd = compact_order(pred_mask, B.DEP)
    border, nb = compact_order(block_mask, B.BB)
    ps = dict(
        ps,
        dep_src=_put_rows(ps["dep_src"],
                          _compact_rows(order, row_src, B.DEP), s, slot),
        dep_seq=_put_rows(ps["dep_seq"],
                          _compact_rows(order, row_seq, B.DEP), s, slot),
        bb_src=_put_rows(ps["bb_src"], _compact_rows(border, row_src, B.BB),
                         s, slot),
        bb_seq=_put_rows(ps["bb_seq"], _compact_rows(border, row_seq, B.BB),
                         s, slot),
        err=_err(ps, ERR_CAPACITY, (nd > B.DEP) | (nb > B.BB)),
    )
    ps = _kc_add(B, ps, key, s, seq, cseq, cpid,
                 torch.ones_like(s, dtype=torch.bool))

    # the direct blocker verdicts of this one dot (caesar.py:474-495)
    bsrc = take2(ps["bb_src"], s, slot)                         # [L, N, BB]
    bseq = take2(ps["bb_seq"], s, slot)
    bslot = dot_slot(bseq, D)
    present = bseq > 0
    valid = gather_cell(ps["pseq"], bsrc, bslot) == bseq
    gcd = present & ~valid
    safe = present & valid & (gather_cell(ps["status"], bsrc, bslot)
                              >= ST_ACCEPT)
    my_seq = take2(ps["pseq"], s, slot)
    b_dsrc = gather_cell(ps["dep_src"], bsrc, bslot)            # [.., BB, DEP]
    b_dseq = gather_cell(ps["dep_seq"], bsrc, bslot)
    member = ((b_dseq > 0) & (b_dsrc == s[..., None, None])
              & (b_dseq == my_seq[..., None, None])).any(-1)
    reject = safe & ~member
    resolved = ~present | gcd | (safe & member)
    has_block = nb > 0
    any_rej, all_res = reject.any(-1), resolved.all(-1)
    wait = B.lane("wait_condition")
    accept_now = ~has_block | (wait & all_res & ~any_rej)
    reject_now = has_block & (~wait | any_rej)
    ps, ob = _propose_reply(B, ps, B.empty(), s, slot, seq, accept_now, 0,
                            accept_now | reject_now)
    return ps, ob, B.off(), B.off()


def _agg_union(B, ps, slot, base, enable):
    """Union the message's dep list (count at word ``base``, pairs after
    it) into the dot's aggregate table: new entries, deduped against the
    table and against earlier entries of the message, take the free
    table slots in rank order; too few raise ERR_CAPACITY."""
    Q = B.DEP
    do = enable
    iota = B.iota(Q)
    en = do[..., None] & (iota < B.pay[..., base:base + 1])
    idxs = base + 1 + 2 * iota
    dsrcs = torch.where(en, take_words(B.pay, idxs), 0)
    dseqs = torch.where(en, take_words(B.pay, idxs + 1), 0)
    row_src, row_seq = take(ps["ag_src"], slot), take(ps["ag_seq"], slot)
    in_table = ((row_seq[..., None, :] == dseqs[..., :, None])
                & (row_src[..., None, :] == dsrcs[..., :, None])
                & (row_seq[..., None, :] > 0)).any(-1)
    same = ((dseqs[..., None, :] == dseqs[..., :, None])
            & (dsrcs[..., None, :] == dsrcs[..., :, None]))
    earlier = en[..., None, :] & (iota[None, :] < iota[:, None])
    new = en & ~in_table & ~(same & earlier).any(-1)
    new_order, n_new = compact_order(new, Q)
    free = row_seq == 0
    free_order, n_free = compact_order(free, Q)
    match = ((new_order[..., :, None] == free_order[..., None, :])
             & new[..., :, None] & free[..., None, :])
    write = match.any(-2)
    wslot = torch.where(do, slot, B.D)
    return dict(
        ps,
        ag_src=_put_rows(ps["ag_src"],
                         torch.where(write, match_take(match, dsrcs), row_src),
                         wslot),
        ag_seq=_put_rows(ps["ag_seq"],
                         torch.where(write, match_take(match, dseqs), row_seq),
                         wslot),
        err=_err(ps, ERR_CAPACITY, do & (n_new > n_free)),
    )


def _agg_broadcast(B, ps, seq, cseq, cpid, mtype, valid):
    """Broadcast MCommit/MRetry (``mtype`` per (lane, process)) with the
    aggregated clock and deps."""
    slot = dot_slot(seq, B.D)
    ag_seq_row = take(ps["ag_seq"], slot)
    order, nd = compact_order(ag_seq_row > 0, B.DEP)
    pay = B.zeros(B.P)
    for i, w in enumerate((B.me, seq, cseq, cpid, nd)):
        pay[..., i] = w
    pay = pack_pairs(pay, 5 + 2 * order.clamp(max=B.P),
                     take(ps["ag_src"], slot), ag_seq_row)
    ob = emit_broadcast(B.empty(), CaesarDev.MCOMMIT, pay, B.n)
    ob["mtype"] = mtype[..., None].expand_as(ob["mtype"]).clone()
    ob["valid"] = ob["valid"] & valid[..., None]
    return ob


def _mproposeack(B, ps):
    """Join clocks, union deps, and take the fast path (all ok at the
    fast quorum size) or the retry round (a reject once the write
    quorum replied) (caesar.py:966)."""
    X = CaesarDev
    seq = B.pay[..., 0]
    cseq = B.pay[..., 1].clamp(0, B.clk_max)
    cpid = B.pay[..., 2]
    ok = B.pay[..., 3] > 0
    slot = dot_slot(seq, B.D)
    st = take2(ps["status"], B.me, slot)
    qa_done_s = take(ps["qa_done"], slot)
    live = ((st == ST_PROPOSE_END) | (st == ST_REJECT)) & ~qa_done_s
    qa_cseq_s, qa_cpid_s = take(ps["qa_cseq"], slot), take(ps["qa_cpid"],
                                                           slot)
    join_hi = live & _clk_lt(qa_cseq_s, qa_cpid_s, cseq, cpid)
    qa_cnt_s = take(ps["qa_cnt"], slot)
    cnt = qa_cnt_s + 1
    qa_ok_s = take(ps["qa_ok"], slot)
    all_ok = qa_ok_s & ok
    ps = dict(
        ps,
        qa_cnt=put(ps["qa_cnt"], slot, torch.where(live, cnt, qa_cnt_s)),
        qa_ok=put(ps["qa_ok"], slot, torch.where(live, all_ok, qa_ok_s)),
        qa_cseq=put(ps["qa_cseq"], slot,
                    torch.where(join_hi, cseq, qa_cseq_s)),
        qa_cpid=put(ps["qa_cpid"], slot,
                    torch.where(join_hi, cpid, qa_cpid_s)),
    )
    ps = _agg_union(B, ps, slot, 4, live)
    done = live & ((cnt == B.lane("fq_size"))
                   | (~all_ok & (cnt >= B.lane("wq_size"))))
    fast = done & all_ok
    slow = done & ~all_ok
    ps = dict(
        ps,
        qa_done=put(ps["qa_done"], slot, qa_done_s | done),
        m_fast=ps["m_fast"] + fast.to(I32),
        m_slow=ps["m_slow"] + slow.to(I32),
    )
    mtype = torch.where(fast, X.MCOMMIT, X.MRETRY).to(I32)
    ob = _agg_broadcast(B, ps, seq, take(ps["qa_cseq"], slot),
                        take(ps["qa_cpid"], slot), mtype, done)
    return ps, ob, B.off(), B.off()


def _store_deps(B, ps, src, slot, skip_self, seq, enable):
    """Replace the dot's dep list with the message's (count at word 4),
    minus a self-dep when ``skip_self`` (caesar.rs:665-668)."""
    Q = B.DEP
    nd = B.pay[..., 4]
    idxs = 5 + 2 * B.iota(Q)
    en = B.iota(Q) < nd[..., None]
    dsrcs = torch.where(en, take_words(B.pay, idxs), 0)
    dseqs = torch.where(en, take_words(B.pay, idxs + 1), 0)
    if skip_self:
        selfdep = (dsrcs == src[..., None]) & (dseqs == seq[..., None])
        dsrcs = torch.where(selfdep, 0, dsrcs)
        dseqs = torch.where(selfdep, 0, dseqs)
    wsrc = torch.where(enable, src, B.N)
    return dict(
        ps,
        dep_src=_put_rows(ps["dep_src"], dsrcs, wsrc, slot),
        dep_seq=_put_rows(ps["dep_seq"], dseqs, wsrc, slot),
        err=_err(ps, ERR_CAPACITY, enable & (nd > Q)),
    )


def _update_clock(B, ps, src, slot, key, new_cseq, new_cpid, enable):
    """Swap the registered clock (caesar.rs:893-918), clamped to the
    executor's packing bound."""
    new_cseq = new_cseq.clamp(0, B.clk_max)
    new_cpid = new_cpid.clamp(0, B.N)
    old_cseq = take2(ps["clk_seq"], src, slot)
    old_cpid = take2(ps["clk_pid"], src, slot)
    changed = enable & ((old_cseq != new_cseq) | (old_cpid != new_cpid))
    ps = _kc_remove(B, ps, key, old_cseq, old_cpid, changed)
    ps = _kc_add(B, ps, key, src, take2(ps["pseq"], src, slot), new_cseq,
                 new_cpid, changed)
    wsrc = torch.where(enable, src, B.N)
    return dict(
        ps,
        clk_seq=put2(ps["clk_seq"], wsrc, slot, new_cseq),
        clk_pid=put2(ps["clk_pid"], wsrc, slot, new_cpid),
    )


def _commit_or_retry(B, ps, skip_self, new_status):
    """What MCommit and MRetry share: the dot's state, the final (or
    retry) clock and deps. Returns ``(ps, dsrc, seq, cseq, cpid, slot,
    key, do)``."""
    dsrc, seq, cseq, cpid = (B.pay[..., i] for i in range(4))
    slot = dot_slot(seq, B.D)
    st = take2(ps["status"], dsrc, slot)
    have = take2(ps["pseq"], dsrc, slot) == seq
    do = have & (st != ST_COMMIT) & (st != ST_EXECUTED)
    key = take2(ps["key_of"], dsrc, slot)
    ps = dict(
        ps,
        clk_counter=torch.maximum(ps["clk_counter"], cseq),
        err=_err(ps, ERR_PROTO, ~have),
    )
    ps = _store_deps(B, ps, dsrc, slot, skip_self, seq, do)
    ps = _update_clock(B, ps, dsrc, slot, key, cseq, cpid, do)
    wsrc = torch.where(do, dsrc, B.N)
    ps = dict(ps, status=put2(ps["status"], wsrc, slot,
                              torch.full_like(dsrc, new_status)))
    return ps, dsrc, seq, cseq, cpid, slot, key, do


def _mcommit(B, ps):
    """Final clock + deps; both scans run (caesar.py:1072)."""
    ps, *_, do = _commit_or_retry(B, ps, True, ST_COMMIT)
    return ps, B.empty(), do, do


def _mretry(B, ps):
    """Adopt the retry clock + deps, reply with my predecessors at the
    new clock ∪ the message deps; the wait scan runs (caesar.py:1104)."""
    Q, P = B.DEP, B.P
    ps, dsrc, seq, cseq, cpid, slot, key, do = _commit_or_retry(
        B, ps, False, ST_ACCEPT)
    ps = dict(ps, bb_seq=_put_rows(ps["bb_seq"], B.zeros(B.BB),
                                   torch.where(do, dsrc, B.N), slot))
    pred_mask, _ = _predecessors(ps, key, cseq, cpid)
    pay = B.zeros(P)
    pay[..., 0] = dsrc
    pay[..., 1] = seq
    pay, nd, overflow = _pack_deps(B, ps, key, pred_mask, 2, pay)
    iota = B.iota(Q)
    my_valid = iota < nd[..., None]
    my_src = take_words(pay, 3 + 2 * iota)
    my_seq = take_words(pay, 4 + 2 * iota)
    m_en = iota < B.pay[..., 4:5]
    msrcs = torch.where(m_en, take_words(B.pay, 5 + 2 * iota), 0)
    mseqs = torch.where(m_en, take_words(B.pay, 6 + 2 * iota), 0)
    have_already = (my_valid[..., None, :]
                    & (my_src[..., None, :] == msrcs[..., :, None])
                    & (my_seq[..., None, :] == mseqs[..., :, None])).any(-1)
    same = ((mseqs[..., None, :] == mseqs[..., :, None])
            & (msrcs[..., None, :] == msrcs[..., :, None]))
    earlier = m_en[..., None, :] & (iota[None, :] < iota[:, None])
    add = m_en & ~have_already & ~(same & earlier).any(-1)
    add_order, n_add = compact_order(add, Q)
    at = nd[..., None] + add_order.clamp(max=Q)
    lo = torch.where(add & (nd[..., None] + add_order < Q), 3 + 2 * at, P)
    pay = pack_pairs(pay, lo, msrcs, mseqs)
    o2 = nd + n_add > Q
    pay[..., 2] = torch.minimum(nd + n_add, torch.full_like(nd, Q))
    ps = dict(ps, err=_err(ps, ERR_CAPACITY, do & (overflow | o2)))
    ob = emit(B.empty(), 0, B.src, CaesarDev.MRETRYACK, pay, do)
    return ps, ob, B.off(), do


def _mretryack(B, ps):
    """Union the write quorum's dep replies; on the last one, commit
    (caesar.py:1188)."""
    seq = B.pay[..., 1]
    slot = dot_slot(seq, B.D)
    live = take2(ps["status"], B.me, slot) == ST_ACCEPT
    qr_cnt_s = take(ps["qr_cnt"], slot)
    cnt = qr_cnt_s + 1
    ps = dict(ps, qr_cnt=put(ps["qr_cnt"], slot,
                             torch.where(live, cnt, qr_cnt_s)))
    ps = _agg_union(B, ps, slot, 2, live)
    chosen = live & (cnt == B.lane("wq_size"))
    mtype = torch.full_like(seq, CaesarDev.MCOMMIT)
    ob = _agg_broadcast(B, ps, seq, take2(ps["clk_seq"], B.me, slot),
                        take2(ps["clk_pid"], B.me, slot), mtype, chosen)
    return ps, ob, B.off(), B.off()


def _mgc(B, ps):
    """Count each advertised executed dot; free at n sightings
    (caesar.py:1217). The reference loops over gc_per_msg entries; an
    entry past every MGC's count changes nothing, so the loop ends
    there."""
    nd = torch.where(B.idx == CaesarDev.MGC, B.pay[..., 0], 0)
    freed = _no_freed(B)
    for i in range(CaesarDev.gc_per_msg(B.dims)):
        take_ = i < nd
        if not bool(take_.any()):
            break
        ps, freed = _gc_count(B, ps, freed, B.pay[..., 1 + 2 * i],
                              B.pay[..., 2 + 2 * i], take_)
    return _apply_freed(ps, freed), B.empty(), B.off(), B.off()


def _wait_drain(B, ps):
    return ps, B.empty(), B.off(), ~B.off()


def _exec_drain(B, ps):
    return ps, B.empty(), ~B.off(), B.off()


def _gc_drain(B, ps):
    """Broadcast up to one message's worth of the GC round's buffered
    dots to all but me; chain while the round's snapshot remains
    (caesar.py:1249)."""
    N, P, EB = B.N, B.P, B.EB
    DPM = CaesarDev.gc_per_msg(B.dims)
    n_buf = ps["gb_n"]
    take_ = torch.minimum(torch.minimum(ps["gb_gc"], n_buf),
                          torch.full_like(n_buf, DPM))
    idx = B.iota(DPM)
    pay = B.zeros(P)
    pay[..., 0] = take_
    lo = torch.where(idx < take_[..., None], 1 + 2 * idx, P)
    at = idx.clamp(max=EB - 1).long()             # jnp's clamped gather
    pay = pack_pairs(pay, lo, ps["gb_src"][..., at], ps["gb_seq"][..., at])
    # jnp.roll(x, -take): out[i] = x[(i + take) mod EB]
    rolled = torch.remainder(B.iota(EB) + take_[..., None], EB).long()
    remaining = n_buf - take_
    remaining_gc = ps["gb_gc"] - take_
    keep = B.iota(EB) < remaining[..., None]
    ps = dict(
        ps,
        gb_src=torch.where(keep, ps["gb_src"].gather(-1, rolled), 0),
        gb_seq=torch.where(keep, ps["gb_seq"].gather(-1, rolled), 0),
        gb_n=remaining,
        gb_gc=remaining_gc,
    )
    ob = emit_broadcast(B.empty(), CaesarDev.MGC, pay, B.n, B.me,
                        exclude_me=True)
    ob["valid"] = ob["valid"] & (take_ > 0)[..., None]
    ob = emit(ob, N, B.me, CaesarDev.GC_DRAIN, B.zero_word(),
              remaining_gc > 0)
    return ps, ob, B.off(), B.off()
