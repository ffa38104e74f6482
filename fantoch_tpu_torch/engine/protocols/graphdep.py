"""Device twin of the dependency-based protocols, Atlas
(fantoch_ps/src/protocol/atlas.rs) and EPaxos (epaxos.rs), batched over
``[L, N]`` (lane, process): the counterpart of the reference's
``fantoch_tpu/engine/protocols/graphdep.py``.

Flow: the coordinator takes its per-key latest dot as the command's
dependencies and broadcasts MCollect; fast-quorum members merge the
coordinator's deps with their own latest dot and ack; the coordinator
counts the reports per dependency and takes the fast path iff

- Atlas: every reported dep was reported by >= f members;
- EPaxos: every reported dep was reported by every member;

else a single-decree consensus round on the dep set runs through the
write quorum (chosen at model-f+1 accepts). Commits carry (key, client,
deps) into the graph executor. The two protocols differ only in quorum
sizes and the fast-path predicate, which the lane ctx carries
(``fp_mode``, ``ack_self``, the quorum masks, ``expected_acks``), so one
kernel serves both.

Graph executor: instead of Tarjan's SCC walk the device computes the
greatest fixed point of

    ok(d) = committed(d) and for every dep e: executed(e) or ok(e)

by masked relaxation: ok converges to the dots whose transitive
dependency closure is committed. One dot executes per drain (dots whose
deps are all executed first, then cycle members, in (source, sequence)
order), chained through MDRAIN self-messages.

State (per process, fixed shapes; the reference's ``init_state``): the
per-key latest dot ``[K]``; the per-dot payload ``[N, D]`` of every
source; the coordinator's per-dot dep report table ``qd_* [D, Q]``
(Q = N + 1 bounds the distinct deps); the executor's vertex store
``vx_* [N, D]`` with its dep lists ``[N, D, Q]``; the executed and GC
committed clocks per source (interval sets, ``engine/iset.py``) and the
frontier exchange.

:meth:`_DepDev.ready_plain`, :meth:`_DepDev.periodic_plain` and
:meth:`_DepDev.handle_plain`, composed by :meth:`_DepDev.step_plain`,
are the plain PyTorch twin of the ``graphdep_handle`` CUDA kernel
(``kernels/graphdep_handle.py``): like the reference's ``lax.switch``
under ``vmap`` the twin computes branches over the whole batch and
selects with masks (skipping the branches no (lane, process) takes),
then runs the hoisted drain on every (lane, process), enabled where
the branch asks for it.

On a monitored step the drain records every execution at its pick
(``engine/monitor.py`` ``mon_exec``), with the execute-before-commit
guard read from the GC committed clock, a data path independent of the
vertex store's committed flags (the reference's ``graphdep.py:415-433``).
Not here: the narrowed metric planes (``NARROW_METRICS``, ROADMAP Queue
A item 5). Like the reference, recovery is not modeled.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core import emit, emit_broadcast, empty_outbox, write_running
from ..dims import (
    ERR_CAPACITY, ERR_DOT, ERR_PROTO, ERR_SEQ, INF, PMT, PPAY, PSRC,
    SEQ_BOUND, EngineDims, dot_slot,
)
from ..iset import (
    first_true, iset_add, iset_contains, iset_contains_gathered,
)
from ..monitor import mon_exec
from .identity import DevIdentity
from .masked import bcast, put, put2, select, take

I32 = torch.int32


class _DepDev(DevIdentity):
    """Shared machinery; subclasses pick the quorum formulas and the
    fast-path predicate through the lane ctx."""

    SUBMIT = 0
    MCOLLECT = 1
    MCOLLECTACK = 2
    MCOMMIT = 3
    MCONSENSUS = 4
    MCONSENSUSACK = 5
    MGC = 6
    MDRAIN = 7
    NUM_TYPES = 8
    TO_CLIENT = 9

    PERIODIC_ROWS = 1  # garbage collection
    MONITORED = True  # mon_exec hook at the graph executor's drain
    # the hoisted graph drain fills the last two outbox slots, beyond
    # what a branch itself fills
    EXTRA_SLOTS = 2

    def __init__(self, keys: int, gap_slots: int = 8):
        self.K = keys
        self.G = gap_slots

    # -- host-side builders -------------------------------------------

    @staticmethod
    def dep_slots(n: int) -> int:
        """Q: each of the <= n ack reporters contributes at most its own
        latest dep, plus the coordinator's dep rides in every ack."""
        return n + 1

    def payload_width(self, n: int) -> int:
        # MCOMMIT: [dsrc, seq, key, client, nd] + (src, seq) * Q
        return max(5 + 2 * self.dep_slots(n), n)

    def periodic_intervals(self, config, dims: EngineDims):
        gc = config.gc_interval_ms
        return [gc if gc is not None else INF]

    def min_live(self, config) -> int:
        """Every collect waits on the full fast quorum and the slow path
        on the write quorum; recovery is not modeled, so fewer survivors
        than either cannot commit."""
        return max(self._quorum_sizes(config))

    def _quorum_sizes(self, config):
        raise NotImplementedError

    def _fp_mode(self) -> int:
        raise NotImplementedError

    def _ack_self(self) -> bool:
        raise NotImplementedError

    def lane_ctx(self, config, dims: EngineDims, sorted_idx: np.ndarray):
        N = dims.N
        fq_size, wq_size = self._quorum_sizes(config)
        fq = np.zeros((N, N), bool)
        wq = np.zeros((N, N), bool)
        for p in range(config.n):
            for member in sorted_idx[p][:fq_size]:
                fq[p, member] = True
            for member in sorted_idx[p][:wq_size]:
                wq[p, member] = True
        ack_self = self._ack_self()
        return {
            "fast_quorum": fq,
            "write_quorum": wq,
            "expected_acks": np.int32(fq_size if ack_self else fq_size - 1),
            "fp_mode": np.int32(self._fp_mode()),
            "ack_self": np.bool_(ack_self),
        }

    def init_state(self, dims: EngineDims, ctx_np) -> Dict[str, np.ndarray]:
        N, D, K, G = dims.N, dims.D, self.K, self.G
        Q = self.dep_slots(N)
        z = np.zeros
        return {
            "latest_src": z((N, K), np.int32),
            "latest_seq": z((N, K), np.int32),
            "seq_in_slot": z((N, N, D), np.int32),
            "key_of": z((N, N, D), np.int32),
            "client_of": z((N, N, D), np.int32),
            "own_seq": z((N,), np.int32),
            "ack_cnt": z((N, D), np.int32),
            "qd_src": z((N, D, Q), np.int32),
            "qd_seq": z((N, D, Q), np.int32),
            "qd_cnt": z((N, D, Q), np.int32),
            "slow_acks": z((N, D), np.int32),
            "vx_committed": z((N, N, D), bool),
            "vx_seq": z((N, N, D), np.int32),
            "vx_key": z((N, N, D), np.int32),
            "vx_client": z((N, N, D), np.int32),
            "vx_nd": z((N, N, D), np.int32),
            "vx_dep_src": z((N, N, D, Q), np.int32),
            "vx_dep_seq": z((N, N, D, Q), np.int32),
            "exec_front": z((N, N), np.int32),
            "exec_gaps": z((N, N, G, 2), np.int32),
            "comm_front": z((N, N), np.int32),
            "comm_gaps": z((N, N, G, 2), np.int32),
            "others_frontier": z((N, N, N), np.int32),
            "seen": z((N, N), bool),
            "prev_stable": z((N, N), np.int32),
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
    def handlers(ps, has, rows, fire, ep, ctx, dims: EngineDims,
                 cap=None):
        """Readiness gate, periodic timer, message handler and graph
        drain of every (lane, process): ``(rdy, ps, periodic outbox,
        handler outbox)`` (the event times ``ep`` are not read). ``ps``
        is updated in place on the lanes ``cap`` lets run (every lane
        without one) and returned as the same tensors. Runs the
        ``graphdep_handle`` kernel on CUDA tensors."""
        from ...kernels.graphdep_handle import graphdep_handle

        return graphdep_handle(ps, has, rows, fire, ctx, dims, cap)

    @staticmethod
    def step_plain(ps, has, rows, fire, ctx, dims: EngineDims, cap=None):
        """The plain twin of the kernel, in the reference's order
        (core.py:890-918): ``ready`` on the incoming state, ``periodic``,
        then ``handle`` (the branch, then the drain), out of place; then
        the running lanes' rows (of ``cap``; every lane without one) are
        copied into ``ps``, in place, as the kernel writes them
        (``core.write_running``). A frozen lane's ``rdy`` is false and
        its outboxes empty."""
        X = _DepDev
        none = torch.full_like(rows[..., PMT], X.NUM_TYPES)
        mtype0 = torch.where(has, rows[..., PMT], none)
        rdy = X.ready_plain(ps, rows, mtype0, dims)
        mtype = torch.where(has & rdy, mtype0, none)
        new, pout = X.periodic_plain(ps, fire, ctx, dims)
        new, hout = X.handle_plain(new, mtype, rows, ctx, dims)
        return write_running(ps, (rdy, new, pout, hout), cap, dims)

    @staticmethod
    def ready_plain(ps, rows, mtype, dims: EngineDims):
        """MCollect needs a free dot slot (payload and vertex store);
        MCommit needs the MCollect payload (atlas.rs buffers early
        commits). Out-of-range sources read 0."""
        src, pay = rows[..., PSRC], rows[..., PPAY:]
        c_slot = dot_slot(pay[..., 0], dims.D)
        collect_ok = (
            (take(take(ps["seq_in_slot"], src), c_slot) == 0)
            & (take(take(ps["vx_seq"], src), c_slot) == 0)
        )
        seq = pay[..., 1]
        have = take(take(ps["seq_in_slot"], pay[..., 0]),
                    dot_slot(seq, dims.D)) == seq
        ok = torch.where(mtype == _DepDev.MCOLLECT, collect_ok,
                         torch.ones_like(collect_ok))
        return torch.where(mtype == _DepDev.MCOMMIT, have, ok)

    @staticmethod
    def periodic_plain(ps, fire, ctx, dims: EngineDims):
        """GARBAGE_COLLECTION: broadcast my committed frontier to all but
        me."""
        L, N = fire.shape[:2]
        me = torch.arange(N, device=fire.device, dtype=I32).expand(L, N)
        ob = emit_broadcast(
            empty_outbox(dims, (L, N), fire.device), _DepDev.MGC,
            ps["comm_front"], ctx["n"], me, exclude_me=True,
        )
        ob["valid"] = ob["valid"] & fire[..., 0:1]
        return ps, ob

    @staticmethod
    def handle_plain(ps, mtype, rows, ctx, dims: EngineDims):
        """The message switch (each branch that some (lane, process)
        takes, computed over the batch and selected by type), then the
        hoisted graph drain on every (lane, process), enabled after
        MCommit and MDrain."""
        X = _DepDev
        B = _Batch(ps, rows, ctx, dims)
        branches = [_submit, _mcollect, _mcollectack, _mcommit, _mconsensus,
                    _mconsensusack, _mgc]
        idx = mtype.clamp(0, X.NUM_TYPES)
        new_ps, new_ob = dict(ps), B.empty()
        for k, fn in enumerate(branches):
            mask = idx == k
            # a branch no (lane, process) takes is never selected; the
            # masks are disjoint, and MDrain and the noop keep ps and an
            # empty outbox
            if not bool(mask.any()):
                continue
            st, ob = fn(B, ps)
            for name, v in st.items():
                if v is not ps[name]:
                    new_ps[name] = torch.where(bcast(mask, v), v,
                                               new_ps[name])
            for name, v in ob.items():
                new_ob[name] = torch.where(bcast(mask, v), v, new_ob[name])
        enable = (idx == X.MCOMMIT) | (idx == X.MDRAIN)
        return _drain(B, new_ps, new_ob, enable)


class AtlasDev(_DepDev):
    """Atlas: fast quorum n/2 + f, write quorum f + 1; the coordinator
    acks itself; threshold-union fast path."""

    def _quorum_sizes(self, config):
        return config.atlas_quorum_sizes()

    def _fp_mode(self) -> int:
        return 0

    def _ack_self(self) -> bool:
        return True


class EPaxosDev(_DepDev):
    """EPaxos: minority-based quorums with f = n // 2; the coordinator
    does not ack itself; all-equal fast path."""

    def _quorum_sizes(self, config):
        return config.epaxos_quorum_sizes()

    def _fp_mode(self) -> int:
        return 1

    def _ack_self(self) -> bool:
        return False


class _Batch:
    """What every handler branch reads: the sizes, the popped messages
    and the lane ctx, with ``[L, N]`` leading axes."""

    def __init__(self, ps, rows, ctx, dims):
        self.dims = dims
        self.L, self.N, self.D, self.P = rows.shape[0], dims.N, dims.D, dims.P
        self.K = ps["latest_src"].shape[2]
        self.Q = ps["qd_src"].shape[3]
        self.dev = rows.device
        self.me = torch.arange(self.N, device=self.dev,
                               dtype=I32).expand(self.L, self.N)
        self.src = rows[..., PSRC]
        self.pay = rows[..., PPAY:]
        self.ctx = ctx
        self.n = ctx["n"]

    def lane(self, key):
        """A per-lane ctx scalar as ``[L, 1]``."""
        return self.ctx[key][:, None]

    def empty(self):
        return empty_outbox(self.dims, (self.L, self.N), self.dev)

    def words(self, *ws):
        """Payload words ``[L, N, P]``: ``ws`` first, zeros after."""
        out = torch.zeros((self.L, self.N, self.P), dtype=I32,
                          device=self.dev)
        for i, w in enumerate(ws):
            out[..., i] = w
        return out


def _err(ps, code, cond):
    return ps["err"] | code * cond.to(I32)


# ----------------------------------------------------------------------
# helpers (graphdep.py:316-366)
# ----------------------------------------------------------------------

def _qd_add(B, ps, slot, dsrc, dseq):
    """Merge one reported dep into the coordinator's count table: the
    first matching entry counts one more, else the first free one takes
    it; no free entry raises ERR_CAPACITY and drops it."""
    src_row = take(ps["qd_src"], slot)                          # [L, N, Q]
    seq_row = take(ps["qd_seq"], slot)
    do = dseq > 0
    match = (seq_row == dseq[..., None]) & (src_row == dsrc[..., None])
    found = match.any(-1)
    free = seq_row == 0
    overflow = do & ~found & ~free.any(-1)
    widx = torch.where(do & ~overflow,
                       torch.where(found, first_true(match), first_true(free)),
                       B.Q)
    cnt = take(take(ps["qd_cnt"], slot), widx)
    return dict(
        ps,
        qd_src=put2(ps["qd_src"], slot, widx, dsrc),
        qd_seq=put2(ps["qd_seq"], slot, widx, dseq),
        qd_cnt=put2(ps["qd_cnt"], slot, widx,
                    torch.where(found, cnt + 1, torch.ones_like(cnt))),
        err=_err(ps, ERR_CAPACITY, overflow),
    )


def _commit_broadcast(B, ps, seq, key, client, valid):
    """MCommit to all with the aggregated dep union, the present deps
    packed to the front as (src, seq) pairs from word 5."""
    slot = dot_slot(seq, B.D)
    seq_row = take(ps["qd_seq"], slot)                          # [L, N, Q]
    present = seq_row > 0
    order = present.cumsum(-1, dtype=I32) - 1
    order = torch.where(present & (order < B.Q), order, INF)
    pay = B.words(B.me, seq, key, client, present.sum(-1, dtype=I32))
    lo = 5 + 2 * torch.clamp(order, max=B.P)                    # > P: drops
    at = torch.arange(B.P, device=B.dev, dtype=I32)
    src_row = take(ps["qd_src"], slot)
    pay = pay + (
        torch.where(lo[..., None] == at, src_row[..., None], 0)
        + torch.where(lo[..., None] + 1 == at, seq_row[..., None], 0)
    ).sum(-2, dtype=I32)
    ob = emit_broadcast(B.empty(), _DepDev.MCOMMIT, pay, B.n)
    ob["valid"] = ob["valid"] & valid[..., None]
    return ob


# ----------------------------------------------------------------------
# graph-executor drain (graphdep.py:374-463)
# ----------------------------------------------------------------------

def _relax(ps, N, D):
    """``(ok, ready, passes)``: ``ok [L, N, N, D]`` the greatest fixed
    point of ``ok(d) = committed(d) and every dep of d is absent,
    executed or ok`` (a dep counts as ok only while its vertex cell still
    holds its sequence); ``ready`` the ok vertices whose deps are all
    absent or executed; ``passes [L, N]`` the Jacobi passes each (lane,
    process) needs until its set stands still (the last changes
    nothing). Only committed vertices can be ok, so only their dep rows
    are gathered."""
    committed = ps["vx_committed"]
    L, NP = committed.shape[:2]   # (lane, process); NP may be 1 (rows)
    # the M committed vertices, by flat index, and their (lane, process)
    vert = committed.flatten().nonzero().squeeze(1)
    lp = vert // (N * D)
    dep_src = ps["vx_dep_src"].flatten(0, 3)[vert]               # [M, Q]
    dep_seq = ps["vx_dep_seq"].flatten(0, 3)[vert]
    # the reference's plain gathers: a negative source counts from the
    # end, one out of range is clamped
    srcn = torch.where(dep_src < 0, dep_src + N, dep_src).clamp(0, N - 1)
    cell = (lp[:, None] * N + srcn) * D + dot_slot(dep_seq, D)   # flat [M, Q]
    executed = iset_contains_gathered(
        ps["exec_front"].flatten(0, 1)[lp],
        ps["exec_gaps"].flatten(0, 1)[lp], dep_src, dep_seq)
    static = (dep_seq == 0) | executed
    cell_valid = ps["vx_seq"].flatten()[cell] == dep_seq
    # from the committed set down; each (lane, process) relaxes on its
    # own, and the operator is monotone, so once a set stands still it
    # is that process's fixed point
    ok = committed.flatten().clone()
    passes = torch.zeros(L * NP, dtype=torch.int64, device=ok.device)
    active = torch.ones_like(passes, dtype=torch.bool)
    while bool(active.any()):
        old = ok[vert]
        new = old & (static | (ok[cell] & cell_valid)).all(-1)
        passes += active.long()
        moved = torch.zeros_like(passes).index_add_(0, lp, (new != old).long())
        active = active & (moved > 0)
        ok[vert] = new
    ready = torch.zeros_like(ok)
    ready[vert] = ok[vert] & static.all(-1)
    return (ok.view_as(committed), ready.view_as(committed),
            passes.view(L, NP))


def _drain(B, ps, ob, enable):
    """Execute one dot whose transitive dep closure is committed where
    ``enable`` holds: TO_CLIENT in outbox slot F - 2 if its client is
    attached here, MDRAIN to self in slot F - 1 while more remain. Runs
    on every (lane, process), as the reference's hoisted drain: a
    disabled one still writes both slots (invalid) and runs the
    executed set's absorption passes at its pick."""
    N, D, F = B.N, B.D, B.dims.F
    ok, ready, _passes = _relax(ps, N, D)
    num_ok = ok.sum((-2, -1), dtype=I32)
    sel = torch.where(ready.flatten(2).any(-1)[..., None, None], ready, ok)
    srcs = torch.arange(N, device=B.dev, dtype=I32)[:, None]
    packed = srcs * SEQ_BOUND + ps["vx_seq"]
    flat = torch.where(sel, packed, INF).flatten(2).argmin(-1).to(I32)
    esrc, eslot = flat // D, flat % D
    eseq = take(take(ps["vx_seq"], esrc), eslot)
    client = take(take(ps["vx_client"], esrc), eslot)
    do = enable & (num_ok > 0)
    if "_mon_hash" in ps:
        # safety monitor: the execute-before-commit guard reads the GC
        # committed clock of the picked dot's source
        committed = iset_contains(take(ps["comm_front"], esrc),
                                  take(ps["comm_gaps"], esrc), eseq)
        ps = mon_exec(ps, take(take(ps["vx_key"], esrc), eslot), esrc, eseq,
                      do, premature=~committed)
    front, gaps, overflow = iset_add(take(ps["exec_front"], esrc),
                                     take(ps["exec_gaps"], esrc), eseq, do)
    wsrc = torch.where(do, esrc, N)
    ps = dict(
        ps,
        exec_front=put(ps["exec_front"], esrc, front),
        exec_gaps=put(ps["exec_gaps"], esrc, gaps),
        vx_committed=put2(ps["vx_committed"], wsrc, eslot,
                          torch.zeros_like(do)),
        vx_seq=put2(ps["vx_seq"], wsrc, eslot, torch.zeros_like(eseq)),
        err=_err(ps, ERR_CAPACITY, overflow),
    )
    attach = B.ctx["client_attach"][:, None, :].expand(B.L, N, -1)
    zero = torch.zeros_like(client)[..., None]
    ob = emit(ob, F - 2, N + client, _DepDev.TO_CLIENT, zero,
              do & (take(attach, client) == B.me))
    ob = emit(ob, F - 1, B.me, _DepDev.MDRAIN, zero, do & (num_ok > 1))
    return ps, ob


# ----------------------------------------------------------------------
# handlers (graphdep.py:471-728)
# ----------------------------------------------------------------------

def _submit(B, ps):
    """Next dot; deps = my latest dot on the key; MCollect to all."""
    client, key = B.pay[..., 0], B.pay[..., 2]
    seq = ps["own_seq"] + 1
    slot = dot_slot(seq, B.D)
    zero = torch.zeros_like(seq)
    zq = torch.zeros((B.L, B.N, B.Q), dtype=I32, device=B.dev)
    prev_src, prev_seq = take(ps["latest_src"], key), take(ps["latest_seq"],
                                                           key)
    ps = dict(
        ps,
        err=_err(ps, ERR_SEQ, seq >= SEQ_BOUND),
        own_seq=seq,
        latest_src=put(ps["latest_src"], key, B.me),
        latest_seq=put(ps["latest_seq"], key, seq),
        ack_cnt=put(ps["ack_cnt"], slot, zero),
        slow_acks=put(ps["slow_acks"], slot, zero),
        qd_src=put(ps["qd_src"], slot, zq),
        qd_seq=put(ps["qd_seq"], slot, zq),
        qd_cnt=put(ps["qd_cnt"], slot, zq),
    )
    ob = emit_broadcast(
        B.empty(), _DepDev.MCOLLECT,
        torch.stack([seq, key, client, prev_src, prev_seq], -1), B.n,
    )
    return ps, ob


def _mcollect(B, ps):
    """Store the payload; fast-quorum members merge the coordinator's
    deps with their own latest and ack; the coordinator acks its own
    deps iff ``ack_self`` (Atlas)."""
    s = B.src
    seq, key, client, cdsrc, cdseq = (B.pay[..., i] for i in range(5))
    slot = dot_slot(seq, B.D)
    dirty = ((take(take(ps["seq_in_slot"], s), slot) != 0)
             | (take(take(ps["vx_seq"], s), slot) != 0))
    ps = dict(
        ps,
        err=_err(ps, ERR_DOT, dirty),
        seq_in_slot=put2(ps["seq_in_slot"], s, slot, seq),
        key_of=put2(ps["key_of"], s, slot, key),
        client_of=put2(ps["client_of"], s, slot, client),
    )
    fq = B.ctx["fast_quorum"][:, None].expand(B.L, B.N, B.N, B.N)
    in_q = take(take(fq, s), B.me)
    from_self = s == B.me
    member = in_q & ~from_self
    d1src = torch.where(member, take(ps["latest_src"], key), cdsrc)
    d1seq = torch.where(member, take(ps["latest_seq"], key), cdseq)
    # the second dep is the coordinator's, dropped when equal to mine
    keep = member & ~((d1src == cdsrc) & (d1seq == cdseq))
    d2src = torch.where(keep, cdsrc, 0)
    d2seq = torch.where(keep, cdseq, 0)
    mkey = torch.where(member, key, B.K)
    ps = dict(ps, latest_src=put(ps["latest_src"], mkey, s),
              latest_seq=put(ps["latest_seq"], mkey, seq))
    ack = in_q & (B.lane("ack_self") | ~from_self)
    ob = emit(B.empty(), 0, s, _DepDev.MCOLLECTACK,
              torch.stack([seq, d1src, d1seq, d2src, d2seq], -1), ack)
    return ps, ob


def _mcollectack(B, ps):
    """Aggregate the dep reports; on the last expected ack run the
    fast-path predicate: commit, or a consensus round through the write
    quorum. When neither is taken the outbox keeps the consensus
    broadcast's (invalid) rows, as the reference's select does."""
    seq = B.pay[..., 0]
    slot = dot_slot(seq, B.D)
    ps = _qd_add(B, ps, slot, B.pay[..., 1], B.pay[..., 2])
    ps = _qd_add(B, ps, slot, B.pay[..., 3], B.pay[..., 4])
    cnt = take(ps["ack_cnt"], slot) + 1
    ps = dict(ps, ack_cnt=put(ps["ack_cnt"], slot, cnt))
    all_acks = cnt == B.lane("expected_acks")
    present = take(ps["qd_seq"], slot) > 0
    counts = take(ps["qd_cnt"], slot)
    # Atlas: every dep seen >= f times; EPaxos: every dep seen by all
    threshold = torch.where(B.lane("fp_mode") == 0, B.lane("f"),
                            B.lane("expected_acks"))
    fp_ok = (~present | (counts >= threshold[..., None])).all(-1)
    fast = all_acks & fp_ok
    slow = all_acks & ~fast
    ps = dict(ps, m_fast=ps["m_fast"] + fast.to(I32),
              m_slow=ps["m_slow"] + slow.to(I32))
    key = take(take(ps["key_of"], B.me), slot)
    client = take(take(ps["client_of"], B.me), slot)
    ob = _commit_broadcast(B, ps, seq, key, client, fast)
    obc = emit_broadcast(B.empty(), _DepDev.MCONSENSUS,
                         torch.stack([B.me, seq], -1), B.n)
    F = obc["valid"].shape[-1]
    wq = torch.zeros((B.L, B.N, F), dtype=torch.bool, device=B.dev)
    wq[..., :B.N] = B.ctx["write_quorum"]
    obc["valid"] = obc["valid"] & slow[..., None] & wq
    return ps, {k: select([fast], [ob[k], obc[k]]) for k in ob}


def _mcommit(B, ps):
    """Feed the vertex store and record the committed dot for GC; the
    drain runs after the switch. The dot source is not clamped: one out
    of range reads 0 and its writes drop."""
    N, Q = B.N, B.Q
    dsrc = B.pay[..., 0]
    seq, key, client, nd = (B.pay[..., i] for i in range(1, 5))
    slot = dot_slot(seq, B.D)
    have = take(take(ps["seq_in_slot"], dsrc), slot) == seq
    already = take(take(ps["vx_seq"], dsrc), slot) == seq
    do = have & ~already
    ps = dict(ps, err=_err(ps, ERR_PROTO, ~have))
    dep_en = torch.arange(Q, device=B.dev, dtype=I32) < nd[..., None]
    dsrcs = torch.where(dep_en, B.pay[..., 5:5 + 2 * Q:2], 0)
    dseqs = torch.where(dep_en, B.pay[..., 6:6 + 2 * Q:2], 0)
    wsrc = torch.where(do, dsrc, N)
    ps = dict(
        ps,
        vx_committed=put2(ps["vx_committed"], wsrc, slot,
                          torch.ones_like(do)),
        vx_seq=put2(ps["vx_seq"], wsrc, slot, seq),
        vx_key=put2(ps["vx_key"], wsrc, slot, key),
        vx_client=put2(ps["vx_client"], wsrc, slot, client),
        vx_nd=put2(ps["vx_nd"], wsrc, slot, nd),
        vx_dep_src=put2(ps["vx_dep_src"], wsrc, slot, dsrcs),
        vx_dep_seq=put2(ps["vx_dep_seq"], wsrc, slot, dseqs),
    )
    cf, cg, overflow = iset_add(take(ps["comm_front"], dsrc),
                                take(ps["comm_gaps"], dsrc), seq, do)
    return dict(
        ps,
        comm_front=put(ps["comm_front"], dsrc, cf),
        comm_gaps=put(ps["comm_gaps"], dsrc, cg),
        err=_err(ps, ERR_CAPACITY, overflow),
    ), B.empty()


def _mconsensus(B, ps):
    """Slow-path accept: with no recovery the initial ballot always
    wins, so the acceptor just acks."""
    ob = emit(B.empty(), 0, B.src, _DepDev.MCONSENSUSACK,
              B.pay[..., 0:2], torch.ones_like(B.src, dtype=torch.bool))
    return ps, ob


def _mconsensusack(B, ps):
    """Chosen at model-f+1 accepts (also for EPaxos), then commit with
    the dep union gathered during collect."""
    seq = B.pay[..., 1]
    slot = dot_slot(seq, B.D)
    cnt = take(ps["slow_acks"], slot) + 1
    chosen = cnt == B.lane("f") + 1
    ps = dict(ps, slow_acks=put(ps["slow_acks"], slot, cnt))
    key = take(take(ps["key_of"], B.me), slot)
    client = take(take(ps["client_of"], B.me), slot)
    return ps, _commit_broadcast(B, ps, seq, key, client, chosen)


def _mgc(B, ps):
    """Committed-clock GC: join the sender's frontier; stable = min of
    my committed clock and every other's; free the dot slots up to it."""
    N, s = B.N, B.src
    of = put(ps["others_frontier"], s,
             torch.maximum(take(ps["others_frontier"], s), B.pay[..., :N]))
    seen = put(ps["seen"], s, torch.ones_like(s, dtype=torch.bool))
    procs = torch.arange(N, device=B.dev, dtype=I32)
    nmask = (procs < B.n[:, None])[:, None, :]                  # [L, 1, N]
    others = nmask & (procs != B.me[..., None])                 # [L, N, N]
    ready = (seen | ~others).all(-1)
    min_others = torch.where(others[..., None], of, INF).amin(-2)
    stable = torch.minimum(ps["comm_front"], min_others)
    stable = torch.where(ready[..., None] & nmask, stable, 0)
    delta = torch.clamp(stable - ps["prev_stable"], min=0)
    prev = torch.maximum(ps["prev_stable"], stable)
    sis = ps["seq_in_slot"]
    freed = (sis > 0) & (sis <= prev[..., None])
    return dict(
        ps,
        others_frontier=of,
        seen=seen,
        prev_stable=prev,
        m_stable=ps["m_stable"] + delta.sum(-1, dtype=I32),
        seq_in_slot=torch.where(freed, 0, sis),
    ), B.empty()
