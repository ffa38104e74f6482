"""Device twin of Tempo with partial replication and multi-key commands,
batched over ``[L, N]`` (lane, process): the counterpart of the
reference's ``fantoch_tpu/engine/protocols/tempo_partial.py``
(fantoch_ps/src/protocol/partial.rs and tempo.rs).

The protocol core is :class:`TempoDev`'s; partial replication adds the
reference's shard coordination:

- ``MForwardSubmit`` hands the dot to the closest process of every
  other shard the command touches (partial.rs:8-35); each shard runs
  its own collect round for the shared dot;
- quorum members ``MBump`` other shards' closest processes with their
  clock so remote keys advance (tempo.rs:674-701, 1013-1049);
- per-shard commit clocks aggregate at the dot owner through
  ``MShardCommit`` → ``MShardAggregatedCommit`` (partial.rs:37-167);
  each shard coordinator then broadcasts the final-clock ``MCommit``
  inside its shard with the votes it holds;
- the table executor runs per key with pending queues, the
  ``StableAtShard`` fan-out once all of a command's local keys are
  stable, and cross-shard messages through the closest process
  (executor/table/executor.rs:171-360);
- clients count per-key result parts (the engine's ``cmd_parts``,
  kernel ``emit_rewrite``).

A command is (client, cseq): its keys per shard, touched-shard mask and
part count are ctx tables (``cmd_skey``/``cmd_kmask``/``cmd_parts``,
``engine/spec.py command_tables``), so messages carry (client, cseq).
Coordinator state is per (dot source, slot): a process coordinates
foreign dots when it is a forwarded shard coordinator. At most one
entry per key (the parked queue head, phase 2) has contributed to
``stable_cnt`` and sent its ``StableAtShard`` fan-out.

:meth:`TempoPartialDev.step_plain` is the plain PyTorch twin of the
``tempo_partial_handle`` CUDA kernel (``kernels/tempo_partial_handle.py``).
Its handlers run on the (lane, process) pairs that take each branch
only: their state rows are gathered, updated with the reference's
one-hot semantics (a read out of range yields 0, a write there drops)
and written back, so the twin's cost follows the messages, not the
``[N, N, D, KPC, N]`` vote planes.

Not here, as in the reference: the safety-monitor hook and the
narrowed metric planes.
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
from ..iset import first_true, iset_add, iset_add_range
from .masked import bcast, put, put2, select, take, take2
from .tempo import TempoDev, _bump, _detached_all, _err, _vote_add

I32 = torch.int32

OUTBOX_KEYS = ("valid", "dst", "mtype", "payload", "delay", "src")
# the lane ctx the handlers read
CTX_KEYS = ("n", "f", "fq_size", "wq_size", "threshold", "clock_bump_mode",
            "fast_quorum", "write_quorum", "shard_of", "closest",
            "client_attach_s", "cmd_kmask", "cmd_skey")


class TempoPartialDev(TempoDev):
    SUBMIT = 0
    MCOLLECT = 1
    MCOLLECTACK = 2
    MCOMMIT = 3
    MDETACHED = 4
    MCONSENSUS = 5
    MCONSENSUSACK = 6
    MGC = 7
    MDRAIN = 8
    DETACH_DRAIN = 9
    MFWDSUBMIT = 10
    MBUMP = 11
    MSHARDCOMMIT = 12
    MSHARDAGG = 13
    STABLEAT = 14
    NUM_TYPES = 15
    TO_CLIENT = 16

    PERIODIC_ROWS = 3
    # the partial twin's handlers carry no safety-monitor hooks (fuzzing
    # is single-shard, as in the reference): monitors are refused
    MONITORED = False

    def __init__(
        self,
        keys: int,
        shards: int = 2,
        keys_per_cmd: int = 2,
        pending_per_key: int = 32,
        detached_slots: int = 16,
        gap_slots: int = 8,
    ):
        super().__init__(keys, pending_per_key, detached_slots, gap_slots)
        self.S = shards
        self.KPC = keys_per_cmd

    # -- host-side builders -------------------------------------------

    def payload_width(self, n: int) -> int:
        # MCommit: [dsrc, dseq, clock, client, cseq, nv], the voter ids,
        # then a (start, end) range per (key, voter) over the N = S·n rows
        N = self.S * n
        return max(6 + N + 2 * self.KPC * N, N, 10)

    def fanout(self, n: int) -> int:
        """Outbox slots one handler may need: a shard broadcast fills
        slots 0..N-1, plus the forward/bump/StableAtShard extras."""
        N = self.S * n
        return max(N + self.S + 2, 3 + self.S * self.KPC)

    def lane_ctx(self, config, dims: EngineDims, sorted_idx: np.ndarray):
        N, n, S = dims.N, config.n, config.shard_count
        fq_size, wq_size, threshold = config.tempo_quorum_sizes()
        fq = np.zeros((N, N), bool)
        wq = np.zeros((N, N), bool)
        # block-diagonal per shard: quorums never cross shards
        for s in range(S):
            for p in range(n):
                row = s * n + p
                for member in sorted_idx[p][:fq_size]:
                    fq[row, s * n + member] = True
                for member in sorted_idx[p][:wq_size]:
                    wq[row, s * n + member] = True
        return {
            "fast_quorum": fq,
            "write_quorum": wq,
            "fq_size": np.int32(fq_size),
            "wq_size": np.int32(wq_size),
            "threshold": np.int32(threshold),
            "clock_bump_mode": np.bool_(
                config.tempo_clock_bump_interval_ms is not None
            ),
        }

    def init_state(self, dims: EngineDims, ctx_np) -> Dict[str, np.ndarray]:
        N, D, C = dims.N, dims.D, dims.C
        K, PK, R, G, KPC = self.K, self.PK, self.R, self.G, self.KPC
        z = np.zeros
        return {
            "clocks": z((N, K), np.int32),
            "det": z((N, K, R, 2), np.int32),
            "max_commit_clock": z((N,), np.int32),
            "seq_in_slot": z((N, N, D), np.int32),
            "client_of": z((N, N, D), np.int32),
            "cseq_of": z((N, N, D), np.int32),
            "own_seq": z((N,), np.int32),
            "ack_cnt": z((N, N, D), np.int32),
            "max_clock": z((N, N, D), np.int32),
            "max_cnt": z((N, N, D), np.int32),
            "slow_acks": z((N, N, D), np.int32),
            "votes_n": z((N, N, D), np.int32),
            "votes_by": z((N, N, D, N), np.int32),
            "votes_s": z((N, N, D, KPC, N), np.int32),
            "votes_e": z((N, N, D, KPC, N), np.int32),
            "shag_cnt": z((N, D), np.int32),
            "shag_max": z((N, D), np.int32),
            "mbump_buf": z((N, N, D), np.int32),
            "vote_front": z((N, K, N), np.int32),
            "vote_gaps": z((N, K, N, G, 2), np.int32),
            "pend_clock": z((N, K, PK), np.int32),
            "pend_src": z((N, K, PK), np.int32),
            "pend_seq": z((N, K, PK), np.int32),
            "pend_client": z((N, K, PK), np.int32),
            "pend_cseq": z((N, K, PK), np.int32),
            "pend_kmask": z((N, K, PK), np.int32),
            "pend_missing": z((N, K, PK), np.int32),
            "pend_phase": z((N, K, PK), np.int32),
            "stable_cnt": z((N, C), np.int32),
            "stable_cnt_seq": z((N, C), np.int32),
            "buf_cnt": z((N, K, C), np.int32),
            "buf_seq": z((N, K, C), np.int32),
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

    # -- the handler step ----------------------------------------------

    def handlers(self, ps, has, rows, fire, ep, ctx, dims: EngineDims,
                 cap=None):
        """Readiness gate, periodic timers (at each process's event time
        ``ep``) and message handler of every (lane, process): ``(rdy, ps,
        periodic outbox, handler outbox)``. ``ps`` is updated in place
        on the lanes ``cap`` lets run (every lane without one) and
        returned as the same tensors. Runs the ``tempo_partial_handle``
        kernel on CUDA tensors."""
        from ...kernels.tempo_partial_handle import tempo_partial_handle

        return tempo_partial_handle(ps, has, rows, fire, ep, ctx, dims,
                                    cap)

    def step_plain(self, ps, has, rows, fire, now, ctx, dims: EngineDims,
                   cap=None):
        """The plain twin of the kernel, in the reference's order:
        ``ready`` on the incoming state, ``periodic`` at ``now``, then
        ``handle`` on the state ``periodic`` returned, out of place; then
        the running lanes' rows (of ``cap``; every lane without one) are
        copied into ``ps``, in place, as the kernel writes them
        (``core.write_running``)."""
        X = TempoPartialDev
        none = torch.full_like(rows[..., PMT], X.NUM_TYPES)
        mtype0 = torch.where(has, rows[..., PMT], none)
        rdy = X.ready_plain(ps, rows, mtype0, dims)
        mtype = torch.where(has & rdy, mtype0, none)
        new, pout = self.periodic_plain(ps, fire, now, ctx, dims)
        new, hout = self.handle_plain(new, mtype, rows, ctx, dims)
        return write_running(ps, (rdy, new, pout, hout), cap, dims)

    @staticmethod
    def ready_plain(ps, rows, mtype, dims: EngineDims):
        """MCollect waits for a free dot slot; MCommit, MConsensus,
        MShardAgg and MShardCommit wait for the MCollect payload (the
        reference requeues messages that overtook it)."""
        X = TempoPartialDev
        pay = rows[..., PPAY:]
        seq = pay[..., 1]
        cell = take2(ps["seq_in_slot"], pay[..., 0], dot_slot(seq, dims.D))
        ok = torch.where(mtype == X.MCOLLECT, cell == 0,
                         torch.ones_like(cell, dtype=torch.bool))
        needs = ((mtype == X.MCOMMIT) | (mtype == X.MCONSENSUS)
                 | (mtype == X.MSHARDAGG) | (mtype == X.MSHARDCOMMIT))
        return torch.where(needs, cell == seq, ok)

    def periodic_plain(self, ps, fire, now, ctx, dims: EngineDims):
        """TempoDev's timers with a shard-aware broadcast: the GC
        frontier to the rest of my shard, the real-time clock bump at
        ``now``, the detached-send kick-off in slot N."""
        L, N = fire.shape[:2]
        dev = fire.device
        me = torch.arange(N, device=dev, dtype=I32).expand(L, N)
        base = ctx["shard_of"] * ctx["n"][:, None]
        ob = emit_broadcast(
            empty_outbox(dims, (L, N), dev), self.MGC, ps["comm_front"],
            ctx["n"], me, exclude_me=True, base=base,
        )
        ob["valid"] = ob["valid"] & fire[..., 0:1]
        micros = torch.where(now >= INF // 1000, INF, now * 1000)
        min_clock = torch.maximum(ps["max_commit_clock"], micros)
        ps = _detached_all(self, ps, min_clock, fire[..., 1])
        has = (ps["det"][..., 0] > 0).flatten(2).any(-1)
        ob = emit(ob, N, me, self.DETACH_DRAIN,
                  torch.zeros_like(me)[..., None], fire[..., 2] & has)
        return ps, ob

    def handle_plain(self, ps, mtype, rows, ctx, dims: EngineDims):
        """The message switch: each branch on the pairs that take it."""
        branches = [_submit, _mcollect, _mcollectack, _mcommit, _mdetached,
                    _mconsensus, _mconsensusack, _mgc, _mdrain,
                    _detach_drain, _mfwdsubmit, _mbump, _mshardcommit,
                    _mshardagg, _stableat]
        L, N = mtype.shape
        idx = mtype.clamp(0, self.NUM_TYPES)
        new_ps = dict(ps)
        hout = empty_outbox(dims, (L, N), mtype.device)
        for k, fn in enumerate(branches):
            li, pi = (idx == k).nonzero(as_tuple=True)
            if li.numel() == 0:
                continue
            B = _Rows(self, ps, rows, ctx, dims, li, pi)
            st, ob = fn(B, B.ps)
            for name, v in st.items():
                if v is B.ps[name]:
                    continue
                if new_ps[name] is ps[name]:
                    new_ps[name] = ps[name].clone()
                new_ps[name][li, pi] = v[:, 0]
            for name in OUTBOX_KEYS:
                hout[name][li, pi] = ob[name][:, 0]
        return new_ps, hout


class _Rows:
    """The (lane, process) pairs ``(li, pi)`` that take one branch: their
    state rows, popped messages and lane ctx, each with leading axes
    ``[A, 1]`` (so the masked helpers index axis 2 as on ``[L, N]``).
    ``CTX`` names the lane ctx the handlers read."""

    CTX = CTX_KEYS

    def __init__(self, t, ps, rows, ctx, dims, li, pi):
        self.t = t
        self.dims = dims
        self.A = li.numel()
        self.N, self.D, self.P = dims.N, dims.D, dims.P
        self.S, self.KPC = t.S, t.KPC
        self.dev = rows.device
        self.me = pi.to(I32)[:, None]
        row = rows[li, pi][:, None]
        self.src = row[..., PSRC]
        self.pay = row[..., PPAY:]
        self.ps = {k: v[li, pi][:, None] for k, v in ps.items()}
        self.ctx = {k: ctx[k][li][:, None] for k in self.CTX}
        self.n = ctx["n"][li]
        self.s_me = take(self.ctx["shard_of"], self.me)
        self.base = self.s_me * self.n[:, None]
        self.closest = take(self.ctx["closest"], self.me)      # [A, 1, S]

    def empty(self):
        return empty_outbox(self.dims, (self.A, 1), self.dev)

    def words(self, *ws):
        """Payload words ``[A, 1, P]``: ``ws`` first, zeros after."""
        out = torch.zeros((self.A, 1, self.P), dtype=I32, device=self.dev)
        for i, w in enumerate(ws):
            out[..., i] = w
        return out

    def zero(self):
        return torch.zeros((self.A, 1), dtype=I32, device=self.dev)


# ----------------------------------------------------------------------
# shared helpers (tempo_partial.py:279-430)
# ----------------------------------------------------------------------

def _gather(vec, idx):
    """``vec[..., idx]`` along the last axis for an index tensor of the
    same leading axes; out of range reads 0/False (``oh_take``)."""
    K = vec.shape[-1]
    ok = (idx >= 0) & (idx < K)
    v = torch.gather(vec, -1, idx.clamp(0, K - 1).long())
    return torch.where(ok, v, torch.zeros_like(v))


def _cmd(B, client, cseq):
    """``(kmask, skey [A, 1, S, KPC])`` of command (client, cseq); the
    sequence is clamped to the table's last column."""
    j = torch.minimum(cseq, torch.full_like(cseq,
                                            B.ctx["cmd_kmask"].shape[3] - 1))
    return (take2(B.ctx["cmd_kmask"], client, j),
            take2(B.ctx["cmd_skey"], client, j))


def _popcount(kmask, S: int):
    return sum((kmask >> s) & 1 for s in range(S))


def _proposal(B, ps, keys, min_clock):
    """key_clocks.proposal over up to KPC keys: clock = max(min_clock,
    highest key clock + 1); each key votes its vacated range."""
    valid = keys >= 0
    cur = torch.where(valid, _gather(ps["clocks"], keys), 0)
    clock = torch.maximum(min_clock, torch.where(valid, cur, 0).amax(-1) + 1)
    up = valid & (cur < clock[..., None])
    vs = torch.where(up, cur + 1, 0)
    ve = torch.where(up, clock[..., None], 0)
    clocks = ps["clocks"]
    for d in range(B.KPC):
        clocks = put(clocks, torch.where(valid[..., d], keys[..., d], -1),
                     clock)
    return dict(ps, clocks=clocks), clock, vs, ve


def _detached_keys(B, ps, keys, up_to, enable):
    for d in range(B.KPC):
        k = keys[..., d]
        ps = _bump(B.t, ps, torch.where(k >= 0, k, -1), up_to,
                   enable & (k >= 0))
    return ps


def _set_votes(arr, dsrc, slot, idx, vals):
    """``arr [.., N, D, (KPC,) NV]``: write ``vals`` at voter column
    ``idx`` of the (dsrc, slot) row (out of range drops)."""
    row = take2(arr, dsrc, slot)
    hit = torch.arange(row.shape[-1], device=row.device) == bcast(idx, row)
    return put2(arr, dsrc, slot, torch.where(hit, bcast(vals, row), row))


# ----------------------------------------------------------------------
# submit / forward / collect
# ----------------------------------------------------------------------

def _start(B, ps, dsrc, dseq, client, cseq, forward: bool):
    """The coordinator start (tempo.rs:267-339 at the target shard; the
    MForwardSubmit path runs it without forwarding, partial.rs:8-35)."""
    X = TempoPartialDev
    kmask, skey = _cmd(B, client, cseq)
    keys = take(skey, B.s_me)
    slot = dot_slot(dseq, B.D)
    zero = B.zero()
    ps, clock, vs, ve = _proposal(B, ps, keys, zero)
    ps = dict(
        ps,
        ack_cnt=put2(ps["ack_cnt"], dsrc, slot, zero),
        max_clock=put2(ps["max_clock"], dsrc, slot, zero),
        max_cnt=put2(ps["max_cnt"], dsrc, slot, zero),
        slow_acks=put2(ps["slow_acks"], dsrc, slot, zero),
        votes_n=put2(ps["votes_n"], dsrc, slot, zero + 1),
        votes_by=_set_votes(ps["votes_by"], dsrc, slot, zero, B.me),
        votes_s=_set_votes(ps["votes_s"], dsrc, slot, zero, vs),
        votes_e=_set_votes(ps["votes_e"], dsrc, slot, zero, ve),
    )
    ob = emit_broadcast(B.empty(), X.MCOLLECT,
                        torch.stack([dsrc, dseq, client, cseq, clock], -1),
                        B.n, base=B.base)
    if forward:
        ps = dict(ps, shag_cnt=put(ps["shag_cnt"], slot, zero),
                  shag_max=put(ps["shag_max"], slot, zero))
        words = torch.stack([dsrc, dseq, client, cseq], -1)
        for s in range(B.S):
            touched = ((kmask >> s) & 1) == 1
            ob = emit(ob, B.N + s, B.closest[..., s], X.MFWDSUBMIT, words,
                      touched & (B.s_me != s))
    return ps, ob


def _submit(B, ps):
    client, cseq = B.pay[..., 0], B.pay[..., 1]
    dseq = ps["own_seq"] + 1
    ps = dict(ps, own_seq=dseq, err=_err(ps, ERR_SEQ, dseq >= SEQ_BOUND))
    return _start(B, ps, B.me, dseq, client, cseq, True)


def _mfwdsubmit(B, ps):
    dsrc, dseq, client, cseq = (B.pay[..., i] for i in range(4))
    return _start(B, ps, dsrc, dseq, client, cseq, False)


def _mcollect(B, ps):
    """tempo.rs:341-459 with the dot source decoupled from the sender
    (the shard coordinator)."""
    X = TempoPartialDev
    coord = B.src
    dsrc, dseq, client, cseq, rclock = (B.pay[..., i] for i in range(5))
    slot = dot_slot(dseq, B.D)
    dirty = take2(ps["seq_in_slot"], dsrc, slot) != 0
    ps = dict(
        ps,
        err=_err(ps, ERR_DOT, dirty),
        seq_in_slot=put2(ps["seq_in_slot"], dsrc, slot, dseq),
        client_of=put2(ps["client_of"], dsrc, slot, client),
        cseq_of=put2(ps["cseq_of"], dsrc, slot, cseq),
    )
    in_q = take2(B.ctx["fast_quorum"], coord, B.me)
    from_self = coord == B.me
    kmask, skey = _cmd(B, client, cseq)
    keys = take(skey, B.s_me)
    # quorum member: proposal with the remote clock as floor (the
    # self-collect keeps the original clock, no votes)
    ps2, pclock, vs, ve = _proposal(B, ps, keys, rclock)
    propose = in_q & ~from_self
    ps = dict(ps, clocks=torch.where(propose[..., None], ps2["clocks"],
                                     ps["clocks"]))
    clock = torch.where(from_self, rclock, pclock)
    vs = torch.where(propose[..., None], vs, 0)
    ve = torch.where(propose[..., None], ve, 0)
    # a buffered MBump applies after the proposal (tempo.rs:371-373)
    bump_to = take2(ps["mbump_buf"], dsrc, slot)
    ps = _detached_keys(B, ps, keys, bump_to, in_q & (bump_to > 0))
    ps = dict(ps, mbump_buf=put2(ps["mbump_buf"], dsrc, slot, B.zero()))
    pay = B.words(dsrc, dseq, clock)
    pay[..., 3:3 + 2 * B.KPC] = torch.stack([vs, ve], -1).flatten(-2)
    ob = emit(B.empty(), 0, coord, X.MCOLLECTACK, pay, in_q)
    # MBump the other touched shards' closest processes
    words = torch.stack([dsrc, dseq, clock], -1)
    for s in range(B.S):
        touched = ((kmask >> s) & 1) == 1
        ob = emit(ob, 1 + s, B.closest[..., s], X.MBUMP, words,
                  in_q & touched & (B.s_me != s))
    return ps, ob


def _mbump(B, ps):
    """tempo.rs:674-701: bump the command's local keys, or buffer the
    max clock until the payload arrives."""
    dsrc, dseq, clock = (B.pay[..., i] for i in range(3))
    slot = dot_slot(dseq, B.D)
    have = take2(ps["seq_in_slot"], dsrc, slot) == dseq
    _kmask, skey = _cmd(B, take2(ps["client_of"], dsrc, slot),
                        take2(ps["cseq_of"], dsrc, slot))
    ps = _detached_keys(B, ps, take(skey, B.s_me), clock, have)
    buffered = torch.maximum(take2(ps["mbump_buf"], dsrc, slot), clock)
    ps = dict(ps, mbump_buf=put2(ps["mbump_buf"], dsrc, slot,
                                 torch.where(have, 0, buffered)))
    return ps, B.empty()


# ----------------------------------------------------------------------
# collect-ack / commit paths
# ----------------------------------------------------------------------

def _commit_broadcast(B, ps, dsrc, dseq, clock, client, cseq, valid):
    """MCommit inside my shard, carrying this shard's votes."""
    X = TempoPartialDev
    slot = dot_slot(dseq, B.D)
    N = B.N
    pay = B.words(dsrc, dseq, clock, client, cseq,
                  take2(ps["votes_n"], dsrc, slot))
    pay[..., 6:6 + N] = take2(ps["votes_by"], dsrc, slot)
    pairs = torch.stack([take2(ps["votes_s"], dsrc, slot),
                         take2(ps["votes_e"], dsrc, slot)], -1)
    pay[..., 6 + N:6 + N + 2 * B.KPC * N] = pairs.flatten(-3)
    ob = emit_broadcast(B.empty(), X.MCOMMIT, pay, B.n, base=B.base)
    ob["valid"] = ob["valid"] & valid[..., None]
    return ob


def _commit_actions(B, ps, dsrc, dseq, clock, client, cseq, kmask, valid):
    """partial.rs:37-101: a single-shard command commits in this shard;
    a multi-shard one sends MShardCommit to the dot owner."""
    X = TempoPartialDev
    single = _popcount(kmask, B.S) == 1
    ob_commit = _commit_broadcast(B, ps, dsrc, dseq, clock, client, cseq,
                                  valid & single)
    ob_shard = emit(B.empty(), 0, dsrc, X.MSHARDCOMMIT,
                    torch.stack([dsrc, dseq, clock], -1), valid & ~single)
    return {k: select([single], [ob_commit[k], ob_shard[k]])
            for k in ob_commit}


def _mcollectack(B, ps):
    """tempo.rs:461-554 at the shard coordinator (possibly of a foreign
    dot)."""
    X = TempoPartialDev
    src = B.src
    dsrc, dseq, clock = (B.pay[..., i] for i in range(3))
    vs = B.pay[..., 3:3 + 2 * B.KPC:2]
    ve = B.pay[..., 4:4 + 2 * B.KPC:2]
    slot = dot_slot(dseq, B.D)
    nv = take2(ps["votes_n"], dsrc, slot)
    has_vote = (vs > 0).any(-1)
    fits = has_vote & (nv < B.N)
    widx = torch.where(fits, nv, B.N)
    ps = dict(
        ps,
        votes_by=_set_votes(ps["votes_by"], dsrc, slot, widx, src),
        votes_s=_set_votes(ps["votes_s"], dsrc, slot, widx, vs),
        votes_e=_set_votes(ps["votes_e"], dsrc, slot, widx, ve),
        votes_n=put2(ps["votes_n"], dsrc, slot, nv + fits.to(I32)),
        err=_err(ps, ERR_CAPACITY, has_vote & ~fits),
    )
    old_max = take2(ps["max_clock"], dsrc, slot)
    new_max = torch.maximum(old_max, clock)
    new_cnt = torch.where(
        clock > old_max, 1,
        take2(ps["max_cnt"], dsrc, slot) + (clock == old_max).to(I32),
    )
    cnt = take2(ps["ack_cnt"], dsrc, slot) + 1
    ps = dict(
        ps,
        max_clock=put2(ps["max_clock"], dsrc, slot, new_max),
        max_cnt=put2(ps["max_cnt"], dsrc, slot, new_cnt),
        ack_cnt=put2(ps["ack_cnt"], dsrc, slot, cnt),
    )
    client = take2(ps["client_of"], dsrc, slot)
    cseq = take2(ps["cseq_of"], dsrc, slot)
    kmask, skey = _cmd(B, client, cseq)
    ps = _detached_keys(B, ps, take(skey, B.s_me), new_max, src != B.me)
    all_acks = cnt == B.ctx["fq_size"]
    fast = all_acks & (new_cnt >= B.ctx["f"])
    slow = all_acks & ~fast
    ps = dict(ps, m_fast=ps["m_fast"] + fast.to(I32),
              m_slow=ps["m_slow"] + slow.to(I32))
    ob = _commit_actions(B, ps, dsrc, dseq, new_max, client, cseq, kmask,
                         fast)
    obc = emit_broadcast(B.empty(), X.MCONSENSUS,
                         torch.stack([dsrc, dseq, new_max], -1), B.n,
                         base=B.base)
    F = obc["valid"].shape[-1]
    procs = torch.arange(F, device=B.dev, dtype=I32) + B.base[..., None]
    wq = _gather(take(B.ctx["write_quorum"], B.me), procs.clamp(0, B.N - 1))
    obc["valid"] = obc["valid"] & slow[..., None] & wq
    return ps, {k: select([fast], [ob[k], obc[k]]) for k in ob}


def _mshardcommit(B, ps):
    """partial.rs:103-142 at the dot owner: aggregate the shards' commit
    clocks; when every touched shard reported, send the aggregate to
    the participants (me and the closest process of every other touched
    shard — who received the MForwardSubmit)."""
    X = TempoPartialDev
    dsrc, dseq, clock = (B.pay[..., i] for i in range(3))
    slot = dot_slot(dseq, B.D)
    ps = dict(ps, err=_err(ps, ERR_PROTO, dsrc != B.me))
    smax = torch.maximum(take(ps["shag_max"], slot), clock)
    scnt = take(ps["shag_cnt"], slot) + 1
    ps = dict(ps, shag_max=put(ps["shag_max"], slot, smax),
              shag_cnt=put(ps["shag_cnt"], slot, scnt))
    kmask, _skey = _cmd(B, take2(ps["client_of"], B.me, slot),
                        take2(ps["cseq_of"], B.me, slot))
    done = scnt == _popcount(kmask, B.S)
    words = torch.stack([dsrc, dseq, smax], -1)
    ob = emit(B.empty(), 0, B.me, X.MSHARDAGG, words, done)
    for s in range(B.S):
        touched = ((kmask >> s) & 1) == 1
        ob = emit(ob, 1 + s, B.closest[..., s], X.MSHARDAGG, words,
                  done & touched & (B.s_me != s))
    return ps, ob


def _mshardagg(B, ps):
    """partial.rs:144-167 at each shard coordinator: the final-clock
    MCommit inside this shard."""
    dsrc, dseq, clock = (B.pay[..., i] for i in range(3))
    slot = dot_slot(dseq, B.D)
    ob = _commit_broadcast(B, ps, dsrc, dseq, clock,
                           take2(ps["client_of"], dsrc, slot),
                           take2(ps["cseq_of"], dsrc, slot),
                           torch.ones_like(dsrc, dtype=torch.bool))
    return ps, ob


# ----------------------------------------------------------------------
# commit receiver + table executor
# ----------------------------------------------------------------------

def _stable_clock(B, ps, key):
    """The (n - threshold)-th smallest voter frontier of ``key`` among my
    shard's rows (foreign and pad rows sit at INF), ties by row."""
    fronts = take(ps["vote_front"], key)                        # [A, 1, N]
    procs = torch.arange(B.N, device=B.dev, dtype=I32)
    mine = B.ctx["shard_of"] == B.s_me[..., None]
    masked = torch.where(mine, fronts, INF)
    a, b = masked[..., None, :], masked[..., :, None]
    rank = ((a < b) | ((a == b) & (procs[None, :] < procs[:, None]))).sum(
        -1, dtype=I32)
    k = (B.n - B.ctx["threshold"][:, 0])[:, None, None]
    return torch.where(rank == k, masked, 0).sum(-1, dtype=I32)


def _pend_insert(B, ps, key, clock, dsrc, dseq, client, cseq, kmask,
                 missing, enable):
    """One pending entry of ``key`` (phase 1: awaiting stability)."""
    free = take(ps["pend_clock"], key) == 0
    overflow = enable & ~free.any(-1)
    widx = torch.where(enable & ~overflow, first_true(free), B.t.PK)
    out = dict(ps, err=_err(ps, ERR_CAPACITY, overflow))
    for name, v in (("pend_clock", clock), ("pend_src", dsrc),
                    ("pend_seq", dseq), ("pend_client", client),
                    ("pend_cseq", cseq), ("pend_kmask", kmask),
                    ("pend_missing", missing),
                    ("pend_phase", torch.ones_like(clock))):
        out[name] = put2(ps[name], key, widx, v)
    return out


def _mcommit(B, ps):
    """tempo.rs:556-654: feed the votes table per local key, insert the
    per-key pending entries, record the commit for GC (my shard's dots
    only; a foreign dot frees its slot at once), then one zero-delay
    MDrain per local key. The dot source is clamped to a process id."""
    X = TempoPartialDev
    N = B.N
    dsrc = B.pay[..., 0].clamp(0, N - 1)
    dseq, clock, client, cseq, nv = (B.pay[..., i] for i in range(1, 6))
    slot = dot_slot(dseq, B.D)
    have = take2(ps["seq_in_slot"], dsrc, slot) == dseq
    ps = dict(ps, err=_err(ps, ERR_PROTO, ~have))
    kmask, skey = _cmd(B, client, cseq)
    keys = take(skey, B.s_me)
    nsh = _popcount(kmask, B.S)
    bump_mode = B.ctx["clock_bump_mode"]
    mcc = ps["max_commit_clock"]
    ps = dict(ps, max_commit_clock=torch.where(
        bump_mode, torch.maximum(mcc, clock), mcc))
    ps = _detached_keys(B, ps, keys, clock, ~bump_mode)

    # attached votes: voter ids at [6, 6 + N), then (start, end) per
    # (key, voter); routed to per-voter lanes by one-hot sums
    procs = torch.arange(N, device=B.dev, dtype=I32)
    enable_v = procs < nv[..., None]
    bys = torch.where(enable_v, B.pay[..., 6:6 + N], N)
    route = bys[..., :, None] == procs                          # [A, 1, i, v]
    per_en_v = (route & enable_v[..., None]).any(-2)
    for d in range(B.KPC):
        key_d = keys[..., d]
        lo = 6 + N + 2 * d * N
        starts = B.pay[..., lo:lo + 2 * N:2]
        ends = B.pay[..., lo + 1:lo + 2 * N:2]
        per_s = torch.where(route, starts[..., None], 0).sum(-2, dtype=I32)
        per_e = torch.where(route, ends[..., None], 0).sum(-2, dtype=I32)
        per_en = per_en_v & (per_s > 0) & (key_d >= 0)[..., None]
        fronts, gaps, ovf = iset_add_range(
            take(ps["vote_front"], key_d), take(ps["vote_gaps"], key_d),
            per_s, per_e, per_en,
        )
        ps = dict(
            ps,
            vote_front=put(ps["vote_front"], key_d, fronts),
            vote_gaps=put(ps["vote_gaps"], key_d, gaps),
            err=_err(ps, ERR_CAPACITY, ovf.any(-1)),
        )
        ps = _pend_insert(B, ps, key_d, clock, dsrc, dseq, client, cseq,
                          kmask, nsh, key_d >= 0)

    # GC: only my shard's dots feed the committed clock
    my_dot = take(B.ctx["shard_of"], dsrc) == B.s_me
    cf, cg, overflow = iset_add(take(ps["comm_front"], dsrc),
                                take(ps["comm_gaps"], dsrc), dseq,
                                enable=my_dot)
    ps = dict(
        ps,
        comm_front=put(ps["comm_front"], dsrc, cf),
        comm_gaps=put(ps["comm_gaps"], dsrc, cg),
        err=_err(ps, ERR_CAPACITY, overflow),
        seq_in_slot=put2(ps["seq_in_slot"], dsrc, slot,
                         torch.where(my_dot, dseq, 0)),
    )
    ob = B.empty()
    for d in range(B.KPC):
        ob = emit(ob, d, B.me, X.MDRAIN, keys[..., d, None],
                  keys[..., d] >= 0)
    return ps, ob


def _mdetached(B, ps):
    """tempo.rs:703-716: union the sender's detached ranges, drain."""
    key, nr = B.pay[..., 0], B.pay[..., 1]
    for i in range(B.t.detached_per_msg(B.dims)):
        # after the first add, a disabled add changes nothing (see
        # TempoDev's _mdetached), so stop once no pair has a range left
        if i > 0 and not bool((i < nr).any()):
            break
        ps = _vote_add(B.t, ps, key, B.src, B.pay[..., 2 + 2 * i],
                       B.pay[..., 3 + 2 * i], i < nr)
    return _drain(B, ps, key, B.empty())


def _mconsensus(B, ps):
    """tempo.rs:718-773 (the initial ballot always wins)."""
    X = TempoPartialDev
    dsrc, dseq, clock = (B.pay[..., i] for i in range(3))
    slot = dot_slot(dseq, B.D)
    has_cmd = take2(ps["seq_in_slot"], dsrc, slot) == dseq
    _kmask, skey = _cmd(B, take2(ps["client_of"], dsrc, slot),
                        take2(ps["cseq_of"], dsrc, slot))
    ps = _detached_keys(B, ps, take(skey, B.s_me), clock, has_cmd)
    ob = emit(B.empty(), 0, B.src, X.MCONSENSUSACK,
              torch.stack([dsrc, dseq], -1), torch.ones_like(has_cmd))
    return ps, ob


def _mconsensusack(B, ps):
    """tempo.rs:775-812: the write quorum's accepts choose the
    slow-path clock."""
    dsrc, dseq = B.pay[..., 0], B.pay[..., 1]
    slot = dot_slot(dseq, B.D)
    cnt = take2(ps["slow_acks"], dsrc, slot) + 1
    chosen = cnt == B.ctx["wq_size"]
    ps = dict(ps, slow_acks=put2(ps["slow_acks"], dsrc, slot, cnt))
    client = take2(ps["client_of"], dsrc, slot)
    cseq = take2(ps["cseq_of"], dsrc, slot)
    kmask, _skey = _cmd(B, client, cseq)
    return ps, _commit_actions(B, ps, dsrc, dseq,
                               take2(ps["max_clock"], dsrc, slot), client,
                               cseq, kmask, chosen)


def _mgc(B, ps):
    """Committed-clock GC within my shard (tempo.rs:897-970)."""
    N, s = B.N, B.src
    of = put(ps["others_frontier"], s,
             torch.maximum(take(ps["others_frontier"], s), B.pay[..., :N]))
    seen = put(ps["seen"], s, torch.ones_like(s, dtype=torch.bool))
    mine = B.ctx["shard_of"] == B.s_me[..., None]               # [A, 1, N]
    procs = torch.arange(N, device=B.dev, dtype=I32)
    others = mine & (procs != B.me[..., None])
    ready = (seen | ~others).all(-1)
    min_others = torch.where(others[..., None], of, INF).amin(-2)
    stable = torch.minimum(ps["comm_front"], min_others)
    stable = torch.where(ready[..., None] & mine, stable, 0)
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


def _mdrain(B, ps):
    return _drain(B, ps, B.pay[..., 0], B.empty())


def _detach_drain(B, ps):
    """One key's detached ranges to my shard, chained (TempoDev's
    detach drain with a shard-aware broadcast)."""
    X = TempoPartialDev
    det = ps["det"]
    key_has = (det[..., 0] > 0).any(-1)                         # [A, 1, K]
    key = first_true(key_has)
    any_key = key_has.any(-1)
    row = take(det, key)                                        # [A, 1, R, 2]
    occ = row[..., 0] > 0
    order = occ.cumsum(-1, dtype=I32)
    taken = occ & (order <= B.t.detached_per_msg(B.dims))
    pay = B.words(key, taken.sum(-1, dtype=I32))
    lo = torch.where(taken, 2 + 2 * (order - 1), B.P)
    at = torch.arange(B.P, device=B.dev, dtype=I32)
    pay = pay + (torch.where(lo[..., None] == at, row[..., 0:1], 0)
                 + torch.where(lo[..., None] + 1 == at, row[..., 1:2], 0)
                 ).sum(-2, dtype=I32)
    det = put(det, key, torch.where(taken[..., None], 0, row))
    ob = emit_broadcast(B.empty(), X.MDETACHED, pay, B.n, base=B.base)
    ob["valid"] = ob["valid"] & any_key[..., None]
    more = (det[..., 0] > 0).flatten(2).any(-1)
    ob = emit(ob, B.N, B.me, X.DETACH_DRAIN,
              torch.zeros_like(key)[..., None], any_key & more)
    return dict(ps, det=det), ob


# ----------------------------------------------------------------------
# the per-key pending queue (executor.rs:171-360)
# ----------------------------------------------------------------------

def _execute(B, ps, key, idx, client, ob, enable):
    """Execute the entry: the per-key result part to the client when I
    am its connected process of my shard, free the slot."""
    X = TempoPartialDev
    connected = take2(B.ctx["client_attach_s"], client, B.s_me) == B.me
    ob = emit(ob, 0, B.N + client, X.TO_CLIENT,
              torch.zeros_like(client)[..., None], enable & connected)
    widx = torch.where(enable, idx, B.t.PK)
    zero = torch.zeros_like(idx)
    return dict(ps, pend_clock=put2(ps["pend_clock"], key, widx, zero),
                pend_phase=put2(ps["pend_phase"], key, widx, zero)), ob


def _queue_head(ps, key, eligible, clocks):
    """The lowest (clock, src·SEQ_BOUND + seq) eligible entry of ``key``
    (first index on ties)."""
    cmin = torch.where(eligible, clocks, INF).amin(-1)
    tie = eligible & (clocks == cmin[..., None])
    packed = take(ps["pend_src"], key) * SEQ_BOUND + take(ps["pend_seq"],
                                                           key)
    return torch.where(tie, packed, INF).argmin(-1).to(I32)


def _drain(B, ps, key, ob):
    """Promote or execute ``key``'s lowest ready entry (stable_ops,
    _send_stable_or_execute, _execute_single_or_mark_stable,
    executor.rs:234-360): TO_CLIENT in slot 0, MDrain in slot 1 while
    more are ready, StableAtShard to the command's other keys in slots
    2 on."""
    X = TempoPartialDev
    t = B.t
    stable = _stable_clock(B, ps, key)
    clocks = take(ps["pend_clock"], key)                        # [A, 1, PK]
    phase = take(ps["pend_phase"], key)
    eligible = ((phase == 1) & (clocks > 0) & (clocks <= stable[..., None])
                | (phase == 2))
    idx = _queue_head(ps, key, eligible, clocks)
    proceed = eligible.any(-1) & (take(phase, idx) != 2) & (key >= 0)

    client = take2(ps["pend_client"], key, idx)
    cseq = take2(ps["pend_cseq"], key, idx)
    kmask = take2(ps["pend_kmask"], key, idx)
    missing0 = take2(ps["pend_missing"], key, idx)
    _kmask, skey = _cmd(B, client, cseq)
    nloc = (take(skey, B.s_me) >= 0).sum(-1, dtype=I32)
    single = (_popcount(kmask, B.S) == 1) & (nloc == 1)

    # rifl_to_stable_count (executor.rs:318-330), for commands with more
    # than one local key; the count completing marks the rifl stable
    prev = torch.where(take(ps["stable_cnt_seq"], client) == cseq,
                       take(ps["stable_cnt"], client), 0)
    cnt = prev + 1
    counted = proceed & ~single & (nloc > 1)
    do_mark = (torch.where(nloc > 1, cnt == nloc, True) & proceed
               & ~single)
    cw = torch.where(counted, client, B.dims.C)
    ps = dict(
        ps,
        stable_cnt=put(ps["stable_cnt"], cw, torch.where(do_mark, 0, cnt)),
        stable_cnt_seq=put(ps["stable_cnt_seq"], cw, cseq),
    )
    # apply and clear the buffered StableAtShard count of this rifl
    bmatch = take2(ps["buf_seq"], key, client) == cseq
    bcnt = torch.where(bmatch, take2(ps["buf_cnt"], key, client), 0)
    bw = torch.where(proceed & ~single, key, t.K)
    ps = dict(ps, buf_cnt=put2(ps["buf_cnt"], bw, client,
                               torch.zeros_like(client)))
    missing = missing0 - do_mark.to(I32) - bcnt

    # StableAtShard to the command's other keys: local ones to myself,
    # remote ones through the closest process of their shard
    slot_i = 2
    for s in range(B.S):
        dst = torch.where(B.s_me == s, B.me, B.closest[..., s])
        for d in range(B.KPC):
            kk = skey[..., s, d]
            ob = emit(ob, slot_i, dst, X.STABLEAT,
                      torch.stack([kk, client, cseq], -1),
                      do_mark & (kk >= 0) & (kk != key))
            slot_i += 1

    execute = proceed & (single | (missing <= 0))
    park = proceed & ~execute
    widx = torch.where(park, idx, t.PK)
    ps = dict(
        ps,
        pend_phase=put2(ps["pend_phase"], key, widx,
                        torch.full_like(idx, 2)),
        pend_missing=put2(ps["pend_missing"], key, widx, missing),
    )
    ps, ob = _execute(B, ps, key, idx, client, ob, execute)
    more = eligible.sum(-1, dtype=I32) > 1
    ob = emit(ob, 1, B.me, X.MDRAIN, key[..., None], execute & more)
    return ps, ob


def _stableat(B, ps):
    """StableAtShard arrival (executor.rs:191-214): count it against the
    parked head when that is this rifl, else buffer it."""
    X = TempoPartialDev
    t = B.t
    key, client, cseq = (B.pay[..., i] for i in range(3))
    clocks = take(ps["pend_clock"], key)
    parked = (take(ps["pend_phase"], key) == 2) & (clocks > 0)
    idx = _queue_head(ps, key, parked, clocks)
    match = (parked.any(-1)
             & (take2(ps["pend_client"], key, idx) == client)
             & (take2(ps["pend_cseq"], key, idx) == cseq))
    missing = take2(ps["pend_missing"], key, idx) - 1
    widx = torch.where(match, idx, t.PK)
    ps = dict(ps, pend_missing=put2(ps["pend_missing"], key, widx, missing))
    execute = match & (missing <= 0)
    ps, ob = _execute(B, ps, key, idx, client, B.empty(), execute)
    ob = emit(ob, 1, B.me, X.MDRAIN, key[..., None], execute)
    # no parked head for this rifl yet: buffer (executor.rs:211-214)
    buffer = ~match & (key >= 0)
    old = torch.where(take2(ps["buf_seq"], key, client) == cseq,
                      take2(ps["buf_cnt"], key, client), 0)
    bw = torch.where(buffer, key, t.K)
    ps = dict(ps, buf_cnt=put2(ps["buf_cnt"], bw, client, old + 1),
              buf_seq=put2(ps["buf_seq"], bw, client, cseq))
    return ps, ob
