"""Device twin of Tempo (fantoch_ps/src/protocol/tempo.rs), batched over
``[L, N]`` (lane, process): the counterpart of the reference's
``fantoch_tpu/engine/protocols/tempo.py``, the flagship protocol.

Flow: submit bumps the coordinator's per-key clock into a timestamp
proposal; fast-quorum members bump their own clocks to at least the
proposal and report (clock, vote range); the fast path commits at the
max reported clock iff it was reported by >= f members, else a
single-decree consensus round fixes the timestamp. Commits carry the
attached votes to the table executor, which executes a command once a
stability threshold's worth of voters have voted past its timestamp.
Detached votes (clock bumps without commands) are batched and sent
periodically to keep the stability frontier moving; the optional
real-time mode bumps all clocks to the wall clock.

State (per process, fixed shapes; the reference's ``init_state``):
per-key clocks ``[K]`` and detached-vote range slots ``[K, R, 2]``;
the per-dot payload ``[N, D]`` of every source; the coordinator's
per-dot quorum bookkeeping ``[D]`` and attached votes ``[D, N]``; the
table executor's per-(key, voter) vote clocks (interval sets,
``engine/iset.py``) and ``[K, PK]`` pending commands; the GC committed
clock per source (an interval set: commits may complete out of source
order) and the frontier exchange.

:meth:`TempoDev.ready_plain`, :meth:`TempoDev.periodic_plain` and
:meth:`TempoDev.handle_plain`, composed by :meth:`TempoDev.step_plain`,
are the plain PyTorch twin of the ``tempo_handle`` CUDA kernel
(``kernels/tempo_handle.py``): like the reference's ``lax.switch`` under
``vmap`` the twin computes branches over the whole batch and selects
with masks (skipping the branches no (lane, process) takes); the kernel
runs only the branch of each (lane, process).

On a monitored step the table executor's drain records every execution
(``engine/monitor.py`` ``mon_exec``), with the execute-before-commit
guard read from the GC committed clock, a data path independent of the
pending table that fed the drain (the reference's ``tempo.py:434-453``).
Not here: the narrowed metric planes (``NARROW_METRICS``, ROADMAP Queue
A item 5). Like the reference, recovery is not modeled;
``skip_fast_ack`` is (the ``skip_capable`` gate below).
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
from ..iset import first_true, iset_add, iset_add_range, iset_contains
from ..monitor import mon_exec
from .identity import DevIdentity
from .masked import bcast, hit, put, put2, select, take

I32 = torch.int32


class TempoDev(DevIdentity):
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
    NUM_TYPES = 10
    TO_CLIENT = 11

    PERIODIC_ROWS = 3  # [garbage collection, clock bump, send detached]
    MONITORED = True  # mon_exec hook at the table executor's drain

    def __init__(
        self,
        keys: int,
        pending_per_key: int = 32,
        detached_slots: int = 16,
        gap_slots: int = 8,
        skip_capable: bool = False,
    ):
        self.K = keys
        self.PK = pending_per_key
        self.R = detached_slots
        self.G = gap_slots
        # the skip_fast_ack paths (tempo.rs:91-93, 442-455) run only for
        # instances built with this flag, and then only on lanes whose
        # ctx["skip_fast_ack"] holds (the reference gates them at trace
        # time)
        self.skip_capable = skip_capable

    @classmethod
    def for_load(cls, keys: int, clients: int) -> "TempoDev":
        """Capacity bounds that survive ``clients`` closed-loop clients on
        one conflict key at f up to 2 (the reference's sizing)."""
        return cls(
            keys=keys,
            pending_per_key=max(32, 8 * clients),
            detached_slots=max(16, 4 * clients),
            gap_slots=max(8, 2 * clients),
        )

    # -- host-side builders -------------------------------------------

    def payload_width(self, n: int) -> int:
        # MCOMMIT: [src, seq, clock, key, client, nv] + (by, start, end)*n
        return max(6 + 3 * n, n, 2 + 2 * 4)

    def detached_per_msg(self, dims: EngineDims) -> int:
        return (dims.P - 2) // 2

    def periodic_intervals(self, config, dims: EngineDims):
        def ms(v):
            return v if v is not None else INF

        return [
            ms(config.gc_interval_ms),
            ms(config.tempo_clock_bump_interval_ms),
            ms(config.tempo_detached_send_interval_ms),
        ]

    @staticmethod
    def min_live(config) -> int:
        """Smallest membership that still commits and stabilizes: the
        fast quorum, the write quorum and the stability threshold."""
        fast, write, threshold = config.tempo_quorum_sizes()
        return max(fast, write, threshold)

    def lane_ctx(self, config, dims: EngineDims, sorted_idx: np.ndarray):
        N = dims.N
        fq_size, wq_size, threshold = config.tempo_quorum_sizes()
        fq = np.zeros((N, N), bool)
        wq = np.zeros((N, N), bool)
        for p in range(config.n):
            for member in sorted_idx[p][:fq_size]:
                fq[p, member] = True
            for member in sorted_idx[p][:wq_size]:
                wq[p, member] = True
        return {
            "fast_quorum": fq,
            "write_quorum": wq,
            "fq_size": np.int32(fq_size),
            "wq_size": np.int32(wq_size),
            "threshold": np.int32(threshold),
            "clock_bump_mode": np.bool_(
                config.tempo_clock_bump_interval_ms is not None
            ),
            # tempo.rs:91-93: only with a pair fast quorum
            "skip_fast_ack": np.bool_(config.skip_fast_ack and fq_size == 2),
        }

    def init_state(self, dims: EngineDims, ctx_np) -> Dict[str, np.ndarray]:
        N, D = dims.N, dims.D
        K, PK, R, G = self.K, self.PK, self.R, self.G
        z = np.zeros
        return {
            "clocks": z((N, K), np.int32),
            "det": z((N, K, R, 2), np.int32),
            "max_commit_clock": z((N,), np.int32),
            "seq_in_slot": z((N, N, D), np.int32),
            "key_of": z((N, N, D), np.int32),
            "client_of": z((N, N, D), np.int32),
            "own_seq": z((N,), np.int32),
            "ack_cnt": z((N, D), np.int32),
            "max_clock": z((N, D), np.int32),
            "max_cnt": z((N, D), np.int32),
            "slow_acks": z((N, D), np.int32),
            "votes_n": z((N, D), np.int32),
            "votes_by": z((N, D, N), np.int32),
            "votes_s": z((N, D, N), np.int32),
            "votes_e": z((N, D, N), np.int32),
            "vote_front": z((N, K, N), np.int32),
            "vote_gaps": z((N, K, N, G, 2), np.int32),
            "pend_clock": z((N, K, PK), np.int32),
            "pend_src": z((N, K, PK), np.int32),
            "pend_seq": z((N, K, PK), np.int32),
            "pend_client": z((N, K, PK), np.int32),
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

    def handlers(self, ps, has, rows, fire, ep, ctx, dims: EngineDims):
        """Readiness gate, periodic timers (at each process's event time
        ``ep``) and message handler of every (lane, process): ``(rdy, ps,
        periodic outbox, handler outbox)``. Runs the ``tempo_handle``
        kernel on CUDA tensors."""
        from ...kernels.tempo_handle import tempo_handle

        return tempo_handle(ps, has, rows, fire, ep, ctx, dims,
                            self.skip_capable)

    def step_plain(self, ps, has, rows, fire, now, ctx, dims: EngineDims):
        """The plain twin of the kernel, in the reference's order
        (core.py:890-918): ``ready`` on the incoming state, ``periodic``
        at ``now``, then ``handle`` on the state ``periodic`` returned."""
        none = torch.full_like(rows[..., PMT], TempoDev.NUM_TYPES)
        mtype0 = torch.where(has, rows[..., PMT], none)
        rdy = TempoDev.ready_plain(ps, rows, mtype0, dims)
        valid = has & rdy
        mtype = torch.where(valid, mtype0, none)
        ps, pout = self.periodic_plain(ps, fire, now, ctx, dims)
        ps, hout = self.handle_plain(ps, mtype, rows, ctx, dims)
        return rdy, ps, pout, hout

    @staticmethod
    def ready_plain(ps, rows, mtype, dims: EngineDims):
        """MCollect needs a free dot slot (its predecessor GC'd);
        MCommit/MConsensus need the MCollect payload. The dot source is
        not clamped here, so an out-of-range one reads 0."""
        src, pay = rows[..., PSRC], rows[..., PPAY:]
        sis = ps["seq_in_slot"]
        collect_ok = take(take(sis, src), dot_slot(pay[..., 0], dims.D)) == 0
        seq = pay[..., 1]
        have = take(take(sis, pay[..., 0]), dot_slot(seq, dims.D)) == seq
        ok = torch.where(mtype == TempoDev.MCOLLECT, collect_ok,
                         torch.ones_like(collect_ok))
        commit = (mtype == TempoDev.MCOMMIT) | (mtype == TempoDev.MCONSENSUS)
        return torch.where(commit, have, ok)

    def periodic_plain(self, ps, fire, now, ctx, dims: EngineDims):
        """Rows: GC frontier broadcast; real-time clock bump
        (tempo.rs:972-992) at ``now``; detached-send kick-off."""
        L, N = fire.shape[:2]
        dev = fire.device
        me = torch.arange(N, device=dev, dtype=I32).expand(L, N)
        ob = emit_broadcast(
            empty_outbox(dims, (L, N), dev), TempoDev.MGC,
            ps["comm_front"], ctx["n"], me, exclude_me=True,
        )
        ob["valid"] = ob["valid"] & fire[..., 0:1]
        # the micros conversion saturates at INF instead of wrapping
        micros = torch.where(now >= INF // 1000, INF, now * 1000)
        min_clock = torch.maximum(ps["max_commit_clock"], micros)
        ps = _detached_all(self, ps, min_clock, fire[..., 1])
        has = (ps["det"][..., 0] > 0).flatten(2).any(-1)
        ob = emit(ob, N, me, TempoDev.DETACH_DRAIN,
                  torch.zeros_like(me)[..., None], fire[..., 2] & has)
        return ps, ob

    def handle_plain(self, ps, mtype, rows, ctx, dims: EngineDims):
        """The message switch: each branch that some (lane, process)
        takes, computed over the batch and selected by type."""
        B = _Batch(self, rows, ctx, dims)
        branches = [_submit, _mcollect, _mcollectack, _mcommit, _mdetached,
                    _mconsensus, _mconsensusack, _mgc, _mdrain,
                    _detach_drain]
        idx = mtype.clamp(0, TempoDev.NUM_TYPES)
        new_ps, new_ob = dict(ps), B.empty()
        for k, fn in enumerate(branches):
            mask = idx == k
            # a branch no (lane, process) takes is never selected; the
            # masks are disjoint, and the noop keeps ps and an empty outbox
            if not bool(mask.any()):
                continue
            B.active = mask
            st, ob = fn(B, ps)
            for name, v in st.items():
                if v is not ps[name]:
                    new_ps[name] = torch.where(bcast(mask, v), v,
                                               new_ps[name])
            for name, v in ob.items():
                new_ob[name] = torch.where(bcast(mask, v), v, new_ob[name])
        return new_ps, new_ob


class _Batch:
    """What every handler branch reads: the instance's sizes, the popped
    messages and the lane ctx, with ``[L, N]`` leading axes."""

    def __init__(self, tempo, rows, ctx, dims):
        self.t = tempo
        self.dims = dims
        self.L, self.N, self.D, self.P = rows.shape[0], dims.N, dims.D, dims.P
        self.dev = rows.device
        self.me = torch.arange(self.N, device=self.dev,
                               dtype=I32).expand(self.L, self.N)
        self.src = rows[..., PSRC]
        self.pay = rows[..., PPAY:]
        self.ctx = ctx
        self.n = ctx["n"]
        # the (lane, process) pairs that take the branch being computed
        self.active = None

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
# clock/vote helpers (tempo.py:308-392)
# ----------------------------------------------------------------------

def _slot_hit(t, key, slot):
    """``[L, N, K, R]`` one-hot of (key, detached slot); out of range hits
    none."""
    return hit(key, t.K)[..., :, None] & hit(slot, t.R)[..., None, :]


def _det_add(t, ps, key, start, end, enable):
    """Append a detached vote range for ``key``: extend a range that
    ends at ``start - 1``, else take the first free slot (Votes::add)."""
    det = ps["det"]                                       # [L, N, K, R, 2]
    row = take(det, key)                                  # [L, N, R, 2]
    touch = (row[..., 0] > 0) & (row[..., 1] + 1 == start[..., None])
    can_compress = touch.any(-1)
    do = enable & (end >= start)
    comp = do & can_compress
    h = _slot_hit(t, key, first_true(touch)) & comp[..., None, None]
    upper = torch.tensor([False, True], device=det.device)
    det = torch.where(h[..., None] & upper, end[..., None, None, None], det)
    free = row[..., 0] == 0
    store = do & ~can_compress
    overflow = store & ~free.any(-1)
    h = _slot_hit(t, key, first_true(free)) & (store & ~overflow)[
        ..., None, None]
    pair = torch.stack([start, end], -1)[..., None, None, :]
    det = torch.where(h[..., None], pair, det)
    return dict(ps, det=det, err=_err(ps, ERR_CAPACITY, overflow))


def _bump(t, ps, key, up_to, enable):
    """Vote (clock+1..up_to) and lift the key's clock
    (clocks/keys/sequential.rs:96-104)."""
    cur = take(ps["clocks"], key)
    do = enable & (cur < up_to)
    ps = _det_add(t, ps, key, cur + 1, up_to, do)
    return dict(ps, clocks=put(ps["clocks"], key,
                               torch.where(do, up_to, cur)))


def _detached_all(t, ps, min_clock, enable):
    """Bump every key below ``min_clock``, each into its first free
    detached slot."""
    clocks, det = ps["clocks"], ps["det"]
    do = enable[..., None] & (clocks < min_clock[..., None])   # [L, N, K]
    free = det[..., 0] == 0                                    # [L, N, K, R]
    overflow = do & ~free.any(-1)
    slot = torch.where(do & ~overflow, first_true(free), t.R)
    h = torch.arange(t.R, device=det.device, dtype=I32) == slot[..., None]
    vals = torch.stack(
        [clocks + 1, min_clock[..., None].expand_as(clocks)], -1
    )
    return dict(
        ps,
        det=torch.where(h[..., None], vals[..., None, :], det),
        clocks=torch.where(do, min_clock[..., None], clocks),
        err=_err(ps, ERR_CAPACITY, overflow.any(-1)),
    )


def _vote_add(t, ps, key, voter, start, end, enable):
    """Union a vote range into the (key, voter) interval clock."""
    front = take(take(ps["vote_front"], key), voter)
    gaps = take(take(ps["vote_gaps"], key), voter)
    front, gaps, overflow = iset_add_range(front, gaps, start, end, enable)
    return dict(
        ps,
        vote_front=put2(ps["vote_front"], key, voter, front),
        vote_gaps=put2(ps["vote_gaps"], key, voter, gaps),
        err=_err(ps, ERR_CAPACITY, overflow),
    )


# ----------------------------------------------------------------------
# table-executor drain (tempo.py:401-490)
# ----------------------------------------------------------------------

def _stable_clock(B, ps, key):
    """The (n - threshold)-th order statistic of the key's voter
    frontiers, ties ranked by process index (table/mod.rs:243-263)."""
    fronts = take(ps["vote_front"], key)                       # [L, N, N]
    procs = torch.arange(B.N, device=B.dev, dtype=I32)
    masked = torch.where(procs < B.n[:, None, None], fronts, INF)
    a, b = masked[..., None, :], masked[..., :, None]
    rank = ((a < b) | ((a == b) & (procs[None, :] < procs[:, None]))).sum(
        -1, dtype=I32)
    k = (B.n - B.ctx["threshold"])[:, None, None]
    return torch.where(rank == k, masked, 0).sum(-1, dtype=I32)


def _drain(B, ps, key):
    """Execute the lowest stable pending command on ``key`` (clock,
    then ``src * SEQ_BOUND + seq``, then index): TO_CLIENT in outbox
    slot 0 if the client is attached here, and MDRAIN to self in slot 1
    when more than one is ready."""
    t = B.t
    stable = _stable_clock(B, ps, key)
    clocks = take(ps["pend_clock"], key)                       # [L, N, PK]
    ready = (clocks > 0) & (clocks <= stable[..., None])
    num_ready = ready.sum(-1, dtype=I32)
    cmin = torch.where(ready, clocks, INF).amin(-1)
    tie = ready & (clocks == cmin[..., None])
    packed = (take(ps["pend_src"], key) * SEQ_BOUND
              + take(ps["pend_seq"], key))
    idx = torch.where(tie, packed, INF).argmin(-1).to(I32)
    do = num_ready > 0
    client = take(take(ps["pend_client"], key), idx)
    if "_mon_hash" in ps:
        # safety monitor: the execute-before-commit guard reads the GC
        # committed clock of the executed dot's source
        e_src = take(take(ps["pend_src"], key), idx)
        e_seq = take(take(ps["pend_seq"], key), idx)
        committed = iset_contains(take(ps["comm_front"], e_src),
                                  take(ps["comm_gaps"], e_src), e_seq)
        ps = mon_exec(ps, key, e_src, e_seq, do, premature=~committed)
    ps = dict(ps, pend_clock=put2(ps["pend_clock"], key,
                                  torch.where(do, idx, t.PK),
                                  torch.zeros_like(idx)))
    attach = B.ctx["client_attach"][:, None, :].expand(B.L, B.N, -1)
    zero = torch.zeros_like(idx)[..., None]
    ob = emit(B.empty(), 0, B.N + client, TempoDev.TO_CLIENT, zero,
              do & (take(attach, client) == B.me))
    ob = emit(ob, 1, B.me, TempoDev.MDRAIN, key[..., None],
              do & (num_ready > 1))
    return ps, ob


def _pend_insert(t, ps, key, clock, src, seq, client):
    free = take(ps["pend_clock"], key) == 0
    overflow = ~free.any(-1)
    widx = torch.where(overflow, t.PK, first_true(free))
    out = dict(ps, err=_err(ps, ERR_CAPACITY, overflow))
    for name, v in (("pend_clock", clock), ("pend_src", src),
                    ("pend_seq", seq), ("pend_client", client)):
        out[name] = put2(ps[name], key, widx, v)
    return out


# ----------------------------------------------------------------------
# handlers (tempo.py:498-941)
# ----------------------------------------------------------------------

def _submit(B, ps):
    """tempo.rs:267-339: next dot; clock proposal with the coordinator's
    own attached vote kept locally (sent later inside MCommit)."""
    client, key = B.pay[..., 0], B.pay[..., 2]
    seq = ps["own_seq"] + 1
    slot = dot_slot(seq, B.D)
    cur = take(ps["clocks"], key)
    clock = cur + 1
    one = torch.ones_like(seq)
    if B.t.skip_capable:
        own_vote = torch.where(B.lane("skip_fast_ack"), 0, one)
    else:
        own_vote = one
    zero = torch.zeros_like(seq)
    ps = dict(
        ps,
        err=_err(ps, ERR_SEQ, seq >= SEQ_BOUND),
        own_seq=seq,
        clocks=put(ps["clocks"], key, clock),
        ack_cnt=put(ps["ack_cnt"], slot, zero),
        max_clock=put(ps["max_clock"], slot, zero),
        max_cnt=put(ps["max_cnt"], slot, zero),
        slow_acks=put(ps["slow_acks"], slot, zero),
        votes_n=put(ps["votes_n"], slot, own_vote),
        votes_by=put2(ps["votes_by"], slot, zero, B.me),
        votes_s=put2(ps["votes_s"], slot, zero, cur + 1),
        votes_e=put2(ps["votes_e"], slot, zero, clock),
    )
    ob = emit_broadcast(
        B.empty(), TempoDev.MCOLLECT,
        torch.stack([seq, key, clock, client, cur + 1, clock], -1), B.n,
    )
    return ps, ob


def _mcollect(B, ps):
    """tempo.rs:341-459: store the payload; quorum members re-propose
    with the remote clock as a floor and report their vote range."""
    s = B.src
    seq, key, rclock, client = (B.pay[..., i] for i in range(4))
    slot = dot_slot(seq, B.D)
    dirty = take(take(ps["seq_in_slot"], s), slot) != 0
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
    cur = take(ps["clocks"], key)
    clock = torch.maximum(rclock, cur + 1)
    propose = in_q & ~from_self
    ps = dict(ps, clocks=put(ps["clocks"], key,
                             torch.where(propose, clock, cur)))
    ack_clock = torch.where(from_self, rclock, clock)
    vs = torch.where(propose, cur + 1, 0)
    ve = torch.where(propose, clock, 0)
    skipv = torch.zeros_like(in_q)
    if B.t.skip_capable:
        # tempo.rs:442-455: with a pair fast quorum the non-coordinator
        # member commits directly, with the coordinator's shipped votes
        skipv = B.lane("skip_fast_ack") & in_q & ~from_self
        two = torch.full_like(seq, 2)
        obc = emit_broadcast(
            B.empty(), TempoDev.MCOMMIT,
            torch.stack([s, seq, clock, key, client, two, s, B.pay[..., 4],
                         B.pay[..., 5], B.me, vs, ve], -1), B.n,
        )
        obc["valid"] = obc["valid"] & skipv[..., None]
    ob = emit(B.empty(), 0, s, TempoDev.MCOLLECTACK,
              torch.stack([seq, ack_clock, vs, ve], -1), in_q & ~skipv)
    if B.t.skip_capable:
        ob = {k: select([skipv], [obc[k], ob[k]]) for k in ob}
    return ps, ob


def _commit_broadcast(B, ps, seq, clock, key, client, valid):
    """The MCommit broadcast carrying the dot's aggregated votes."""
    slot = dot_slot(seq, B.D)
    votes = torch.stack(
        [take(ps[k], slot) for k in ("votes_by", "votes_s", "votes_e")], -1
    ).flatten(2)                                               # [L, N, 3N]
    pay = B.words(B.me, seq, clock, key, client, take(ps["votes_n"], slot))
    pay[..., 6:6 + 3 * B.N] = votes
    ob = emit_broadcast(B.empty(), TempoDev.MCOMMIT, pay, B.n)
    ob["valid"] = ob["valid"] & valid[..., None]
    return ob


def _mcollectack(B, ps):
    """tempo.rs:461-554: aggregate clocks and votes; fast path iff the
    max clock was reported >= f times; bump own keys to the running
    max."""
    t, src = B.t, B.src
    seq, clock, vs, ve = (B.pay[..., i] for i in range(4))
    slot = dot_slot(seq, B.D)
    nv = take(ps["votes_n"], slot)
    has_vote = vs > 0
    fits = has_vote & (nv < B.N)
    widx = torch.where(fits, nv, B.N)
    ps = dict(
        ps,
        votes_by=put2(ps["votes_by"], slot, widx, src),
        votes_s=put2(ps["votes_s"], slot, widx, vs),
        votes_e=put2(ps["votes_e"], slot, widx, ve),
        votes_n=put(ps["votes_n"], slot, nv + fits.to(I32)),
        err=_err(ps, ERR_CAPACITY, has_vote & ~fits),
    )
    old_max = take(ps["max_clock"], slot)
    new_max = torch.maximum(old_max, clock)
    new_cnt = torch.where(
        clock > old_max, 1,
        take(ps["max_cnt"], slot) + (clock == old_max).to(I32),
    )
    cnt = take(ps["ack_cnt"], slot) + 1
    ps = dict(
        ps,
        max_clock=put(ps["max_clock"], slot, new_max),
        max_cnt=put(ps["max_cnt"], slot, new_cnt),
        ack_cnt=put(ps["ack_cnt"], slot, cnt),
    )
    key = take(take(ps["key_of"], B.me), slot)
    ps = _bump(t, ps, key, new_max, src != B.me)
    all_acks = cnt == B.lane("fq_size")
    fast = all_acks & (new_cnt >= B.lane("f"))
    slow = all_acks & ~fast
    ps = dict(ps, m_fast=ps["m_fast"] + fast.to(I32),
              m_slow=ps["m_slow"] + slow.to(I32))
    client = take(take(ps["client_of"], B.me), slot)
    ob = _commit_broadcast(B, ps, seq, new_max, key, client, fast)
    obc = emit_broadcast(B.empty(), TempoDev.MCONSENSUS,
                         torch.stack([B.me, seq, new_max], -1), B.n)
    F = obc["valid"].shape[-1]
    wq = torch.zeros((B.L, B.N, F), dtype=torch.bool, device=B.dev)
    wq[..., :B.N] = B.ctx["write_quorum"]
    obc["valid"] = obc["valid"] & slow[..., None] & wq
    return ps, {k: select([fast], [ob[k], obc[k]]) for k in ob}


def _mcommit(B, ps):
    """tempo.rs:556-654: detached-bump the committed clock, feed the
    votes table (attached votes, then the pending entry), record the
    commit for GC, then drain. The dot source is clamped to a process
    id; voter ranges are routed by one-hot sums, so duplicate voters
    add up."""
    t, N = B.t, B.N
    dsrc = B.pay[..., 0].clamp(0, N - 1)
    seq, clock, key, client, nv = (B.pay[..., i] for i in range(1, 6))
    slot = dot_slot(seq, B.D)
    have = take(take(ps["seq_in_slot"], dsrc), slot) == seq
    ps = dict(ps, err=_err(ps, ERR_PROTO, ~have))
    bump_mode = B.lane("clock_bump_mode")
    mcc = ps["max_commit_clock"]
    ps = dict(ps, max_commit_clock=torch.where(
        bump_mode, torch.maximum(mcc, clock), mcc))
    ps = _bump(t, ps, key, clock, ~bump_mode)

    procs = torch.arange(N, device=B.dev, dtype=I32)
    enable = procs < nv[..., None]                             # [L, N, N]
    bys = torch.where(enable, B.pay[..., 6:6 + 3 * N:3], N)
    route = bys[..., :, None] == procs                          # [L, N, i, v]

    def per_voter(vals):
        return torch.where(route, vals[..., None], 0).sum(-2, dtype=I32)

    per_s = per_voter(B.pay[..., 7:7 + 3 * N:3])
    per_e = per_voter(B.pay[..., 8:8 + 3 * N:3])
    per_enable = (route & enable[..., None]).any(-2)
    fronts, gaps, ovf = iset_add_range(
        take(ps["vote_front"], key), take(ps["vote_gaps"], key),
        per_s, per_e, per_enable,
    )
    ps = dict(
        ps,
        vote_front=put(ps["vote_front"], key, fronts),
        vote_gaps=put(ps["vote_gaps"], key, gaps),
        err=_err(ps, ERR_CAPACITY, ovf.any(-1)),
    )
    ps = _pend_insert(t, ps, key, clock, dsrc, seq, client)
    cf, cg, overflow = iset_add(take(ps["comm_front"], dsrc),
                                take(ps["comm_gaps"], dsrc), seq)
    ps = dict(
        ps,
        comm_front=put(ps["comm_front"], dsrc, cf),
        comm_gaps=put(ps["comm_gaps"], dsrc, cg),
        err=_err(ps, ERR_CAPACITY, overflow),
    )
    return _drain(B, ps, key)


def _mdetached(B, ps):
    """tempo.rs:703-716: union the sender's detached ranges into its
    vote clock for the key, in payload order, then drain."""
    key, nr = B.pay[..., 0], B.pay[..., 1]
    for i in range(B.t.detached_per_msg(B.dims)):
        # a disabled add still runs the absorption passes, but after the
        # first add to a set nothing in it touches the frontier: once no
        # taker has a range left, the later adds change nothing
        if i > 0 and not bool((B.active & (i < nr)).any()):
            break
        ps = _vote_add(B.t, ps, key, B.src, B.pay[..., 2 + 2 * i],
                       B.pay[..., 3 + 2 * i], i < nr)
    return _drain(B, ps, key)


def _mconsensus(B, ps):
    """tempo.rs:718-773 (no recovery: the acceptor bumps its key and
    acks)."""
    dsrc, seq, clock = B.pay[..., 0], B.pay[..., 1], B.pay[..., 2]
    slot = dot_slot(seq, B.D)
    key = take(take(ps["key_of"], dsrc), slot)
    has_cmd = take(take(ps["seq_in_slot"], dsrc), slot) == seq
    ps = _bump(B.t, ps, key, clock, has_cmd)
    ob = emit(B.empty(), 0, B.src, TempoDev.MCONSENSUSACK,
              torch.stack([dsrc, seq], -1), torch.ones_like(has_cmd))
    return ps, ob


def _mconsensusack(B, ps):
    """tempo.rs:775-812: the write quorum's accepts choose the slow-path
    clock; commit with the votes gathered during collect."""
    seq = B.pay[..., 1]
    slot = dot_slot(seq, B.D)
    cnt = take(ps["slow_acks"], slot) + 1
    chosen = cnt == B.lane("wq_size")
    ps = dict(ps, slow_acks=put(ps["slow_acks"], slot, cnt))
    key = take(take(ps["key_of"], B.me), slot)
    client = take(take(ps["client_of"], B.me), slot)
    return ps, _commit_broadcast(B, ps, seq, take(ps["max_clock"], slot),
                                 key, client, chosen)


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


def _mdrain(B, ps):
    return _drain(B, ps, B.pay[..., 0])


def _detach_drain(B, ps):
    """Send the first key's first ``per_msg`` detached ranges (slot
    order) to everyone, then continue the chain at outbox slot N while
    any key still has ranges."""
    det = ps["det"]
    key_has = (det[..., 0] > 0).any(-1)                         # [L, N, K]
    key = first_true(key_has)
    any_key = key_has.any(-1)
    row = take(det, key)                                        # [L, N, R, 2]
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
    ob = emit_broadcast(B.empty(), TempoDev.MDETACHED, pay, B.n)
    ob["valid"] = ob["valid"] & any_key[..., None]
    more = (det[..., 0] > 0).flatten(2).any(-1)
    ob = emit(ob, B.N, B.me, TempoDev.DETACH_DRAIN,
              torch.zeros_like(key)[..., None], any_key & more)
    return dict(ps, det=det), ob
