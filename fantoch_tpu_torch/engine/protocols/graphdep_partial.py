"""Device twin of Atlas with partial replication and multi-key commands,
batched over ``[L, N]`` (lane, process): the counterpart of the
reference's ``fantoch_tpu/engine/protocols/graphdep_partial.py``
(fantoch_ps/src/protocol/atlas.rs with partial.rs, and the graph
executor's cross-shard protocol, executor/graph/mod.rs:279-408).

The dependency core is :class:`AtlasDev`'s; partial replication adds:

- ``MForwardSubmit`` hands the dot to the closest process of every other
  shard the command touches (partial.rs:8-35); each shard runs its own
  collect round over its keys' dependencies;
- per-shard dep sets aggregate at the dot owner: ``MShardCommit`` carries
  a shard's decided deps, the owner unions them and sends
  ``MShardAggregatedCommit`` back (partial.rs:37-167); every shard
  coordinator then broadcasts the final ``MCommit`` inside its shard;
- the graph executor fetches a committed-but-blocked dependency whose
  command does not touch this shard from the closest process of the dot
  owner's shard (``GREQ``); the responder answers with the vertex
  (``GREPLY``) or an executed marker (``GREPLYEXEC``), and buffers dots
  it does not know until the periodic cleanup tick answers them;
- clients count per-key result parts (the engine's ``cmd_parts``, kernel
  ``emit_rewrite``); a vertex executes all of this shard's keys at once.

Dependencies are (source, sequence, shard mask) triples; the mask is the
dep command's touched shards, which decides whether a missing dep is
replicated here. A command is (client, cseq): its keys per shard and
touched-shard mask are ctx tables (``cmd_skey``/``cmd_kmask``).

:meth:`AtlasPartialDev.step_plain` is the plain PyTorch twin of the
``atlas_partial_handle`` CUDA kernel (``kernels/atlas_partial_handle.py``).
Its handlers run on the (lane, process) pairs that take each branch
only: their state rows are gathered, updated with the reference's
one-hot semantics (a read out of range yields 0, a write there drops;
the drain's gathers by dep source index as jnp's plain gathers: negative
from the end, clamped) and written back. The graph drain runs only for
the branches that call it (MCommit, MDrain, GReply, GReplyExec), as
under the reference's ``lax.switch``.

Not here, as in the reference: the safety-monitor hook and the narrowed
metric planes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core import emit, emit_broadcast, empty_outbox, write_running
from ..dims import (
    ERR_CAPACITY, ERR_DOT, ERR_PROTO, ERR_SEQ, INF, PMT, PPAY, SEQ_BOUND,
    EngineDims, dot_slot,
)
from ..iset import first_true, iset_add, iset_contains, iset_contains_gathered
from .graphdep import AtlasDev, _relax
from .masked import (
    compact_order, gather_cell, put, put2, select, take, take2, take_words,
)
from .tempo_partial import _Rows as _PartialRows
from .tempo_partial import _cmd, _err, _gather, _mgc, _popcount

I32 = torch.int32

OUTBOX_KEYS = ("valid", "dst", "mtype", "payload", "delay", "src")
# the lane ctx the handlers read
CTX_KEYS = ("n", "f", "expected_acks", "fp_mode", "ack_self",
            "fast_quorum", "write_quorum", "shard_of", "closest",
            "client_attach_s", "cmd_kmask", "cmd_skey")


class AtlasPartialDev(AtlasDev):
    SUBMIT = 0
    MCOLLECT = 1
    MCOLLECTACK = 2
    MCOMMIT = 3
    MCONSENSUS = 4
    MCONSENSUSACK = 5
    MGC = 6
    MDRAIN = 7
    MFWDSUBMIT = 8
    MSHARDCOMMIT = 9
    MSHARDAGG = 10
    GREQ = 11
    GREPLY = 12
    GREPLYEXEC = 13
    NUM_TYPES = 14
    TO_CLIENT = 15

    PERIODIC_ROWS = 2  # [garbage collection, executor cleanup]
    # the partial twin's handlers carry no safety-monitor hooks (fuzzing
    # is single-shard, as in the reference): monitors are refused
    MONITORED = False

    def __init__(self, keys: int, shards: int = 2, keys_per_cmd: int = 2,
                 gap_slots: int = 8, req_buffer: int = 16):
        super().__init__(keys, gap_slots)
        self.S = shards
        self.KPC = keys_per_cmd
        self.B = req_buffer

    # -- host-side builders -------------------------------------------

    def q_shard(self, n: int) -> int:
        """Per-shard dep-slot bound: each of the n reporters contributes
        up to KPC latest deps plus the coordinator's KPC."""
        return self.KPC * (n + 1)

    def q_union(self, n: int) -> int:
        """Aggregated (cross-shard union) dep bound."""
        return self.S * self.q_shard(n)

    def payload_width(self, n: int) -> int:
        # MCommit/GReply: [dsrc, dseq, client, cseq, nd] + 3 * QS; MGC
        # the committed frontier over all S·n sources
        return max(5 + 3 * self.q_union(n), self.S * n, 8)

    def fanout(self, n: int) -> int:
        """Outbox slots one handler may need: a shard broadcast plus the
        forwards, the cleanup replies in slots N+1..N+B of the periodic
        outbox, the drain's KPC client parts, request and chain."""
        N = self.S * n
        return max(N + self.B + 2, N + self.S + 2, self.KPC + 3)

    def periodic_intervals(self, config, dims: EngineDims):
        gc = config.gc_interval_ms
        cl = config.executor_cleanup_interval_ms
        return [gc if gc is not None else INF, cl if cl else INF]

    def lane_ctx(self, config, dims: EngineDims, sorted_idx: np.ndarray):
        N, n, S = dims.N, config.n, config.shard_count
        fq_size, wq_size = self._quorum_sizes(config)
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
        ack_self = self._ack_self()
        return {
            "fast_quorum": fq,
            "write_quorum": wq,
            "expected_acks": np.int32(fq_size if ack_self else fq_size - 1),
            "fp_mode": np.int32(self._fp_mode()),
            "ack_self": np.bool_(ack_self),
        }

    def init_state(self, dims: EngineDims, ctx_np) -> Dict[str, np.ndarray]:
        N, D, G = dims.N, dims.D, self.G
        n = int(ctx_np["n"])
        K, B = self.K, self.B
        Q, QS = self.q_shard(n), self.q_union(n)
        z = np.zeros
        return {
            "latest_src": z((N, K), np.int32),
            "latest_seq": z((N, K), np.int32),
            "latest_km": z((N, K), np.int32),
            "seq_in_slot": z((N, N, D), np.int32),
            "client_of": z((N, N, D), np.int32),
            "cseq_of": z((N, N, D), np.int32),
            "own_seq": z((N,), np.int32),
            "ack_cnt": z((N, N, D), np.int32),
            "slow_acks": z((N, N, D), np.int32),
            "qd_src": z((N, N, D, Q), np.int32),
            "qd_seq": z((N, N, D, Q), np.int32),
            "qd_km": z((N, N, D, Q), np.int32),
            "qd_cnt": z((N, N, D, Q), np.int32),
            "sh_cnt": z((N, D), np.int32),
            "sh_src": z((N, D, QS), np.int32),
            "sh_seq": z((N, D, QS), np.int32),
            "sh_km": z((N, D, QS), np.int32),
            "vx_committed": z((N, N, D), bool),
            "vx_seq": z((N, N, D), np.int32),
            "vx_client": z((N, N, D), np.int32),
            "vx_cseq": z((N, N, D), np.int32),
            "vx_nd": z((N, N, D), np.int32),
            "vx_dep_src": z((N, N, D, QS), np.int32),
            "vx_dep_seq": z((N, N, D, QS), np.int32),
            "vx_dep_km": z((N, N, D, QS), np.int32),
            "req_seq": z((N, N, D), np.int32),
            "breq_from": np.full((N, B), -1, np.int32),
            "breq_src": z((N, B), np.int32),
            "breq_seq": z((N, B), np.int32),
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

    # -- the handler step ----------------------------------------------

    def handlers(self, ps, has, rows, fire, ep, ctx, dims: EngineDims,
                 cap=None):
        """Readiness gate, both timers and the message handler (with the
        graph drain where the branch calls it) of every (lane, process):
        ``(rdy, ps, periodic outbox, handler outbox)`` (the event times
        ``ep`` are not read). ``ps`` is updated in place on the lanes
        ``cap`` lets run (every lane without one) and returned as the
        same tensors. Runs the ``atlas_partial_handle`` kernel on CUDA
        tensors."""
        from ...kernels.atlas_partial_handle import atlas_partial_handle

        return atlas_partial_handle(ps, has, rows, fire, ctx, dims, cap)

    def step_plain(self, ps, has, rows, fire, ctx, dims: EngineDims,
                   cap=None):
        """The plain twin of the kernel, in the reference's order:
        ``ready`` on the incoming state, ``periodic``, then ``handle`` on
        the state ``periodic`` returned, out of place; then the running
        lanes' rows (of ``cap``; every lane without one) are copied into
        ``ps``, in place, as the kernel writes them
        (``core.write_running``). A frozen lane's ``rdy`` is false and
        its outboxes empty."""
        X = AtlasPartialDev
        none = torch.full_like(rows[..., PMT], X.NUM_TYPES)
        mtype0 = torch.where(has, rows[..., PMT], none)
        rdy = X.ready_plain(ps, rows, mtype0, dims)
        mtype = torch.where(has & rdy, mtype0, none)
        new, pout = self.periodic_plain(ps, fire, ctx, dims)
        new, hout = self.handle_plain(new, mtype, rows, ctx, dims)
        return write_running(ps, (rdy, new, pout, hout), cap, dims)

    @staticmethod
    def ready_plain(ps, rows, mtype, dims: EngineDims):
        """MCollect waits for a free dot slot (payload and vertex store);
        MCommit, MShardCommit and MShardAgg for the MCollect payload."""
        X = AtlasPartialDev
        pay = rows[..., PPAY:]
        seq = pay[..., 1]
        slot = dot_slot(seq, dims.D)
        cell = take2(ps["seq_in_slot"], pay[..., 0], slot)
        free = (cell == 0) & (take2(ps["vx_seq"], pay[..., 0], slot) == 0)
        ok = torch.where(mtype == X.MCOLLECT, free,
                         torch.ones_like(free))
        needs = ((mtype == X.MCOMMIT) | (mtype == X.MSHARDCOMMIT)
                 | (mtype == X.MSHARDAGG))
        return torch.where(needs, cell == seq, ok)

    def periodic_plain(self, ps, fire, ctx, dims: EngineDims):
        """Row 0: the GC frontier to the rest of my shard. Row 1: the
        executor cleanup tick, which answers the buffered requests whose
        dots have since committed or executed here (slots N+1..N+B)."""
        L, N = fire.shape[:2]
        dev = fire.device
        li = torch.arange(L, device=dev).repeat_interleave(N)
        pi = torch.arange(N, device=dev).repeat(L)
        rows = torch.zeros((L, N, PPAY + dims.P), dtype=I32, device=dev)
        B = _Rows(self, ps, rows, ctx, dims, li, pi)
        ob = emit_broadcast(B.empty(), self.MGC, B.ps["comm_front"], B.n,
                            B.me, exclude_me=True, base=B.base)
        ob["valid"] = ob["valid"] & fire.reshape(L * N, 1, -1)[..., 0:1]
        st, ob = _cleanup(B, B.ps, ob, fire.reshape(L * N, 1, -1)[..., 1])
        return (dict(ps, breq_from=st["breq_from"].view_as(ps["breq_from"])),
                {k: v.reshape((L, N) + v.shape[2:]) for k, v in ob.items()})

    def handle_plain(self, ps, mtype, rows, ctx, dims: EngineDims):
        """The message switch: each branch on the pairs that take it."""
        branches = [_submit, _mcollect, _mcollectack, _mcommit, _mconsensus,
                    _mconsensusack, _mgc, _mdrain, _mfwdsubmit,
                    _mshardcommit, _mshardagg, _request, _reply,
                    _replyexec]
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


class _Rows(_PartialRows):
    """The (lane, process) pairs that take one branch, with the sizes of
    the partial Atlas tables."""

    CTX = CTX_KEYS

    def __init__(self, t, ps, rows, ctx, dims, li, pi):
        super().__init__(t, ps, rows, ctx, dims, li, pi)
        n = dims.N // t.S
        self.Q, self.QS = t.q_shard(n), t.q_union(n)


# ----------------------------------------------------------------------
# dep-set helpers (graphdep_partial.py:284-337)
# ----------------------------------------------------------------------

def _dep_row_add(rows, dsrc, dseq, dkm):
    """Merge one dep into a table row ``(src, seq, km, cnt)`` (each
    ``[A, 1, Q]``): the first match counts one more, else the first
    free entry takes it; a full row drops it. Returns (rows, overflow)."""
    src_row, seq_row, km_row, cnt_row = rows
    Q = src_row.shape[-1]
    do = dseq > 0
    match = (seq_row == dseq[..., None]) & (src_row == dsrc[..., None])
    found = match.any(-1)
    free = seq_row == 0
    overflow = do & ~found & ~free.any(-1)
    widx = torch.where(do & ~overflow,
                       torch.where(found, first_true(match), first_true(free)),
                       Q)
    hit = torch.arange(Q, device=seq_row.device, dtype=I32) == widx[..., None]
    cnt = torch.where(found[..., None], cnt_row + 1, 1)
    return (torch.where(hit, dsrc[..., None], src_row),
            torch.where(hit, dseq[..., None], seq_row),
            torch.where(hit, dkm[..., None], km_row),
            torch.where(hit, cnt, cnt_row)), overflow


def _pack_deps(pay, lo_base, src_row, seq_row, km_row, limit):
    """Add the present (seq > 0) dep triples, packed to the front, into
    ``pay [A, 1, P]`` from word ``lo_base``; returns (payload, count)."""
    P = pay.shape[-1]
    order, nd = compact_order(seq_row > 0, limit)
    lo = torch.where(order < limit, lo_base + 3 * torch.clamp(order, max=limit),
                     P)[..., None]
    at = torch.arange(P, device=pay.device, dtype=I32)
    pay = pay + (torch.where(lo == at, src_row[..., None], 0)
                 + torch.where(lo + 1 == at, seq_row[..., None], 0)
                 + torch.where(lo + 2 == at, km_row[..., None], 0)
                 ).sum(-2, dtype=I32)
    return pay, nd


def _take_deps(pay, lo_base, count, slots):
    """Up to ``slots`` dep triples read from the payload from word
    ``lo_base``; entries at or past ``count`` read 0."""
    idx = lo_base + 3 * torch.arange(slots, device=pay.device, dtype=I32)
    en = torch.arange(slots, device=pay.device, dtype=I32) < count[..., None]
    return tuple(torch.where(en, take_words(pay, idx + i), 0)
                 for i in range(3))


def _own_deps(B, ps, keys):
    """This shard's latest dep per command key, duplicates and empties
    dropped (key_deps.add_cmd before the latest pointers move)."""
    valid = keys >= 0
    src, seq, km = (torch.where(valid, _gather(ps[k], keys), 0)
                    for k in ("latest_src", "latest_seq", "latest_km"))
    keep = seq > 0
    for i in range(1, B.KPC):
        for j in range(i):
            dup = (src[..., i] == src[..., j]) & (seq[..., i] == seq[..., j])
            keep[..., i] = keep[..., i] & ~dup
    return (torch.where(keep, src, 0), torch.where(keep, seq, 0),
            torch.where(keep, km, 0))


def _bump_latest(B, ps, keys, dsrc, dseq, kmask):
    """Point every command key's latest dep at this dot."""
    out = dict(ps)
    for d in range(B.KPC):
        k = torch.where(keys[..., d] >= 0, keys[..., d], -1)
        for name, v in (("latest_src", dsrc), ("latest_seq", dseq),
                        ("latest_km", kmask)):
            out[name] = put(out[name], k, v)
    return out


# ----------------------------------------------------------------------
# submit / forward / collect (graphdep_partial.py:386-540)
# ----------------------------------------------------------------------

def _start(B, ps, dsrc, dseq, client, cseq, forward: bool):
    """The coordinator start (atlas.rs:210-248 at the target shard; the
    MForwardSubmit path runs it without forwarding)."""
    X = AtlasPartialDev
    kmask, skey = _cmd(B, client, cseq)
    keys = take(skey, B.s_me)
    slot = dot_slot(dseq, B.D)
    d_src, d_seq, d_km = _own_deps(B, ps, keys)
    ps = _bump_latest(B, ps, keys, dsrc, dseq, kmask)
    zero = B.zero()
    zq = torch.zeros_like(take2(ps["qd_src"], dsrc, slot))
    ps = dict(ps, ack_cnt=put2(ps["ack_cnt"], dsrc, slot, zero),
              slow_acks=put2(ps["slow_acks"], dsrc, slot, zero),
              **{k: put2(ps[k], dsrc, slot, zq)
                 for k in ("qd_src", "qd_seq", "qd_km", "qd_cnt")})
    pay, nd = _pack_deps(B.words(dsrc, dseq, client, cseq), 5, d_src, d_seq,
                         d_km, B.KPC)
    pay[..., 4] = nd
    ob = emit_broadcast(B.empty(), X.MCOLLECT, pay, B.n, base=B.base)
    if forward:
        zqs = torch.zeros_like(take(ps["sh_src"], slot))
        ps = dict(ps, sh_cnt=put(ps["sh_cnt"], slot, zero),
                  **{k: put(ps[k], slot, zqs)
                     for k in ("sh_src", "sh_seq", "sh_km")})
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
    """atlas.rs:250-323 with the dot source decoupled from the sender
    (the shard coordinator): a quorum member reports its own latest deps
    with the coordinator's not already among them; the self-collect
    reports the coordinator's deps unchanged."""
    X = AtlasPartialDev
    coord = B.src
    dsrc, dseq, client, cseq, cnd = (B.pay[..., i] for i in range(5))
    slot = dot_slot(dseq, B.D)
    dirty = ((take2(ps["seq_in_slot"], dsrc, slot) != 0)
             | (take2(ps["vx_seq"], dsrc, slot) != 0))
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
    c_src, c_seq, c_km = _take_deps(B.pay, 5, cnd, B.KPC)
    member = in_q & ~from_self
    o_src, o_seq, o_km = _own_deps(B, ps, keys)
    ps2 = _bump_latest(B, ps, keys, dsrc, dseq, kmask)
    ps = dict(ps, **{k: torch.where(member[..., None], ps2[k], ps[k])
                     for k in ("latest_src", "latest_seq", "latest_km")})
    keep = c_seq > 0
    for i in range(B.KPC):
        for j in range(B.KPC):
            dup = ((c_src[..., i] == o_src[..., j])
                   & (c_seq[..., i] == o_seq[..., j]) & (o_seq[..., j] > 0))
            keep[..., i] = keep[..., i] & ~dup
    zero = torch.zeros_like(c_src)
    reported = []
    for o, c in ((o_src, c_src), (o_seq, c_seq), (o_km, c_km)):
        a = torch.cat([o, torch.where(keep, c, 0)], -1)
        mine = torch.cat([c, zero], -1)
        reported.append(torch.where(member[..., None], a, mine))
    pay, nd = _pack_deps(B.words(dsrc, dseq), 3, *reported, 2 * B.KPC)
    pay[..., 2] = nd
    ack = in_q & (B.ctx["ack_self"] | ~from_self)
    return ps, emit(B.empty(), 0, coord, X.MCOLLECTACK, pay, ack)


# ----------------------------------------------------------------------
# collect-ack / commit paths (graphdep_partial.py:547-851)
# ----------------------------------------------------------------------

def _commit_broadcast(B, dsrc, dseq, client, cseq, rows, valid):
    """MCommit inside my shard with the dep set ``rows`` (src, seq, km)."""
    X = AtlasPartialDev
    pay, nd = _pack_deps(B.words(dsrc, dseq, client, cseq), 5, *rows,
                         rows[0].shape[-1])
    pay[..., 4] = nd
    ob = emit_broadcast(B.empty(), X.MCOMMIT, pay, B.n, base=B.base)
    ob["valid"] = ob["valid"] & valid[..., None]
    return ob


def _commit_actions(B, ps, dsrc, dseq, client, cseq, kmask, valid):
    """partial.rs:37-101: a single-shard command commits in this shard
    with this shard's dep union; a multi-shard one sends the union to the
    dot owner as an MShardCommit."""
    X = AtlasPartialDev
    single = _popcount(kmask, B.S) == 1
    slot = dot_slot(dseq, B.D)
    rows = tuple(take2(ps[k], dsrc, slot) for k in ("qd_src", "qd_seq",
                                                    "qd_km"))
    ob_commit = _commit_broadcast(B, dsrc, dseq, client, cseq, rows,
                                  valid & single)
    pay, nd = _pack_deps(B.words(dsrc, dseq), 3, *rows, rows[0].shape[-1])
    pay[..., 2] = nd
    ob_shard = emit(B.empty(), 0, dsrc, X.MSHARDCOMMIT, pay, valid & ~single)
    return {k: select([single], [ob_commit[k], ob_shard[k]])
            for k in ob_commit}


def _mcollectack(B, ps):
    """atlas.rs:325-391 at the shard coordinator (possibly of a foreign
    dot): count the dep reports, run the fast-path predicate on the last
    expected ack. When neither path is taken the outbox keeps the
    consensus broadcast's (invalid) rows."""
    X = AtlasPartialDev
    dsrc, dseq, nd = (B.pay[..., i] for i in range(3))
    slot = dot_slot(dseq, B.D)
    r_src, r_seq, r_km = _take_deps(B.pay, 3, nd, 2 * B.KPC)
    names = ("qd_src", "qd_seq", "qd_km", "qd_cnt")
    rows = tuple(take2(ps[k], dsrc, slot) for k in names)
    overflow = torch.zeros_like(dsrc, dtype=torch.bool)
    for i in range(2 * B.KPC):
        rows, ovf = _dep_row_add(rows, r_src[..., i], r_seq[..., i],
                                 r_km[..., i])
        overflow = overflow | ovf
    cnt = take2(ps["ack_cnt"], dsrc, slot) + 1
    ps = dict(ps, ack_cnt=put2(ps["ack_cnt"], dsrc, slot, cnt),
              err=_err(ps, ERR_CAPACITY, overflow),
              **{k: put2(ps[k], dsrc, slot, r) for k, r in zip(names, rows)})
    expected = B.ctx["expected_acks"]
    all_acks = cnt == expected
    threshold = torch.where(B.ctx["fp_mode"] == 0, B.ctx["f"], expected)
    fp_ok = ((rows[1] <= 0) | (rows[3] >= threshold[..., None])).all(-1)
    fast = all_acks & fp_ok
    slow = all_acks & ~fast
    ps = dict(ps, m_fast=ps["m_fast"] + fast.to(I32),
              m_slow=ps["m_slow"] + slow.to(I32))
    client = take2(ps["client_of"], dsrc, slot)
    cseq = take2(ps["cseq_of"], dsrc, slot)
    kmask, _skey = _cmd(B, client, cseq)
    ob = _commit_actions(B, ps, dsrc, dseq, client, cseq, kmask, fast)
    obc = emit_broadcast(B.empty(), X.MCONSENSUS,
                         torch.stack([dsrc, dseq], -1), B.n, base=B.base)
    F = obc["valid"].shape[-1]
    procs = torch.arange(F, device=B.dev, dtype=I32) + B.base[..., None]
    wq = _gather(take(B.ctx["write_quorum"], B.me), procs.clamp(0, B.N - 1))
    obc["valid"] = obc["valid"] & slow[..., None] & wq
    return ps, {k: select([fast], [ob[k], obc[k]]) for k in ob}


def _mshardcommit(B, ps):
    """partial.rs:103-142 at the dot owner: union each shard's deps; once
    every touched shard reported, send the union to me and the closest
    process of every other touched shard."""
    X = AtlasPartialDev
    dsrc, dseq, nd = (B.pay[..., i] for i in range(3))
    slot = dot_slot(dseq, B.D)
    ps = dict(ps, err=_err(ps, ERR_PROTO, dsrc != B.me))
    r_src, r_seq, r_km = _take_deps(B.pay, 3, nd, B.Q)
    names = ("sh_src", "sh_seq", "sh_km")
    rows = tuple(take(ps[k], slot) for k in names)
    rows = rows + (torch.zeros_like(rows[0]),)   # counts unused here
    overflow = torch.zeros_like(dsrc, dtype=torch.bool)
    for i in range(B.Q):
        rows, ovf = _dep_row_add(rows, r_src[..., i], r_seq[..., i],
                                 r_km[..., i])
        overflow = overflow | ovf
    scnt = take(ps["sh_cnt"], slot) + 1
    ps = dict(ps, sh_cnt=put(ps["sh_cnt"], slot, scnt),
              err=_err(ps, ERR_CAPACITY, overflow),
              **{k: put(ps[k], slot, r) for k, r in zip(names, rows)})
    kmask, _skey = _cmd(B, take2(ps["client_of"], B.me, slot),
                        take2(ps["cseq_of"], B.me, slot))
    done = scnt == _popcount(kmask, B.S)
    pay, und = _pack_deps(B.words(dsrc, dseq), 3, *rows[:3],
                          rows[0].shape[-1])
    pay[..., 2] = und
    ob = emit(B.empty(), 0, B.me, X.MSHARDAGG, pay, done)
    for s in range(B.S):
        touched = ((kmask >> s) & 1) == 1
        ob = emit(ob, 1 + s, B.closest[..., s], X.MSHARDAGG, pay,
                  done & touched & (B.s_me != s))
    return ps, ob


def _mshardagg(B, ps):
    """partial.rs:144-167 at each shard coordinator: the final MCommit
    inside this shard with the aggregated union."""
    dsrc, dseq, nd = (B.pay[..., i] for i in range(3))
    slot = dot_slot(dseq, B.D)
    rows = _take_deps(B.pay, 3, nd, B.QS)
    ob = _commit_broadcast(B, dsrc, dseq, take2(ps["client_of"], dsrc, slot),
                           take2(ps["cseq_of"], dsrc, slot), rows,
                           torch.ones_like(dsrc, dtype=torch.bool))
    return ps, ob


def _install(B, ps, dsrc, slot, do, words):
    """Write a vertex (committed, seq, client, cseq, nd and the dep
    triples from word 5) where ``do`` holds."""
    dseq, client, cseq, nd = (words[..., i] for i in range(1, 5))
    deps = _take_deps(words, 5, nd, B.QS)
    wsrc = torch.where(do, dsrc, B.N)
    out = dict(ps, vx_committed=put2(ps["vx_committed"], wsrc, slot,
                                     torch.ones_like(do)))
    for name, v in (("vx_seq", dseq), ("vx_client", client),
                    ("vx_cseq", cseq), ("vx_nd", nd),
                    ("vx_dep_src", deps[0]), ("vx_dep_seq", deps[1]),
                    ("vx_dep_km", deps[2])):
        out[name] = put2(ps[name], wsrc, slot, v)
    return out


def _mcommit(B, ps):
    """atlas.rs:393-464: install the vertex with the aggregated deps,
    record the commit for GC (my shard's dots only; a foreign dot frees
    its payload slot at once), drain the graph. The dot source is not
    clamped: one out of range reads 0 and its writes drop."""
    dsrc, dseq = B.pay[..., 0], B.pay[..., 1]
    slot = dot_slot(dseq, B.D)
    have = take2(ps["seq_in_slot"], dsrc, slot) == dseq
    already = take2(ps["vx_seq"], dsrc, slot) == dseq
    do = have & ~already
    ps = dict(ps, err=_err(ps, ERR_PROTO, ~have))
    ps = _install(B, ps, dsrc, slot, do, B.pay)
    my_dot = take(B.ctx["shard_of"], dsrc) == B.s_me
    cf, cg, overflow = iset_add(take(ps["comm_front"], dsrc),
                                take(ps["comm_gaps"], dsrc), dseq,
                                enable=do & my_dot)
    ps = dict(
        ps,
        comm_front=put(ps["comm_front"], dsrc, cf),
        comm_gaps=put(ps["comm_gaps"], dsrc, cg),
        err=_err(ps, ERR_CAPACITY, overflow),
        seq_in_slot=put2(ps["seq_in_slot"], dsrc, slot,
                         torch.where(my_dot, dseq, 0)),
    )
    return _drain(B, ps, B.empty())


def _mconsensus(B, ps):
    """Slow-path accept: with no recovery the initial ballot always
    wins, so the acceptor just acks."""
    X = AtlasPartialDev
    ob = emit(B.empty(), 0, B.src, X.MCONSENSUSACK, B.pay[..., 0:2],
              torch.ones_like(B.src, dtype=torch.bool))
    return ps, ob


def _mconsensusack(B, ps):
    """Chosen at model-f+1 accepts, then the commit actions with the dep
    union gathered during collect."""
    dsrc, dseq = B.pay[..., 0], B.pay[..., 1]
    slot = dot_slot(dseq, B.D)
    cnt = take2(ps["slow_acks"], dsrc, slot) + 1
    chosen = cnt == B.ctx["f"] + 1
    ps = dict(ps, slow_acks=put2(ps["slow_acks"], dsrc, slot, cnt))
    client = take2(ps["client_of"], dsrc, slot)
    cseq = take2(ps["cseq_of"], dsrc, slot)
    kmask, _skey = _cmd(B, client, cseq)
    return ps, _commit_actions(B, ps, dsrc, dseq, client, cseq, kmask,
                               chosen)


# ----------------------------------------------------------------------
# graph-executor drain and cross-shard requests (graphdep_partial.py:858-1123)
# ----------------------------------------------------------------------

def _drain(B, ps, ob):
    """Execute one dot whose transitive dep closure is committed (the
    greatest fixed point of graphdep's drain): a result part per local
    key to the client in slots 0..KPC-1 where I am its connected process
    of my shard. Then request one blocked dep that is neither executed
    nor present here and whose command does not touch my shard from the
    closest process of its owner's shard (GREQ in slot KPC, the lowest
    clipped src·2^20 + seq first). MDRAIN to me in slot KPC + 1 while
    more can execute or more requests are due."""
    X = AtlasPartialDev
    N, D, KPC = B.N, B.D, B.KPC
    ok, ready, _passes = _relax(ps, N, D)
    num_ok = ok.sum((-2, -1), dtype=I32)
    sel = torch.where(ready.flatten(2).any(-1)[..., None, None], ready, ok)
    srcs = torch.arange(N, device=B.dev, dtype=I32)[:, None]
    packed = srcs * SEQ_BOUND + ps["vx_seq"]
    flat = torch.where(sel, packed, INF).flatten(2).argmin(-1).to(I32)
    esrc, eslot = flat // D, flat % D
    eseq = take2(ps["vx_seq"], esrc, eslot)
    client = take2(ps["vx_client"], esrc, eslot)
    cseq = take2(ps["vx_cseq"], esrc, eslot)
    do = num_ok > 0
    pre = ps  # the executed sets and vertex cells the relaxation read
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
    _kmask, skey = _cmd(B, client, cseq)
    keys = take(skey, B.s_me)
    connected = take2(B.ctx["client_attach_s"], client, B.s_me) == B.me
    zero = torch.zeros_like(client)[..., None]
    for d in range(KPC):
        ob = emit(ob, d, N + client, X.TO_CLIENT, zero,
                  do & connected & (keys[..., d] >= 0))

    # one request for a blocked dep of a still-committed vertex, judged
    # on the state before the pick executed
    dep_src, dep_seq, dep_km = (ps[k] for k in ("vx_dep_src", "vx_dep_seq",
                                                "vx_dep_km"))
    dslot = dot_slot(dep_seq, D)
    static = (dep_seq == 0) | iset_contains_gathered(
        pre["exec_front"], pre["exec_gaps"], dep_src, dep_seq)
    cell_valid = gather_cell(pre["vx_seq"], dep_src, dslot) == dep_seq
    s_me = B.s_me[..., None, None, None]
    touches_me = ((dep_km >> s_me) & 1) == 1
    req_done = gather_cell(ps["req_seq"], dep_src, dslot) == dep_seq
    missing = (ps["vx_committed"][..., None] & ~static & ~cell_valid
               & ~touches_me & ~req_done & (dep_seq > 0))
    any_missing = missing.flatten(2).any(-1)
    m_packed = dep_src.clamp(0, N) * SEQ_BOUND + dep_seq
    m_flat = torch.where(missing, m_packed, INF).flatten(2).argmin(-1,
                                                                   True)
    r_src = dep_src.flatten(2).gather(-1, m_flat)[..., 0]
    r_seq = dep_seq.flatten(2).gather(-1, m_flat)[..., 0]
    r_shard = take(B.ctx["shard_of"], r_src)
    ps = dict(ps, req_seq=put2(ps["req_seq"],
                               torch.where(any_missing, r_src, N),
                               dot_slot(r_seq, D), r_seq))
    ob = emit(ob, KPC, take(B.closest, r_shard), X.GREQ,
              torch.stack([r_src, r_seq], -1), any_missing)
    more = ((do & (num_ok > 1))
            | (any_missing & (missing.flatten(2).sum(-1) > 1)))
    return ps, emit(ob, KPC + 1, B.me, X.MDRAIN, zero, more)


def _mdrain(B, ps):
    return _drain(B, ps, B.empty())


def _answer(B, ps, ob, slot_i, from_shard, dsrc, dseq, enable):
    """GREPLY (the committed vertex, not yet executed) or GREPLYEXEC (an
    executed marker) for one requested dot in outbox slot ``slot_i``, to
    the closest process of the requesting shard; returns (outbox,
    answered). The slot is written either way."""
    X = AtlasPartialDev
    slot = dot_slot(dseq, B.D)
    pending = ((take2(ps["vx_seq"], dsrc, slot) == dseq)
               & take2(ps["vx_committed"], dsrc, slot))
    executed = iset_contains(take(ps["exec_front"], dsrc),
                             take(ps["exec_gaps"], dsrc), dseq)
    en = enable & (dseq > 0)
    pay = B.words(dsrc, dseq, *(take2(ps[k], dsrc, slot)
                                for k in ("vx_client", "vx_cseq", "vx_nd")))
    pay, _nd = _pack_deps(pay, 5, *(take2(ps[k], dsrc, slot)
                                    for k in ("vx_dep_src", "vx_dep_seq",
                                              "vx_dep_km")),
                    ps["vx_dep_src"].shape[-1])
    pay = torch.where(pending[..., None], pay, B.words(dsrc, dseq))
    answered = en & (pending | executed)
    ob = emit(ob, slot_i, take(B.closest, from_shard),
              torch.where(pending, X.GREPLY, X.GREPLYEXEC), pay, answered)
    return ob, answered


def _request(B, ps):
    """mod.rs:372-393 at the responder: answer with the vertex or an
    executed marker in slot 0; buffer an unknown dot (once per requesting
    shard) for the cleanup tick."""
    dsrc, dseq = B.pay[..., 0], B.pay[..., 1]
    from_shard = take(B.ctx["shard_of"], B.src)
    ob, answered = _answer(B, ps, B.empty(), 0, from_shard, dsrc, dseq,
                           torch.ones_like(dsrc, dtype=torch.bool))
    dup = ((ps["breq_from"] == from_shard[..., None])
           & (ps["breq_src"] == dsrc[..., None])
           & (ps["breq_seq"] == dseq[..., None])).any(-1)
    free = ps["breq_from"] < 0
    store = ~answered & ~dup
    overflow = store & ~free.any(-1)
    widx = torch.where(store & ~overflow, first_true(free), B.t.B)
    return dict(
        ps,
        breq_from=put(ps["breq_from"], widx, from_shard),
        breq_src=put(ps["breq_src"], widx, dsrc),
        breq_seq=put(ps["breq_seq"], widx, dseq),
        err=_err(ps, ERR_CAPACITY, overflow),
    ), ob


def _reply(B, ps):
    """mod.rs:395-398 at the requester: install the remote vertex with
    its deps, then drain. A live vertex of another sequence in its slot
    is a window collision (ERR_DOT), which drops the install."""
    dsrc, dseq = B.pay[..., 0], B.pay[..., 1]
    slot = dot_slot(dseq, B.D)
    cell = take2(ps["vx_seq"], dsrc, slot)
    already = cell == dseq
    dirty = (cell != 0) & ~already
    ps = dict(ps, err=_err(ps, ERR_DOT, dirty))
    ps = _install(B, ps, dsrc, slot, ~already & ~dirty, B.pay)
    return _drain(B, ps, B.empty())


def _replyexec(B, ps):
    """mod.rs:399-407: mark the remote dot executed, then drain."""
    dsrc, dseq = B.pay[..., 0], B.pay[..., 1]
    front, gaps, overflow = iset_add(take(ps["exec_front"], dsrc),
                                     take(ps["exec_gaps"], dsrc), dseq)
    ps = dict(ps, exec_front=put(ps["exec_front"], dsrc, front),
              exec_gaps=put(ps["exec_gaps"], dsrc, gaps),
              err=_err(ps, ERR_CAPACITY, overflow))
    return _drain(B, ps, B.empty())


def _cleanup(B, ps, ob, fire):
    """The executor cleanup tick where ``fire``: each buffered request in
    order answers into periodic slot N + 1 + b and, if answered, frees its
    entry."""
    for b in range(B.t.B):
        from_shard = ps["breq_from"][..., b]
        ob, answered = _answer(B, ps, ob, B.N + 1 + b, from_shard,
                               ps["breq_src"][..., b],
                               ps["breq_seq"][..., b],
                               fire & (from_shard >= 0))
        ps = dict(ps, breq_from=put(ps["breq_from"],
                                    torch.where(answered, b, B.t.B),
                                    torch.full_like(from_shard, -1)))
    return ps, ob
