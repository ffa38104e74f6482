"""Each kernel module's plain twin against the reference's own code for
the region it replaces, on seeded random inputs (numpy) that reach what
one run's trajectory may not: tied keys, empty processes, all-INF lanes,
full pools, out-of-range sources and dot slots that wrap.

- ``qualify_pop`` against ``_lane_step`` §1-2 (core.py:820-883, with
  ``frontier_min`` and ``mark_popped``);
- ``land_emissions`` against §6 (core.py:1460-1492, with ``cumsum_i32``
  and ``searchsorted_left``);
- ``basic_handle``, ``fpaxos_handle``, ``tempo_handle``,
  ``graphdep_handle``, ``caesar_handle``, ``tempo_partial_handle`` and
  ``atlas_partial_handle`` against their protocol's ``ready``/``periodic`` and ``run_handlers``
  in the step's order (core.py:873-918), Tempo's (both twins') at each
  process's event time, Atlas/EPaxos's in both fast-path modes;
- ``qualify_pop``, ``emit_rewrite`` and ``land_emissions`` under the
  fault flags and the reorder switch (the crash cut-off, the horizon,
  link windows with the overflow clamp, jitter, drops, ERR_UNAVAIL and
  the reorder draws) against the reference's whole ``_lane_step`` with
  the flags, around ``tests/test_torch_emit.py``'s stub protocol, and
  ``lane_freeze`` with the horizon against ``_lane_running``.

The wrappers get CPU tensors, so they run their twins; the CUDA kernels
are held against the same twins on the card by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fantoch_tpu.engine import EngineDims as RDims
from fantoch_tpu.engine.dims import ERR_POOL as R_ERR_POOL
from fantoch_tpu.engine.core import (
    cumsum_i32,
    frontier_min,
    mark_popped,
    run_handlers,
    searchsorted_left,
)
from fantoch_tpu.engine.protocols import BasicDev as RBasic
from fantoch_tpu.engine.protocols import FPaxosDev as RFPaxos
from fantoch_tpu.engine.protocols import AtlasDev as RAtlas
from fantoch_tpu.engine.protocols import AtlasPartialDev as RAtlasPartial
from fantoch_tpu.engine.protocols import CaesarDev as RCaesar
from fantoch_tpu.engine.protocols import TempoDev as RTempo
from fantoch_tpu.engine.protocols import TempoPartialDev as RTempoPartial
from fantoch_tpu_torch import carry
from fantoch_tpu_torch.engine.dims import (
    INF, PA, PDST, PKC, PKS, PMT, PPAY, PPR, PSRC, EngineDims,
)
from fantoch_tpu_torch.engine.protocols import (
    AtlasDev, BasicDev, FPaxosDev, TempoDev,
)
from fantoch_tpu_torch.kernels import (
    basic_handle, fpaxos_handle, graphdep_handle, land_emissions,
    qualify_pop, tempo_handle,
)

I32 = jnp.int32
SEEDS = [0, 1, 2, 3]
L, N, P = 6, 5, 5
W = PPAY + P


def _with_inf(rng, shape, hi, p_inf):
    """Small times (many ties) with a share of INF entries."""
    v = rng.integers(0, hi, shape).astype(np.int32)
    return np.where(rng.random(shape) < p_inf, INF, v).astype(np.int32)


def _assert_equal(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


# ----------------------------------------------------------------------
# K1 qualify_pop
# ----------------------------------------------------------------------

def _ref_qualify_pop(pool, next_periodic, lookahead):
    """One lane of ``_lane_step`` §1-2, fault-free."""
    n, m = next_periodic.shape[0], pool.shape[0]
    procs = jnp.arange(n, dtype=I32)
    arrival = pool[:, PA]
    dstmask = pool[:, PDST][None, :] == procs[:, None]
    arr_p = jnp.min(jnp.where(dstmask, arrival[None, :], INF), axis=1)
    ep = jnp.minimum(arr_p, jnp.min(next_periodic, axis=1))
    reach = jnp.where(
        (ep[:, None] >= INF) | (lookahead >= INF), INF,
        ep[:, None] + lookahead,
    )
    bound, now = frontier_min(reach, ep)
    active = (ep < INF) & ((ep < bound) | (ep == now))
    fire = (next_periodic == ep[:, None]) & active[:, None]
    cand = (
        (arrival[None, :] == ep[:, None]) & dstmask & active[:, None]
        & ~jnp.any(fire, axis=1)[:, None]
    )
    cand_prio = cand & (pool[:, PPR] != 0)[None, :]
    use = jnp.where(jnp.any(cand_prio, axis=1)[:, None], cand_prio, cand)
    min_src = jnp.min(jnp.where(use, pool[:, PKS][None, :], INF), axis=1)
    order = jnp.where(
        use & (pool[:, PKS][None, :] == min_src[:, None]),
        pool[:, PKC][None, :], INF,
    )
    slot = jnp.argmin(order, axis=1).astype(I32)
    has = jnp.any(use, axis=1)
    arrival = jnp.where(mark_popped(slot, has, m), INF, arrival)
    return arrival, ep, now, active, fire, slot, has, pool[slot]


def _qualify_inputs(seed, M=40, R=1):
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 9, (L, M, W)).astype(np.int32)
    pool[..., PA] = _with_inf(rng, (L, M), 6, 0.4)
    pool[..., PKS] = rng.integers(0, 4, (L, M))
    pool[..., PKC] = rng.integers(0, 3, (L, M))
    pool[..., PDST] = rng.integers(0, N, (L, M))
    pool[..., PPR] = rng.random((L, M)) < 0.2
    pool[0, :, PA] = INF                       # an empty lane
    next_periodic = _with_inf(rng, (L, N, R), 6, 0.3)
    next_periodic[0] = INF
    lookahead = _with_inf(rng, (L, N, N), 4, 0.2)
    lookahead[:, np.arange(N), np.arange(N)] = INF
    return pool, next_periodic, lookahead


@pytest.mark.parametrize("seed", SEEDS)
def test_qualify_pop_twin_matches_reference(seed):
    pool, next_periodic, lookahead = _qualify_inputs(seed)
    want = jax.jit(jax.vmap(_ref_qualify_pop))(
        pool, next_periodic, lookahead
    )
    before = qualify_pop.launches
    got = qualify_pop(*(torch.from_numpy(a) for a in
                        (pool, next_periodic, lookahead)))
    assert qualify_pop.launches == before  # the twin, not the kernel
    names = ("arrival", "ep", "now", "active", "fire", "slot", "has", "rows")
    for name, g, w in zip(names, got, want):
        _assert_equal(g.numpy(), w, name)
    # the inputs reach the paths they are meant to: some processes pop,
    # some have nothing to pop (slot 0), some timers fire
    has = np.asarray(want[6])
    assert has.any() and not has.all()
    assert np.asarray(want[4]).any()


# ----------------------------------------------------------------------
# K2 land_emissions
# ----------------------------------------------------------------------

def _ref_land(pool, arrival, deliver, new_rows, pool_peak, err):
    """One lane of ``_lane_step`` §6, fault-free, with §7's overflow
    bit."""
    m = pool.shape[0]
    rank = cumsum_i32(deliver)
    free = arrival == INF
    target = searchsorted_left(cumsum_i32(free), rank)
    target = jnp.where(deliver, target, m)
    n_free = jnp.sum(free)
    overflow = jnp.sum(deliver) > n_free
    peak = jnp.maximum(pool_peak, m - n_free + jnp.sum(deliver, dtype=I32))
    new_pool = pool.at[:, PA].set(arrival).at[target].set(
        new_rows, mode="drop"
    )
    return new_pool, overflow, peak, err | R_ERR_POOL * overflow


@pytest.mark.parametrize("seed", SEEDS)
def test_land_emissions_twin_matches_reference(seed, M=24, E=15):
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 50, (L, M, W)).astype(np.int32)
    # free shares from a nearly full pool (overflow) to an empty one
    p_free = np.linspace(0.05, 1.0, L)[:, None]
    arrival = np.where(
        rng.random((L, M)) < p_free, INF, rng.integers(0, 50, (L, M))
    ).astype(np.int32)
    deliver = rng.random((L, E)) < 0.6
    new_rows = rng.integers(0, 50, (L, E, W)).astype(np.int32)
    pool_peak = rng.integers(0, M, (L,)).astype(np.int32)
    err = (rng.integers(0, 2, (L,)) * 8).astype(np.int32)
    want = jax.jit(jax.vmap(_ref_land))(
        pool, arrival, deliver, new_rows, pool_peak, err
    )
    got = land_emissions(*(torch.from_numpy(a) for a in
                           (pool, arrival, deliver, new_rows, pool_peak,
                            err)))
    for name, g, w in zip(("pool", "overflow", "peak", "err"), got, want):
        _assert_equal(g.numpy(), w, name)
    overflow = np.asarray(want[1])
    assert overflow.any() and not overflow.all()


# ----------------------------------------------------------------------
# K4 basic_handle
# ----------------------------------------------------------------------

def _basic_inputs(seed, dims, lanes=24):
    """Enough (lane, process) pairs that every message type is handled
    and some are refused by the gate."""
    rng = np.random.default_rng(seed)
    D, C = dims.D, dims.C
    ri = lambda lo, hi, *s: rng.integers(lo, hi, (lanes, *s)).astype(np.int32)  # noqa: E731
    rb = lambda p, *s: rng.random((lanes, *s)) < p  # noqa: E731
    ps = {
        "seq_in_slot": ri(0, 7, N, N, D) * rb(0.5, N, N, D),
        "buffered_commit": rb(0.2, N, N, D),
        "committed_cnt": ri(0, 6, N, N),
        "acks": ri(0, 3, N, D),
        "client_of": ri(0, C, N, D),
        "own_seq": ri(0, 8, N),
        "others_frontier": ri(0, 6, N, N, N),
        "seen": rb(0.7, N, N),
        "prev_stable": ri(0, 3, N, N),
        "m_fast_path": ri(0, 9, N),
        "m_stable": ri(0, 9, N),
        "err": ri(0, 2, N) * 8,
    }
    rows = ri(0, 8, N, W)
    rows[..., PSRC] = ri(0, N + C, N)        # clients are out of range
    rows[..., PMT] = ri(0, RBasic.NUM_TYPES + 2, N)
    # MCommit's first word names a process; MStore/MStoreAck's is a seq
    # whose slot wraps (seq 0 → slot D - 1, as jnp's floor %)
    commit = rows[..., PMT] == RBasic.MCOMMIT
    rows[..., PPAY] = np.where(commit, ri(0, N + 1, N), ri(0, 9, N))
    # most commits arrive in order (the gate's in-order case)
    dsrc = np.minimum(rows[..., PPAY], N - 1)
    in_order = np.take_along_axis(
        ps["committed_cnt"], dsrc[..., None], axis=2
    )[..., 0] + 1
    rows[..., PPAY + 1] = np.where(
        commit & rb(0.7, N), in_order, rows[..., PPAY + 1]
    )
    ctx = {
        "n": ri(2, N + 1),
        "quorum": rb(0.5, N, N),
        "q_size": ri(1, 4),
    }
    return ps, rb(0.8, N), rows, rb(0.3, N, dims.R), ctx


def _ref_handler_lane(proto, dims, ps, has, rows, fire, ctx, ep=None):
    """One lane of the step's handler phase, in core.py:873-918's order,
    each process at its event time ``ep`` (0 where not given)."""
    ep = jnp.zeros((dims.N,), I32) if ep is None else ep
    procs = jnp.arange(dims.N, dtype=I32)
    msg = {
        "valid": has,
        "src": rows[:, PSRC],
        "mtype": jnp.where(has, rows[:, PMT], proto.NUM_TYPES),
        "payload": rows[:, PPAY:],
    }
    rdy = jax.vmap(
        lambda p, m, me: proto.ready(p, m, me, ctx, dims)
    )(ps, msg, procs)
    msg = dict(
        msg, valid=has & rdy,
        mtype=jnp.where(has & rdy, msg["mtype"], proto.NUM_TYPES),
    )
    ps, pout = jax.vmap(
        lambda p, f, me, t: proto.periodic(p, f, me, t, ctx, dims)
    )(ps, fire, procs, ep)
    ps, hout = run_handlers(proto, ps, msg, procs, ep, ctx, dims)
    return rdy, ps, pout, hout


def _run_handler_twin(wrapper, proto, rdims, dims, ps, has, rows, fire,
                      ctx, ep=None, extra=()):
    """The reference's handler phase and the port's wrapper (on CPU
    tensors: its twin) on the same inputs; asserts equality and returns
    the reference's outputs. With ``ep`` (the processes' event times)
    the wrapper takes it after ``fire``, and ``extra`` after ``dims``."""
    if ep is None:
        want = jax.jit(jax.vmap(
            lambda *a: _ref_handler_lane(proto, rdims, *a)
        ))(ps, has, rows, fire, ctx)
        times = ()
    else:
        want = jax.jit(jax.vmap(
            lambda *a: _ref_handler_lane(proto, rdims, *a)
        ))(ps, has, rows, fire, ctx, ep)
        times = (torch.from_numpy(ep),)
    before = wrapper.launches
    got = wrapper(
        carry.to_torch(ps, "cpu"), torch.from_numpy(has),
        torch.from_numpy(rows), torch.from_numpy(fire), *times,
        carry.to_torch(ctx, "cpu"), dims, *extra,
    )
    assert wrapper.launches == before  # the twin, not the kernel
    _assert_equal(got[0].numpy(), want[0], "rdy")
    for name, g, w in zip(("ps", "periodic", "handler"), got[1:], want[1:]):
        assert sorted(g) == sorted(w), name
        for k in w:
            _assert_equal(g[k].numpy(), w[k], f"{name}/{k}")
    return jax.tree_util.tree_map(np.asarray, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_basic_handle_twin_matches_reference(seed):
    kw = dict(n=N, clients=4, payload=P, dot_slots=4)
    rdims = RDims.for_protocol(RBasic, **kw)
    dims = EngineDims.for_protocol(BasicDev, **kw)
    ps, has, rows, fire, ctx = _basic_inputs(seed, dims)
    want = _run_handler_twin(basic_handle, RBasic, rdims, dims, ps, has,
                             rows, fire, ctx)
    # every message type was handled somewhere, and some were refused
    handled = np.where(np.asarray(want[0]) & has, rows[..., PMT], -1)
    assert set(range(RBasic.NUM_TYPES)) <= set(handled.ravel().tolist())
    assert (has & ~np.asarray(want[0])).any()


# ----------------------------------------------------------------------
# K5 fpaxos_handle
# ----------------------------------------------------------------------

def _fpaxos_inputs(seed, dims, lanes=48):
    """Every message type handled and refused somewhere; slots that wrap
    (slot 0 → entry D - 1), stale and counted accepts, GC that frees
    acceptor entries, clients past the attach table."""
    rng = np.random.default_rng(seed)
    D, C = dims.D, dims.C
    ri = lambda lo, hi, *s: rng.integers(lo, hi, (lanes, *s)).astype(np.int32)  # noqa: E731
    rb = lambda p, *s: rng.random((lanes, *s)) < p  # noqa: E731
    X = RFPaxos
    ps = {
        "last_slot": ri(0, 7, N),
        "cmd_slot": ri(0, 7, N, D) * rb(0.6, N, D),
        "acc_count": ri(0, 3, N, D),
        "acc_slot": ri(0, 7, N, D) * rb(0.5, N, D),
        "exec_frontier": ri(0, 6, N),
        "others_committed": ri(0, 6, N, N),
        "seen": rb(0.7, N, N),
        "m_stable": ri(0, 9, N),
        "err": ri(0, 2, N) * 8,
    }
    rows = ri(0, 8, N, W)
    rows[..., PSRC] = ri(0, N + C, N)        # clients are out of range
    rows[..., PMT] = ri(0, X.NUM_TYPES + 2, N)
    slot = ri(0, 9, N) * rb(0.8, N)          # slot 0 wraps to D - 1
    mt = rows[..., PMT]
    # most MChosen arrive in order; most MAccepted name their commander
    in_order = ps["exec_frontier"] + 1
    occupant = np.take_along_axis(
        ps["cmd_slot"], ((slot - 1) % D)[..., None], axis=2
    )[..., 0]
    slot = np.where((mt == X.MCHOSEN) & rb(0.7, N), in_order, slot)
    slot = np.where((mt == X.MACCEPTED) & rb(0.6, N) & (occupant > 0),
                    occupant, slot)
    rows[..., PPAY] = slot
    rows[..., PPAY + 1] = ri(0, C + 2, N)    # clients past the table
    ctx = {
        "n": ri(2, N + 1),
        "leader": ri(0, N),
        "write_quorum": rb(0.6, N),
        "q_size": ri(1, 4),
        "client_attach": ri(0, N, C),
    }
    # half the MAccepted complete their quorum
    li, pi = np.nonzero((mt == X.MACCEPTED) & rb(0.5, N))
    ps["acc_count"][li, pi, (slot[li, pi] - 1) % D] = ctx["q_size"][li] - 1
    return ps, rb(0.8, N), rows, rb(0.3, N, dims.R), ctx


@pytest.mark.parametrize("seed", SEEDS)
def test_fpaxos_handle_twin_matches_reference(seed):
    kw = dict(n=N, clients=4, payload=P, dot_slots=4)
    rdims = RDims.for_protocol(RFPaxos, **kw)
    dims = EngineDims.for_protocol(FPaxosDev, **kw)
    ps, has, rows, fire, ctx = _fpaxos_inputs(seed, dims)
    rdy, new_ps, _pout, hout = _run_handler_twin(
        fpaxos_handle, RFPaxos, rdims, dims, ps, has, rows, fire, ctx
    )
    X = RFPaxos
    mt = np.where(rdy & has, rows[..., PMT], -1)
    assert set(range(X.NUM_TYPES)) <= set(mt.ravel().tolist())
    assert (has & ~rdy).any()
    pay = rows[..., PPAY:]
    # a slot-0 message (entry D - 1), a stale MAccepted, a chosen slot,
    # an MGC that frees entries, a handled MChosen of an unknown client
    assert ((mt >= X.MACCEPT) & (mt <= X.MACCEPTED) & (pay[..., 0] == 0)).any()
    stale = (mt == X.MACCEPTED) & ((new_ps["err"] & 32) > (ps["err"] & 32))
    assert stale.any()
    assert ((mt == X.MACCEPTED) & hout["valid"].any(-1)).any()
    assert ((mt == X.MGC) & (new_ps["m_stable"] > ps["m_stable"])).any()
    assert ((mt == X.MCHOSEN) & (pay[..., 1] >= dims.C)).any()


# ----------------------------------------------------------------------
# K8 tempo_handle
# ----------------------------------------------------------------------

# small tables, so that inputs reach full ones: K keys, PK pending slots,
# R detached slots and G gap slots per interval set
TEMPO_SIZES = dict(keys=3, pending_per_key=4, detached_slots=4, gap_slots=3)


def _gap_sets(rng, shape, G, lo_max=6):
    """Interval sets ``(frontier, gaps)`` over ``shape``: gap chains above
    the frontier (some touching it after an add), free and full buffers,
    slots in no particular order."""
    front = rng.integers(0, lo_max, shape).astype(np.int32)
    gaps = np.zeros(shape + (G, 2), np.int32)
    lo = front + 1 + rng.integers(0, 3, shape)
    for j in range(G):
        start = lo + rng.integers(0, 3, shape)
        end = start + rng.integers(0, 3, shape)
        keep = rng.random(shape) < 0.6
        gaps[..., j, 0] = np.where(keep, start, 0)
        gaps[..., j, 1] = np.where(keep, end, 0)
        lo = np.where(keep, end + 1, lo)
    perm = np.argsort(rng.random(shape + (G,)), axis=-1)
    return front, np.take_along_axis(gaps, perm[..., None], axis=-2)


def _tempo_inputs(seed, dims, t, lanes=64):
    """Every message type handled somewhere, the gated ones (MCollect,
    MCommit, MConsensus) also refused; all three timer rows firing at
    real event times (some past the micros saturation point); occupied
    and full gap, pending and detached tables; MCommits with duplicate
    voters and with dot sources out of range; keys and clients out of
    range; dot slots that wrap (seq 0 → slot D - 1)."""
    rng = np.random.default_rng(seed)
    D, C, P = dims.D, dims.C, dims.P
    K, PK, R, G = t.K, t.PK, t.R, t.G
    ri = lambda lo, hi, *s: rng.integers(lo, hi, (lanes, *s)).astype(np.int32)  # noqa: E731
    rb = lambda p, *s: rng.random((lanes, *s)) < p  # noqa: E731
    X = RTempo
    det = np.zeros((lanes, N, K, R, 2), np.int32)
    det[..., 0] = ri(1, 12, N, K, R) * rb(0.5, N, K, R)
    det[..., 1] = det[..., 0] + ri(0, 4, N, K, R)
    det[rb(0.15, N, K)] = [30, 31]                       # full rows
    det[..., 1] = np.where(det[..., 0] > 0, det[..., 1], 0)
    vf, vg = _gap_sets(rng, (lanes, N, K, N), G)
    cf, cg = _gap_sets(rng, (lanes, N, N), G)
    pend_clock = ri(1, 16, N, K, PK) * rb(0.6, N, K, PK)
    pend_clock[rb(0.2, N, K)] = 9                        # full rows
    ps = {
        "clocks": ri(0, 20, N, K),
        "det": det,
        "max_commit_clock": ri(0, 30, N),
        "seq_in_slot": ri(0, 9, N, N, D) * rb(0.6, N, N, D),
        "key_of": ri(0, K + 1, N, N, D),
        "client_of": ri(0, C + 1, N, N, D),
        "own_seq": ri(0, 9, N),
        "ack_cnt": ri(0, 4, N, D),
        "max_clock": ri(0, 20, N, D),
        "max_cnt": ri(0, 3, N, D),
        "slow_acks": ri(0, 3, N, D),
        "votes_n": ri(0, N + 1, N, D),
        "votes_by": ri(0, N, N, D, N),
        "votes_s": ri(0, 12, N, D, N),
        "votes_e": ri(0, 16, N, D, N),
        "vote_front": vf,
        "vote_gaps": vg,
        "pend_clock": pend_clock,
        "pend_src": ri(0, N, N, K, PK),
        "pend_seq": ri(0, 9, N, K, PK),
        "pend_client": ri(0, C + 1, N, K, PK),
        "comm_front": cf,
        "comm_gaps": cg,
        "others_frontier": ri(0, 8, N, N, N),
        "seen": rb(0.7, N, N),
        "prev_stable": ri(0, 4, N, N),
        "m_fast": ri(0, 9, N),
        "m_slow": ri(0, 9, N),
        "m_stable": ri(0, 9, N),
        "err": ri(0, 2, N) * 8,
    }
    rows = ri(0, 12, N, PPAY + P)
    rows[..., PSRC] = ri(0, N + C, N)                    # clients too
    mt = ri(0, X.NUM_TYPES + 2, N)
    rows[..., PMT] = mt
    pay = rows[..., PPAY:]
    pay[..., 0] = np.where(mt == X.SUBMIT, ri(0, C + 1, N), pay[..., 0])
    pay[..., 2] = np.where(mt == X.SUBMIT, ri(0, K + 1, N), pay[..., 2])
    # MCollect [seq, key, rclock, client, vs, ve]: half find a free slot
    src = rows[..., PSRC]
    sis = ps["seq_in_slot"]
    seq = ri(0, 9, N)
    occ = np.take_along_axis(
        np.take_along_axis(
            sis, np.minimum(src, N - 1)[..., None, None].repeat(D, -1),
            axis=2)[:, :, 0], ((seq - 1) % D)[..., None], axis=2)[..., 0]
    collect = mt == X.MCOLLECT
    pay[..., 0] = np.where(collect, seq, pay[..., 0])
    pay[..., 1] = np.where(collect, ri(0, K + 1, N), pay[..., 1])
    sis_src = np.where(collect & (src < N) & rb(0.6, N), 0, occ)
    li, pi = np.nonzero(collect & (src < N))
    sis[li, pi, src[li, pi], (seq[li, pi] - 1) % D] = sis_src[li, pi]
    # MCommit / MConsensus [dsrc, seq, ...]: most name a stored dot; some
    # MCommits name a source out of range with seq 0 (which reads 0)
    commit = (mt == X.MCOMMIT) | (mt == X.MCONSENSUS)
    dsrc = ri(0, N, N)
    slot = ri(0, D, N)
    stored = sis[np.arange(lanes)[:, None], np.arange(N)[None, :], dsrc,
                 slot]
    good = commit & rb(0.7, N) & (stored > 0)
    pay[..., 0] = np.where(commit, dsrc, pay[..., 0])
    pay[..., 1] = np.where(good, stored, np.where(commit, ri(0, 9, N),
                                                  pay[..., 1]))
    oob = (mt == X.MCOMMIT) & rb(0.2, N)
    pay[..., 0] = np.where(oob, ri(N, 2 * N, N) * np.where(
        rb(0.5, N), 1, -1), pay[..., 0])
    pay[..., 1] = np.where(oob, 0, pay[..., 1])
    # MCommit's votes: nv ranges (by, start, end), voters often repeated
    mc = mt == X.MCOMMIT
    pay[..., 3] = np.where(mc, ri(0, K + 1, N), pay[..., 3])
    pay[..., 5] = np.where(mc, ri(0, N + 2, N), pay[..., 5])
    by = ri(0, N, N, N)
    by[..., 1] = np.where(rb(0.4, N), by[..., 0], by[..., 1])
    for v in range(N):
        pay[..., 6 + 3 * v] = np.where(mc, by[..., v], pay[..., 6 + 3 * v])
        s0 = ri(0, 12, N)
        pay[..., 7 + 3 * v] = np.where(mc, s0, pay[..., 7 + 3 * v])
        pay[..., 8 + 3 * v] = np.where(mc, s0 + ri(-1, 4, N),
                                       pay[..., 8 + 3 * v])
    # MDetached [key, nr, (start, end) * per_msg]
    md = mt == X.MDETACHED
    per = t.detached_per_msg(dims)
    pay[..., 0] = np.where(md, ri(0, K + 1, N), pay[..., 0])
    pay[..., 1] = np.where(md, ri(0, per + 2, N), pay[..., 1])
    for i in range(per):
        s0 = ri(0, 14, N)
        pay[..., 2 + 2 * i] = np.where(md, s0, pay[..., 2 + 2 * i])
        pay[..., 3 + 2 * i] = np.where(md, s0 + ri(-1, 3, N),
                                       pay[..., 3 + 2 * i])
    for key_type in (X.MDRAIN,):
        pay[..., 0] = np.where(mt == key_type, ri(0, K + 1, N), pay[..., 0])
    rows[..., PPAY:] = pay

    fq = rb(0.6, N, N)
    ctx = {
        "n": ri(2, N + 1),
        "f": ri(1, 3),
        "fast_quorum": fq,
        "write_quorum": rb(0.6, N, N),
        "fq_size": ri(1, N + 1),
        "wq_size": ri(1, 4),
        "threshold": ri(1, 4),
        "clock_bump_mode": rb(0.5),
        "skip_fast_ack": rb(0.5),
        "client_attach": ri(0, N, C),
    }
    fire = rb(0.3, N, 3)
    ep = np.where(rb(0.1, N), ri(1 << 20, 1 << 30, N), ri(0, 40, N))
    return ps, rb(0.8, N), rows, fire, ctx, ep.astype(np.int32)


@pytest.mark.parametrize("seed, skip", [(0, False), (1, False), (2, True),
                                        (3, True)])
def test_tempo_handle_twin_matches_reference(seed, skip):
    t = TempoDev(**TEMPO_SIZES, skip_capable=skip)
    rt = RTempo(**TEMPO_SIZES, skip_capable=skip)
    kw = dict(n=N, clients=4, payload=t.payload_width(N), dot_slots=4)
    rdims = RDims.for_protocol(rt, **kw)
    dims = EngineDims.for_protocol(t, **kw)
    assert dims == EngineDims(**vars(rdims))
    ps, has, rows, fire, ctx, ep = _tempo_inputs(seed, dims, t)
    rdy, new_ps, _pout, hout = _run_handler_twin(
        tempo_handle, rt, rdims, dims, ps, has, rows, fire, ctx, ep,
        extra=(skip,),
    )
    X = RTempo
    handled = rdy & has
    mt = np.where(handled, rows[..., PMT], -1)
    assert set(range(X.NUM_TYPES)) <= set(mt.ravel().tolist())
    refused = np.where(has & ~rdy, rows[..., PMT], -1)
    assert {X.MCOLLECT, X.MCOMMIT, X.MCONSENSUS} <= set(refused.ravel().tolist())
    assert fire.any((0, 1)).all()
    pay = rows[..., PPAY:]
    grew = (new_ps["err"] & 16) > (ps["err"] & 16)       # ERR_CAPACITY
    assert (grew & (mt == X.MCOMMIT)).any()
    assert (grew & (mt == X.MDETACHED)).any()
    # a duplicate voter and an out-of-range source among handled commits
    mc = mt == X.MCOMMIT
    assert (mc & (pay[..., 6] == pay[..., 9]) & (pay[..., 5] > 1)).any()
    assert (mc & ((pay[..., 0] < 0) | (pay[..., 0] >= N))).any()
    # drains executed (slot 0 TO_CLIENT) and chained (slot 1 MDRAIN)
    drains = (mt == X.MCOMMIT) | (mt == X.MDETACHED) | (mt == X.MDRAIN)
    assert (drains & hout["valid"][..., 0]).any()
    assert (drains & hout["valid"][..., 1]).any()
    if skip:
        assert (mt == X.MCOLLECT)[hout["valid"].any(-1)
                                  & (hout["mtype"][..., 0] == X.MCOMMIT)
                                  ].any()


# ----------------------------------------------------------------------
# K9 graphdep_handle
# ----------------------------------------------------------------------

# small tables, so that inputs reach full ones: K keys, G gap slots per
# interval set (Q = N + 1 dep slots)
GRAPHDEP_SIZES = dict(keys=3, gap_slots=3)


def _graphdep_inputs(seed, dims, K, G, fp_mode, lanes=64):
    """Every message type handled somewhere, the gated ones (MCollect,
    MCommit) also refused; report tables with matching, free and full
    rows; a vertex store whose committed vertices depend on each other
    (chains and cycles), on executed dots, on cells that no longer hold
    the dep, and through sources out of range (negative ones count from
    the end, large ones clamp); MCommits naming stored, already
    committed and out-of-range dots; keys and clients out of range; dot
    slots that wrap (seq 0 → slot D - 1)."""
    rng = np.random.default_rng(seed)
    D, C = dims.D, dims.C
    Q = N + 1
    ri = lambda lo, hi, *s: rng.integers(lo, hi, (lanes, *s)).astype(np.int32)  # noqa: E731
    rb = lambda p, *s: rng.random((lanes, *s)) < p  # noqa: E731
    X = RAtlas
    qd_seq = ri(1, 6, N, D, Q) * rb(0.5, N, D, Q)
    qd_seq[rb(0.2, N, D)] = 5                            # full rows
    # the vertex store: a present cell holds a seq of its own slot
    vx_seq = (np.arange(D)[None, None, None, :] + 1
              + D * ri(0, 2, N, N, D)) * rb(0.7, N, N, D)
    committed = rb(0.6, N, N, D) & (vx_seq > 0)
    # deps: mostly a present vertex's (src, seq), some stale seqs, some
    # absent; sources sometimes shifted by -N (same cell) or clamped
    tsrc, tslot = ri(0, N, N, N, D, Q), ri(0, D, N, N, D, Q)
    li = np.arange(lanes)[:, None, None, None, None]
    pi = np.arange(N)[None, :, None, None, None]
    target = vx_seq[li, pi, tsrc, tslot]
    dep_seq = np.where(rb(0.8, N, N, D, Q), target, ri(1, 9, N, N, D, Q))
    dep_seq = dep_seq * rb(0.6, N, N, D, Q)
    dep_src = tsrc - N * rb(0.1, N, N, D, Q)
    dep_src = np.where(rb(0.05, N, N, D, Q), N + 2, dep_src)
    ef, eg = _gap_sets(rng, (lanes, N, N), G, lo_max=4)
    cf, cg = _gap_sets(rng, (lanes, N, N), G)
    ps = {
        "latest_src": ri(0, N, N, K),
        "latest_seq": ri(0, 9, N, K),
        "seq_in_slot": ri(0, 9, N, N, D) * rb(0.6, N, N, D),
        "key_of": ri(0, K + 1, N, N, D),
        "client_of": ri(0, C + 1, N, N, D),
        "own_seq": ri(0, 9, N),
        "ack_cnt": ri(0, 4, N, D),
        "qd_src": ri(0, N, N, D, Q),
        "qd_seq": qd_seq,
        "qd_cnt": ri(1, 4, N, D, Q) * (qd_seq > 0),
        "slow_acks": ri(0, 3, N, D),
        "vx_committed": committed,
        "vx_seq": vx_seq.astype(np.int32),
        "vx_key": ri(0, K + 1, N, N, D),
        "vx_client": ri(0, C + 1, N, N, D),
        "vx_nd": ri(0, Q + 1, N, N, D),
        "vx_dep_src": dep_src.astype(np.int32),
        "vx_dep_seq": dep_seq.astype(np.int32),
        "exec_front": ef,
        "exec_gaps": eg,
        "comm_front": cf,
        "comm_gaps": cg,
        "others_frontier": ri(0, 8, N, N, N),
        "seen": rb(0.7, N, N),
        "prev_stable": ri(0, 4, N, N),
        "m_fast": ri(0, 9, N),
        "m_slow": ri(0, 9, N),
        "m_stable": ri(0, 9, N),
        "err": ri(0, 2, N) * 8,
    }
    rows = ri(0, 9, N, PPAY + dims.P)
    rows[..., PSRC] = ri(0, N + C, N)                    # clients too
    mt = ri(0, X.NUM_TYPES + 2, N)
    rows[..., PMT] = mt
    pay = rows[..., PPAY:]
    src = rows[..., PSRC]
    lp = (np.arange(lanes)[:, None], np.arange(N)[None, :])
    pay[..., 0] = np.where(mt == X.SUBMIT, ri(0, C + 1, N), pay[..., 0])
    pay[..., 2] = np.where(mt == X.SUBMIT, ri(0, K + 1, N), pay[..., 2])
    # MCollect [seq, key, client, cdsrc, cdseq]: half find a free slot
    collect = mt == X.MCOLLECT
    seq = ri(0, 9, N)
    pay[..., 0] = np.where(collect, seq, pay[..., 0])
    pay[..., 1] = np.where(collect, ri(0, K + 1, N), pay[..., 1])
    free = collect & (src < N) & rb(0.6, N)
    li, pj = np.nonzero(free)
    cs = (seq[li, pj] - 1) % D
    ps["seq_in_slot"][li, pj, src[li, pj], cs] = 0
    ps["vx_seq"][li, pj, src[li, pj], cs] = 0
    ps["vx_committed"][li, pj, src[li, pj], cs] = False
    # MCollectAck [seq, d1src, d1seq, d2src, d2seq]: reports that match
    # an entry of the dot's row, new ones, and absent ones (seq 0)
    ack = mt == X.MCOLLECTACK
    aslot = ri(0, D, N)
    q = ri(0, Q, N)
    for w in (1, 3):
        hit = rb(0.5, N)
        old_src = ps["qd_src"][lp[0], lp[1], aslot, q]
        old_seq = ps["qd_seq"][lp[0], lp[1], aslot, q]
        pay[..., w] = np.where(ack, np.where(hit, old_src, ri(0, N, N)),
                               pay[..., w])
        pay[..., w + 1] = np.where(ack, np.where(hit, old_seq, ri(0, 6, N)),
                                   pay[..., w + 1])
    pay[..., 0] = np.where(ack, aslot + 1 + D * ri(0, 2, N), pay[..., 0])
    # MCommit [dsrc, seq, key, client, nd, (src, seq) * Q]: most name a
    # stored dot, some one already in the vertex store, some a source out
    # of range with seq 0 (which reads 0)
    mc = mt == X.MCOMMIT
    dsrc, slot = ri(0, N, N), ri(0, D, N)
    stored = ps["seq_in_slot"][lp[0], lp[1], dsrc, slot]
    good = mc & rb(0.8, N) & (stored > 0)
    pay[..., 0] = np.where(mc, dsrc, pay[..., 0])
    pay[..., 1] = np.where(good, stored, np.where(mc, ri(0, 9, N),
                                                  pay[..., 1]))
    li, pj = np.nonzero(good & rb(0.2, N))
    ps["vx_seq"][li, pj, dsrc[li, pj], slot[li, pj]] = stored[li, pj]
    oob = mc & rb(0.15, N)
    pay[..., 0] = np.where(oob, ri(N, 2 * N, N) * np.where(
        rb(0.5, N), 1, -1), pay[..., 0])
    pay[..., 1] = np.where(oob, 0, pay[..., 1])
    pay[..., 2] = np.where(mc, ri(0, K + 1, N), pay[..., 2])
    pay[..., 4] = np.where(mc, ri(0, Q + 2, N), pay[..., 4])
    for j in range(Q):
        tsrc = ri(0, N, N)
        tgt = ps["vx_seq"][lp[0], lp[1], tsrc, ri(0, D, N)]
        pay[..., 5 + 2 * j] = np.where(mc, tsrc, pay[..., 5 + 2 * j])
        pay[..., 6 + 2 * j] = np.where(mc, tgt * rb(0.7, N),
                                       pay[..., 6 + 2 * j])
    rows[..., PPAY:] = pay

    ctx = {
        "n": ri(2, N + 1),
        "f": ri(1, 3),
        "fast_quorum": rb(0.6, N, N),
        "write_quorum": rb(0.6, N, N),
        "expected_acks": ri(1, 4),
        "fp_mode": np.full((lanes,), fp_mode, np.int32),
        "ack_self": rb(0.5),
        "client_attach": ri(0, N, C),
    }
    return ps, rb(0.85, N), rows, rb(0.3, N, 1), ctx


@pytest.mark.parametrize("seed, fp_mode", [(0, 0), (1, 0), (2, 1), (3, 1)])
def test_graphdep_handle_twin_matches_reference(seed, fp_mode):
    t = AtlasDev(**GRAPHDEP_SIZES)
    rt = RAtlas(**GRAPHDEP_SIZES)
    kw = dict(n=N, clients=4, payload=t.payload_width(N), dot_slots=4)
    rdims = RDims.for_protocol(rt, **kw)
    dims = EngineDims.for_protocol(t, **kw)
    assert dims == EngineDims(**vars(rdims))
    ps, has, rows, fire, ctx = _graphdep_inputs(seed, dims, t.K, t.G,
                                                fp_mode)
    rdy, new_ps, _pout, hout = _run_handler_twin(
        graphdep_handle, rt, rdims, dims, ps, has, rows, fire, ctx,
    )
    X = RAtlas
    F = dims.F
    mt = np.where(rdy & has, rows[..., PMT], -1)
    assert set(range(X.NUM_TYPES)) <= set(mt.ravel().tolist())
    refused = np.where(has & ~rdy, rows[..., PMT], -1)
    assert {X.MCOLLECT, X.MCOMMIT} <= set(refused.ravel().tolist())
    assert fire.any()
    grew = (new_ps["err"] & 16) > (ps["err"] & 16)       # ERR_CAPACITY
    assert (grew & (mt == X.MCOLLECTACK)).any()
    # both paths of the fast-path predicate, and the kept consensus rows
    done = mt == X.MCOLLECTACK
    assert (done & (new_ps["m_fast"] > ps["m_fast"])).any()
    assert (done & (new_ps["m_slow"] > ps["m_slow"])).any()
    assert (done & (hout["mtype"][..., 0] == X.MCONSENSUS)
            & ~hout["valid"].any(-1)).any()
    # drains executed (TO_CLIENT) and chained (MDRAIN), some through a
    # cycle (no ready vertex), and a disabled drain's pick elsewhere
    drains = (mt == X.MCOMMIT) | (mt == X.MDRAIN)
    assert (drains & hout["valid"][..., F - 2]).any()
    assert (drains & hout["valid"][..., F - 1]).any()
    assert (~drains & (hout["dst"][..., F - 2] != N)).any()
    executed = (new_ps["exec_front"] != ps["exec_front"]).any(-1)
    assert (drains & executed).any()


# ----------------------------------------------------------------------
# K10 caesar_handle
# ----------------------------------------------------------------------

CAESAR_SIZES = dict(keys=3, key_slots=4, dep_slots=6, blocker_slots=3,
                    gap_slots=3, exec_buffer=4)
_CAESAR_REF = {}


def _caesar_inputs(seed, dims, t, wait, lanes=96):
    """Every message type handled somewhere, the gated ones (MPropose,
    MCommit, MRetry, MGC) also refused; both timer rows firing, with
    executed dots buffered and GC buffers fuller than one message; key
    rows with free slots, duplicate and full ones; dots that wait on
    blockers that are safe (with this dot in their deps or not), unsafe,
    freed (a stale sequence) and absent; committed dots whose deps are
    live, executed, dead, lower and higher in clock order, through
    sources out of range (negative ones count from the end, large ones
    clamp); acks that fill, dedup against and overflow the union rows;
    self-deps in MCommit; MGC sightings that reach n and free the dot;
    keys and clients out of range; dot slots that wrap."""
    from fantoch_tpu_torch.engine.protocols.caesar import (
        ST_ACCEPT, ST_COMMIT, ST_EXECUTED, ST_PROPOSE_END, ST_REJECT,
    )

    rng = np.random.default_rng(seed)
    D, C, P = dims.D, dims.C, dims.P
    K, S, DEP, BB, G, EB = t.K, t.S, t.DEP, t.BB, t.G, t.EB
    ri = lambda lo, hi, *s: rng.integers(lo, hi, (lanes, *s)).astype(np.int32)  # noqa: E731
    rb = lambda p, *s: rng.random((lanes, *s)) < p  # noqa: E731
    X = RCaesar
    li = np.arange(lanes)[:, None, None, None]
    pi = np.arange(N)[None, :, None, None]
    # dots: a present cell holds a sequence of its own slot
    pseq = ((np.arange(D)[None, None, None, :] + 1 + D * ri(0, 2, N, N, D))
            * rb(0.75, N, N, D)).astype(np.int32)
    statuses = np.array([0, ST_PROPOSE_END, ST_REJECT, ST_ACCEPT, ST_COMMIT,
                         ST_EXECUTED], np.int32)
    status = statuses[rng.choice(6, (lanes, N, N, D),
                                 p=[0.1, 0.25, 0.1, 0.15, 0.3, 0.1])]
    status = np.where(pseq > 0, status, 0).astype(np.int32)

    def refs(shape, p_live=0.7):
        """(src, seq) pairs naming present dots, stale sequences, absent
        entries and sources shifted by -N or out of range."""
        tsrc, tslot = ri(0, N, *shape), ri(0, D, *shape)
        idx = (li.reshape((lanes,) + (1,) * len(shape)),
               pi.reshape((1, N) + (1,) * (len(shape) - 1)))
        target = pseq[idx[0], idx[1], tsrc, tslot] if len(shape) > 1 else None
        seq = np.where(rb(p_live, *shape), target, ri(1, 9, *shape))
        seq = seq * rb(0.8, *shape)
        src = tsrc - N * rb(0.1, *shape)
        src = np.where(rb(0.05, *shape), N + 2, src)
        return src.astype(np.int32), seq.astype(np.int32)

    dep_src, dep_seq = refs((N, N, D, DEP))
    bb_src, bb_seq = refs((N, N, D, BB), p_live=0.8)
    bb_src = np.where(bb_src < 0, bb_src + N, bb_src) % (N + 3)
    # a blocker lists the blocked dot in its deps for about half of them
    ls, ps_, ss, ds, bs = np.nonzero(rb(0.5, N, N, D, BB) & (bb_seq > 0))
    bsrc = np.clip(bb_src[ls, ps_, ss, ds, bs], 0, N - 1)
    bslot = (bb_seq[ls, ps_, ss, ds, bs] - 1) % D
    j = rng.integers(0, DEP, ls.shape)
    dep_src[ls, ps_, bsrc, bslot, j] = ss
    dep_seq[ls, ps_, bsrc, bslot, j] = pseq[ls, ps_, ss, ds]
    # clock-table rows: registrations with distinct-ish clocks, free slots
    kc_cseq = ri(1, 7, N, K, S) * rb(0.7, N, K, S)
    kc_cseq[rb(0.15, N, K)] = 5                      # full rows
    ef, eg = _gap_sets(rng, (lanes, N, N), G, lo_max=4)
    ag_seq = ri(1, 6, N, D, DEP) * rb(0.5, N, D, DEP)
    ag_seq[rb(0.2, N, D)] = 4                        # full rows
    ps = {
        "kc_src": ri(0, N, N, K, S),
        "kc_seq": ri(1, 9, N, K, S),
        "kc_cseq": kc_cseq.astype(np.int32),
        "kc_cpid": ri(0, N + 1, N, K, S),
        "clk_counter": ri(0, 8, N),
        "pseq": pseq,
        "status": status,
        "key_of": ri(0, K + 1, N, N, D),
        "client_of": ri(0, C + 1, N, N, D),
        "clk_seq": ri(0, 7, N, N, D),
        "clk_pid": ri(0, N + 1, N, N, D),
        "dep_src": dep_src,
        "dep_seq": dep_seq,
        "bb_src": bb_src.astype(np.int32),
        "bb_seq": bb_seq,
        "own_seq": ri(0, 8, N),
        "qa_cnt": ri(0, 4, N, D),
        "qa_ok": rb(0.7, N, D),
        "qa_done": rb(0.2, N, D),
        "qa_cseq": ri(0, 6, N, D),
        "qa_cpid": ri(0, N + 1, N, D),
        "ag_src": ri(0, N, N, D, DEP),
        "ag_seq": ag_seq.astype(np.int32),
        "qr_cnt": ri(0, 3, N, D),
        "ex_front": ef,
        "ex_gaps": eg,
        "eb_src": ri(0, N, N, EB),
        "eb_seq": ri(0, 9, N, EB),
        "eb_n": ri(0, EB + 1, N),
        "gb_src": ri(0, N, N, EB),
        "gb_seq": ri(1, 9, N, EB),
        "gb_n": ri(0, EB + 1, N),
        "gb_gc": ri(0, EB + 2, N),
        "gc_cnt": ri(0, N, N, N, D),
        "m_fast": ri(0, 9, N),
        "m_slow": ri(0, 9, N),
        "m_stable": ri(0, 9, N),
        "err": ri(0, 2, N) * 8,
    }
    # the executed buffer names present dots, so notifications free some
    es, esl = ri(0, N, N, EB), ri(0, D, N, EB)
    lp2 = (np.arange(lanes)[:, None, None], np.arange(N)[None, :, None])
    ps["eb_src"], ps["eb_seq"] = es, pseq[lp2[0], lp2[1], es, esl]

    rows = ri(0, 9, N, PPAY + P)
    rows[..., PSRC] = ri(0, N + C, N)                    # clients too
    mt = ri(0, X.NUM_TYPES + 2, N)
    rows[..., PMT] = mt
    pay = rows[..., PPAY:]
    src = rows[..., PSRC]
    lp = (np.arange(lanes)[:, None], np.arange(N)[None, :])
    me = np.broadcast_to(np.arange(N), (lanes, N))

    def pairs(at, nd_max, base_src, base_seq, kind):
        """Dep pairs from word ``at``: present dots, a few repeats."""
        for q in range(DEP + 1):
            s_, q_ = ri(0, N, N), ri(0, 9, N)
            hit = rb(0.5, N)
            w = at + 2 * q
            if w + 1 < P:
                pay[..., w] = np.where(kind, np.where(hit, base_src, s_),
                                       pay[..., w])
                pay[..., w + 1] = np.where(kind, np.where(hit, base_seq, q_),
                                           pay[..., w + 1])

    sub = mt == X.SUBMIT
    pay[..., 0] = np.where(sub, ri(0, C + 1, N), pay[..., 0])
    pay[..., 2] = np.where(sub, ri(0, K + 1, N), pay[..., 2])
    # MPropose [seq, key, client, cseq]: half find a free slot
    prop = mt == X.MPROPOSE
    seq = ri(1, 9, N)
    pay[..., 0] = np.where(prop, seq, pay[..., 0])
    pay[..., 1] = np.where(prop, ri(0, K + 1, N), pay[..., 1])
    pay[..., 3] = np.where(prop, ri(0, 7, N), pay[..., 3])
    free = prop & (src < N) & rb(0.6, N)
    fl, fp = np.nonzero(free)
    ps["pseq"][fl, fp, src[fl, fp], (seq[fl, fp] - 1) % D] = 0
    # MProposeAck [seq, cseq, cpid, ok, nd, pairs]: live dots of mine
    ack = mt == X.MPROPOSEACK
    aslot = ri(0, D, N)
    ps["status"][lp[0], lp[1], me, aslot] = np.where(
        ack & rb(0.8, N), np.where(rb(0.5, N), ST_PROPOSE_END, ST_REJECT),
        ps["status"][lp[0], lp[1], me, aslot])
    pay[..., 0] = np.where(ack, aslot + 1 + D * ri(0, 2, N), pay[..., 0])
    pay[..., 3] = np.where(ack, rb(0.7, N), pay[..., 3])
    # half of them are the quorum's last ack
    fq_size = ri(1, 5)
    last = ack & rb(0.5, N)
    ps["qa_cnt"][lp[0], lp[1], aslot] = np.where(
        last, fq_size[:, None] - 1, ps["qa_cnt"][lp[0], lp[1], aslot])
    pay[..., 4] = np.where(ack, ri(0, DEP + 2, N), pay[..., 4])
    q = ri(0, DEP, N)
    pairs(5, DEP, ps["ag_src"][lp[0], lp[1], aslot, q],
          ps["ag_seq"][lp[0], lp[1], aslot, q], ack)
    # MCommit / MRetry [dsrc, seq, cseq, cpid, nd, pairs]: stored dots,
    # some self-deps, some already committed, some sources out of range
    cr = (mt == X.MCOMMIT) | (mt == X.MRETRY)
    dsrc, cslot = ri(0, N, N), ri(0, D, N)
    stored = ps["pseq"][lp[0], lp[1], dsrc, cslot]
    good = cr & rb(0.8, N) & (stored > 0)
    pay[..., 0] = np.where(cr, dsrc, pay[..., 0])
    pay[..., 1] = np.where(good, stored, np.where(cr, ri(0, 9, N),
                                                  pay[..., 1]))
    oob = cr & rb(0.1, N)
    pay[..., 0] = np.where(oob, ri(N, 2 * N, N) * np.where(
        rb(0.5, N), 1, -1), pay[..., 0])
    pay[..., 1] = np.where(oob, 0, pay[..., 1])
    pay[..., 2] = np.where(cr, ri(0, 7, N), pay[..., 2])
    pay[..., 3] = np.where(cr, ri(0, N + 1, N), pay[..., 3])
    pay[..., 4] = np.where(cr, ri(0, DEP + 2, N), pay[..., 4])
    pairs(5, DEP, pay[..., 0].copy(), pay[..., 1].copy(), cr)
    # MRetryAck [dsrc, seq, nd, pairs]: my accepted dots
    ra = mt == X.MRETRYACK
    rslot = ri(0, D, N)
    ps["status"][lp[0], lp[1], me, rslot] = np.where(
        ra & rb(0.8, N), ST_ACCEPT, ps["status"][lp[0], lp[1], me, rslot])
    pay[..., 1] = np.where(ra, rslot + 1 + D * ri(0, 2, N), pay[..., 1])
    pay[..., 2] = np.where(ra, ri(0, DEP + 2, N), pay[..., 2])
    q = ri(0, DEP, N)
    pairs(3, DEP, ps["ag_src"][lp[0], lp[1], rslot, q],
          ps["ag_seq"][lp[0], lp[1], rslot, q], ra)
    # MGC [nd, (src, seq)...]: sightings of present dots, most ready
    gc = mt == X.MGC
    dpm = (P - 1) // 2
    pay[..., 0] = np.where(gc, ri(0, dpm + 2, N), pay[..., 0])
    ok_gc = gc & rb(0.7, N)
    for i in range(dpm):
        gs, gsl = ri(0, N, N), ri(0, D, N)
        pay[..., 1 + 2 * i] = np.where(gc, gs, pay[..., 1 + 2 * i])
        pay[..., 2 + 2 * i] = np.where(
            ok_gc, ps["pseq"][lp[0], lp[1], gs, gsl],
            np.where(gc, ri(0, 9, N), pay[..., 2 + 2 * i]))
    rows[..., PPAY:] = pay
    ctx = {
        "n": ri(2, N + 1),
        "fq_size": fq_size,
        "wq_size": ri(1, 4),
        "wait_condition": np.full((lanes,), wait, bool),
        "client_attach": ri(0, N, C),
    }
    return ps, rb(0.85, N), rows, rb(0.3, N, 2), ctx


@pytest.mark.parametrize("seed, wait", [(0, True), (1, True), (2, False),
                                        (3, False)])
def test_caesar_handle_twin_matches_reference(seed, wait):
    """The twin of K10 against the reference's vmapped ``ready``,
    ``periodic`` and ``handle`` (one jit for every case)."""
    from fantoch_tpu_torch.engine.protocols import CaesarDev
    from fantoch_tpu_torch.kernels import caesar_handle

    t = CaesarDev(**CAESAR_SIZES)
    rt = RCaesar(**CAESAR_SIZES)
    kw = dict(n=N, clients=4, payload=t.payload_width(N), dot_slots=4)
    rdims = RDims.for_protocol(rt, **kw)
    dims = EngineDims.for_protocol(t, **kw)
    assert dims == EngineDims(**vars(rdims))
    assert t.gc_per_msg(dims) > t.EB      # the GC drain's clamped gather
    ps, has, rows, fire, ctx = _caesar_inputs(seed, dims, t, wait)
    if "fn" not in _CAESAR_REF:
        _CAESAR_REF["fn"] = jax.jit(jax.vmap(
            lambda *a: _ref_handler_lane(rt, rdims, *a)))
    want = jax.tree_util.tree_map(
        np.asarray, _CAESAR_REF["fn"](ps, has, rows, fire, ctx))
    before = caesar_handle.launches
    got = caesar_handle(
        carry.to_torch(ps, "cpu"), torch.from_numpy(has),
        torch.from_numpy(rows), torch.from_numpy(fire),
        carry.to_torch(ctx, "cpu"), dims,
    )
    assert caesar_handle.launches == before  # the twin, not the kernel
    _assert_equal(got[0].numpy(), want[0], "rdy")
    for name, g, w in zip(("ps", "periodic", "handler"), got[1:], want[1:]):
        assert sorted(g) == sorted(w), name
        for k in w:
            _assert_equal(g[k].numpy(), w[k], f"{name}/{k}")

    rdy, new_ps, pout, hout = want
    X = RCaesar
    F = dims.F
    mt = np.where(rdy & has, rows[..., PMT], -1)
    assert set(range(X.NUM_TYPES)) <= set(mt.ravel().tolist())
    refused = np.where(has & ~rdy, rows[..., PMT], -1)
    assert {X.MPROPOSE, X.MCOMMIT, X.MRETRY, X.MGC} <= set(
        refused.ravel().tolist())
    assert fire[..., 0].any() and fire[..., 1].any()
    # both timers' work: a GC round kicked, buffered dots moved and freed
    assert pout["valid"][..., 0].any()
    assert (fire[..., 1] & (new_ps["m_stable"] > ps["m_stable"])).any()
    # MPropose decided both ways and left some waiting
    prop = mt == X.MPROPOSE
    accepted = hout["valid"][..., 0] & (hout["payload"][..., 0, 3] == 1)
    rejected = hout["valid"][..., 0] & (hout["payload"][..., 0, 3] == 0)
    assert (prop & accepted).any() and (prop & rejected).any()
    assert (prop & ~hout["valid"][..., 0]).any() == wait
    # the wait scan replied both ways and chained; the exec scan executed
    # and chained; both wrote their slots where disabled too
    wait_ack = hout["valid"][..., F - 2]
    assert (wait_ack & (hout["payload"][..., F - 2, 3] == 1)).any()
    assert (wait_ack & (hout["payload"][..., F - 2, 3] == 0)).any()
    assert hout["valid"][..., F - 1].any() and hout["valid"][..., F - 3].any()
    assert (~wait_ack).any()
    assert (hout["mtype"][..., F - 2] == X.MPROPOSEACK).all()
    assert (hout["mtype"][..., F - 3] == X.EXEC_DRAIN).all()
    # fast and slow decisions, MRetry broadcasts and union overflows
    done = mt == X.MPROPOSEACK
    assert (done & (new_ps["m_fast"] > ps["m_fast"])).any()
    assert (done & (new_ps["m_slow"] > ps["m_slow"])).any()
    assert (done & hout["valid"].any(-1)
            & (hout["mtype"][..., 0] == X.MRETRY)).any()
    grew = (new_ps["err"] & 16) > (ps["err"] & 16)       # ERR_CAPACITY
    assert (grew & (mt == X.MPROPOSEACK)).any()


# ----------------------------------------------------------------------
# K11 tempo_partial_handle
# ----------------------------------------------------------------------

# two shards of three rows (N = 6); small tables, so that inputs reach
# full ones: K keys, PK pending slots, R detached slots, G gap slots
PARTIAL_SIZES = dict(keys=4, shards=2, keys_per_cmd=2, pending_per_key=4,
                     detached_slots=4, gap_slots=3)
PARTIAL_N, PARTIAL_T1 = 3, 5
_PARTIAL_REF = {}


def _tempo_partial_inputs(seed, dims, t, lanes=96):
    """Every message type handled somewhere, the gated ones (MCollect,
    MCommit, MConsensus, MShardAgg, MShardCommit) also refused; all
    three timer rows firing at real event times (some past the micros
    saturation point); lanes with n = 2 and n = 3 rows per shard (pad
    rows carry shard id S); occupied and full gap, pending and detached
    tables; parked queue heads that a StableAtShard matches, and
    buffered counts; single- and multi-shard commands with one or two
    local keys (-1 pads), keys out of range; MCommits with duplicate
    voters and with dot sources out of range; clients and command
    sequences out of range of the tables; dot slots that wrap."""
    rng = np.random.default_rng(seed)
    Np, D, C, P = dims.N, dims.D, dims.C, dims.P
    K, PK, R, G, S, KPC = t.K, t.PK, t.R, t.G, t.S, t.KPC
    T1 = PARTIAL_T1
    ri = lambda lo, hi, *s: rng.integers(lo, hi, (lanes, *s)).astype(np.int32)  # noqa: E731
    rb = lambda p, *s: rng.random((lanes, *s)) < p  # noqa: E731
    X = RTempoPartial
    n = np.where(rb(0.3), 2, PARTIAL_N).astype(np.int32)
    rows_ = np.arange(Np)[None, :]
    shard_of = np.where(rows_ < S * n[:, None], rows_ // n[:, None],
                        S).astype(np.int32)
    closest = np.zeros((lanes, Np, S), np.int32)
    for s in range(S):
        closest[..., s] = s * n[:, None] + ri(0, 1, Np) + np.minimum(
            ri(0, 2, Np), n[:, None] - 1)
    det = np.zeros((lanes, Np, K, R, 2), np.int32)
    det[..., 0] = ri(1, 12, Np, K, R) * rb(0.5, Np, K, R)
    det[..., 1] = det[..., 0] + ri(0, 4, Np, K, R)
    det[rb(0.15, Np, K)] = [30, 31]                      # full rows
    det[..., 1] = np.where(det[..., 0] > 0, det[..., 1], 0)
    vf, vg = _gap_sets(rng, (lanes, Np, K, Np), G, lo_max=12)
    cf, cg = _gap_sets(rng, (lanes, Np, Np), G)
    pend_clock = ri(1, 14, Np, K, PK) * rb(0.7, Np, K, PK)
    pend_clock[rb(0.2, Np, K)] = 9                       # full rows
    phase = np.where(pend_clock > 0, ri(1, 3, Np, K, PK), 0)
    phase = np.where(rb(0.05, Np, K, PK), 2, phase)      # parked, clock 0
    cmd_skey = ri(-1, K + 1, C, T1, S, KPC)
    cmd_skey[..., 1] = np.where(rb(0.3, C, T1, S), -1, cmd_skey[..., 1])
    ps = {
        "clocks": ri(0, 20, Np, K),
        "det": det,
        "max_commit_clock": ri(0, 30, Np),
        "seq_in_slot": ri(0, 9, Np, Np, D) * rb(0.6, Np, Np, D),
        "client_of": ri(0, C + 1, Np, Np, D),
        "cseq_of": ri(0, T1 + 2, Np, Np, D),
        "own_seq": ri(0, 9, Np),
        "ack_cnt": ri(0, 4, Np, Np, D),
        "max_clock": ri(0, 20, Np, Np, D),
        "max_cnt": ri(0, 3, Np, Np, D),
        "slow_acks": ri(0, 3, Np, Np, D),
        "votes_n": ri(0, Np + 1, Np, Np, D),
        "votes_by": ri(0, Np, Np, Np, D, Np),
        "votes_s": ri(0, 12, Np, Np, D, KPC, Np),
        "votes_e": ri(0, 16, Np, Np, D, KPC, Np),
        "shag_cnt": ri(0, 2, Np, D),
        "shag_max": ri(0, 20, Np, D),
        "mbump_buf": ri(0, 20, Np, Np, D) * rb(0.3, Np, Np, D),
        "vote_front": vf,
        "vote_gaps": vg,
        "pend_clock": pend_clock,
        "pend_src": ri(0, Np, Np, K, PK),
        "pend_seq": ri(0, 9, Np, K, PK),
        "pend_client": ri(0, C + 1, Np, K, PK),
        "pend_cseq": ri(0, T1 + 1, Np, K, PK),
        "pend_kmask": ri(1, 4, Np, K, PK),
        "pend_missing": ri(0, 4, Np, K, PK),
        "pend_phase": phase.astype(np.int32),
        "stable_cnt": ri(0, 3, Np, C),
        "stable_cnt_seq": ri(0, T1 + 1, Np, C),
        "buf_cnt": ri(0, 3, Np, K, C),
        "buf_seq": ri(0, T1 + 1, Np, K, C),
        "comm_front": cf,
        "comm_gaps": cg,
        "others_frontier": ri(0, 8, Np, Np, Np),
        "seen": rb(0.7, Np, Np),
        "prev_stable": ri(0, 4, Np, Np),
        "m_fast": ri(0, 9, Np),
        "m_slow": ri(0, 9, Np),
        "m_stable": ri(0, 9, Np),
        "err": ri(0, 2, Np) * 8,
    }
    rows = ri(0, 8, Np, PPAY + P)
    rows[..., PSRC] = ri(0, Np + C, Np)                  # clients too
    mt = ri(0, X.NUM_TYPES + 2, Np)
    rows[..., PMT] = mt
    pay = rows[..., PPAY:]
    me = np.broadcast_to(np.arange(Np)[None, :], (lanes, Np))
    # dots: (dsrc, seq) words; gated types mostly name a stored dot, an
    # MCollect half the time a free slot
    dsrc, slot = ri(0, Np, Np), ri(0, D, Np)
    li = np.arange(lanes)[:, None]
    stored = ps["seq_in_slot"][li, me, dsrc, slot]
    dotted = np.isin(mt, [X.MCOLLECT, X.MCOLLECTACK, X.MCOMMIT,
                          X.MCONSENSUS, X.MCONSENSUSACK, X.MBUMP,
                          X.MSHARDCOMMIT, X.MSHARDAGG, X.MFWDSUBMIT])
    dsrc = np.where(mt == X.MSHARDCOMMIT,
                    np.where(rb(0.8, Np), me, dsrc), dsrc)
    stored = ps["seq_in_slot"][li, me, dsrc, slot]
    good = rb(0.7, Np) & (stored > 0)
    seq = np.where(good, stored, ri(0, 9, Np))
    free = (mt == X.MCOLLECT) & rb(0.5, Np)
    ps["seq_in_slot"][li, me, dsrc, (seq - 1) % D] = np.where(
        free, 0, ps["seq_in_slot"][li, me, dsrc, (seq - 1) % D])
    pay[..., 0] = np.where(dotted, dsrc, pay[..., 0])
    pay[..., 1] = np.where(dotted, seq, pay[..., 1])
    # SUBMIT [client, cseq]; MFwdSubmit/MCollect [.., client, cseq, clk]
    sub = mt == X.SUBMIT
    pay[..., 0] = np.where(sub, ri(0, C + 1, Np), pay[..., 0])
    pay[..., 1] = np.where(sub, ri(0, T1 + 2, Np), pay[..., 1])
    fwd = (mt == X.MCOLLECT) | (mt == X.MFWDSUBMIT)
    pay[..., 2] = np.where(fwd, ri(0, C + 1, Np), pay[..., 2])
    pay[..., 3] = np.where(fwd, ri(0, T1 + 2, Np), pay[..., 3])
    rows[..., PSRC] = np.where(mt == X.MCOLLECT,
                               np.where(rb(0.3, Np), me, ri(0, Np, Np)),
                               rows[..., PSRC])
    # MCollectAck [dsrc, seq, clock, (vs, ve) per key]: some vote nothing
    ack = mt == X.MCOLLECTACK
    for k in range(KPC):
        vs = ri(0, 12, Np) * rb(0.6, Np)
        pay[..., 3 + 2 * k] = np.where(ack, vs, pay[..., 3 + 2 * k])
        pay[..., 4 + 2 * k] = np.where(ack, vs + ri(0, 4, Np),
                                       pay[..., 4 + 2 * k])
    # MCommit [dsrc, seq, clock, client, cseq, nv, by * N, (s, e) per
    # (key, voter)]: voters often repeated; some sources out of range
    mc = mt == X.MCOMMIT
    pay[..., 3] = np.where(mc, ri(0, C + 1, Np), pay[..., 3])
    pay[..., 4] = np.where(mc, ri(0, T1 + 1, Np), pay[..., 4])
    pay[..., 5] = np.where(mc, ri(0, Np + 2, Np), pay[..., 5])
    by = ri(0, Np, Np, Np)
    by[..., 1] = np.where(rb(0.4, Np), by[..., 0], by[..., 1])
    pay[..., 6:6 + Np] = np.where(mc[..., None], by, pay[..., 6:6 + Np])
    for j in range(KPC * Np):
        s0 = ri(0, 12, Np)
        lo = 6 + Np + 2 * j
        pay[..., lo] = np.where(mc, s0, pay[..., lo])
        pay[..., lo + 1] = np.where(mc, s0 + ri(-1, 4, Np), pay[..., lo + 1])
    oob = mc & rb(0.15, Np)
    pay[..., 0] = np.where(oob, ri(Np, 2 * Np, Np) * np.where(
        rb(0.5, Np), 1, -1), pay[..., 0])
    pay[..., 1] = np.where(oob, 0, pay[..., 1])
    # MDetached [key, nr, (start, end) * per_msg]
    md = mt == X.MDETACHED
    per = t.detached_per_msg(dims)
    pay[..., 0] = np.where(md, ri(0, K + 1, Np), pay[..., 0])
    pay[..., 1] = np.where(md, ri(0, per + 2, Np), pay[..., 1])
    for i in range(per):
        s0 = ri(0, 14, Np)
        pay[..., 2 + 2 * i] = np.where(md, s0, pay[..., 2 + 2 * i])
        pay[..., 3 + 2 * i] = np.where(md, s0 + ri(-1, 3, Np),
                                       pay[..., 3 + 2 * i])
    pay[..., 0] = np.where(mt == X.MDRAIN, ri(-1, K + 1, Np), pay[..., 0])
    # StableAtShard [key, client, cseq]: most name a parked head
    sa = mt == X.STABLEAT
    key = ri(0, K + 1, Np)
    kk = np.minimum(key, K - 1)
    j = ri(0, PK, Np)
    head_client = ps["pend_client"][li, me, kk, j]
    head_cseq = ps["pend_cseq"][li, me, kk, j]
    match = rb(0.6, Np)
    pay[..., 0] = np.where(sa, key, pay[..., 0])
    pay[..., 1] = np.where(sa, np.where(match, head_client, ri(0, C + 1, Np)),
                           pay[..., 1])
    pay[..., 2] = np.where(sa, np.where(match, head_cseq,
                                        ri(0, T1 + 1, Np)), pay[..., 2])
    rows[..., PPAY:] = pay

    ctx = {
        "n": n,
        "f": ri(1, 3),
        "fast_quorum": rb(0.6, Np, Np),
        "write_quorum": rb(0.6, Np, Np),
        "fq_size": ri(1, 4),
        "wq_size": ri(1, 3),
        "threshold": ri(1, 3),
        "clock_bump_mode": rb(0.5),
        "shard_of": shard_of,
        "closest": closest,
        "client_attach_s": (np.arange(S)[None, None, :] * n[:, None, None]
                            + ri(0, 2, C, S)).astype(np.int32),
        "cmd_kmask": ri(1, 4, C, T1),
        "cmd_skey": cmd_skey,
    }
    fire = rb(0.3, Np, 3)
    ep = np.where(rb(0.1, Np), ri(1 << 20, 1 << 30, Np), ri(0, 40, Np))
    return ps, rb(0.85, Np), rows, fire, ctx, ep.astype(np.int32)


@pytest.mark.parametrize("seed", SEEDS)
def test_tempo_partial_handle_twin_matches_reference(seed):
    """The twin of K11 against the reference's vmapped ``ready``,
    ``periodic`` and ``handle`` at each process's event time (one jit
    for every case)."""
    from fantoch_tpu_torch.engine.protocols import TempoPartialDev
    from fantoch_tpu_torch.kernels import tempo_partial_handle

    t = TempoPartialDev(**PARTIAL_SIZES)
    rt = RTempoPartial(**PARTIAL_SIZES)
    rdims = RDims.for_partial(rt, PARTIAL_N, 4, 3)
    dims = EngineDims.for_partial(t, PARTIAL_N, 4, 3)
    assert dims == EngineDims(**vars(rdims))
    ps, has, rows, fire, ctx, ep = _tempo_partial_inputs(seed, dims, t)
    if "fn" not in _PARTIAL_REF:
        _PARTIAL_REF["fn"] = jax.jit(jax.vmap(
            lambda *a: _ref_handler_lane(rt, rdims, *a)))
    want = jax.tree_util.tree_map(
        np.asarray, _PARTIAL_REF["fn"](ps, has, rows, fire, ctx, ep))
    before = tempo_partial_handle.launches
    got = tempo_partial_handle(
        carry.to_torch(ps, "cpu"), torch.from_numpy(has),
        torch.from_numpy(rows), torch.from_numpy(fire), torch.from_numpy(ep),
        carry.to_torch(ctx, "cpu"), dims,
    )
    assert tempo_partial_handle.launches == before  # the twin
    _assert_equal(got[0].numpy(), want[0], "rdy")
    for name, g, w in zip(("ps", "periodic", "handler"), got[1:], want[1:]):
        assert sorted(g) == sorted(w), name
        for k in w:
            _assert_equal(g[k].numpy(), w[k], f"{name}/{k}")

    rdy, new_ps, _pout, hout = want
    X = RTempoPartial
    mt = np.where(rdy & has, rows[..., PMT], -1)
    assert set(range(X.NUM_TYPES)) <= set(mt.ravel().tolist())
    refused = np.where(has & ~rdy, rows[..., PMT], -1)
    assert {X.MCOLLECT, X.MCOMMIT, X.MCONSENSUS, X.MSHARDAGG,
            X.MSHARDCOMMIT} <= set(refused.ravel().tolist())
    assert fire.any((0, 1)).all()
    grew = (new_ps["err"] & 16) > (ps["err"] & 16)       # ERR_CAPACITY
    assert (grew & (mt == X.MCOMMIT)).any()
    # drains executed (TO_CLIENT in slot 0), chained (MDRAIN in slot 1)
    # and parked with a StableAtShard fan-out (slots 2 on)
    drains = (mt == X.MDETACHED) | (mt == X.MDRAIN)
    assert (drains & hout["valid"][..., 0]).any()
    assert (drains & hout["valid"][..., 1]).any()
    assert (drains & hout["valid"][..., 2:6].any(-1)).any()
    parked = (new_ps["pend_phase"] == 2) & (ps["pend_phase"] != 2)
    assert (drains & parked.any((-1, -2))).any()
    # StableAtShard: executes a matched head (and chains a drain in
    # slot 1), buffers the others
    sa = mt == X.STABLEAT
    assert (sa & hout["valid"][..., 1]).any()
    assert (sa & (new_ps["buf_cnt"] != ps["buf_cnt"]).any((-1, -2))).any()
    # the shard aggregation completes and the multi-shard commit path
    # goes to the owner
    assert ((mt == X.MSHARDCOMMIT) & hout["valid"][..., 0]).any()
    assert (((mt == X.MCOLLECTACK) | (mt == X.MCONSENSUSACK))
            & hout["valid"][..., 0]
            & (hout["mtype"][..., 0] == X.MSHARDCOMMIT)).any()


# ----------------------------------------------------------------------
# K12 atlas_partial_handle
# ----------------------------------------------------------------------

# two shards of three rows (N = 6); small tables, so that inputs reach
# full ones: K keys, G gap slots, B buffered requests (Q = 8, QS = 16)
ATLAS_PARTIAL_SIZES = dict(keys=4, shards=2, keys_per_cmd=2, gap_slots=3,
                           req_buffer=4)
_ATLAS_PARTIAL_REF = {}


def _atlas_partial_inputs(seed, dims, t, lanes=96):
    """Every message type handled somewhere, the gated ones (MCollect,
    MCommit, MShardCommit, MShardAgg) also refused; both timer rows
    firing; lanes with n = 2 and n = 3 rows per shard (pad rows carry
    shard id S); report, union and request tables with matching, free
    and full rows; a vertex store whose committed vertices depend on each
    other (chains and cycles), on executed dots, on cells that no longer
    hold the dep, on requested dots, on deps whose command touches or
    misses the process's shard, and through sources out of range
    (negative ones count from the end, large ones clamp, in the drain's
    plain gathers; the payload's triples carry such sources too);
    MCommits and GReplies naming stored, already installed and colliding
    dots and sources out of range; GReqs for pending, executed and
    unknown dots; clients and command sequences out of range of the
    tables; dot slots that wrap (seq 0 → slot D - 1)."""
    rng = np.random.default_rng(seed)
    Np, D, C, P = dims.N, dims.D, dims.C, dims.P
    K, G, S, KPC, BB = t.K, t.G, t.S, t.KPC, t.B
    Q, QS = t.q_shard(PARTIAL_N), t.q_union(PARTIAL_N)
    T1 = PARTIAL_T1
    ri = lambda lo, hi, *s: rng.integers(lo, hi, (lanes, *s)).astype(np.int32)  # noqa: E731
    rb = lambda p, *s: rng.random((lanes, *s)) < p  # noqa: E731
    X = RAtlasPartial
    li = np.arange(lanes)[:, None]
    me = np.broadcast_to(np.arange(Np)[None, :], (lanes, Np))
    n = np.where(rb(0.3), 2, PARTIAL_N).astype(np.int32)
    rows_ = np.arange(Np)[None, :]
    shard_of = np.where(rows_ < S * n[:, None], rows_ // n[:, None],
                        S).astype(np.int32)
    closest = np.zeros((lanes, Np, S), np.int32)
    for s in range(S):
        closest[..., s] = s * n[:, None] + np.minimum(ri(0, 2, Np),
                                                      n[:, None] - 1)
    qd_seq = ri(1, 6, Np, Np, D, Q) * rb(0.4, Np, Np, D, Q)
    qd_seq[rb(0.2, Np, Np, D)] = 5                       # full rows
    sh_seq = ri(1, 6, Np, D, QS) * rb(0.4, Np, D, QS)
    sh_seq[rb(0.2, Np, D)] = 5
    # the vertex store: a present cell holds a seq of its own slot
    vx_seq = (np.arange(D)[None, None, None, :] + 1
              + D * ri(0, 2, Np, Np, D)) * rb(0.7, Np, Np, D)
    committed = rb(0.6, Np, Np, D) & (vx_seq > 0)
    tsrc, tslot = ri(0, Np, Np, Np, D, QS), ri(0, D, Np, Np, D, QS)
    target = vx_seq[li[..., None, None, None], me[..., None, None, None],
                    tsrc, tslot]
    dep_seq = np.where(rb(0.7, Np, Np, D, QS), target,
                       ri(1, 9, Np, Np, D, QS))
    dep_seq = dep_seq * rb(0.4, Np, Np, D, QS)
    dep_src = tsrc - Np * rb(0.1, Np, Np, D, QS)
    dep_src = np.where(rb(0.05, Np, Np, D, QS), Np + 2, dep_src)
    # requested markers: some deps already asked for
    req_seq = ri(1, 9, Np, Np, D) * rb(0.3, Np, Np, D)
    ef, eg = _gap_sets(rng, (lanes, Np, Np), G, lo_max=4)
    cf, cg = _gap_sets(rng, (lanes, Np, Np), G)
    breq_from = np.where(rb(0.5, Np, BB), ri(0, S + 1, Np, BB), -1)
    breq_from[rb(0.3, Np)] = 0                           # full buffers
    # buffered requests: most for stored vertices, some for executed dots
    bsrc, bslot = ri(0, Np, Np, BB), ri(0, D, Np, BB)
    bseq = vx_seq[li[..., None], me[..., None], bsrc, bslot]
    bseq = np.where(rb(0.7, Np, BB), bseq, ri(0, 5, Np, BB))
    cmd_skey = ri(-1, K + 1, C, T1, S, KPC)
    cmd_skey[..., 1] = np.where(rb(0.3, C, T1, S), -1, cmd_skey[..., 1])
    ps = {
        "latest_src": ri(0, Np, Np, K),
        "latest_seq": ri(0, 9, Np, K) * rb(0.7, Np, K),
        "latest_km": ri(1, 4, Np, K),
        "seq_in_slot": ri(0, 9, Np, Np, D) * rb(0.6, Np, Np, D),
        "client_of": ri(0, C + 1, Np, Np, D),
        "cseq_of": ri(0, T1 + 2, Np, Np, D),
        "own_seq": ri(0, 9, Np),
        "ack_cnt": ri(0, 4, Np, Np, D),
        "slow_acks": ri(0, 3, Np, Np, D),
        "qd_src": ri(0, Np, Np, Np, D, Q),
        "qd_seq": qd_seq,
        "qd_km": ri(1, 4, Np, Np, D, Q),
        "qd_cnt": ri(1, 4, Np, Np, D, Q) * (qd_seq > 0),
        "sh_cnt": ri(0, 2, Np, D),
        "sh_src": ri(0, Np, Np, D, QS),
        "sh_seq": sh_seq,
        "sh_km": ri(1, 4, Np, D, QS),
        "vx_committed": committed,
        "vx_seq": vx_seq.astype(np.int32),
        "vx_client": ri(0, C + 1, Np, Np, D),
        "vx_cseq": ri(0, T1 + 2, Np, Np, D),
        "vx_nd": ri(0, QS + 1, Np, Np, D),
        "vx_dep_src": dep_src.astype(np.int32),
        "vx_dep_seq": dep_seq.astype(np.int32),
        "vx_dep_km": ri(1, 4, Np, Np, D, QS),
        "req_seq": req_seq,
        "breq_from": breq_from.astype(np.int32),
        "breq_src": bsrc.astype(np.int32),
        "breq_seq": bseq.astype(np.int32),
        "exec_front": ef,
        "exec_gaps": eg,
        "comm_front": cf,
        "comm_gaps": cg,
        "others_frontier": ri(0, 8, Np, Np, Np),
        "seen": rb(0.7, Np, Np),
        "prev_stable": ri(0, 4, Np, Np),
        "m_fast": ri(0, 9, Np),
        "m_slow": ri(0, 9, Np),
        "m_stable": ri(0, 9, Np),
        "err": ri(0, 2, Np) * 32,
    }
    rows = ri(0, 8, Np, PPAY + P)
    rows[..., PSRC] = ri(0, Np + C, Np)                  # clients too
    mt = ri(0, X.NUM_TYPES + 2, Np)
    rows[..., PMT] = mt
    pay = rows[..., PPAY:]
    # dep triples from word 3 (reports, unions) or 5 (collects, commits,
    # replies): sources in and out of range, present and empty seqs
    at3 = np.isin(mt, [X.MCOLLECTACK, X.MSHARDCOMMIT, X.MSHARDAGG])
    lo = np.where(at3, 3, 5)
    for j in range(QS):
        w = lo + 3 * j
        src = np.where(rb(0.1, Np), ri(-Np, 2 * Np, Np), ri(0, Np, Np))
        for word, v in ((w, src), (w + 1, ri(0, 7, Np) * rb(0.7, Np)),
                        (w + 2, ri(0, 4, Np))):
            np.put_along_axis(pay, np.minimum(word, P - 1)[..., None],
                              v[..., None], -1)
    nd = np.where(at3, ri(0, 2 * KPC + 2, Np), ri(0, QS + 2, Np))
    nd = np.where(mt == X.MSHARDCOMMIT, ri(0, Q + 2, Np), nd)
    nd = np.where(mt == X.MCOLLECT, ri(0, KPC + 2, Np), nd)
    pay[..., 2] = np.where(at3, nd, pay[..., 2])
    pay[..., 4] = np.where(~at3, nd, pay[..., 4])
    # dots: (dsrc, seq) words; gated types mostly name a stored dot, an
    # MCollect half the time a free slot
    dotted = ~np.isin(mt, [X.SUBMIT, X.MGC, X.MDRAIN])
    dsrc, slot = ri(0, Np, Np), ri(0, D, Np)
    dsrc = np.where(mt == X.MSHARDCOMMIT,
                    np.where(rb(0.8, Np), me, dsrc), dsrc)
    stored = ps["seq_in_slot"][li, me, dsrc, slot]
    vertex = ps["vx_seq"][li, me, dsrc, slot]
    good = rb(0.7, Np) & (stored > 0)
    seq = np.where(good, stored, ri(0, 9, Np))
    # GReq and GReply name vertices half the time
    named = np.isin(mt, [X.GREQ, X.GREPLY]) & rb(0.5, Np) & (vertex > 0)
    seq = np.where(named, vertex, seq)
    # and GReq a dot known nowhere here a third of the time
    unknown = (mt == X.GREQ) & ~named & rb(0.3, Np)
    seq = np.where(unknown, 40 + ri(0, D, Np), seq)
    free = (mt == X.MCOLLECT) & rb(0.5, Np)
    fslot = (seq - 1) % D
    # most gated messages find their payload; half the shard commits a
    # full union row
    gated = np.isin(mt, [X.MCOMMIT, X.MSHARDCOMMIT, X.MSHARDAGG])
    cell = ps["seq_in_slot"][li, me, dsrc, fslot]
    ps["seq_in_slot"][li, me, dsrc, fslot] = np.where(
        gated & good, seq, cell)
    full = (mt == X.MSHARDCOMMIT) & rb(0.5, Np)
    ps["sh_seq"][li, me, fslot] = np.where(full[..., None], 6,
                                           ps["sh_seq"][li, me, fslot])
    for k in ("seq_in_slot", "vx_seq"):
        ps[k][li, me, dsrc, fslot] = np.where(free, 0,
                                              ps[k][li, me, dsrc, fslot])
    ps["vx_committed"][li, me, dsrc, fslot] &= ~free
    pay[..., 0] = np.where(dotted, dsrc, pay[..., 0])
    pay[..., 1] = np.where(dotted, seq, pay[..., 1])
    oob = np.isin(mt, [X.MCOMMIT, X.GREPLY, X.GREPLYEXEC, X.GREQ]) & rb(
        0.1, Np)
    pay[..., 0] = np.where(oob, ri(Np, 2 * Np, Np) * np.where(
        rb(0.5, Np), 1, -1), pay[..., 0])
    # SUBMIT [client, cseq]; MFwdSubmit/MCollect/MCommit/GReply
    # [dsrc, seq, client, cseq, ..]
    sub = mt == X.SUBMIT
    pay[..., 0] = np.where(sub, ri(0, C + 1, Np), pay[..., 0])
    pay[..., 1] = np.where(sub, ri(0, T1 + 2, Np), pay[..., 1])
    fwd = np.isin(mt, [X.MCOLLECT, X.MFWDSUBMIT, X.MCOMMIT, X.GREPLY])
    pay[..., 2] = np.where(fwd, ri(0, C + 1, Np), pay[..., 2])
    pay[..., 3] = np.where(fwd, ri(0, T1 + 2, Np), pay[..., 3])
    rows[..., PSRC] = np.where(mt == X.MCOLLECT,
                               np.where(rb(0.3, Np), me, ri(0, Np, Np)),
                               rows[..., PSRC])
    # MGC [frontier of every row]
    pay[..., :Np] = np.where((mt == X.MGC)[..., None], ri(0, 8, Np, Np),
                             pay[..., :Np])
    rows[..., PPAY:] = pay

    ctx = {
        "n": n,
        "f": ri(1, 3),
        "expected_acks": ri(1, 4),
        "fp_mode": ri(0, 2),
        "ack_self": rb(0.5),
        "fast_quorum": rb(0.6, Np, Np),
        "write_quorum": rb(0.6, Np, Np),
        "shard_of": shard_of,
        "closest": closest,
        "client_attach_s": (np.arange(S)[None, None, :] * n[:, None, None]
                            + ri(0, 2, C, S)).astype(np.int32),
        "cmd_kmask": ri(1, 4, C, T1),
        "cmd_skey": cmd_skey,
    }
    return ps, rb(0.85, Np), rows, rb(0.3, Np, 2), ctx


@pytest.mark.parametrize("seed", SEEDS)
def test_atlas_partial_handle_twin_matches_reference(seed):
    """The twin of K12 against the reference's vmapped ``ready``,
    ``periodic`` and ``handle`` (one jit for every case)."""
    from fantoch_tpu_torch.engine.protocols import AtlasPartialDev
    from fantoch_tpu_torch.kernels import atlas_partial_handle

    t = AtlasPartialDev(**ATLAS_PARTIAL_SIZES)
    rt = RAtlasPartial(**ATLAS_PARTIAL_SIZES)
    rdims = RDims.for_partial(rt, PARTIAL_N, 4, 3)
    dims = EngineDims.for_partial(t, PARTIAL_N, 4, 3)
    assert dims == EngineDims(**vars(rdims))
    ps, has, rows, fire, ctx = _atlas_partial_inputs(seed, dims, t)
    if "fn" not in _ATLAS_PARTIAL_REF:
        _ATLAS_PARTIAL_REF["fn"] = jax.jit(jax.vmap(
            lambda *a: _ref_handler_lane(rt, rdims, *a)))
    want = jax.tree_util.tree_map(
        np.asarray, _ATLAS_PARTIAL_REF["fn"](ps, has, rows, fire, ctx))
    before = atlas_partial_handle.launches
    got = atlas_partial_handle(
        carry.to_torch(ps, "cpu"), torch.from_numpy(has),
        torch.from_numpy(rows), torch.from_numpy(fire),
        carry.to_torch(ctx, "cpu"), dims,
    )
    assert atlas_partial_handle.launches == before  # the twin
    _assert_equal(got[0].numpy(), want[0], "rdy")
    for name, g, w in zip(("ps", "periodic", "handler"), got[1:], want[1:]):
        assert sorted(g) == sorted(w), name
        for k in w:
            _assert_equal(g[k].numpy(), w[k], f"{name}/{k}")

    rdy, new_ps, pout, hout = want
    X = RAtlasPartial
    N, KPC = dims.N, t.KPC
    mt = np.where(rdy & has, rows[..., PMT], -1)
    assert set(range(X.NUM_TYPES)) <= set(mt.ravel().tolist())
    refused = np.where(has & ~rdy, rows[..., PMT], -1)
    assert {X.MCOLLECT, X.MCOMMIT, X.MSHARDCOMMIT,
            X.MSHARDAGG} <= set(refused.ravel().tolist())
    grew = (new_ps["err"] & 16) > (ps["err"] & 16)       # ERR_CAPACITY
    for t_ in (X.MCOLLECTACK, X.MSHARDCOMMIT, X.GREQ):
        assert (grew & (mt == t_)).any(), t_
    dot = (new_ps["err"] & 8) > (ps["err"] & 8)          # ERR_DOT
    assert (dot & (mt == X.GREPLY)).any()
    # drains executed (a part in slot 0 or 1), requested (GREQ in slot
    # KPC) and chained (MDRAIN in slot KPC + 1)
    drains = np.isin(mt, [X.MCOMMIT, X.MDRAIN, X.GREPLY, X.GREPLYEXEC])
    assert (drains & hout["valid"][..., :KPC].any(-1)).any()
    assert (drains & hout["valid"][..., KPC]).any()
    assert (drains & hout["valid"][..., KPC + 1]).any()
    assert ((new_ps["req_seq"] != ps["req_seq"]).any((-1, -2))
            & drains).any()
    # a GReq answered with each reply type, another buffered; the
    # cleanup tick answers buffered requests with both types
    greq = mt == X.GREQ
    for reply in (X.GREPLY, X.GREPLYEXEC):
        assert (greq & hout["valid"][..., 0]
                & (hout["mtype"][..., 0] == reply)).any(), reply
    assert (greq & (new_ps["breq_from"] != ps["breq_from"]).any(-1)).any()
    tick = pout["valid"][..., N + 1:N + 1 + t.B]
    for reply in (X.GREPLY, X.GREPLYEXEC):
        assert (tick & (pout["mtype"][..., N + 1:N + 1 + t.B]
                        == reply)).any(), reply
    # the shard aggregation completes and the multi-shard commit path
    # goes to the owner
    assert ((mt == X.MSHARDCOMMIT) & hout["valid"][..., 0]).any()
    assert (((mt == X.MCOLLECTACK) | (mt == X.MCONSENSUSACK))
            & hout["valid"][..., 0]
            & (hout["mtype"][..., 0] == X.MSHARDCOMMIT)).any()


# ----------------------------------------------------------------------
# K1, K6 and K7 under the fault flags and the reorder switch
# ----------------------------------------------------------------------

def _random_fault_ctx(rng, lanes, n):
    """Each lane's fault plan ctx at random, over the stub inputs' small
    times: crash times, a horizon, link windows (the first with a
    multiplier past INF on some lanes; overrides, partitions), drop rates
    from 0 to certain, jitter multipliers and keys, the unavailability
    word, the reorder key."""
    from fantoch_tpu_torch.engine.faults import MAX_WINDOWS as MW

    ri = lambda lo, hi, *s: rng.integers(lo, hi, (lanes, *s)).astype(np.int32)  # noqa: E731
    rb = lambda p, *s: rng.random((lanes, *s)) < p  # noqa: E731
    key = lambda: rng.integers(0, 1 << 32, (lanes, 2), dtype=np.uint32)  # noqa: E731
    t0 = ri(0, 5, MW)
    mul = ri(1, 7, MW)
    mul[:, 0] = np.where(rb(0.5), 1 << 29, mul[:, 0])
    ovr = np.where(rb(0.6, MW), -1, np.where(rb(0.5, MW), INF, ri(1, 9, MW)))
    return {
        "fault_crash_t": np.where(rb(0.5, n), INF, ri(0, 6, n)),
        "fault_win_src": np.where(rb(0.2, MW), -1, ri(0, n, MW)),
        "fault_win_dst": np.where(rb(0.2, MW), -1, ri(0, n, MW)),
        "fault_win_t0": t0,
        "fault_win_t1": t0 + ri(1, 6, MW),
        "fault_win_mul": mul,
        "fault_win_ovr": ovr.astype(np.int32),
        "fault_drop_num": np.where(rb(0.3), 0, ri(0, 10_001)),
        "fault_drop_key": key(),
        "fault_jitter_num": ri(0, 9),
        "fault_jitter_key": key(),
        "fault_horizon": np.where(rb(0.3), INF, ri(0, 9)),
        "fault_unavail": ri(0, 2) * rb(0.3),
        "reorder_key": key(),
    }


def _fault_port_step(st, ctx, dims, flags):
    """The port's step around the stub's tables under ``flags``: K1, K6
    (reading the masked timers) and K2, their twins."""
    from fantoch_tpu_torch.kernels import emit_rewrite

    ps = st["ps"]
    arrival, ep, now, _a, fire, _s, has, rows, timers = qualify_pop(
        st["pool"], st["next_periodic"], ctx["lookahead"],
        ctx["fault_crash_t"], ctx["fault_horizon"], flags,
    )

    def outbox(side):
        return {"valid": ps[side + "v"], "dst": ps[side + "d"],
                "mtype": ps[side + "m"], "payload": ps[side + "p"]}

    new_rows, deliver, upd = emit_rewrite(
        dict(st, next_periodic=timers), ctx, ep, fire, has, ps["rdy"], rows,
        outbox("p"), outbox("h"), ps["perr"], dims, 0, flags,
    )
    pool, _o, peak, err = land_emissions(
        st["pool"], arrival, deliver, new_rows, st["pool_peak"], upd["err"]
    )
    return {**upd, "pool": pool, "now": now, "pool_peak": peak, "err": err}


FAULT_MODES = {
    "faults": (True, False),
    "reorder": (False, True),
    "faults+reorder": (True, True),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode", sorted(FAULT_MODES))
def test_step_twins_under_fault_flags_match_reference(mode, seed):
    """The whole step's new state (pool arrivals after the crash purge,
    the re-armed masked timers, the delivered rows with their windowed,
    jittered and reorder-scaled arrivals, the lost count, the error
    word) equal to the reference's ``_lane_step(..., reorder, faults)``
    on random inputs and random fault ctx."""
    import test_torch_emit as emit_case

    from fantoch_tpu.engine.core import _lane_step
    from fantoch_tpu.engine.faults import FaultFlags as RFlags
    from fantoch_tpu_torch.engine.faults import FaultFlags, flag_bits

    faults_on, reorder = FAULT_MODES[mode]
    st, ctx = emit_case._inputs(seed)
    rng = np.random.default_rng(seed + 50)
    ctx.update(_random_fault_ctx(rng, emit_case.L, emit_case.N))
    rdims, dims = emit_case._dims()
    on = (True,) * 5 if faults_on else (False,) * 5
    want = jax.jit(jax.vmap(lambda s, c: _lane_step(
        emit_case.Stub, rdims, s, c, reorder, RFlags(*on))))(st, ctx)
    want = jax.tree_util.tree_map(np.asarray, want)
    flags = flag_bits(FaultFlags(*on), reorder)
    got = carry.to_numpy(_fault_port_step(
        carry.to_torch(st, "cpu"), carry.to_torch(ctx, "cpu"), dims, flags))
    for k in got:
        for path, g, w in (
            [(f"{k}/{j}", got[k][j], want[k][j]) for j in got[k]]
            if isinstance(got[k], dict) else [(k, got[k], want[k])]
        ):
            assert g.dtype == w.dtype and g.shape == w.shape, path
            np.testing.assert_array_equal(g, w, err_msg=path)
    # the inputs reach the branches: messages and timers purged by a
    # crash, rows lost on the wire, unavailable lanes
    if faults_on:
        assert (want["fault_dropped"] > st["fault_dropped"]).any()
        assert (want["err"] & 128).any() and not (want["err"] & 128).all()
        purged = (st["pool"][..., PA] < INF) & (want["pool"][..., PA] >= INF)
        assert purged.any()
    if reorder:
        assert (want["pool"][..., PA] != _fault_port_step(
            carry.to_torch(st, "cpu"), carry.to_torch(ctx, "cpu"), dims,
            flag_bits(FaultFlags(*on), False))["pool"][..., PA].numpy()
        ).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_lane_freeze_horizon_twin_matches_reference(seed):
    """K7's predicate under the horizon flag: a lane whose clock reached
    its horizon stops, as ``_lane_running(..., faults)``."""
    import test_torch_emit as emit_case

    from fantoch_tpu.engine.core import _lane_running
    from fantoch_tpu.engine.faults import FaultFlags as RFlags
    from fantoch_tpu_torch.engine.faults import FLAG_HORIZON
    from fantoch_tpu_torch.kernels import lane_freeze

    new, old, ctx = emit_case._freeze_inputs(seed)
    rng = np.random.default_rng(seed + 7)
    lanes = old["now"].shape[0]
    ctx["fault_horizon"] = np.where(
        rng.random(lanes) < 0.3, INF, rng.integers(0, 60, lanes)
    ).astype(np.int32)
    ctx["fault_horizon"][2] = old["now"][2]  # lane 2 was in its extra time
    running = np.asarray(jax.vmap(lambda s, c: _lane_running(
        None, s, c, 10, RFlags(horizon=True)))(old, ctx))
    got, got_running = lane_freeze(
        carry.to_torch(new, "cpu"), carry.to_torch(old, "cpu"),
        carry.to_torch(ctx, "cpu"), 10, FLAG_HORIZON,
    )
    np.testing.assert_array_equal(got_running.numpy(), running)
    plain = np.asarray(jax.vmap(lambda s, c: _lane_running(
        None, s, c, 10))(old, ctx))
    assert (plain & ~running).any()  # the horizon stopped a lane
    got = carry.to_numpy(got)
    np.testing.assert_array_equal(
        got["pool"], np.where(running[:, None, None], new["pool"],
                              old["pool"]))
