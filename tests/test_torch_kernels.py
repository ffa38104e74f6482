"""Each kernel module's plain twin against the reference's own code for
the region it replaces, on seeded random inputs (numpy) that reach what
one run's trajectory may not: tied keys, empty processes, all-INF lanes,
full pools, out-of-range sources and dot slots that wrap.

- ``qualify_pop`` against ``_lane_step`` §1-2 (core.py:820-883, with
  ``frontier_min`` and ``mark_popped``);
- ``land_emissions`` against §6 (core.py:1460-1492, with ``cumsum_i32``
  and ``searchsorted_left``);
- ``basic_handle`` and ``fpaxos_handle`` against their protocol's
  ``ready``/``periodic`` and ``run_handlers`` in the step's order
  (core.py:873-918).

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
from fantoch_tpu_torch import carry
from fantoch_tpu_torch.engine.dims import (
    INF, PA, PDST, PKC, PKS, PMT, PPAY, PPR, PSRC, EngineDims,
)
from fantoch_tpu_torch.engine.protocols import BasicDev, FPaxosDev
from fantoch_tpu_torch.kernels import (
    basic_handle, fpaxos_handle, land_emissions, qualify_pop,
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


def _ref_handler_lane(proto, dims, ps, has, rows, fire, ctx):
    """One lane of the step's handler phase, in core.py:873-918's order."""
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
        lambda p, f, me: proto.periodic(p, f, me, 0, ctx, dims)
    )(ps, fire, procs)
    ps, hout = run_handlers(
        proto, ps, msg, procs, jnp.zeros((dims.N,), I32), ctx, dims
    )
    return rdy, ps, pout, hout


def _run_handler_twin(wrapper, proto, rdims, dims, ps, has, rows, fire,
                      ctx):
    """The reference's handler phase and the port's wrapper (on CPU
    tensors: its twin) on the same inputs; asserts equality and returns
    the reference's outputs."""
    want = jax.jit(jax.vmap(
        lambda *a: _ref_handler_lane(proto, rdims, *a)
    ))(ps, has, rows, fire, ctx)
    before = wrapper.launches
    got = wrapper(
        carry.to_torch(ps, "cpu"), torch.from_numpy(has),
        torch.from_numpy(rows), torch.from_numpy(fire),
        carry.to_torch(ctx, "cpu"), dims,
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
