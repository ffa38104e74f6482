"""The run cap of K1 (``qualify_pop``) and the in-place contract of K8
(``tempo_handle``) on the CPU, through their plain twins.

K8 updates Tempo's process state (with the monitor planes) in place, on
the lanes whose run predicate holds at the step's start
(``kernels/lane_freeze.py Cap``), and returns the very tensors it was
given; K1 reads nothing of a frozen lane's pool and gives it defined
outputs, its timers as they were.
All comparisons are exact. The arguments are those of step 301 of the
reference's tier-1 Tempo sweep batch (``tests/test_torch_inplace.py
_step_301``), with every third lane's error word set and a step cap that
stops half the lanes (its ``_freeze``):

- K8's twin with the cap: running lanes equal the out-of-place
  arithmetic, frozen lanes' rows are bit for bit as before, the planes
  returned are the ones given, a frozen lane's ``rdy`` is false and its
  outboxes empty; its ``work`` on a snapshot taken before the call
  equals its value on the out-of-place result;
- K1's twin with the cap (fault-free, and under the crash and horizon
  flags): running lanes equal the uncapped twin's outputs, frozen lanes
  hold the defined values;
- K1's twin on a pool of 60,000 slots, more than the kernel stages in
  an H100's shared memory, whose pops take slots past 50,000, against
  the reference's ``_lane_step`` sections 1-2;
- 64 ``frozen_step``s with lanes frozen against the reference's vmapped
  run loop (its ``build_segment_runner``), whole state, for a Tempo
  batch under fault plans (a crash, windows, drops, jitter, horizons),
  for the monitored Tempo batch and for an open-loop Tempo batch; the
  planes a step updates in place (the pool, the process state, K6's
  clients, metrics, channel counts and timers, the monitor planes) stay
  the same tensors throughout."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_faults_step import _batch as _fault_batch
from test_torch_inplace import (
    MAX_STEPS, WARMUP, _assert_tree_equal, _batch, _freeze, _step_301,
)
from test_torch_kernels import W as K1_W
from test_torch_kernels import _ref_qualify_pop, _with_inf
from test_torch_monitor_step import _ctx_with_keys
from test_torch_monitor_step import _tempo as _monitored_tempo
from test_torch_open_loop_step import _batch as _open_batch
from torch_threads import one_torch_thread  # noqa: F401

from fantoch_tpu.engine.core import build_segment_runner as r_segment_runner
from fantoch_tpu.engine.driver import stack_states
from fantoch_tpu.engine.faults import batch_fault_flags
from fantoch_tpu_torch import carry
from fantoch_tpu_torch.engine import core as engine_core
from fantoch_tpu_torch.engine.core import empty_outbox, frozen_step
from fantoch_tpu_torch.engine.dims import INF, PA, PDST, PKC, PKS, PMT, PPR
from fantoch_tpu_torch.engine.faults import (
    FLAG_CRASH, FLAG_HORIZON, FaultFlags, flag_bits,
)
from fantoch_tpu_torch.kernels.lane_freeze import Cap, lane_live
from fantoch_tpu_torch.kernels.mon_finalize import mon_finalize_plain
from fantoch_tpu_torch.kernels.step_loop import clone_tree

k1 = importlib.import_module("fantoch_tpu_torch.kernels.qualify_pop")
k8 = importlib.import_module("fantoch_tpu_torch.kernels.tempo_handle")
# the lane-state planes the reference re-derives at a segment's end for
# lanes that no longer run (its segment_lane_fn's finalize_lane)
MON_FINAL = ("viol", "viol_step", "cov")


@functools.lru_cache(maxsize=None)
def _calls():
    """The port's Tempo batch after ``WARMUP`` run-loop steps (numpy),
    its ctx, and the arguments of step 301's K1 and K8 calls, the
    arguments each updates or that a later kernel of the step updates
    in place (the pool, the process state) copied before the call."""
    st300, pctx, _calls_ = _step_301("tempo")
    pdev, pdims = _batch("tempo")[4:6]
    st = carry.to_torch(st300, "cpu")
    calls = {}
    saved_k1, saved_k8 = engine_core.qualify_pop, k8.tempo_handle

    def rec_k1(*a):
        calls["qualify_pop"] = (a[0].clone(),) + a[1:]
        return saved_k1(*a)

    def rec_k8(*a):
        calls["tempo_handle"] = (clone_tree(a[0]),) + a[1:]
        return saved_k8(*a)

    engine_core.qualify_pop, k8.tempo_handle = rec_k1, rec_k8
    try:
        frozen_step(pdev, pdims, st, pctx, MAX_STEPS)
    finally:
        engine_core.qualify_pop, k8.tempo_handle = saved_k1, saved_k8
    return st300, pctx, calls


def _capped():
    """The step-301 state with lanes frozen (:func:`_freeze`) and its
    cap, with the lanes it lets run."""
    st300, pctx, _c = _calls()
    st = _freeze(carry.to_torch(st300, "cpu"), lim=WARMUP)
    cap = Cap(st, pctx, WARMUP, 0)
    run = cap.running()
    assert int(run.sum()) >= 2 and int((~run).sum()) >= 4, run
    return cap, run


def _tempo_out_of_place(ps, has, rows, fire, now, ctx, dims, skip):
    """K8's twin out of place: a new state tree."""
    X = k8._protocol(ps, skip)
    none = torch.full_like(rows[..., PMT], X.NUM_TYPES)
    mtype0 = torch.where(has, rows[..., PMT], none)
    rdy = X.ready_plain(ps, rows, mtype0, dims)
    mtype = torch.where(has & rdy, mtype0, none)
    new, pout = X.periodic_plain(ps, fire, now, ctx, dims)
    new, hout = X.handle_plain(new, mtype, rows, ctx, dims)
    return rdy, new, pout, hout


# ----------------------------------------------------------------------
# K8
# ----------------------------------------------------------------------

def test_tempo_handle_twin_updates_running_lanes_in_place():
    _st, _pctx, calls = _calls()
    a = calls["tempo_handle"]
    cap, run = _capped()
    frozen = ~run
    before, given = clone_tree(a[0]), clone_tree(a[0])
    got = k8.tempo_handle_plain(given, *a[1:-1], cap)
    want = _tempo_out_of_place(clone_tree(a[0]), *a[1:-1])
    assert all(got[1][k] is given[k] for k in given)
    for k in given:
        assert torch.equal(got[1][k][frozen], before[k][frozen]), (
            f"{k}: a frozen lane moved")
        assert torch.equal(got[1][k][run], want[1][k][run]), (
            f"{k}: a running lane differs")
    moved = sum(int((got[1][k][run] != before[k][run]).sum())
                for k in given)
    assert moved > 0, "no running lane changed"
    empty = empty_outbox(a[6], a[2].shape[:2], "cpu")
    outs = [(got[0], want[0], torch.zeros_like(want[0]))]
    for g, w in zip(got[2:], want[2:]):
        outs += [(g[k], w[k], empty[k]) for k in w]
    for g, w, dflt in outs:
        lead = run.reshape(run.shape + (1,) * (w.dim() - 1))
        assert torch.equal(g, torch.where(lead, w, dflt.expand_as(w)))


def test_tempo_handle_work_on_a_snapshot_equals_out_of_place():
    """K8's ``work`` on the state copied before the call equals its
    value on the out-of-place arithmetic's result."""
    _st, _pctx, calls = _calls()
    a = calls["tempo_handle"]
    want = k8.work(*a[:-1], _tempo_out_of_place(*a[:-1]))
    ps = clone_tree(a[0])
    out = k8.tempo_handle(ps, *a[1:])
    assert all(out[1][k] is ps[k] for k in ps)
    assert k8.work(*a, out) == want


# ----------------------------------------------------------------------
# K1
# ----------------------------------------------------------------------

@pytest.mark.parametrize("flags", [0, FLAG_CRASH | FLAG_HORIZON])
def test_qualify_pop_twin_skips_frozen_lanes(flags):
    """K1's twin with the cap equals the uncapped twin on running lanes
    and gives the defined values on frozen lanes: ep and arrival INF,
    active, fire and has false, slot 0, rows zero, now the lane's now
    plane, and the timers given (under the crash flag the masked copy
    holds a frozen lane's timers as they were: no select follows).
    Under the fault flags each lane's crash times and horizon are drawn
    from a seed, inside the step's event times."""
    _st, pctx, calls = _calls()
    pool, timers, lookahead, crash_t, horizon = calls["qualify_pop"][:5]
    if flags:
        rng = np.random.default_rng(15)
        arrivals = pool[..., PA]
        hi = int(arrivals[arrivals < INF].max()) + 1
        crash_t = torch.from_numpy(
            rng.integers(0, hi, crash_t.shape).astype(np.int32))
        horizon = torch.from_numpy(
            rng.integers(0, hi, horizon.shape).astype(np.int32))
    a = (pool, timers, lookahead, crash_t, horizon, flags)
    cap, run = _capped()
    frozen = ~run
    got = k1.qualify_pop_plain(*a, cap)
    free = k1.qualify_pop_plain(*a)
    for i, (g, f) in enumerate(zip(got, free)):
        assert torch.equal(g[run], f[run]), f"output {i}"
    arrival, ep, now, active, fire, slot, has, rows, t_out = got
    assert bool((arrival[frozen] == INF).all() & (ep[frozen] == INF).all())
    assert not bool(active[frozen].any() | fire[frozen].any()
                    | has[frozen].any())
    assert not bool(slot[frozen].any() | rows[frozen].any())
    assert torch.equal(now[frozen], cap.st["now"][frozen])
    if flags & FLAG_CRASH:
        assert torch.equal(t_out[frozen], timers[frozen])
        assert bool((timers[frozen] < INF).any())
        assert bool((t_out[run] < INF).any() & (t_out[run] == INF).any())
    else:
        assert t_out is timers
    # the running lanes pop something, so the comparison is not vacuous
    assert bool(has[run].any())


@pytest.mark.parametrize("seed", [0, 1])
def test_qualify_pop_twin_matches_reference_on_a_large_pool(seed):
    """On a pool of 60,000 slots (the kernel stages about 46,000 of them
    at N = 5 on an H100 and re-reads the rest), lane 1's messages all
    past slot 50,000: the twin equals the reference's sections 1-2 on
    every output, and lane 1 pops slots past 50,000."""
    L, M, N = 2, 60_000, 5
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 9, (L, M, K1_W)).astype(np.int32)
    pool[..., PA] = INF
    for lane, lo in ((0, 0), (1, 50_000)):
        hot = lo + rng.choice(M - lo, 400, replace=False)
        pool[lane, hot, PA] = rng.integers(0, 6, hot.size)
    pool[..., PKS] = rng.integers(0, 4, (L, M))
    pool[..., PKC] = rng.integers(0, 3, (L, M))
    pool[..., PDST] = rng.integers(0, N, (L, M))
    pool[..., PPR] = rng.random((L, M)) < 0.2
    next_periodic = _with_inf(rng, (L, N, 2), 8, 0.5)
    lookahead = _with_inf(rng, (L, N, N), 4, 0.2)
    lookahead[:, np.arange(N), np.arange(N)] = INF
    want = jax.jit(jax.vmap(_ref_qualify_pop))(pool, next_periodic,
                                               lookahead)
    got = k1.qualify_pop(*(torch.from_numpy(x)
                           for x in (pool, next_periodic, lookahead)))
    names = ("arrival", "ep", "now", "active", "fire", "slot", "has", "rows")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    slot, has = got[5].numpy(), got[6].numpy()
    assert (has[1] & (slot[1] >= 50_000)).any()


# ----------------------------------------------------------------------
# 64 frozen steps against the reference's run loop
# ----------------------------------------------------------------------

def _faults():
    ref, port, dims, ctx, state, specs = _fault_batch(False)
    return ref, port, dims, ctx, state, batch_fault_flags(specs), 0


def _monitored():
    ref, port, dims, specs, mk = _monitored_tempo()
    ctx = _ctx_with_keys(specs, dims)
    state = stack_states(ref, dims, specs, monitor_keys=mk)
    return ref, port, dims, ctx, state, batch_fault_flags(specs), mk


def _open_loop():
    """The open-loop Tempo batch of tests/test_torch_open_loop_step.py
    (Poisson arrivals at load 400, a window of 2, and a burst lane)."""
    ref, port, dims, ctx, state = _open_batch()
    return ref, port, dims, ctx, state, batch_fault_flags([]), 0


PROVIDERS = {"tempo_faults": _faults, "tempo_monitored": _monitored,
             "tempo_open_loop": _open_loop}


@pytest.mark.parametrize("name", sorted(PROVIDERS))
def test_frozen_tempo_steps_match_the_reference_run_loop(name):
    """From the port's state after 20 steps, every third lane failed and
    every other lane one step behind the cap at 83: 64 ``frozen_step``s
    of the port and the reference's segment runner to 83 end in the same
    whole state, Tempo's process state (and the monitor planes) updated
    in place throughout. The reference re-derives the violation word,
    its step and the digest of lanes that no longer run at the segment's
    end; so does the port's ``mon_finalize`` twin, applied to those
    lanes here."""
    frozen_steps_against_reference(*PROVIDERS[name]())


def _in_place_planes(st, flags: int):
    """The planes a step updates in place: the pool, the process state,
    the clients, metrics and channel counts, the timers (but under the
    crash flag, whose masked timers are K1's copy) and the monitor
    planes."""
    out = [st["pool"], st["pair_cnt"]]
    out += [st[g][k] for g in ("ps", "clients", "metrics") for k in st[g]]
    if not flags & FLAG_CRASH:
        out.append(st["next_periodic"])
    return out + [st[k] for k in ("mon_hash", "mon_cnt", "mon_flags")
                  if k in st]


def frozen_steps_against_reference(ref, port, dims, ctx, state, rflags,
                                   mk):
    """64 ``frozen_step``s of the port against the reference's segment
    runner from the port's state after 20 steps, every third lane
    failed and every other lane one step behind the cap at 83; the
    planes the step updates in place stay the same tensors throughout.
    Lanes that no longer run have their monitor fields re-derived by the
    ``mon_finalize`` twin, as the reference's segment end does."""
    pflags = FaultFlags(*rflags)
    warm, lim = 20, 20 + 63
    pctx = carry.to_torch(ctx, "cpu")
    st = carry.to_torch(state, "cpu")
    for _ in range(warm):
        st, _running = frozen_step(port, dims, st, pctx, MAX_STEPS, False,
                                   pflags, mk)
    start = carry.to_numpy(_freeze(st, lim=warm))
    runner, _alive = r_segment_runner(ref, dims, faults=rflags,
                                      monitor_keys=mk)
    want, _any = runner(jax.tree_util.tree_map(jnp.asarray, start),
                        jax.tree_util.tree_map(jnp.asarray, ctx),
                        np.int32(lim))
    want = jax.tree_util.tree_map(np.asarray, want)
    st = carry.to_torch(start, "cpu")
    planes = _in_place_planes(st, flag_bits(pflags))
    for _ in range(64):
        st, _running = frozen_step(port, dims, st, pctx, lim, False, pflags,
                                   mk)
    assert all(x is y for x, y in zip(
        _in_place_planes(st, flag_bits(pflags)), planes))
    assert not bool(Cap(st, pctx, lim, flag_bits(pflags)).running().any())
    got = carry.to_numpy(st)
    if mk:
        live = lane_live(st, pctx, flag_bits(pflags))
        derived = mon_finalize_plain(st, pctx, flag_bits(pflags),
                                     getattr(port, "MONITOR_ORDER", True))
        for k, v in zip(MON_FINAL, derived):
            got[k] = np.where(live.numpy(), got[k], v.numpy())
        assert got["mon_cnt"].sum() > start["mon_cnt"].sum()
    _assert_tree_equal(want, got)
    assert (want["steps"][::3] == start["steps"][::3]).all()
    assert (want["steps"] == lim).sum() >= 1
