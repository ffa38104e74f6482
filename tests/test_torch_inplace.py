"""The in-place contract of K2 (``land_emissions``), K4
(``basic_handle``), K5 (``fpaxos_handle``), K9 (``graphdep_handle``),
K10 (``caesar_handle``), K11 (``tempo_partial_handle``) and K12
(``atlas_partial_handle``) on the CPU, through their plain twins.

A step consumes its input state: K2 writes the pool, and the Basic,
FPaxos, Atlas/EPaxos, Caesar, Tempo partial and Atlas partial handlers
their process state, in place, on the lanes whose run predicate holds
at the step's start (``kernels/lane_freeze.py Cap``), and return the
very tensors they were given. No runner consumes its caller's state.
All comparisons are exact. The batches are the reference's tier-1 sweep
shapes (n = 3, 4 region subsets x conflict 0 and 100, f = 1, one client
a region) at 40 commands a client, and under partial replication (Tempo
and Atlas) the partial golden batches' shapes
(tests/test_torch_tempo_partial.py, tests/test_torch_atlas_partial.py:
2 shards, a pool of 4, 2 keys a command) over the same subsets at
conflict 10 and 100, so every lane still runs at step 300 (Atlas
partial at step 100: its lane at conflict 10 on the third subset ends in
ERR_CAPACITY at step 155, as the reference's does, so its warm-up is
:data:`WARMUP_ATLAS_PARTIAL` steps):

- (a) each twin on the arguments of step 301, with every third lane's
  error word set and a step cap that stops half the lanes: running
  lanes equal the out-of-place arithmetic the twins computed before
  the in-place contract, recomputed here from a copy, frozen lanes'
  in-place planes are bit for bit as before, the planes returned are
  the ones given, and a frozen lane's ``rdy`` is false and its outboxes
  empty;
- (b) 64 ``frozen_step``s with those lanes frozen against the
  reference's vmapped run loop (its ``build_segment_runner``), whole
  state, for Basic, FPaxos, Tempo, Caesar, Tempo partial, Atlas, EPaxos
  and Atlas partial;
- (c) a mixed batch of all six protocols with lanes frozen the same way
  equals its homogeneous runs, whole state;
- (d) the runners (eager, window, ``run_sweep``, the mixed eager
  runner) run twice on one prepared batch give equal results and leave
  the batch as it was;
- (e) ``work`` on a snapshot taken before the call equals its value on
  the out-of-place arithmetic's result."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fantoch_tpu.core import Config as RConfig
from fantoch_tpu.core import Planet as RPlanet
from fantoch_tpu.engine import EngineDims as RDims
from fantoch_tpu.engine import make_lane as r_make_lane
from fantoch_tpu.engine import protocols as rprotocols
from fantoch_tpu.engine.core import build_segment_runner as r_segment_runner
from fantoch_tpu.engine.core import key_table_fn
from fantoch_tpu.engine.driver import stack_states
from fantoch_tpu.engine.spec import stack_lanes as r_stack_lanes
from fantoch_tpu.parallel import sweep as rsweep
from fantoch_tpu_torch import carry, cli
from fantoch_tpu_torch.core import Config, Planet
from fantoch_tpu_torch.engine import EngineDims, hetero, make_lane
from fantoch_tpu_torch.engine import core as engine_core
from fantoch_tpu_torch.engine import protocols as pprotocols
from fantoch_tpu_torch.engine.core import (
    build_eager_runner, build_runner, frozen_step,
)
from fantoch_tpu_torch.engine.dims import ERR_POOL, ERR_STUCK, INF, PA, PMT
from fantoch_tpu_torch.engine.driver import prepare_batch
from fantoch_tpu_torch.engine.protocols import (
    AtlasDev, BasicDev, CaesarDev, FPaxosDev,
)
from fantoch_tpu_torch.kernels.lane_freeze import Cap
from fantoch_tpu_torch.kernels.step_loop import clone_tree
from fantoch_tpu_torch.parallel import sweep
from torch_threads import one_torch_thread  # noqa: F401

COMMANDS = 40
WARMUP = 300
# Atlas partial's warm-up: one of its lanes fills a dep table (ERR_CAPACITY,
# as the reference's) at step 155, and every lane must still run after it
WARMUP_ATLAS_PARTIAL = 100
REF = (RConfig, RPlanet, RDims, rprotocols, rsweep, r_make_lane)
PORT = (Config, Planet, EngineDims, pprotocols, sweep, make_lane)
MAX_STEPS = 1 << 22
# the kernel modules (the package exports each wrapper under its name)
k2 = importlib.import_module("fantoch_tpu_torch.kernels.land_emissions")
k10 = importlib.import_module("fantoch_tpu_torch.kernels.caesar_handle")
k4 = importlib.import_module("fantoch_tpu_torch.kernels.basic_handle")
k11 = importlib.import_module(
    "fantoch_tpu_torch.kernels.tempo_partial_handle")
k9 = importlib.import_module("fantoch_tpu_torch.kernels.graphdep_handle")
k5 = importlib.import_module("fantoch_tpu_torch.kernels.fpaxos_handle")
k12 = importlib.import_module(
    "fantoch_tpu_torch.kernels.atlas_partial_handle")
# the in-place handler kernels by name, with their modules
HANDLERS = {"caesar_handle": k10, "basic_handle": k4,
            "tempo_partial_handle": k11, "graphdep_handle": k9,
            "fpaxos_handle": k5, "atlas_partial_handle": k12}


def _partial_specs(pkg, name, commands=COMMANDS):
    """Tempo or Atlas (``name``) under partial replication at the partial
    golden batches' shapes (tests/test_torch_tempo_partial.py
    ``golden_batches``, tests/test_torch_atlas_partial.py
    ``golden_batch``: n = 3, 2 shards, a pool of 4, 2 keys a command,
    K = pool + n + 1): 4 region subsets x conflict 10 and 100, f = 1, one
    client a region."""
    cfg, planet_cls, dims_cls, protos, _sweep, make = pkg
    planet = planet_cls.new()
    regions = planet.regions()
    cls = (protos.TempoPartialDev if name == "tempo_partial"
           else protos.AtlasPartialDev)
    dev = cls(keys=4 + 3 + 1, shards=2, keys_per_cmd=2)
    dims = dims_cls.for_partial(dev, 3, 3, commands * 3, regions=3)
    detached = ({"tempo_detached_send_interval_ms": 100}
                if name == "tempo_partial" else {})
    config = cfg(n=3, f=1, shard_count=2, gc_interval_ms=100,
                 executor_executed_notification_interval_ms=100,
                 executor_cleanup_interval_ms=100, **detached)
    specs = [make(dev, planet, config, conflict_rate=conflict, pool_size=4,
                  commands_per_client=commands, clients_per_region=1,
                  process_regions=regions[i:i + 3],
                  client_regions=regions[i:i + 3], dims=dims)
             for i in range(4) for conflict in (10, 100)]
    return dev, dims, specs


def _specs(pkg, name, commands=COMMANDS):
    """The reference's tier-1 sweep shapes (test_scan_window.py
    ``_specs``): 4 region subsets x conflict 0 and 100, f = 1, n = 3,
    one client a region; :func:`_partial_specs` for Tempo and Atlas
    partial."""
    if name in ("tempo_partial", "atlas_partial"):
        return _partial_specs(pkg, name, commands)
    cfg, planet_cls, dims_cls, protos, sweep_mod, _make = pkg
    planet = planet_cls.new()
    regions = planet.regions()
    clients, total = 3, commands * 3
    dev = protos.dev_protocol(name, clients)
    dims = dims_cls.for_protocol(
        dev, n=3, clients=clients, payload=dev.payload_width(3),
        total_commands=total, dot_slots=total + 1, regions=3,
    )
    specs = sweep_mod.make_sweep_specs(
        dev, planet, region_sets=[regions[i:i + 3] for i in range(4)],
        fs=[1], conflicts=[0, 100], commands_per_client=commands,
        clients_per_region=1, dims=dims,
        config_base=cfg(**protos.dev_config_kwargs(name, 3, 1)),
        pool_size=1,
    )
    return dev, dims, specs


def _assert_tree_equal(want, got, path=""):
    if isinstance(want, dict):
        assert sorted(want) == sorted(got), path
        for k in want:
            _assert_tree_equal(want[k], got[k], f"{path}/{k}")
        return
    a, b = np.asarray(want), np.asarray(got)
    assert a.dtype == b.dtype and a.shape == b.shape, path
    if not np.array_equal(a, b):
        bad = np.argwhere(a != b)[:5].tolist()
        raise AssertionError(f"{path} differs at {bad}")


def _freeze(st, lim=None):
    """``st`` with every third lane's error word set (ERR_STUCK) and, for
    a cap ``lim``, every other lane one step behind it: the others are
    stopped by the cap."""
    st = dict(st, err=st["err"].clone())
    st["err"][::3] |= ERR_STUCK
    if lim is not None:
        st["steps"] = st["steps"].clone()
        st["steps"][::2] = lim - 1
        st["steps"][1::2] = lim
    return st


@functools.lru_cache(maxsize=None)
def _batch(name):
    """The reference's initial state and ctx (numpy, its key table as its
    sweep computes it), its protocol and dims, and the port's."""
    rdev, rdims, rspecs = _specs(REF, name)
    ctx = r_stack_lanes(rspecs)
    T = int(max(2, ctx["cmd_budget"].max() + 2))
    kctx = {k: jnp.asarray(ctx[k]) for k in
            ("rng_key", "conflict_rate", "pool_size", "key_gen_kind",
             "zipf_cum")}
    ctx["key_table"] = np.asarray(jax.vmap(key_table_fn(rdims.C, T))(kctx))
    state = stack_states(rdev, rdims, rspecs)
    pdev, pdims, _ = _specs(PORT, name)
    return rdev, rdims, state, ctx, pdev, pdims


def _warmup(name):
    """The run-loop steps before the checked step of batch ``name``."""
    return WARMUP_ATLAS_PARTIAL if name == "atlas_partial" else WARMUP


@functools.lru_cache(maxsize=None)
def _step_301(name):
    """The port's batch after :func:`_warmup` run-loop steps (numpy), and
    the arguments of the next step's K2 and handler calls, copied before
    each call."""
    _rdev, _rdims, state, ctx, pdev, pdims = _batch(name)
    pctx = carry.to_torch(ctx, "cpu")
    st = carry.to_torch(state, "cpu")
    for _ in range(_warmup(name)):
        st, _running = frozen_step(pdev, pdims, st, pctx, MAX_STEPS)
    assert bool(_running.all()), "every lane must still run after warm-up"
    st300 = carry.to_numpy(st)
    calls = {}

    def recorder(fn, key, in_place):
        def wrapped(*a):
            calls[key] = (a[:in_place] + (clone_tree(a[in_place]),)
                          + a[in_place + 1:])
            return fn(*a)
        wrapped.launches = 0
        return wrapped

    saved = {k: getattr(m, k) for k, m in HANDLERS.items()}
    saved_k2 = engine_core.land_emissions
    engine_core.land_emissions = recorder(saved_k2, "land_emissions", 0)
    for k, m in HANDLERS.items():
        setattr(m, k, recorder(saved[k], k, 0))
    try:
        frozen_step(pdev, pdims, st, pctx, MAX_STEPS)
    finally:
        engine_core.land_emissions = saved_k2
        for k, m in HANDLERS.items():
            setattr(m, k, saved[k])
    return st300, pctx, calls


# ----------------------------------------------------------------------
# the twins' out-of-place arithmetic, before the in-place contract
# ----------------------------------------------------------------------

def _land_out_of_place(pool, arrival, deliver, new_rows, pool_peak, err):
    """K2's twin as PR 12 computed it: a new pool."""
    L, M, W = pool.shape
    rank = torch.cumsum(deliver, dim=1, dtype=torch.int32)
    free = arrival == INF
    free_cum = torch.cumsum(free, dim=1, dtype=torch.int32)
    target = torch.searchsorted(free_cum, rank).to(torch.int32)
    n_free = free.sum(1, dtype=torch.int32)
    n_del = deliver.sum(1, dtype=torch.int32)
    out = pool.clone()
    out[..., PA] = arrival
    li, ei = torch.nonzero(deliver & (target < M), as_tuple=True)
    out[li, target[li, ei].long()] = new_rows[li, ei]
    overflow = n_del > n_free
    return (out, overflow, torch.maximum(pool_peak, M - n_free + n_del),
            err | ERR_POOL * overflow.to(torch.int32))


def _caesar_out_of_place(ps, has, rows, fire, ctx, dims):
    """K10's twin as PR 12 computed it: a new state tree."""
    X = CaesarDev
    none = torch.full_like(rows[..., PMT], X.NUM_TYPES)
    mtype0 = torch.where(has, rows[..., PMT], none)
    rdy = X.ready_plain(ps, rows, mtype0, dims)
    mtype = torch.where(has & rdy, mtype0, none)
    new, pout = X.periodic_plain(ps, fire, ctx, dims)
    new, hout = X.handle_plain(new, mtype, rows, ctx, dims)
    return rdy, new, pout, hout


def _basic_out_of_place(ps, has, rows, fire, ctx, dims):
    """K4's twin out of place: a new state tree."""
    X = BasicDev
    none = torch.full_like(rows[..., PMT], X.NUM_TYPES)
    mtype0 = torch.where(has, rows[..., PMT], none)
    rdy = X.ready_plain(ps, rows, mtype0, dims)
    valid = has & rdy
    mtype = torch.where(valid, mtype0, none)
    pout = X.periodic_plain(ps, fire, ctx["n"], dims)
    new, hout = X.handle_plain(ps, valid, mtype, rows, ctx["n"],
                               ctx["quorum"], ctx["q_size"], dims)
    return rdy, new, pout, hout


def _graphdep_out_of_place(ps, has, rows, fire, ctx, dims):
    """K9's twin out of place: a new state tree."""
    X = AtlasDev
    none = torch.full_like(rows[..., PMT], X.NUM_TYPES)
    mtype0 = torch.where(has, rows[..., PMT], none)
    rdy = X.ready_plain(ps, rows, mtype0, dims)
    mtype = torch.where(has & rdy, mtype0, none)
    new, pout = X.periodic_plain(ps, fire, ctx, dims)
    new, hout = X.handle_plain(new, mtype, rows, ctx, dims)
    return rdy, new, pout, hout


def _tempo_partial_out_of_place(ps, has, rows, fire, now, ctx, dims):
    """K11's twin out of place: a new state tree."""
    X = k11._protocol(ps, ctx)
    none = torch.full_like(rows[..., PMT], X.NUM_TYPES)
    mtype0 = torch.where(has, rows[..., PMT], none)
    rdy = X.ready_plain(ps, rows, mtype0, dims)
    mtype = torch.where(has & rdy, mtype0, none)
    new, pout = X.periodic_plain(ps, fire, now, ctx, dims)
    new, hout = X.handle_plain(new, mtype, rows, ctx, dims)
    return rdy, new, pout, hout


def _fpaxos_out_of_place(ps, has, rows, fire, ctx, dims):
    """K5's twin out of place: a new state tree."""
    X = FPaxosDev
    none = torch.full_like(rows[..., PMT], X.NUM_TYPES)
    mtype0 = torch.where(has, rows[..., PMT], none)
    rdy = X.ready_plain(ps, rows, mtype0, dims)
    valid = has & rdy
    mtype = torch.where(valid, mtype0, none)
    pout = X.periodic_plain(ps, fire, ctx["n"], dims)
    new, hout = X.handle_plain(ps, valid, mtype, rows, ctx, dims)
    return rdy, new, pout, hout


def _atlas_partial_out_of_place(ps, has, rows, fire, ctx, dims):
    """K12's twin out of place: a new state tree."""
    X = k12._protocol(ps, ctx)
    none = torch.full_like(rows[..., PMT], X.NUM_TYPES)
    mtype0 = torch.where(has, rows[..., PMT], none)
    rdy = X.ready_plain(ps, rows, mtype0, dims)
    mtype = torch.where(has & rdy, mtype0, none)
    new, pout = X.periodic_plain(ps, fire, ctx, dims)
    new, hout = X.handle_plain(new, mtype, rows, ctx, dims)
    return rdy, new, pout, hout


# each in-place handler's out-of-place arithmetic
OUT_OF_PLACE = {"caesar_handle": _caesar_out_of_place,
                "basic_handle": _basic_out_of_place,
                "tempo_partial_handle": _tempo_partial_out_of_place,
                "graphdep_handle": _graphdep_out_of_place,
                "fpaxos_handle": _fpaxos_out_of_place,
                "atlas_partial_handle": _atlas_partial_out_of_place}


# ----------------------------------------------------------------------
# (a) the twins with frozen lanes
# ----------------------------------------------------------------------

CASES = [("basic", "land_emissions"), ("tempo", "land_emissions"),
         ("caesar", "land_emissions"), ("caesar", "caesar_handle"),
         ("basic", "basic_handle"),
         ("tempo_partial", "tempo_partial_handle"),
         ("atlas", "graphdep_handle"), ("epaxos", "graphdep_handle"),
         ("fpaxos", "fpaxos_handle"),
         ("atlas_partial", "atlas_partial_handle")]


@pytest.mark.parametrize("name,kname", CASES)
def test_twin_updates_running_lanes_in_place(name, kname):
    st300, pctx, calls = _step_301(name)
    a = calls[kname]
    st = _freeze(carry.to_torch(st300, "cpu"), lim=_warmup(name))
    cap = Cap(st, pctx, _warmup(name), 0)
    run = cap.running()
    frozen = ~run
    assert int(run.sum()) >= 2 and int(frozen.sum()) >= 4, run
    before = clone_tree(a[0])
    given = clone_tree(a[0])
    if kname == "land_emissions":
        got = k2.land_emissions_plain(given, *a[1:-1], cap)
        want = _land_out_of_place(clone_tree(a[0]), *a[1:6])
        ours, new = {"pool": got[0]}, {"pool": want[0]}
        assert got[0] is given
        befores, givens = {"pool": before}, {"pool": given}
        outs = [(got[i], want[i], dflt) for i, dflt in
                ((1, torch.zeros_like(want[1])), (2, a[4]), (3, a[5]))]
        assert torch.equal(got[4], run)  # K2 reports the predicate
    else:
        twin = getattr(HANDLERS[kname], kname + "_plain")
        got = twin(given, *a[1:-1], cap)
        want = OUT_OF_PLACE[kname](clone_tree(a[0]), *a[1:-1])
        ours, new, befores, givens = got[1], want[1], before, given
        assert all(got[1][k] is given[k] for k in given)
        outs = [(got[0], want[0], torch.zeros_like(want[0]))]
        empty = engine_core.empty_outbox(a[-2], a[2].shape[:2], "cpu")
        for g, w in zip(got[2:], want[2:]):
            outs += [(g[k], w[k], empty[k]) for k in w]
    for k in befores:
        o, w, b = ours[k], new[k], befores[k]
        assert torch.equal(o[frozen], b[frozen]), f"{k}: a frozen lane moved"
        assert torch.equal(o[run], w[run]), f"{k}: a running lane differs"
    moved = sum(int((ours[k][run] != befores[k][run]).sum()) for k in ours)
    assert moved > 0, "no running lane changed"
    for g, w, dflt in outs:
        lead = run.reshape(run.shape + (1,) * (w.dim() - 1))
        assert torch.equal(g, torch.where(lead, w, dflt.expand_as(w)))


# ----------------------------------------------------------------------
# (b) 64 frozen steps against the reference's run loop
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["basic", "tempo", "caesar",
                                  "tempo_partial", "atlas", "epaxos",
                                  "fpaxos", "atlas_partial"])
def test_frozen_steps_match_the_reference_run_loop(name):
    """From the port's state after 300 steps (Atlas partial 100), every
    third lane failed and every other lane one step behind the cap at 363
    (163): 64 ``frozen_step``s of the port and the reference's segment
    runner to the cap end in the same whole state (the lanes one step
    ahead stop at the cap one step early)."""
    rdev, rdims, _state, ctx, pdev, pdims = _batch(name)
    st300, pctx, _calls = _step_301(name)
    lim = _warmup(name) + 63
    start = carry.to_numpy(_freeze(carry.to_torch(st300, "cpu"),
                                   lim=_warmup(name)))
    runner, _alive = r_segment_runner(rdev, rdims)
    want, _any = runner(jax.tree_util.tree_map(jnp.asarray, start),
                        jax.tree_util.tree_map(jnp.asarray, ctx),
                        np.int32(lim))
    want = jax.tree_util.tree_map(np.asarray, want)
    st = carry.to_torch(start, "cpu")
    pool = st["pool"]
    for _ in range(64):
        st, _running = frozen_step(pdev, pdims, st, pctx, lim)
    assert st["pool"] is pool  # one pool, updated in place throughout
    assert not bool(Cap(st, pctx, lim).running().any())
    _assert_tree_equal(want, carry.to_numpy(st))
    assert (want["steps"][::3] == start["steps"][::3]).all()
    assert (want["steps"] == lim).sum() >= 2


# ----------------------------------------------------------------------
# (c) a mixed batch with frozen lanes against its homogeneous runs
# ----------------------------------------------------------------------

SIX = ["sweep", "--protocol", "basic,fpaxos,tempo,atlas,epaxos,caesar",
       "--n", "3", "--subsets", "2", "--fs", "1", "--commands", "3",
       "--conflicts", "0,100"]


def _one(argv, name):
    out = list(argv)
    out[out.index("--protocol") + 1] = name
    return out


def test_mixed_batch_with_frozen_lanes_equals_homogeneous_runs():
    """Six protocols, 4 lanes each: after 20 steps every third lane of
    each group fails; the mixed batch's eager runner and each protocol's
    own eager runner then end in the same lane states."""
    protocols, dims, mixed = cli.hetero_setup(cli.parse_args(SIX))
    hb, state, ctx, _lanes = hetero.prepare_batch(protocols, dims, mixed,
                                                  "cpu")
    for _ in range(20):
        state, _r = hetero.hetero_frozen_step(hb, state, ctx, MAX_STEPS)
    for t in state.values():
        t["err"][::3] |= ERR_STUCK
    mixed_final = hetero.build_hetero_eager_runner(hb)(state, ctx)
    for name in protocols:
        proto, pdims, specs = cli.sweep_setup(cli.parse_args(_one(SIX,
                                                                  name)))
        st, cx = prepare_batch(proto, pdims, specs, "cpu")
        for _ in range(20):
            st, _r = frozen_step(proto, pdims, st, cx, MAX_STEPS)
        st["err"][::3] |= ERR_STUCK
        final = build_eager_runner(proto, pdims)(st, cx)
        _assert_tree_equal(carry.to_numpy(final),
                           carry.to_numpy(mixed_final[name]), name)
        assert (final["err"][::3] & ERR_STUCK).all()


# ----------------------------------------------------------------------
# (d) no runner consumes its caller's state
# ----------------------------------------------------------------------

def _small(name):
    pdev, pdims, specs = _specs(PORT, name, commands=2)
    return pdev, pdims, specs


@pytest.mark.parametrize("name", ["tempo", "caesar", "atlas"])
def test_runners_twice_on_one_prepared_batch(name):
    """The eager runner and the window runner (``build_runner``), each
    run twice on one prepared batch, give one result, equal to each
    other's, and leave the batch as it was."""
    pdev, pdims, specs = _small(name)
    state, ctx = prepare_batch(pdev, pdims, specs, "cpu")
    before = carry.to_numpy(state)
    finals = [carry.to_numpy(run(state, ctx))
              for run in (build_eager_runner(pdev, pdims),
                          build_runner(pdev, pdims)) for _ in range(2)]
    _assert_tree_equal(before, carry.to_numpy(state))
    for f in finals[1:]:
        _assert_tree_equal(finals[0], f)
    assert int(finals[0]["clients"]["completed"].sum()) == 2 * 3 * 8


def test_run_sweep_and_mixed_runner_twice():
    """``run_sweep`` twice on one list of lanes gives the same
    ``to_json``; the mixed eager runner twice on one prepared mixed
    batch gives the same state and leaves the batch as it was."""
    pdev, pdims, specs = _small("caesar")
    blobs = [[r.to_json() for r in sweep.run_sweep(pdev, pdims, specs,
                                                    device="cpu")]
             for _ in range(2)]
    assert blobs[0] == blobs[1]
    argv = _one(SIX, "basic,caesar")
    protocols, dims, mixed = cli.hetero_setup(cli.parse_args(argv))
    hb, state, ctx, _lanes = hetero.prepare_batch(protocols, dims, mixed,
                                                  "cpu")
    before = carry.to_numpy(state)
    run = hetero.build_hetero_eager_runner(hb)
    a, b = (carry.to_numpy(run(state, ctx)) for _ in range(2))
    _assert_tree_equal(a, b)
    _assert_tree_equal(before, carry.to_numpy(state))


# ----------------------------------------------------------------------
# (e) work on a snapshot
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["basic", "tempo", "caesar"])
def test_land_emissions_work_on_a_snapshot_equals_pr12(name):
    """K2's ``work`` on the pool copied before the call equals PR 12's
    (the out-of-place call's)."""
    _st300, _pctx, calls = _step_301(name)
    a = calls["land_emissions"]
    # K2 also writes ``running``, every lane true here
    want = k2.work(*a[:6], _land_out_of_place(*a[:6])
                   + (torch.ones(a[0].shape[0], dtype=torch.bool),))
    pool = clone_tree(a[0])
    out = k2.land_emissions(pool, *a[1:])
    assert out[0] is pool
    assert k2.work(*a, out) == want


def test_caesar_handle_work_on_a_snapshot_equals_pr12():
    """K10's ``work`` on the state copied before the call equals PR
    12's (the out-of-place call's)."""
    _st300, _pctx, calls = _step_301("caesar")
    a = calls["caesar_handle"]
    want = k10.work(*a[:6], _caesar_out_of_place(*a[:6]))
    ps = clone_tree(a[0])
    out = k10.caesar_handle(ps, *a[1:])
    assert all(out[1][k] is ps[k] for k in ps)
    assert k10.work(*a, out) == want


@pytest.mark.parametrize("name,kname", [("basic", "basic_handle"),
                                        ("tempo_partial",
                                         "tempo_partial_handle"),
                                        ("atlas", "graphdep_handle"),
                                        ("epaxos", "graphdep_handle"),
                                        ("fpaxos", "fpaxos_handle"),
                                        ("atlas_partial",
                                         "atlas_partial_handle")])
def test_handler_work_on_a_snapshot_equals_out_of_place(name, kname):
    """K4's, K5's, K9's, K11's and K12's ``work`` on the state copied
    before the call equals its value on the out-of-place arithmetic's
    result."""
    _st300, _pctx, calls = _step_301(name)
    a = calls[kname]
    mod = HANDLERS[kname]
    want = mod.work(*a[:-1], OUT_OF_PLACE[kname](*a[:-1]))
    ps = clone_tree(a[0])
    out = getattr(mod, kname)(ps, *a[1:])
    assert all(out[1][k] is ps[k] for k in ps)
    assert mod.work(*a, out) == want
