"""Partial-replication lanes in mixed batches through the port on the
CPU, against the reference (``engine/hetero.py prepare_batch`` and
``build_grid_skeleton``, which take ``tempo@2shards`` and
``atlas@2shards`` groups, ``engine/dims.py SKELETON_GRIDS``):

- the grid skeletons of ``tempo-mixed`` (Tempo, Tempo partial) and
  ``full-grid`` (the six engine protocols and both partial twins) are
  the reference's, plane by plane, fingerprint and all;
- a small batch mixing Tempo, Tempo partial and Atlas partial lanes
  (n = 3, 2 shards, 2 keys a command, 2 commands a client) gives each
  lane the reference's homogeneous ``to_json()`` and the port's
  homogeneous run's (in the slow tier also in 64-step segments, 4 a
  window; ``tests/test_torch_checkpoint.py``'s resume case runs the
  batch in 8-step segments, one a window, in tier 1);
- the grouped state equals the homogeneous groups' state after each of
  64 steps, plane by plane;
- (slow) the reference's own ``run_sweep(hetero=True)`` over the same
  lanes, which its tests never run with ``@2shards`` groups mixed.

The CPU runs the device loop's plain twin over the grouped trees."""

import functools
import json

import pytest
import torch

from fantoch_tpu.core import Config as RConfig
from fantoch_tpu.core import Planet as RPlanet
from fantoch_tpu.engine import EngineDims as RDims
from fantoch_tpu.engine import hetero as rhetero
from fantoch_tpu.engine import make_lane as rmake_lane
from fantoch_tpu.engine import protocols as rprotocols
from fantoch_tpu.engine import skeleton as rskeleton
from fantoch_tpu.engine.dims import SKELETON_GRIDS
from fantoch_tpu.parallel import sweep as rsweep
from fantoch_tpu_torch.core import Config, Planet
from fantoch_tpu_torch.engine import EngineDims, hetero, make_lane
from fantoch_tpu_torch.engine import protocols as pprotocols
from fantoch_tpu_torch.engine.core import frozen_step
from fantoch_tpu_torch.kernels.step_loop import clone_tree
from fantoch_tpu_torch.parallel import sweep
from torch_threads import one_torch_thread  # noqa: F401

COMMANDS = 2
MAX = 1 << 20
STEPS = 64
AUDITS = ("tempo", "tempo@2shards", "atlas@2shards")
CONFLICTS = (100, 10)

REF = (RConfig, RPlanet, RDims, rprotocols, rmake_lane)
PORT = (Config, Planet, EngineDims, pprotocols, make_lane)


def _build(pkg, audit, conflict=100):
    """One lane of ``audit`` (a protocol name, ``<name>@2shards`` its
    partial twin at 2 shards, 2 keys a command from a pool of 4, the
    reference CLI's shard config) at n = 3, one client a region."""
    cfg, planet_cls, dims_cls, protos, mk = pkg
    planet = planet_cls.new()
    n = clients = 3
    regions = planet.regions()[:n]
    total = COMMANDS * clients
    name, _, shards = audit.partition("@")
    config = cfg(**protos.dev_config_kwargs(name, n, 1))
    if shards:
        pool = 4
        dev = protos.partial_dev_protocol(name, clients, 2, keys_per_cmd=2,
                                          pool_size=pool)
        dims = dims_cls.for_partial(dev, n, clients, total, regions=n)
        config = config.with_(
            shard_count=2, executor_executed_notification_interval_ms=100,
            executor_cleanup_interval_ms=100)
    else:
        pool = 1
        dev = protos.dev_protocol(name, clients)
        dims = dims_cls.for_protocol(
            dev, n=n, clients=clients, payload=dev.payload_width(n),
            total_commands=total, dot_slots=total + 1, regions=n)
    spec = mk(dev, planet, config, conflict_rate=conflict, pool_size=pool,
              commands_per_client=COMMANDS, clients_per_region=1,
              process_regions=regions, client_regions=regions, dims=dims)
    return dev, dims, spec


@functools.lru_cache(maxsize=None)
def _grid(pkg, audits=AUDITS):
    """``(protocols, dims, specs, mixed)``: each audit's lanes at
    :data:`CONFLICTS`, and the mixed list interleaved point by point."""
    protocols, dims, specs = {}, {}, {}
    for a in audits:
        for conflict in CONFLICTS:
            protocols[a], dims[a], spec = _build(pkg, a, conflict)
            specs.setdefault(a, []).append(spec)
    mixed = [(a, specs[a][i]) for i in range(len(CONFLICTS)) for a in audits]
    return protocols, dims, specs, mixed


def _blob(r) -> str:
    return json.dumps(r.to_json(), sort_keys=True)


def _interleave(by_audit, audits=AUDITS):
    return [by_audit[a][i] for i in range(len(CONFLICTS)) for a in audits]


@pytest.fixture(scope="module")
def reference_homogeneous():
    """The reference's homogeneous ``run_sweep`` of each audit's lanes,
    in the mixed list's order, once."""
    protocols, dims, specs, _mixed = _grid(REF)
    runs = {a: [_blob(r) for r in rsweep.run_sweep(
        protocols[a], dims[a], specs[a], max_steps=MAX, segment_steps=4096)]
        for a in AUDITS}
    return _interleave(runs)


@functools.lru_cache(maxsize=None)
def _port_homogeneous():
    protocols, dims, specs, _mixed = _grid(PORT)
    runs = {a: [_blob(r) for r in sweep.run_sweep(
        protocols[a], dims[a], specs[a], device="cpu", max_steps=MAX,
        segment_steps=4096)] for a in AUDITS}
    return _interleave(runs)


# ----------------------------------------------------------------------
# the skeletons
# ----------------------------------------------------------------------

@pytest.mark.parametrize("grid", ["tempo-mixed", "full-grid"])
def test_grid_skeleton_is_the_references(grid):
    audits = SKELETON_GRIDS[grid]["audits"]
    reps = {}
    for pkg in (REF, PORT):
        built = {a: _build(pkg, a) for a in audits}
        reps[pkg] = ({a: b[0] for a, b in built.items()},
                     {a: b[1] for a, b in built.items()},
                     {a: b[2] for a, b in built.items()})
    rsk, _nspec = rhetero.build_grid_skeleton(*reps[REF], batch_lanes=512)
    sk = hetero.build_grid_skeleton(*reps[PORT], device="cpu")
    assert sk.audits == rsk.audits == tuple(sorted(audits))
    assert sk.planes == rsk.planes
    assert hetero.skeleton_fingerprint(sk) == \
        rskeleton.skeleton_fingerprint(rsk)
    # the skeleton classifies the partial groups' own planes
    assert "ctx.cmd_skey" in sk.planes
    assert sorted(sk.planes["ctx.cmd_skey"]["native"]) == sorted(
        a for a in audits if "@" in a)


def test_mixed_batch_skeleton_is_the_references():
    rhb = rhetero.prepare_batch(*_grid(REF)[:2], _grid(REF)[3])[0]
    hb, state, ctx, lanes = hetero.prepare_batch(
        *_grid(PORT)[:2], _grid(PORT)[3], "cpu")
    assert hb.fingerprint == rskeleton.skeleton_fingerprint(rhb.skeleton)
    assert list(state) == list(lanes) == sorted(AUDITS)
    # each group's own rows: S·n process rows on the partial lanes
    assert state["tempo"]["next_periodic"].shape[1] == 3
    for a in ("tempo@2shards", "atlas@2shards"):
        assert state[a]["next_periodic"].shape[1] == 6
        assert "cmd_target" in ctx[a] and "cmd_target" not in ctx["tempo"]


# ----------------------------------------------------------------------
# results against the reference's and the port's homogeneous runs
# ----------------------------------------------------------------------

def test_mixed_partial_batch_equals_the_reference(reference_homogeneous):
    protocols, dims, _specs, mixed = _grid(PORT)
    got = [_blob(r) for r in sweep.run_sweep(
        protocols, dims, mixed, hetero=True, device="cpu", max_steps=MAX)]
    assert got == reference_homogeneous
    assert got == _port_homogeneous()
    assert all(not json.loads(g)["err"] for g in got)


@pytest.mark.slow
def test_mixed_partial_batch_in_segments():
    """64-step segments, 4 a window, one window in flight (one a window
    is ``tests/test_torch_checkpoint.py``'s resume case, in tier 1)."""
    protocols, dims, _specs, mixed = _grid(PORT)
    got = [_blob(r) for r in sweep.run_sweep(
        protocols, dims, mixed, hetero=True, device="cpu", max_steps=MAX,
        segment_steps=64, scan_window=4, pipeline_depth=1)]
    assert got == _port_homogeneous()


def _assert_equal(want, got, path=""):
    if isinstance(want, dict):
        assert sorted(want) == sorted(got), path
        for k in want:
            _assert_equal(want[k], got[k], f"{path}/{k}")
        return
    assert want.dtype == got.dtype and want.shape == got.shape, path
    assert torch.equal(want, got), path


def test_whole_grouped_state_after_each_step():
    """The grouped step (``hetero_frozen_step``) against each group's
    native ``frozen_step`` on its own copy, 64 steps."""
    protocols, dims, _specs, mixed = _grid(PORT)
    hb, state, ctx, _lanes = hetero.prepare_batch(protocols, dims, mixed,
                                                  "cpu")
    homo = {a: clone_tree(state[a]) for a in state}
    st = clone_tree(state)
    for step in range(STEPS):
        st, running = hetero.hetero_frozen_step(hb, st, ctx, MAX)
        for a in homo:
            homo[a], run_a = frozen_step(protocols[a], dims[a], homo[a],
                                         ctx[a], MAX)
            _assert_equal(homo[a], st[a], f"step {step} {a}")
            assert torch.equal(run_a, running[a]), f"step {step} {a}"


@pytest.mark.slow
def test_reference_hetero_run_over_partial_groups(reference_homogeneous):
    """The reference's ``run_sweep(hetero=True)`` over the same mixed
    lanes: its lanes equal its homogeneous runs."""
    protocols, dims, _specs, mixed = _grid(REF)
    got = [_blob(r) for r in rsweep.run_sweep(
        protocols, dims, mixed, hetero=True, max_steps=MAX,
        segment_steps=4096)]
    assert got == reference_homogeneous
