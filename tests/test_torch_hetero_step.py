"""A mixed-protocol batch one step at a time: the port's grouped step
(``engine/hetero.py hetero_step``: each group's ``lane_step`` on its own
lanes, through the plain twins on the CPU) against
``jax.jit(jax.vmap(hetero_switch_step(hb)))``, the reference's
``lax.switch`` over every protocol's step on skeleton-packed lanes. The
batch mixes Basic, FPaxos and Tempo lanes (the reference test's shapes:
n = 3, 2 commands a client, conflict 100 and 0), starts from the
reference's own packed state and ctx carried across
(``carry.packed_to_groups``), and after each of 64 steps the port's
groups packed back (``carry.groups_to_packed``) equal the reference's
packed state, leaf by leaf.

Also the grouped layout the device loop relies on
(``kernels/step_loop.py``): each group's liveness planes are views of one
``[L]`` buffer a plane, a copy stays linked, a write into a group's plane
lands in the buffer, an unlinked tree on a device is refused; and the
mixed batch through the segment loop (the window runner) ends in the
whole state of the eager loop (``build_hetero_eager_runner``)."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fantoch_tpu.core import Config as RConfig
from fantoch_tpu.core import Planet as RPlanet
from fantoch_tpu.engine import EngineDims as RDims
from fantoch_tpu.engine import hetero as rhetero
from fantoch_tpu.engine import make_lane as rmake_lane
from fantoch_tpu.engine import protocols as rprotocols
from fantoch_tpu.engine import skeleton as rskeleton
from fantoch_tpu_torch import carry
from fantoch_tpu_torch.core import Config, Planet
from fantoch_tpu_torch.engine import EngineDims, hetero, make_lane
from fantoch_tpu_torch.engine import protocols as pprotocols
from fantoch_tpu_torch.engine import skeleton
from fantoch_tpu_torch.kernels.step_loop import (
    _copy_into, clone_tree, link, live_planes, tree_signature,
)
from fantoch_tpu_torch.parallel import sweep
from torch_threads import one_torch_thread  # noqa: F401

STEPS = 64
COMMANDS = 2
NAMES = ("basic", "fpaxos", "tempo")

REF = (RConfig, RPlanet, RDims, rprotocols, rmake_lane)
PORT = (Config, Planet, EngineDims, pprotocols, make_lane)


def _grid(pkg, names=NAMES):
    """(protocols, dims, mixed): the reference test's ``_grid`` lanes of
    ``names``, conflict 100 and 0 each, interleaved."""
    cfg, planet_cls, dims_cls, protos, mk = pkg
    protocols, dims, specs = {}, {}, {}
    for name in names:
        planet = planet_cls.new()
        regions = planet.regions()[:3]
        dev = protos.dev_protocol(name, 3)
        d = dims_cls.for_protocol(
            dev, n=3, clients=3, payload=dev.payload_width(3),
            total_commands=COMMANDS * 3, dot_slots=COMMANDS * 3 + 1,
            regions=3,
        )
        specs[name] = [
            mk(dev, planet, cfg(**protos.dev_config_kwargs(name, 3, 1)),
               conflict_rate=cf, pool_size=1, commands_per_client=COMMANDS,
               clients_per_region=1, process_regions=regions,
               client_regions=regions, dims=d)
            for cf in (100, 0)
        ]
        protocols[name], dims[name] = dev, d
    mixed = [(n, specs[n][i]) for i in range(2) for n in names]
    return protocols, dims, mixed


def _assert_packed_equal(ref, port, path=""):
    assert sorted(ref) == sorted(port), path
    for k in ref:
        a, b = ref[k], port[k]
        if isinstance(a, dict):
            _assert_packed_equal(a, b, f"{path}/{k}")
            continue
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, k)
        if not np.array_equal(a, b):
            bad = np.argwhere(a != b)[:5].tolist()
            raise AssertionError(f"{path}/{k} differs at {bad}")


@functools.lru_cache(maxsize=None)
def _reference():
    """The reference's mixed batch: its packed state and ctx, and its
    packed state after each of ``STEPS`` switch steps."""
    rp, rd, rmixed = _grid(REF)
    hb, state, ctx, _probes, _nspec = rhetero.prepare_batch(rp, rd, rmixed)
    step = jax.jit(jax.vmap(rhetero.hetero_switch_step(hb)))
    st = jax.tree_util.tree_map(jnp.asarray, state)
    jctx = jax.tree_util.tree_map(jnp.asarray, ctx)
    states = []
    for _ in range(STEPS):
        st = step(st, jctx)
        states.append(jax.tree_util.tree_map(np.asarray, st))
    return hb, state, ctx, states


def _port_batch(hb_ref, state, ctx):
    """The reference's packed batch carried into the port's grouped
    layout under the port's copy of its skeleton."""
    sk = skeleton.build_skeleton(hb_ref.skeleton.planes,
                                 audits=hb_ref.skeleton.audits)
    assert (skeleton.skeleton_fingerprint(sk)
            == rskeleton.skeleton_fingerprint(hb_ref.skeleton))
    pp, pd, _mixed = _grid(PORT)
    hb = hetero.HeteroBatch(sk, pp, pd)
    pst, pcx, lanes = carry.packed_to_groups(sk, state, ctx, "cpu")
    return hb, pst, pcx, lanes


def test_carry_round_trip_is_exact():
    """Packed → grouped → packed gives the reference's trees back, and
    the carried groups equal the port's own batch."""
    hb_ref, state, ctx, _ = _reference()
    hb, pst, pcx, lanes = _port_batch(hb_ref, state, ctx)
    assert lanes == {"basic": [0, 3], "fpaxos": [1, 4], "tempo": [2, 5]}
    _assert_packed_equal(state, carry.groups_to_packed(hb.skeleton, pst,
                                                       lanes))
    _assert_packed_equal(ctx, carry.groups_to_packed(hb.skeleton, pcx, lanes,
                                                     prefix="ctx"))
    pp, pd, pmixed = _grid(PORT)
    own, ost, ocx, olanes = hetero.prepare_batch(pp, pd, pmixed, "cpu")
    assert own.fingerprint == hb.fingerprint and olanes == lanes
    for a in NAMES:
        _assert_packed_equal(carry.to_numpy(pst[a]), carry.to_numpy(ost[a]))
        _assert_packed_equal(carry.to_numpy(pcx[a]), carry.to_numpy(ocx[a]))


def test_whole_packed_state_after_each_step():
    hb_ref, state, ctx, ref_states = _reference()
    hb, pst, pcx, lanes = _port_batch(hb_ref, state, ctx)
    step = hetero.hetero_step(hb)
    for i in range(STEPS):
        pst = step(pst, pcx)
        assert list(pst) == list(NAMES)
        try:
            _assert_packed_equal(
                ref_states[i], carry.groups_to_packed(hb.skeleton, pst, lanes))
        except AssertionError as e:
            raise AssertionError(f"step {i + 1}: {e}") from None
    # the lanes ran through their protocols' steps: commands went through
    done = carry.groups_to_packed(hb.skeleton, pst, lanes)
    assert int(done["shared"]["clients.completed"].sum()) > 0


# ----------------------------------------------------------------------
# the grouped layout
# ----------------------------------------------------------------------

def _grouped(device="cpu"):
    return {
        "a": {"now": torch.arange(2, dtype=torch.int32, device=device),
              "ps": {"x": torch.zeros((2, 3), dtype=torch.int32,
                                      device=device)}},
        "b": {"now": torch.arange(5, 8, dtype=torch.int32, device=device),
              "ps": {"y": torch.ones((3,), dtype=torch.bool,
                                     device=device)}},
    }


def test_link_makes_group_planes_views_of_one_buffer():
    tree = link(_grouped())
    buf = tree["a"]["now"]._base
    assert buf is tree["b"]["now"]._base and buf.tolist() == [0, 1, 5, 6, 7]
    tree["b"]["now"][1] = 42  # a group's write lands in the buffer
    assert buf.tolist() == [0, 1, 5, 42, 7]
    copy = clone_tree(tree)
    assert copy["a"]["now"]._base is copy["b"]["now"]._base is not buf
    assert copy["a"]["now"]._base.tolist() == [0, 1, 5, 42, 7]
    assert tree_signature(copy) == tree_signature(tree)
    # a copy into the linked tree keeps its views
    src = link(_grouped())
    _copy_into(copy, src)
    assert copy["a"]["now"]._base.tolist() == [0, 1, 5, 6, 7]
    # native trees are left as they are
    native = {"now": torch.zeros(2, dtype=torch.int32)}
    assert link(native) is native


def test_live_planes_reads_the_buffers():
    st = link(_grouped())
    for t in st.values():
        t.update(done_time=t["now"] + 1, err=t["now"] * 0,
                 steps=t["now"] * 2)
    st = link(st)
    ctx = link({g: {"extra_time": t["now"] + 3,
                    "fault_horizon": t["now"] + 4} for g, t in st.items()})
    live, cx = live_planes(st, ctx)
    assert live["now"] is st["a"]["now"]._base
    assert live["steps"].tolist() == [0, 2, 10, 12, 14]
    assert cx["fault_horizon"].tolist() == [4, 5, 9, 10, 11]
    # an unlinked tree: concatenated on the CPU, refused on a device
    loose = {g: dict(t, now=t["now"].clone()) for g, t in st.items()}
    assert live_planes(loose, ctx)[0]["now"].tolist() == [0, 1, 5, 6, 7]
    meta = {g: {k: torch.empty_like(v, device="meta") for k, v in t.items()
                if k != "ps"} for g, t in loose.items()}
    mctx = {g: {k: torch.empty_like(v, device="meta") for k, v in t.items()}
            for g, t in ctx.items()}
    with pytest.raises(RuntimeError, match="not linked"):
        live_planes(meta, mctx)
    # a native tree is its own
    native = {"now": torch.zeros(2, dtype=torch.int32)}
    assert live_planes(native, ctx)[0] is native


def test_segment_loop_equals_the_eager_loop():
    """The mixed batch through ``run_sweep``'s segment loop (windows of
    3 segments of 40 steps, 2 in flight, 4-step bodies) ends in the
    eager loop's whole state, also where ``max_steps`` truncates."""
    pp, pd, pmixed = _grid(PORT)
    for max_steps in (1 << 20, 20):
        hb, state, ctx, _lanes = hetero.prepare_batch(pp, pd, pmixed, "cpu")
        want = hetero.build_hetero_eager_runner(hb, max_steps)(state, ctx)
        hb, state, ctx, _lanes = hetero.prepare_batch(pp, pd, pmixed, "cpu")
        runner, alive = hetero.build_hetero_window_runner(
            hb, max_steps, steps_per_body=4)
        assert bool(alive(state, ctx)[0])
        stats = {}
        st = sweep.run_windows(runner, state, ctx, 40, 3, 2, max_steps,
                               stats)
        got = hetero.finish_hetero(st, max_steps)
        for a in NAMES:
            _assert_packed_equal(carry.to_numpy(want[a]),
                                 carry.to_numpy(got[a]), a)
        assert not bool(alive(st, ctx)[0])
        cut = sum(int((got[a]["err"] != 0).sum()) for a in NAMES)
        assert (cut > 0) == (max_steps == 20), cut


def test_segment_runner_contract():
    """``build_hetero_segment_runner``: each call advances every lane to
    at most ``until`` steps; a finished batch re-running is a no-op."""
    pp, pd, pmixed = _grid(PORT)
    hb, state, ctx, _lanes = hetero.prepare_batch(pp, pd, pmixed, "cpu")
    runner, _alive = hetero.build_hetero_segment_runner(hb)
    st, any_alive = runner(state, ctx, 10)
    assert bool(any_alive[0])
    assert all(int(st[a]["steps"].max()) == 10 for a in NAMES)
    st, any_alive = runner(st, ctx, 1 << 20)
    assert not bool(any_alive[0])
    again, _ = runner(st, ctx, 1 << 20)
    for a in NAMES:
        _assert_packed_equal(carry.to_numpy(st[a]), carry.to_numpy(again[a]))
    json.dumps(hetero.result_fetch_tree(hb, carry.to_numpy(st))["tempo"]
               ["steps"].tolist())
