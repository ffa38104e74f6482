"""Mixed-protocol batches through the port on the CPU, against the
reference's (``engine/hetero.py``, ``engine/skeleton.py``,
``parallel/sweep.py run_sweep(hetero=True)``), at the shapes of the
reference's own tier-1 tests (``tests/test_hetero.py`` ``_build`` and
``_grid``: n = 3, 2 commands a client, one client a region, conflict
100 and 0):

- the skeleton the port builds over its own trees has the reference's
  fingerprint, for Basic + Tempo and for all six engine protocols;
  pack → unpack is exact plane by plane for each, numpy and torch; every
  refusal of the skeleton matches by name;
- the Basic + Tempo mixed list: ``to_json()`` byte-identical to the
  reference's ``run_sweep(hetero=True)`` and to the port's homogeneous
  runs; a single-protocol mixed batch equals the native run;
- one mixed batch of all six protocols equals the port's homogeneous
  runs (those are held to the reference by their own tests);
- the same results at 64-step segments with scan windows 1 and 4 and
  with one window in flight, and through a grid skeleton;
- a mixed batch with a fault-planned Tempo lane equals the homogeneous
  runs (every group under the batch's fault flag union);
- the refusals by name: monitor keys, a bare fingerprint, a slashed
  group key, groups outside a given skeleton, a missing mapping entry,
  a lane that is not a pair, a drifted group, and the default device
  without a GPU (partial-replication groups are taken since slice 19:
  ``tests/test_torch_hetero_partial.py``).

The CPU runs the device loop's plain twin (``kernels/step_loop.py
HostLoop``) over the grouped trees."""

import functools
import json

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
from fantoch_tpu.parallel import sweep as rsweep
from fantoch_tpu.registry import DEV_PROTOCOLS
from fantoch_tpu_torch import carry
from fantoch_tpu_torch.core import Config, Planet
from fantoch_tpu_torch.engine import EngineDims, hetero, make_lane
from fantoch_tpu_torch.engine import protocols as pprotocols
from fantoch_tpu_torch.engine import skeleton
from fantoch_tpu_torch.engine.faults import FaultPlan
from fantoch_tpu_torch.engine.hetero import HeteroBatchError
from fantoch_tpu_torch.engine.skeleton import SkeletonMismatchError
from fantoch_tpu_torch.kernels.step_loop import live_planes
from fantoch_tpu_torch.parallel import sweep
from torch_threads import one_torch_thread  # noqa: F401

COMMANDS = 2
MAX = 1 << 20
SIX = tuple(DEV_PROTOCOLS)

REF = (RConfig, RPlanet, RDims, rprotocols, rmake_lane)
PORT = (Config, Planet, EngineDims, pprotocols, make_lane)


def _build(pkg, name, conflict=100, faults=None):
    """The reference test's lane (test_hetero.py ``_build``)."""
    cfg, planet_cls, dims_cls, protos, mk = pkg
    planet = planet_cls.new()
    regions = planet.regions()[:3]
    clients = 3
    total = COMMANDS * clients
    dev = protos.dev_protocol(name, clients)
    dims = dims_cls.for_protocol(
        dev, n=3, clients=clients, payload=dev.payload_width(3),
        total_commands=total, dot_slots=total + 1, regions=3,
    )
    spec = mk(
        dev, planet, cfg(**protos.dev_config_kwargs(name, 3, 1)),
        conflict_rate=conflict, pool_size=1, commands_per_client=COMMANDS,
        clients_per_region=1, process_regions=regions,
        client_regions=regions, dims=dims,
        **({"faults": faults} if faults else {}),
    )
    return dev, dims, spec


def _grid(pkg, names=("basic", "tempo")):
    """(protocols, dims, specs) maps over ``names``, conflict 100 and 0
    each, and the interleaved mixed list (test_hetero.py ``_grid``)."""
    protocols, dims, specs = {}, {}, {}
    for name in names:
        dev, d, s100 = _build(pkg, name)
        _, _, s0 = _build(pkg, name, conflict=0)
        protocols[name], dims[name], specs[name] = dev, d, [s100, s0]
    mixed = [(name, specs[name][i]) for i in range(2) for name in names]
    return protocols, dims, specs, mixed


def _blob(r) -> str:
    return json.dumps(r.to_json(), sort_keys=True)


def _mixed(names=("basic", "tempo"), **kw):
    protocols, dims, _specs, mixed = _grid(PORT, names)
    out = sweep.run_sweep(protocols, dims, mixed, hetero=True, device="cpu",
                          max_steps=MAX, **kw)
    return [_blob(r) for r in out]


@functools.lru_cache(maxsize=None)
def _homogeneous(names):
    """The port's homogeneous run of each protocol's two lanes, in the
    mixed list's order."""
    protocols, dims, specs, mixed = _grid(PORT, names)
    ctrl = {n: sweep.run_sweep(protocols[n], dims[n], specs[n],
                               device="cpu", max_steps=MAX,
                               segment_steps=4096)
            for n in names}
    return [_blob(ctrl[n][i // len(names)]) for i, (n, _) in
            enumerate(mixed)]


@pytest.fixture(scope="module")
def reference_mixed():
    """The reference's ``run_sweep(hetero=True)`` of the Basic + Tempo
    mixed list, once."""
    protocols, dims, _specs, mixed = _grid(REF)
    out = rsweep.run_sweep(protocols, dims, mixed, hetero=True,
                           max_steps=MAX, segment_steps=4096)
    return [_blob(r) for r in out]


# ----------------------------------------------------------------------
# (a) the skeleton
# ----------------------------------------------------------------------

@pytest.mark.parametrize("names", [("basic", "tempo"), SIX],
                         ids=["basic+tempo", "six"])
def test_skeleton_fingerprint_is_the_references(names):
    rp, rd, _rs, rmixed = _grid(REF, names)
    rhb = rhetero.prepare_batch(rp, rd, rmixed)[0]
    pp, pd, _ps, pmixed = _grid(PORT, names)
    hb, state, ctx, lanes = hetero.prepare_batch(pp, pd, pmixed, "cpu")
    assert hb.fingerprint == rskeleton.skeleton_fingerprint(rhb.skeleton)
    assert hb.audits == rhb.audits == tuple(sorted(names))
    assert list(state) == list(ctx) == list(lanes) == sorted(names)
    assert lanes == {n: [i for i, (m, _) in enumerate(pmixed) if m == n]
                     for n in names}
    # the liveness planes lie in one [L] buffer a plane, groups in order
    live_st, live_cx = live_planes(state, ctx)
    for name in ("done_time", "now", "err", "steps"):
        assert live_st[name].shape == (len(pmixed),)
        assert live_st[name]._base is None
        assert all(state[a][name]._base is live_st[name] for a in state)
    assert live_cx["extra_time"].shape == (len(pmixed),)


@pytest.mark.parametrize("name", SIX)
@pytest.mark.parametrize("array", ["numpy", "torch"])
def test_pack_unpack_round_trip_is_exact(name, array):
    pp, pd, _ps, pmixed = _grid(PORT, SIX)
    hb, state, ctx, _lanes = hetero.prepare_batch(pp, pd, pmixed, "cpu")
    sk = hb.skeleton
    for prefix, tree in (("state", state[name]), ("ctx", ctx[name])):
        tree = carry.to_numpy(tree) if array == "numpy" else tree
        pack, unpack = ((skeleton.pack_state, skeleton.unpack_state)
                        if prefix == "state" else
                        (skeleton.pack_ctx, skeleton.unpack_ctx))
        packed = pack(sk, name, tree, lead=1)
        back = unpack(sk, name, packed, lead=1)
        want = skeleton.walk_planes(tree, prefix)
        got = skeleton.walk_planes(back, prefix)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            g = got[k]
            assert type(g) is type(v) and g.dtype == v.dtype, k
            assert g.shape == v.shape, k
            assert (torch.equal(g, v) if array == "torch"
                    else np.array_equal(g, v)), k
        # the packed layout is the skeleton's packed spec, a lane axis
        # in front
        spec = skeleton.packed_spec(sk, prefix)
        assert sorted(packed["shared"]) == sorted(spec["shared"])
        for k, (shape, dt) in spec["shared"].items():
            assert tuple(packed["shared"][k].shape) == (2,) + shape
            assert skeleton.dtype_name(packed["shared"][k]) == dt


def test_skeleton_refusals_by_name():
    pp, pd, _ps, pmixed = _grid(PORT)
    hb, state, ctx, _lanes = hetero.prepare_batch(pp, pd, pmixed, "cpu")
    sk = hb.skeleton
    basic = carry.to_numpy(state["basic"])
    with pytest.raises(SkeletonMismatchError, match="not in this skeleton"):
        skeleton.pack_state(sk, "caesar", basic, lead=1)
    extra = dict(basic, bogus=np.zeros((2,), np.int32))
    with pytest.raises(SkeletonMismatchError, match="does not know"):
        skeleton.pack_state(sk, "basic", extra, lead=1)
    missing = {k: v for k, v in basic.items() if k != "pool"}
    with pytest.raises(SkeletonMismatchError, match="missing plane"):
        skeleton.pack_state(sk, "basic", missing, lead=1)
    drifted = dict(basic, now=basic["now"].astype(np.int16))
    with pytest.raises(SkeletonMismatchError, match="native spec says"):
        skeleton.pack_state(sk, "basic", drifted, lead=1)
    tempo_ps = carry.to_numpy(state["tempo"])["ps"]
    with pytest.raises(SkeletonMismatchError, match="not carried by"):
        skeleton.pack_state(sk, "basic", dict(basic, ps=tempo_ps), lead=1)
    packed = skeleton.pack_state(sk, "basic", basic, lead=1)
    with pytest.raises(SkeletonMismatchError, match="protocol_id"):
        skeleton.unpack_state(sk, "tempo", packed, lead=1)
    with pytest.raises(SkeletonMismatchError, match="no 'priv' slot"):
        skeleton.unpack_ctx(sk, "basic", {"shared": {}}, lead=1)
    with pytest.raises(SkeletonMismatchError, match="dot-free"):
        skeleton.walk_planes({"a.b": np.zeros(1)}, "state")
    with pytest.raises(SkeletonMismatchError, match="unknown verdict"):
        skeleton.build_skeleton({"state.x": {"verdict": "MAYBE",
                                             "native": {"a": {}}}})
    with pytest.raises(SkeletonMismatchError, match="outside the grid"):
        skeleton.build_skeleton(
            {"state.x": {"verdict": "PRIVATE",
                         "native": {"b": {"shape": [], "dtype": "int32"}}}},
            audits=("a",))


def test_classify_planes_is_the_references():
    """The verdicts, unions and lossless widens on the reference's own
    selfcheck-style specs."""
    specs = {
        "a": {"state.x": ((3,), "int32"), "state.y": ((2,), "int32"),
              "state.z": ((), "int32"), "state.w": ((2,), "int64")},
        "b": {"state.x": ((5,), "int32"), "state.y": ((2,), "uint32"),
              "state.w": ((2,), "float32")},
    }
    assert skeleton.classify_planes(specs) == rskeleton.classify_planes(
        specs)


# ----------------------------------------------------------------------
# (b) mixed lanes against the reference and the homogeneous runs
# ----------------------------------------------------------------------

def test_mixed_batch_equals_the_reference_and_homogeneous(reference_mixed):
    got = _mixed(segment_steps=4096)
    assert got == reference_mixed
    assert got == _homogeneous(("basic", "tempo"))


def test_single_protocol_hetero_equals_native():
    protocols, dims, specs, _ = _grid(PORT, ("basic",))
    res = sweep.run_sweep(protocols, dims,
                          [("basic", s) for s in specs["basic"]],
                          hetero=True, device="cpu", max_steps=MAX,
                          segment_steps=4096)
    native = sweep.run_sweep(protocols["basic"], dims["basic"],
                             specs["basic"], device="cpu", max_steps=MAX,
                             segment_steps=4096)
    assert [_blob(r) for r in res] == [_blob(r) for r in native]


# ----------------------------------------------------------------------
# (c) all six protocols in one batch
# ----------------------------------------------------------------------

def test_six_protocol_batch_equals_homogeneous():
    got = _mixed(SIX, segment_steps=4096)
    assert sweep.LAST_STATS["batches"] == 1
    assert sweep.LAST_STATS["lanes"] == 12
    assert got == _homogeneous(SIX)


# ----------------------------------------------------------------------
# (d) composition with the segment loop
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {"segment_steps": 64, "scan_window": 1},
    {"segment_steps": 64, "scan_window": 4},
    {"segment_steps": 64, "scan_window": 1, "pipeline_depth": 1},
], ids=["w1", "w4", "depth1"])
def test_composes_with_windows_and_pipeline(kw):
    got = _mixed(**kw)
    assert sweep.LAST_STATS["scan_window"] == kw["scan_window"]
    assert got == _homogeneous(("basic", "tempo"))


def test_default_window_is_halved_and_batches_chunk_in_order():
    """The default window is the reference's skeleton rule (half the
    cap), and ``batch_lanes`` cuts the mixed list in the caller's
    order, each chunk its own batch and composition."""
    protocols, dims, _specs, mixed = _grid(PORT)
    res = sweep.run_sweep(protocols, dims, mixed, hetero=True, device="cpu",
                          max_steps=MAX, segment_steps=2048, batch_lanes=3)
    stats = dict(sweep.LAST_STATS)
    assert stats["scan_window"] == rsweep.default_scan_window(
        2048, skeleton=True) == sweep.default_scan_window(2048) // 2 == 4
    assert stats["batches"] == 2
    assert [_blob(r) for r in res] == _homogeneous(("basic", "tempo"))


def test_grid_skeleton_fixes_every_batch():
    """A grid skeleton wider than the batch (Basic, FPaxos, Tempo) lays
    out the Basic + Tempo batch; results are unchanged, and its
    fingerprint is the reference's grid skeleton's."""
    pp, pd, ps, _ = _grid(PORT, ("basic", "tempo", "fpaxos"))
    sk = hetero.build_grid_skeleton(pp, pd, {n: ps[n][0] for n in pp},
                                    device="cpu")
    rp, rd, rs, _ = _grid(REF, ("basic", "tempo", "fpaxos"))
    rsk, _nspec = rhetero.build_grid_skeleton(
        rp, rd, {n: rs[n][0] for n in rp}, batch_lanes=4)
    assert (skeleton.skeleton_fingerprint(sk)
            == rskeleton.skeleton_fingerprint(rsk))
    _p, _d, _s, mixed = _grid(PORT)
    res = sweep.run_sweep(pp, pd, mixed, hetero=True, skeleton=sk,
                          device="cpu", max_steps=MAX, segment_steps=4096)
    assert [_blob(r) for r in res] == _homogeneous(("basic", "tempo"))
    hb, state, _ctx, _lanes = hetero.prepare_batch(pp, pd, mixed, "cpu",
                                                   skeleton=sk)
    assert hb.audits == ("basic", "fpaxos", "tempo")
    assert list(state) == ["basic", "tempo"]


# ----------------------------------------------------------------------
# (g) faults
# ----------------------------------------------------------------------

def test_fault_planned_tempo_lane_in_a_mixed_batch():
    """A Tempo lane under a crash plan with jitter beside fault-free
    Basic and Tempo lanes: every group runs under the batch's fault flag
    union, and each lane equals its homogeneous run (the Tempo batch
    under its own union)."""
    plan = FaultPlan.from_json({"crash": {"2": 40}, "jitter_max": 3,
                                "jitter_seed": 7})
    protocols, dims, specs, mixed = _grid(PORT)
    _, _, faulty = _build(PORT, "tempo", faults=plan)
    mixed = mixed + [("tempo", faulty)]
    res = sweep.run_sweep(protocols, dims, mixed, hetero=True, device="cpu",
                          max_steps=MAX, segment_steps=4096)
    tempo = sweep.run_sweep(protocols["tempo"], dims["tempo"],
                            specs["tempo"] + [faulty], device="cpu",
                            max_steps=MAX, segment_steps=4096)
    basic = _homogeneous(("basic", "tempo"))
    assert [_blob(r) for r in res[:4]] == basic
    assert [_blob(r) for r in res[1:5:2] + res[4:]] == [
        _blob(r) for r in tempo]
    assert res[4].faults == faulty.fault_meta and "crash" in res[4].faults


# ----------------------------------------------------------------------
# (f) refusals, by name
# ----------------------------------------------------------------------

def test_run_sweep_hetero_refusals():
    protocols, dims, _specs, mixed = _grid(PORT)
    with pytest.raises(ValueError, match="bare fingerprint"):
        sweep.run_sweep(protocols, dims, mixed, hetero=True, device="cpu",
                        skeleton="deadbeef" * 8)
    with pytest.raises(HeteroBatchError, match="monitor"):
        sweep.run_sweep(protocols, dims, mixed, hetero=True, device="cpu",
                        monitor_keys=2)
    with pytest.raises(HeteroBatchError, match=r"\(group, LaneSpec\) pairs"):
        sweep.run_sweep(protocols, dims, [s for _, s in mixed], hetero=True,
                        device="cpu")
    with pytest.raises(ValueError, match="hetero=True"):
        sk = hetero.prepare_batch(protocols, dims, mixed, "cpu")[0].skeleton
        sweep.run_sweep(protocols["basic"], dims["basic"],
                        [s for n, s in mixed if n == "basic"],
                        device="cpu", skeleton=sk)


def test_prepare_batch_refusals():
    protocols, dims, specs, mixed = _grid(PORT)
    with pytest.raises(HeteroBatchError, match="flattener"):
        hetero.prepare_batch({"basic/n3": protocols["basic"]},
                             {"basic/n3": dims["basic"]},
                             [("basic/n3", specs["basic"][0])], "cpu")
    with pytest.raises(HeteroBatchError, match="no \\(protocol, dims\\)"):
        hetero.prepare_batch({"basic": protocols["basic"]}, dims, mixed,
                             "cpu")
    sk = hetero.prepare_batch(protocols, {"basic": dims["basic"]},
                              [m for m in mixed if m[0] == "basic"],
                              "cpu")[0].skeleton
    with pytest.raises(SkeletonMismatchError, match="outside the skeleton"):
        hetero.prepare_batch(protocols, dims, mixed, "cpu", skeleton=sk)
    with pytest.raises(HeteroBatchError, match="mapping entry"):
        hetero.HeteroBatch(
            hetero.prepare_batch(protocols, dims, mixed, "cpu")[0].skeleton,
            {"basic": protocols["basic"]}, dims)
    with pytest.raises(HeteroBatchError, match="monitor"):
        hetero.prepare_batch(protocols, dims, mixed, "cpu", monitor_keys=1)
    # a skeleton whose Tempo spec drifted from the group's planes
    other = hetero.prepare_batch(protocols, dims, mixed, "cpu")[0].skeleton
    planes = dict(other.planes)
    ent = json.loads(json.dumps(planes["state.ps.clocks"]))
    ent["native"]["tempo"]["shape"][0] += 1
    planes["state.ps.clocks"] = ent
    drifted = skeleton.Skeleton(audits=other.audits, planes=planes)
    with pytest.raises(SkeletonMismatchError, match="native spec"):
        hetero.prepare_batch(protocols, dims, mixed, "cpu",
                             skeleton=drifted)


def test_liveness_must_be_shared():
    protocols, dims, _specs, mixed = _grid(PORT)
    hb = hetero.prepare_batch(protocols, dims, mixed, "cpu")[0]
    planes = dict(hb.skeleton.planes)
    planes["state.now"] = dict(planes["state.now"], verdict="PRIVATE")
    bad = hetero.HeteroBatch(
        skeleton.Skeleton(audits=hb.audits, planes=planes), protocols, dims)
    with pytest.raises(HeteroBatchError, match="state.now"):
        hetero.build_hetero_window_runner(bad)


def test_no_gpu_default_device(monkeypatch):
    protocols, dims, _specs, mixed = _grid(PORT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep.run_sweep(protocols, dims, mixed, hetero=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hetero.prepare_batch(protocols, dims, mixed)


# ----------------------------------------------------------------------
# the mixed main path and its profile
# ----------------------------------------------------------------------

def test_mixed_main_path_is_the_bench_grid_interleaved():
    """``cli.MAIN_PATHS["hetero"]``: the reference bench's mixed
    protocols over the main grid, point by point (cut to one subset
    here), each protocol's lanes its own sweep's."""
    from fantoch_tpu_torch import cli

    args = cli.parse_args(cli.MAIN_PATHS["hetero"])
    assert tuple(args.protocol.split(",")) == cli.HETERO_PROTOCOLS == (
        "basic", "fpaxos", "tempo", "atlas")
    assert (args.subsets, args.batch_lanes, args.n) == (256, 512, 5)
    args.subsets = 1
    protocols, dims, mixed = cli.hetero_setup(args)
    assert [n for n, _ in mixed] == list(cli.HETERO_PROTOCOLS) * 8
    for name in cli.HETERO_PROTOCOLS:
        one = cli.parse_args(cli.MAIN_PATHS[name])
        one.subsets = 1
        proto, d, specs = cli.sweep_setup(one)
        assert proto == protocols[name] and d == dims[name]
        mine = [s for n, s in mixed if n == name]
        assert [s.region_rows for s in mine] == [s.region_rows for s in specs]
        assert all(
            np.array_equal(a.ctx["rng_key"], b.ctx["rng_key"])
            and int(a.ctx["conflict_rate"]) == int(b.ctx["conflict_rate"])
            for a, b in zip(mine, specs))
    with pytest.raises(SystemExit):
        cli.sweep_setup(cli.parse_args(cli.MAIN_PATHS["hetero"]))


def test_step_profile_rehearsal_of_the_mixed_path():
    from fantoch_tpu_torch import step_profile

    protocols, dims, _specs, mixed = _grid(PORT)
    cpu = torch.device("cpu")
    for fn in (step_profile.profile, step_profile.profile_device):
        hb, state, ctx, _lanes = hetero.prepare_batch(protocols, dims, mixed,
                                                      cpu)
        out = fn(hb, None, state, ctx, cpu, 3, 2)
        json.dumps(out)
        assert out["protocol"] == "hetero[basic+tempo]" and out["lanes"] == 4
        assert out["device_busy_ms_per_step"] is None
        assert out["steps"] > 0
