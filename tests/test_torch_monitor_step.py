"""Monitored runs one engine step at a time, and the monitors' gate.

The port's ``lane_step(..., monitor_keys=)`` (on the CPU, through the
plain twins, with the monitor planes in the lane state) against
``jax.jit(jax.vmap(_lane_step(..., monitor_keys=)))`` from the
reference's own monitored lane state: the whole state tree, monitor
planes included, must be equal after each of the first 64 steps of a
Tempo batch (jittered and clean lanes, two clients per region) and of a
Caesar batch (European regions, wait condition on and off). Also:
``monitor_keys=0`` leaves the state tree and every plane of a run as
they are; protocols without hooks (the partial twins, a protocol with
no ``MONITORED``) refuse monitors with the reference's message; and a
monitored step's tree (Caesar: 62 changed planes) fits ``lane_freeze``'s
plane table. Tolerance: none."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fantoch_tpu.core import Config, Planet
from fantoch_tpu.engine import EngineDims, make_lane, stack_lanes
from fantoch_tpu.engine import faults as rfaults
from fantoch_tpu.engine.core import (
    _check_monitorable, _lane_step, key_table_fn,
)
from fantoch_tpu.engine.driver import stack_states
from fantoch_tpu.engine.protocols import CaesarDev as RCaesar
from fantoch_tpu.engine.protocols import TempoDev as RTempo
from fantoch_tpu_torch import carry
from fantoch_tpu_torch.core import Config as PConfig
from fantoch_tpu_torch.core import Planet as PPlanet
from fantoch_tpu_torch.engine import EngineDims as PDims
from fantoch_tpu_torch.engine import make_lane as p_make_lane
from fantoch_tpu_torch.engine import run_lanes
from fantoch_tpu_torch.engine.core import (
    build_runner, check_monitorable, lane_step,
)
from fantoch_tpu_torch.engine.driver import prepare_batch
from fantoch_tpu_torch.engine.protocols import (
    AtlasPartialDev, BasicDev, CaesarDev, TempoDev, TempoPartialDev,
)
from fantoch_tpu_torch.kernels.lane_freeze import MAX_PLANES, plane_pairs
from torch_threads import one_torch_thread  # noqa: F401

STEPS = 64
GCP = Planet.new().regions()
EUROPE = [r for r in GCP if r.startswith("europe")]
MON_STATE = {"mon_hash", "mon_cnt", "mon_flags", "viol", "viol_step", "cov"}


def _tempo():
    n, cpr = 3, 2
    clients = n * cpr
    kw = dict(keys=1 + clients, pending_per_key=8, detached_slots=6,
              gap_slots=4)
    ref, port = RTempo(**kw), TempoDev(**kw)
    dims = EngineDims.for_protocol(ref, n=n, clients=clients,
                                   payload=ref.payload_width(n), regions=n)
    plans = [None, {"jitter_max": 4, "jitter_seed": 5}, None,
             {"jitter_max": 8, "jitter_seed": 9}]
    specs = [
        make_lane(ref, Planet.new(),
                  Config(n=n, f=1, gc_interval_ms=20,
                         tempo_detached_send_interval_ms=20),
                  conflict_rate=cf, commands_per_client=6,
                  clients_per_region=cpr, process_regions=GCP[:n],
                  client_regions=GCP[:n], dims=dims, extra_time_ms=100,
                  seed=i,
                  faults=rfaults.FaultPlan.from_json(p) if p else None)
        for i, (p, cf) in enumerate(zip(plans, (100, 100, 0, 0)))
    ]
    return ref, port, dims, specs, 1 + clients


def _caesar():
    n = 5
    ref = RCaesar.for_load(keys=1 + n, clients=n)
    port = CaesarDev.for_load(keys=1 + n, clients=n)
    dims = EngineDims.for_protocol(ref, n=n, clients=n,
                                   payload=ref.payload_width(n), regions=n)
    specs = [
        make_lane(ref, Planet.new(),
                  Config(n=n, f=f, gc_interval_ms=20,
                         executor_executed_notification_interval_ms=10,
                         caesar_wait_condition=wait),
                  conflict_rate=100, commands_per_client=4,
                  clients_per_region=1, process_regions=regions,
                  client_regions=regions, dims=dims, extra_time_ms=100,
                  seed=i)
        for i, (regions, f, wait) in enumerate([
            (EUROPE[:5], 1, True), (EUROPE[1:6], 2, False)])
    ]
    return ref, port, dims, specs, 1 + n


def _ctx_with_keys(specs, dims):
    ctx = stack_lanes(specs)
    T = int(ctx["cmd_budget"].max()) + 2
    kctx = {k: jnp.asarray(ctx[k]) for k in
            ("rng_key", "conflict_rate", "pool_size", "key_gen_kind",
             "zipf_cum")}
    ctx["key_table"] = np.asarray(jax.vmap(key_table_fn(dims.C, T))(kctx))
    return ctx


def _assert_tree_equal(ref, port, path=""):
    assert sorted(ref) == sorted(port), path
    for k in ref:
        a, b = ref[k], port[k]
        if isinstance(a, dict):
            _assert_tree_equal(a, b, f"{path}/{k}")
            continue
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, k)
        if not np.array_equal(a, b):
            bad = np.argwhere(a != b)[:5].tolist()
            raise AssertionError(f"{path}/{k} differs at {bad}")


@pytest.fixture(scope="module", params=["tempo", "caesar"])
def trajectories(request):
    """Both engines stepped ``STEPS`` times, monitored, from one state."""
    ref, port, dims, specs, mk = {"tempo": _tempo,
                                  "caesar": _caesar}[request.param]()
    ctx = _ctx_with_keys(specs, dims)
    state = stack_states(ref, dims, specs, monitor_keys=mk)
    flags = rfaults.batch_fault_flags(specs)
    step = jax.jit(jax.vmap(functools.partial(
        _lane_step, ref, dims, reorder=False, faults=flags,
        monitor_keys=mk)))
    st = jax.tree_util.tree_map(jnp.asarray, state)
    jctx = jax.tree_util.tree_map(jnp.asarray, ctx)
    ref_states = []
    for _ in range(STEPS):
        st = step(st, jctx)
        ref_states.append(jax.tree_util.tree_map(np.asarray, st))
    pctx = carry.to_torch(ctx, "cpu")
    pst = carry.to_torch(state, "cpu")
    pflags = _port_flags(flags)
    port_states = []
    for _ in range(STEPS):
        pst = lane_step(port, dims, pst, pctx, False, pflags, mk)
        port_states.append(carry.to_numpy(pst))
    return request.param, port, dims, ref_states, port_states, state, pctx


def _port_flags(flags):
    from fantoch_tpu_torch.engine.faults import FaultFlags

    return FaultFlags(*flags)


def test_monitored_state_equal_after_every_step(trajectories):
    name, _p, _d, ref_states, port_states, _s, _c = trajectories
    for i, (ref, port) in enumerate(zip(ref_states, port_states)):
        try:
            _assert_tree_equal(ref, port)
        except AssertionError as e:
            raise AssertionError(f"{name}: step {i + 1}: {e}") from None
    last = ref_states[-1]
    assert MON_STATE <= set(last)
    # executions were recorded within the compared steps
    assert last["mon_cnt"].sum() > 0, name


def _kernel_planes(new, old, passed):
    """The planes a launch of ``lane_freeze`` carries on the card, where
    every kernel writes fresh outputs: all but the ones the step passes
    through (``passed``, top-level keys)."""
    def fresh(n, o):
        if isinstance(n, dict):
            return {k: fresh(n[k], o[k]) for k in n}
        return n.clone()

    full = {k: (v if k in passed else fresh(v, old[k]))
            for k, v in new.items()}
    return plane_pairs(full, old)


def test_monitored_step_tree_fits_the_freeze_plane_table(trajectories):
    """A monitored step changes five more planes (hashes, counts, guard
    words, violation word and step; the digest passes through): a
    monitored Caesar tree is 62 planes, two short of the 64 one launch
    carried before, and Tempo's (jitter lanes: the lost count is a plane
    too) 55; both fit the table with room to spare."""
    name, port, dims, _r, _p, state, pctx = trajectories
    old = carry.to_torch(state, "cpu")
    mk = old["mon_hash"].shape[2]
    passed = {"hlog", "hlog_n", "cov"}
    if name == "caesar":
        passed.add("fault_dropped")  # no wire-fault lane in this batch
    flags = _port_flags(rfaults.FaultFlags(jitter=name == "tempo"))
    new = lane_step(port, dims, old, pctx, False, flags, monitor_keys=mk)
    pairs = _kernel_planes(new, old, passed)
    plain = {k: v for k, v in old.items() if k not in MON_STATE}
    base = _kernel_planes(lane_step(port, dims, plain, pctx, False, flags),
                          plain, passed)
    assert len(pairs) == len(base) + 5 <= MAX_PLANES
    assert len(pairs) == {"caesar": 62, "tempo": 55}[name]


@pytest.mark.parametrize("name", ["tempo", "caesar"])
def test_monitor_keys_zero_leaves_the_run_unchanged(name):
    """``monitor_keys=0`` builds no monitor planes, and a monitored run's
    other planes equal an unmonitored run's at its end."""
    _ref, port, dims, _specs, mk = {"tempo": _tempo,
                                    "caesar": _caesar}[name]()
    n = dims.N
    pdims = PDims.for_protocol(port, n=n, clients=n,
                               payload=port.payload_width(n), regions=n)
    specs = [
        p_make_lane(port, PPlanet.new(),
                    PConfig(n=n, f=1, gc_interval_ms=20,
                            tempo_detached_send_interval_ms=20,
                            executor_executed_notification_interval_ms=10),
                    conflict_rate=100, commands_per_client=3,
                    clients_per_region=1, process_regions=GCP[:n],
                    client_regions=GCP[:n], dims=pdims, extra_time_ms=100,
                    seed=0)
    ]
    state0, ctx = prepare_batch(port, pdims, specs, "cpu")
    state_m, _ = prepare_batch(port, pdims, specs, "cpu", monitor_keys=mk)
    assert set(state_m) - set(state0) == MON_STATE
    assert not set(state0) & MON_STATE
    plain = carry.to_numpy(build_runner(port, pdims)(state0, ctx))
    mon = carry.to_numpy(build_runner(port, pdims, monitor_keys=mk)(
        state_m, ctx))
    for k in MON_STATE:
        mon.pop(k)
    _assert_tree_equal(plain, mon)
    r0 = run_lanes(port, pdims, specs, device="cpu")
    r1 = run_lanes(port, pdims, specs, device="cpu", monitor_keys=0)
    assert [json.dumps(r.to_json()) for r in r0] == [
        json.dumps(r.to_json()) for r in r1]
    assert r0[0].coverage == 0 and r0[0].violation_step == 1 << 30


def _reference_message(proto):
    with pytest.raises(AssertionError) as e:
        _check_monitorable(proto, 1)
    return str(e.value)


class _NoHooks:
    """A protocol class without ``MONITORED``."""


@pytest.mark.parametrize("which", ["tempo_partial", "atlas_partial",
                                   "no_hooks"])
def test_protocols_without_hooks_refuse_monitors(which):
    from fantoch_tpu.engine.protocols import (
        AtlasPartialDev as RAtlasPartial,
    )
    from fantoch_tpu.engine.protocols import (
        TempoPartialDev as RTempoPartial,
    )

    kw = dict(keys=4, shards=2, keys_per_cmd=2)
    ref, port = {
        "tempo_partial": (RTempoPartial(**kw), TempoPartialDev(**kw)),
        "atlas_partial": (RAtlasPartial(**kw), AtlasPartialDev(**kw)),
        "no_hooks": (_NoHooks, _NoHooks),
    }[which]
    want = _reference_message(ref)
    with pytest.raises(AssertionError) as e:
        check_monitorable(port, 3)
    assert str(e.value) == want
    with pytest.raises(AssertionError, match="has no monitor hooks"):
        build_runner(port, None, monitor_keys=3)
    check_monitorable(port, 0)  # unmonitored: nothing to refuse
    assert BasicDev.MONITORED and not BasicDev.MONITOR_ORDER
    assert getattr(port, "MONITORED", False) is False
