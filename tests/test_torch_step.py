"""One engine step at a time: the port's ``lane_step`` (on the CPU, so
through the plain twins of ``qualify_pop``, the protocol's handler
kernel, ``emit_rewrite`` and ``land_emissions``) against
``jax.jit(jax.vmap(_lane_step))``, for Basic and FPaxos, starting
from the reference's own lane state and ctx carried across with
``carry.to_torch``. The whole state tree must be equal after each of the
first 64 steps."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fantoch_tpu.core import Config, Planet
from fantoch_tpu.engine import EngineDims, make_lane, stack_lanes
from fantoch_tpu.engine.core import _lane_step, key_table_fn
from fantoch_tpu.engine.driver import stack_states
from fantoch_tpu.engine.protocols import BasicDev as RBasic
from fantoch_tpu.engine.protocols import FPaxosDev as RFPaxos
from fantoch_tpu_torch import carry
from fantoch_tpu_torch.engine.core import build_runner, lane_step
from fantoch_tpu_torch.engine.protocols import (
    BasicDev, FPaxosDev, dev_config_kwargs,
)

STEPS = 64
GCP = Planet.new().regions()


# protocol name → (reference, port)
PROTOCOLS = {"basic": (RBasic, BasicDev), "fpaxos": (RFPaxos, FPaxosDev)}


def _batch(protocol, regions_list, fs, conflicts, cpr, commands, **dims_kw):
    n = len(regions_list[0])
    ref = PROTOCOLS[protocol][0]
    dims = EngineDims.for_protocol(
        ref, n=n, clients=n * cpr, payload=ref.payload_width(n), regions=n,
        **dims_kw,
    )
    specs = [
        make_lane(
            ref, Planet.new(),
            Config(**dev_config_kwargs(protocol, n, f)),
            conflict_rate=cf, commands_per_client=commands,
            clients_per_region=cpr, process_regions=regions,
            client_regions=regions, dims=dims, extra_time_ms=100, seed=i,
        )
        for i, (regions, f, cf) in enumerate(
            (r, f, c) for r in regions_list for f in fs for c in conflicts
        )
    ]
    ctx = stack_lanes(specs)
    T = int(ctx["cmd_budget"].max()) + 2
    kctx = {k: jnp.asarray(ctx[k]) for k in
            ("rng_key", "conflict_rate", "pool_size", "key_gen_kind",
             "zipf_cum")}
    ctx["key_table"] = np.asarray(jax.vmap(key_table_fn(dims.C, T))(kctx))
    return dims, ctx, stack_states(ref, dims, specs)


# (a) Basic, n=3, two clients per region and a 2-slot dot window:
#     MStores bounce off the readiness gate (requeue rows, kept channel
#     keys);
# (b) Basic, n=5 with a pool too small for the first broadcasts: the
#     emission ranks past the free count drop and ERR_POOL is raised;
# (c) FPaxos, the same lanes as (a) with leader 1: MAccepts bounce off
#     the acceptor window's gate and requeue
REQUEUE = dict(regions_list=[GCP[:3], ["asia-east1", "us-central1",
                                       "us-west1"]],
               fs=[0, 1, 2], conflicts=[0, 100], cpr=2, commands=6,
               dot_slots=2)
CASES = {
    "requeue": dict(protocol="basic", **REQUEUE),
    "overflow": dict(protocol="basic", regions_list=[GCP[2:7]], fs=[1, 2],
                     conflicts=[50], cpr=1, commands=4, pool=14),
    "fpaxos_requeue": dict(protocol="fpaxos", **REQUEUE),
}


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


@pytest.fixture(scope="module", params=sorted(CASES))
def trajectories(request):
    """Both engines stepped ``STEPS`` times from one initial state."""
    case = CASES[request.param]
    ref, port = PROTOCOLS[case["protocol"]]
    dims, ctx, state = _batch(**case)
    step = jax.jit(jax.vmap(functools.partial(_lane_step, ref, dims)))
    ref_states = []
    st = jax.tree_util.tree_map(jnp.asarray, state)
    jctx = jax.tree_util.tree_map(jnp.asarray, ctx)
    for _ in range(STEPS):
        st = step(st, jctx)
        ref_states.append(jax.tree_util.tree_map(np.asarray, st))
    port_ctx = carry.to_torch(ctx, "cpu")
    port_states = []
    pst = carry.to_torch(state, "cpu")
    for _ in range(STEPS):
        pst = lane_step(port, dims, pst, port_ctx)
        port_states.append(carry.to_numpy(pst))
    return (request.param, port, dims, ref_states, port_states, state,
            port_ctx)


def test_whole_state_equal_after_every_step(trajectories):
    name, _port, _dims, ref_states, port_states, _s, _c = trajectories
    for i, (ref, port) in enumerate(zip(ref_states, port_states)):
        try:
            _assert_tree_equal(ref, port)
        except AssertionError as e:
            raise AssertionError(f"{name}: step {i + 1}: {e}") from None


def test_cases_reach_their_paths(trajectories):
    """The requeue case bounces messages and the overflow case overflows
    within the compared steps, so those paths are held too."""
    name, _port, _dims, ref_states, _p, _s, _c = trajectories
    last = ref_states[-1]
    if name.endswith("requeue"):
        assert last["requeues"].max() > 0
        assert (last["metrics"]["lat_count"].sum(-1) > 0).any()
    else:
        assert (last["err"] & 1).any()  # ERR_POOL


def test_runner_freezes_finished_lanes(trajectories):
    """The run loop's per-lane freeze: a lane that stops (an error, or
    ``max_steps``) keeps its state exactly, as under the reference's
    vmapped while loop."""
    name, port, dims, ref_states, _p, state, port_ctx = trajectories
    final = build_runner(port, dims, max_steps=5)(
        carry.to_torch(state, "cpu"), port_ctx
    )
    final = carry.to_numpy(final)
    want = dict(ref_states[4])
    truncated = (want["steps"] >= 5) & (want["done_time"] >= 1 << 30)
    want["err"] = (want["err"] | 2 * truncated).astype(np.int32)
    if name == "overflow":
        # lanes that overflowed earlier froze at their error step
        first_err = [
            next(i for i, s in enumerate(ref_states) if s["err"][lane])
            for lane in range(len(want["err"]))
        ]
        for lane, i in enumerate(first_err):
            if i < 4:
                assert final["steps"][lane] == i + 1
        return
    _assert_tree_equal(want, final)
