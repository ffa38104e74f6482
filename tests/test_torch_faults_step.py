"""Fault plans and reordering one engine step at a time: the port's
``lane_step`` (on the CPU, through the plain twins of ``qualify_pop``,
``tempo_handle``, ``emit_rewrite`` and ``land_emissions``) against
``jax.jit(jax.vmap(_lane_step))`` with the same fault flags and reorder
switch, from the reference's own lane state and ctx carried across with
``carry.to_torch``; the whole state tree must be equal after each of the
first 64 steps. Two Tempo batches: one mixing a crash, a multiplier
window, a partition, drops, jitter and a horizon with a fault-free lane;
one of reorder lanes. Also the run loop's freeze and horizon stop on the
fault batch, and 64 ``frozen_step``s with every third lane failed (K1
keeping a frozen lane's timers under the crash flag) against the
reference's trajectory and predicate. Tolerance: none (integer
state)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fantoch_tpu.core import Config, Planet
from fantoch_tpu.engine import EngineDims, FaultPlan, make_lane, stack_lanes
from fantoch_tpu.engine.core import _lane_step, key_table_fn
from fantoch_tpu.engine.driver import stack_states
from fantoch_tpu.engine.faults import LinkWindow, batch_fault_flags
from fantoch_tpu.engine.protocols import TempoDev as RTempo
from fantoch_tpu_torch import carry
from fantoch_tpu_torch.engine.core import build_runner, lane_step
from fantoch_tpu_torch.engine.faults import FaultFlags
from fantoch_tpu_torch.engine.protocols import TempoDev
from torch_frozen import MAX_STEPS, failed_third, frozen_steps_match
from torch_threads import one_torch_thread  # noqa: F401

STEPS = 64
GCP = Planet.new().regions()
INF = 1 << 30

# the fault batch's plans, early enough to act within the compared steps
PLANS = [
    None,
    FaultPlan(crashes={1: 30}),
    FaultPlan(windows=(LinkWindow(src=0, dst=1, t0=0, t1=300, mult=6),)),
    FaultPlan(windows=(LinkWindow(src=1, dst=2, t0=0, t1=200, delay=INF),),
              horizon_ms=5000),
    FaultPlan(drop_bp=3000, drop_seed=7, horizon_ms=5000),
    FaultPlan(jitter_max=8, jitter_seed=1),
    FaultPlan(horizon_ms=40),
]


def _batch(reorder: bool):
    """A reference batch (n = 3, two clients per region, GC and detached
    sends every 20 ms): dims, ctx with the key table, initial state."""
    n, cpr = 3, 2
    clients = n * cpr
    ref = RTempo(keys=1 + clients, pending_per_key=8, detached_slots=6,
                 gap_slots=4)
    port = TempoDev(keys=1 + clients, pending_per_key=8, detached_slots=6,
                    gap_slots=4)
    dims = EngineDims.for_protocol(ref, n=n, clients=clients,
                                   payload=ref.payload_width(n), regions=n)
    plans = [None, None, None] if reorder else PLANS
    specs = [
        make_lane(
            ref, Planet.new(),
            Config(n=n, f=1, gc_interval_ms=20,
                   tempo_detached_send_interval_ms=20),
            conflict_rate=100 if i % 2 else 0, commands_per_client=6,
            clients_per_region=cpr, process_regions=GCP[:n],
            client_regions=GCP[:n], dims=dims, extra_time_ms=100, seed=i,
            reorder=reorder, faults=plan,
        )
        for i, plan in enumerate(plans)
    ]
    ctx = stack_lanes(specs)
    T = int(ctx["cmd_budget"].max()) + 2
    kctx = {k: jnp.asarray(ctx[k]) for k in
            ("rng_key", "conflict_rate", "pool_size", "key_gen_kind",
             "zipf_cum")}
    ctx["key_table"] = np.asarray(jax.vmap(key_table_fn(dims.C, T))(kctx))
    return ref, port, dims, ctx, stack_states(ref, dims, specs), specs


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


@pytest.fixture(scope="module", params=["faults", "reorder"])
def trajectories(request):
    """Both engines stepped ``STEPS`` times from one initial state."""
    reorder = request.param == "reorder"
    ref, port, dims, ctx, state, specs = _batch(reorder)
    flags = batch_fault_flags(specs)
    step = jax.jit(jax.vmap(functools.partial(
        _lane_step, ref, dims, reorder=reorder, faults=flags)))
    ref_states = []
    st = jax.tree_util.tree_map(jnp.asarray, state)
    jctx = jax.tree_util.tree_map(jnp.asarray, ctx)
    for _ in range(STEPS):
        st = step(st, jctx)
        ref_states.append(jax.tree_util.tree_map(np.asarray, st))
    port_flags = FaultFlags(*flags)
    port_ctx = carry.to_torch(ctx, "cpu")
    port_states = []
    pst = carry.to_torch(state, "cpu")
    for _ in range(STEPS):
        pst = lane_step(port, dims, pst, port_ctx, reorder, port_flags)
        port_states.append(carry.to_numpy(pst))
    return (request.param, port, dims, ref_states, port_states, state,
            port_ctx, port_flags)


def test_whole_state_equal_after_every_step(trajectories):
    name, _port, _dims, ref_states, port_states, *_ = trajectories
    for i, (ref, port) in enumerate(zip(ref_states, port_states)):
        try:
            _assert_tree_equal(ref, port)
        except AssertionError as e:
            raise AssertionError(f"{name}: step {i + 1}: {e}") from None


def test_batches_reach_their_branches(trajectories):
    """Within the compared steps: the crashed process's messages and
    timers are purged and its clients halted; the partition and the
    drops lose messages; the horizon lane stops completing; the reorder
    lanes' messages overtake their prerequisites."""
    name, _port, _dims, ref_states, _p, state, *_ = trajectories
    last = ref_states[-1]
    assert (last["metrics"]["lat_count"].sum(-1) > 0).any()
    if name == "reorder":
        assert (last["requeues"] > 0).any()
        return
    crash = 1
    assert (last["next_periodic"][crash, 1] >= INF).all()
    assert (state["next_periodic"][crash, 1] < INF).any()
    lost = last["fault_dropped"]
    assert lost[3] > 0 and lost[4] > 0 and lost[0] == 0
    horizon = 6
    assert last["now"][horizon] >= 40
    done = [int(s["clients"]["completed"][horizon].sum())
            for s in ref_states]
    assert done[-1] == done[-10]  # nothing completes past the horizon


def test_frozen_steps_keep_timers_and_match_the_reference(trajectories):
    """Every third lane failed (a third of the lanes frozen): K1's twin
    under the batch's flags (the crash flag on the fault batch) returns
    a frozen lane's timers as they were, not INF, and each of 64
    ``frozen_step``s matches the reference's trajectory and predicate,
    the frozen lanes' whole tree as it was (tests/torch_frozen.py)."""
    from fantoch_tpu_torch.engine.faults import FLAG_CRASH, flag_bits
    from fantoch_tpu_torch.kernels.lane_freeze import Cap
    from fantoch_tpu_torch.kernels.qualify_pop import qualify_pop

    name, port, dims, ref_states, _p, state, port_ctx, flags = trajectories
    reorder = name == "reorder"
    bits = flag_bits(flags, reorder)
    assert bool(bits & FLAG_CRASH) != reorder
    st = carry.to_torch(failed_third(state), "cpu")
    cap = Cap(st, port_ctx, MAX_STEPS, bits)
    frozen = ~cap.running()
    timers = qualify_pop(st["pool"], st["next_periodic"],
                         port_ctx["lookahead"], port_ctx["fault_crash_t"],
                         port_ctx["fault_horizon"], bits, cap)[8]
    assert torch.equal(timers[frozen], st["next_periodic"][frozen])
    assert bool((timers[frozen] < INF).any()) and bool(frozen.any())
    frozen_steps_match(port, dims, state, carry.to_numpy(port_ctx),
                       ref_states, reorder, tuple(flags))


def test_runner_freezes_lanes_at_their_horizon(trajectories):
    """The run loop under the batch's flags, cut at ``STEPS``: each lane
    keeps the state it had when the reference's predicate
    (``_lane_running`` with the flags) turned false, as under the
    reference's vmapped while loop; the horizon lane stops early."""
    from fantoch_tpu.engine.core import _lane_running
    from fantoch_tpu.engine.faults import FaultFlags as RFlags

    name, port, dims, ref_states, _p, state, port_ctx, flags = trajectories
    reorder = name == "reorder"
    ctx = carry.to_numpy(port_ctx)
    running = jax.jit(jax.vmap(lambda s, c: _lane_running(
        dims, s, c, STEPS, RFlags(*flags))))
    before = [state] + ref_states[:-1]
    lanes = state["now"].shape[0]
    pick = [STEPS - 1] * lanes
    for i, st in enumerate(before):
        run = np.asarray(running(st, ctx))
        for lane in range(lanes):
            if not run[lane] and pick[lane] == STEPS - 1:
                pick[lane] = i - 1  # the state before step i
    want = jax.tree_util.tree_map(
        lambda *xs: np.stack([
            (xs[k + 1] if k >= 0 else xs[0])[lane]
            for lane, k in enumerate(pick)]),
        state, *ref_states)
    truncated = (want["steps"] >= STEPS) & (want["done_time"] >= INF)
    want["err"] = (want["err"] | 2 * truncated).astype(np.int32)
    final = build_runner(port, dims, max_steps=STEPS, reorder=reorder,
                         faults=flags)(carry.to_torch(state, "cpu"), port_ctx)
    _assert_tree_equal(want, carry.to_numpy(final))
    if not reorder:
        assert want["steps"][6] < STEPS  # the horizon lane stopped early
