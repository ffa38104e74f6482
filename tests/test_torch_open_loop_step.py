"""Open-loop arrivals one engine step at a time: the port's ``lane_step``
(on the CPU, through the plain twins of ``qualify_pop``,
``tempo_handle``, ``emit_rewrite`` under ``FLAG_OPEN_LOOP`` and
``land_emissions``) against ``jax.jit(jax.vmap(_lane_step))`` from the
reference's own open-loop lane state and ctx carried across with
``carry.to_torch``; the whole state tree, the ring of completion times
``ol_comp_t`` and the release clamp ``ol_last_rel`` included, must be
equal after each of the first 64 steps. A Tempo batch (n = 3, two
clients a region) of Poisson arrivals at load 400 and a window of 2,
conflict 100 and 0, and a burst lane; within the compared steps a
SUBMIT is staged at its pop (trigger 1) and a completion admits a
window-blocked command (trigger 2).

A client's results all come from its one attached process, which
handles one event a step, and every protocol's handler emits at most
one result a call, so no protocol completes two commands of one client
in one step. The count-based attribution for that case (ranks, latency
from each row's arrival, several ring slots) is compared on a second
batch run through a double-reply wrapper of Tempo on both sides: a
handler's result row is copied into its outbox's last slot when that is
free, so a client completes two commands in such a step. Tolerance:
none (integer state)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fantoch_tpu.core import Config, Planet
from fantoch_tpu.engine import EngineDims, make_lane, stack_lanes
from fantoch_tpu.engine.core import _lane_step, key_table_fn
from fantoch_tpu.engine.driver import stack_states
from fantoch_tpu.engine.protocols import TempoDev as RTempo
from fantoch_tpu_torch import carry
from fantoch_tpu_torch.engine.core import lane_step
from fantoch_tpu_torch.engine.protocols import TempoDev
from torch_open_loop import PortDoubleReply
from torch_threads import one_torch_thread  # noqa: F401

STEPS = 64
WINDOW = 2
GCP = Planet.new().regions()
# (arrival preset, conflict, seed) of each lane
LANES = [("poisson", 100, 0), ("poisson", 0, 1), ("burst", 100, 2)]


class _RefDoubleReply:
    """The reference's Tempo, each handler's result row also copied into
    its outbox's last slot when that slot is free."""

    def __init__(self, base):
        self._base = base

    def __getattr__(self, name):
        return getattr(self._base, name)

    def handle(self, ps, msg, me, t, ctx, dims):
        ps, ob = self._base.handle(ps, msg, me, t, ctx, dims)
        is_tc = ob["valid"] & (ob["dst"] >= dims.N)
        i, j = jnp.argmax(is_tc), ob["valid"].shape[0] - 1
        dup = jnp.any(is_tc) & ~ob["valid"][j] & (i != j)
        return ps, {k: v.at[j].set(jnp.where(dup, v[i], v[j]))
                    for k, v in ob.items()}


def _batch(double: bool = False):
    """A reference batch: dims, ctx with the key table, initial state."""
    n, cpr = 3, 2
    clients = n * cpr
    kw = dict(keys=1 + clients, pending_per_key=16, detached_slots=8,
              gap_slots=6)
    ref, port = RTempo(**kw), TempoDev(**kw)
    if double:
        ref, port = _RefDoubleReply(ref), PortDoubleReply(port)
    dims = EngineDims.for_protocol(ref, n=n, clients=clients,
                                   payload=ref.payload_width(n), regions=n)
    specs = [
        make_lane(
            ref, Planet.new(),
            Config(n=n, f=1, gc_interval_ms=20,
                   tempo_detached_send_interval_ms=20),
            conflict_rate=conflict, commands_per_client=8,
            clients_per_region=cpr, process_regions=GCP[:n],
            client_regions=GCP[:n], dims=dims, extra_time_ms=100, seed=seed,
            arrivals=arrivals, arrival_load=400, open_window=WINDOW,
        )
        for arrivals, conflict, seed in LANES
    ]
    ctx = stack_lanes(specs)
    T = int(ctx["cmd_budget"].max()) + 2
    kctx = {k: jnp.asarray(ctx[k]) for k in
            ("rng_key", "conflict_rate", "pool_size", "key_gen_kind",
             "zipf_cum")}
    ctx["key_table"] = np.asarray(jax.vmap(key_table_fn(dims.C, T))(kctx))
    return ref, port, dims, ctx, stack_states(ref, dims, specs)


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


@pytest.fixture(scope="module", params=["tempo", "double_reply"])
def trajectories(request):
    """Both engines stepped ``STEPS`` times from one initial state."""
    ref, port, dims, ctx, state = _batch(request.param == "double_reply")
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
    return request.param, ctx, state, ref_states, port_states


def test_whole_state_equal_after_every_step(trajectories):
    _name, _ctx, state, ref_states, port_states = trajectories
    assert "ol_comp_t" in state["clients"]
    for i, (ref, port) in enumerate(zip(ref_states, port_states)):
        try:
            _assert_tree_equal(ref, port)
        except AssertionError as e:
            raise AssertionError(f"step {i + 1}: {e}") from None


def test_batch_reaches_both_triggers_and_multi_completions(trajectories):
    """Per client and step, from the reference's states: trigger 2 is a
    step whose completions admit the command after the last issued one
    (the window was full before it and is not after it); trigger 1 is
    an issue beyond those; a multi-completion step completes two or
    more of one client's commands (the double-reply batch only)."""
    name, ctx, state, ref_states, _port = trajectories
    budget = ctx["cmd_budget"]
    t1 = t2 = multi = 0
    prev = state["clients"]
    for st in ref_states:
        cl = st["clients"]
        k0, k1 = prev["completed"], cl["completed"]
        pend = prev["issued"] + 1
        trig2 = ((k1 > k0) & (prev["issued"] < budget)
                 & (k1 + WINDOW >= pend) & (k0 + WINDOW < pend))
        t2 += int(trig2.sum())
        t1 += int((cl["issued"] - prev["issued"] - trig2 > 0).sum())
        multi += int((k1 - k0 >= 2).sum())
        prev = cl
    assert t1 > 0 and t2 > 0, (t1, t2)
    assert (multi > 0) == (name == "double_reply"), multi


def test_open_loop_monitored_caesar_frozen_steps_keep_a_frozen_lane():
    """The widest lane tree: monitored Caesar on open-loop lanes (with
    the ring and the release clamp), lane 0 failed. Each of 64
    ``frozen_step``s leaves lane 0's whole tree as it was and reports it
    not running (K2's ``running``), and lane 1 steps as in an unfrozen
    run of the batch."""
    from fantoch_tpu_torch.core import Config as PConfig
    from fantoch_tpu_torch.core import Planet as PPlanet
    from fantoch_tpu_torch.engine import EngineDims as PDims
    from fantoch_tpu_torch.engine import make_lane as p_make_lane
    from fantoch_tpu_torch.engine.driver import prepare_batch
    from fantoch_tpu_torch.engine.protocols import (
        dev_config_kwargs, dev_protocol,
    )
    from fantoch_tpu_torch.engine.core import frozen_step
    from fantoch_tpu_torch.kernels.step_loop import clone_tree

    n = 3
    proto = dev_protocol("caesar", n)
    dims = PDims.for_protocol(proto, n=n, clients=n,
                              payload=proto.payload_width(n),
                              total_commands=3 * n, dot_slots=3 * n + 1,
                              regions=n)
    specs = [
        p_make_lane(proto, PPlanet.new(),
                    PConfig(**dev_config_kwargs("caesar", n, 1)),
                    conflict_rate=100, commands_per_client=3,
                    clients_per_region=1, process_regions=GCP[:n],
                    client_regions=GCP[:n], dims=dims, seed=seed,
                    arrivals="poisson", arrival_load=400, open_window=2)
        for seed in (0, 1)
    ]
    state, ctx = prepare_batch(proto, dims, specs, "cpu", monitor_keys=4)
    free = clone_tree(state)
    st = dict(clone_tree(state), err=state["err"].clone())
    st["err"][0] = 64
    before = carry.to_numpy(st)
    for _ in range(64):
        free = lane_step(proto, dims, free, ctx, monitor_keys=4)
        st, running = frozen_step(proto, dims, st, ctx, 1 << 22,
                                  monitor_keys=4)
        assert running.tolist() == [False, True]
    got, want = carry.to_numpy(st), carry.to_numpy(free)
    leaves = _leaves(got, before, want)
    assert {"ol_comp_t", "ol_last_rel", "mon_hash", "viol"} <= {
        path.split("/")[-1] for path, *_ in leaves}
    for path, g, b, w in leaves:
        np.testing.assert_array_equal(g[0], b[0], err_msg=path)
        np.testing.assert_array_equal(g[1], w[1], err_msg=path)
    assert got["clients"]["completed"][1].sum() > 0


def _leaves(got, before, want, path=""):
    """``(path, got, before, want)`` for every plane of three trees."""
    if isinstance(got, dict):
        return [x for k in got for x in _leaves(got[k], before[k], want[k],
                                               f"{path}/{k}")]
    return [(path, got, before, want)]
