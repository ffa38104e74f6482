"""Tempo under partial replication one engine step at a time: the port's
``lane_step`` (on the CPU, through the plain twins of ``qualify_pop``,
``tempo_partial_handle``, ``emit_rewrite`` and ``land_emissions``)
against ``jax.jit(jax.vmap(_lane_step))`` of the reference's
``TempoPartialDev``, starting from the reference's own lane state and
ctx (with the sweep's key table, as the reference's ``run_sweep``
carries it) moved across with ``carry.to_torch``. After each of the
first 64 steps the whole state tree must be equal, and so must the
handler phase's outputs (readiness, state and both outboxes) against
the reference's ``ready``/``periodic``/``run_handlers`` on the same
inputs. The lanes reach all fifteen message types and the three
timers within those steps. Also: the run loop's freeze on these lanes
(whose tree fits ``lane_freeze``'s plane table), the CLI summary of a
small partial sweep against the reference CLI's, and the refusal to run
the sweep without a GPU."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fantoch_tpu.core import Config, Planet
from fantoch_tpu.engine import EngineDims, make_lane, stack_lanes
from fantoch_tpu.engine.core import _lane_step, key_table_fn
from fantoch_tpu.engine.driver import stack_states
from fantoch_tpu.engine.protocols import TempoPartialDev as RTempoPartial
from fantoch_tpu_torch import carry
from fantoch_tpu_torch.engine.core import build_runner, lane_step
from fantoch_tpu_torch.engine.dims import PMT
from fantoch_tpu_torch.engine.protocols import TempoPartialDev
from fantoch_tpu_torch.kernels.lane_freeze import (
    MAX_PLANES, TooManyPlanesError, _leaves, plane_pairs,
)
from test_torch_kernels import _ref_handler_lane
from torch_threads import one_torch_thread  # noqa: F401

STEPS = 64
# small tables (K = pool + clients + 1), so that slots fill
SIZES = dict(pending_per_key=8, detached_slots=6, gap_slots=4)
EU5 = ["europe-west1", "europe-west2", "europe-west3", "europe-west4",
       "europe-west6"]
EU3 = ["europe-west1", "europe-west3", "europe-west4"]
# (regions, f, conflict, clock bump ms): close regions so that commands
# commit within the compared steps; f = 2 at n = 5 takes the slow path;
# the n = 3 lanes pad the process axis; GC every 10 ms and detached
# sends every 20 ms, the clock bump every 10 ms on two lanes
POINTS = [(EU5, 2, 100, None), (EU5, 2, 50, 10), (EU3, 1, 100, None),
          (EU3, 1, 10, 10)]
SHARDS, KPC, POOL, COMMANDS = 2, 2, 4, 4


def _batch():
    """The reference batch: its protocol, dims, ctx (with the key table)
    and initial state."""
    clients = 5
    ref = RTempoPartial(keys=POOL + clients + 1, shards=SHARDS,
                        keys_per_cmd=KPC, **SIZES)
    dims = EngineDims.for_partial(ref, 5, clients, COMMANDS * clients,
                                  regions=5)
    specs = []
    for i, (regions, f, conflict, bump) in enumerate(POINTS):
        config = Config(
            n=len(regions), f=f, shard_count=SHARDS, gc_interval_ms=10,
            tempo_detached_send_interval_ms=20,
            tempo_clock_bump_interval_ms=bump,
            executor_executed_notification_interval_ms=100,
            executor_cleanup_interval_ms=100,
        )
        specs.append(make_lane(
            ref, Planet.new(), config, conflict_rate=conflict,
            pool_size=POOL, commands_per_client=COMMANDS,
            clients_per_region=1, process_regions=regions,
            client_regions=regions, dims=dims, extra_time_ms=100, seed=i,
        ))
    ctx = stack_lanes(specs)
    T = int(ctx["cmd_budget"].max()) + 2
    kctx = {k: jnp.asarray(ctx[k]) for k in
            ("rng_key", "conflict_rate", "pool_size", "key_gen_kind",
             "zipf_cum")}
    ctx["key_table"] = np.asarray(jax.vmap(key_table_fn(dims.C, T))(kctx))
    return ref, dims, ctx, stack_states(ref, dims, specs)


class _Recording(TempoPartialDev):
    """The port's protocol, keeping each step's handler inputs and
    outputs."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.calls = []

    def handlers(self, ps, has, rows, fire, ep, ctx, dims):
        out = super().handlers(ps, has, rows, fire, ep, ctx, dims)
        self.calls.append(carry.to_numpy(
            {"in": {"ps": ps, "has": has, "rows": rows, "fire": fire,
                    "ep": ep},
             "out": dict(zip(("rdy", "ps", "pout", "hout"), out))}))
        return out


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


@pytest.fixture(scope="module")
def trajectories():
    """Both engines stepped ``STEPS`` times from one initial state."""
    ref, dims, ctx, state = _batch()
    step = jax.jit(jax.vmap(functools.partial(_lane_step, ref, dims)))
    ref_states = []
    st = jax.tree_util.tree_map(jnp.asarray, state)
    jctx = jax.tree_util.tree_map(jnp.asarray, ctx)
    for _ in range(STEPS):
        st = step(st, jctx)
        ref_states.append(jax.tree_util.tree_map(np.asarray, st))
    port = _Recording(keys=ref.K, shards=SHARDS, keys_per_cmd=KPC, **SIZES)
    port_ctx = carry.to_torch(ctx, "cpu")
    port_states = []
    pst = carry.to_torch(state, "cpu")
    for _ in range(STEPS):
        pst = lane_step(port, dims, pst, port_ctx)
        port_states.append(carry.to_numpy(pst))
    return ref, port, dims, ctx, ref_states, port_states, state, port_ctx


def test_whole_state_equal_after_every_step(trajectories):
    _r, _p, _d, _c, ref_states, port_states, _s, _pc = trajectories
    for i, (ref, port) in enumerate(zip(ref_states, port_states)):
        try:
            _assert_tree_equal(ref, port)
        except AssertionError as e:
            raise AssertionError(f"step {i + 1}: {e}") from None


def test_handler_outputs_equal_after_every_step(trajectories):
    """Each step's handler phase (readiness, new state, periodic and
    handler outboxes, every slot) equals the reference's on the same
    inputs."""
    ref, port, dims, ctx, _rs, _ps, _s, _pc = trajectories
    handler = jax.jit(jax.vmap(
        lambda *a: _ref_handler_lane(ref, dims, *a)
    ))
    for i, call in enumerate(port.calls):
        a = call["in"]
        want = handler(a["ps"], a["has"], a["rows"], a["fire"], ctx,
                       a["ep"])
        want = dict(zip(("rdy", "ps", "pout", "hout"),
                        jax.tree_util.tree_map(np.asarray, want)))
        try:
            _assert_tree_equal(want, call["out"])
        except AssertionError as e:
            raise AssertionError(f"step {i + 1}: {e}") from None


def test_steps_reach_every_type_and_timer(trajectories):
    """Within the compared steps every one of the fifteen message types
    is handled (the shard forwards, bumps, shard commits and their
    aggregates, StableAtShard, the slow path's consensus round) and all
    three timers fire; commands complete and no lane errs."""
    _r, port, _d, _c, ref_states, _p, _s, _pc = trajectories
    handled = np.zeros(TempoPartialDev.NUM_TYPES, int)
    fired = np.zeros(3, int)
    for call in port.calls:
        a = call["in"]
        mt = np.where(a["has"] & call["out"]["rdy"], a["rows"][..., PMT], -1)
        handled += [(mt == t).sum() for t in range(len(handled))]
        fired += a["fire"].sum((0, 1))
    assert (handled > 0).all(), handled
    assert (fired > 0).all(), fired
    last = ref_states[-1]
    assert not last["err"].any()
    assert last["clients"]["completed"].sum() > 0
    assert last["ps"]["m_slow"].sum() > 0


def test_runner_freezes_finished_lanes(trajectories):
    """The run loop's per-lane freeze: cut by ``max_steps``, each lane
    keeps its state exactly, as under the reference's vmapped while
    loop."""
    _r, port, dims, _c, ref_states, _p, state, port_ctx = trajectories
    final = build_runner(port, dims, max_steps=5)(
        carry.to_torch(state, "cpu"), port_ctx
    )
    want = dict(ref_states[4])
    truncated = (want["steps"] >= 5) & (want["done_time"] >= 1 << 30)
    want["err"] = (want["err"] | 2 * truncated).astype(np.int32)
    _assert_tree_equal(want, carry.to_numpy(final))


def test_partial_tree_fits_the_freeze_plane_table(trajectories):
    """``lane_freeze`` passes one plane table per launch: the partial
    lane tree (63 planes, 41 of them protocol planes) fits it, and a
    tree over the limit is refused by name."""
    _r, port, dims, _c, _rs, _p, state, port_ctx = trajectories
    old = carry.to_torch(state, "cpu")
    new = lane_step(port, dims, old, port_ctx)
    assert len(_leaves(new, old)) == 63
    assert len(new["ps"]) == 41
    pairs = plane_pairs(new, old)
    assert len(pairs) <= MAX_PLANES
    more = MAX_PLANES + 1 - len(pairs)
    wide = dict(new, extra={f"p{i}": torch.zeros(2) for i in range(more)})
    wide_old = dict(old, extra={f"p{i}": torch.ones(2) for i in range(more)})
    with pytest.raises(TooManyPlanesError, match=f"{MAX_PLANES + 1} planes"):
        plane_pairs(wide, wide_old)


GRID = ["sweep", "--protocol", "tempo", "--n", "3", "--shards", "2",
        "--keys-per-command", "2", "--pool-size", "4", "--subsets", "2",
        "--commands", "3", "--conflicts", "10,100"]


def test_cli_summary_matches_reference(capsys):
    from fantoch_tpu.cli import main as r_main
    from fantoch_tpu_torch.cli import main

    r_main(["--platform", "cpu", *GRID])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    main(["--device", "cpu", *GRID])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want
    assert got["points"] == 4 and got["errors"] == 0


def test_sweep_without_a_gpu_raises(monkeypatch):
    """The partial sweep runs on the card unless ``--device cpu``."""
    from fantoch_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(GRID)
