"""Tempo one engine step at a time: the port's ``lane_step`` (on the CPU,
through the plain twins of ``qualify_pop``, ``tempo_handle``,
``emit_rewrite`` and ``land_emissions``) against
``jax.jit(jax.vmap(_lane_step))``, starting from the reference's own
lane state and ctx carried across with ``carry.to_torch``; the whole
state tree must be equal after each of the first 64 steps. Also: the
run loop's freeze on Tempo lanes (whose tree fits ``lane_freeze``'s
plane table), the CLI summary of a small Tempo sweep against the
reference CLI's, and the refusal to run the sweep without a GPU."""

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
from fantoch_tpu.engine.protocols import TempoDev as RTempo
from fantoch_tpu_torch import carry
from fantoch_tpu_torch.engine.core import build_runner, lane_step
from fantoch_tpu_torch.engine.protocols import TempoDev
from fantoch_tpu_torch.kernels.lane_freeze import (
    MAX_PLANES, TooManyPlanesError, _leaves, plane_pairs,
)
from torch_threads import one_torch_thread  # noqa: F401

STEPS = 64
GCP = Planet.new().regions()


def _batch(regions_list, fs, conflicts, cpr, commands, bumps=(None,),
           interval=20, **dims_kw):
    """A reference batch: its dims, ctx (with the key table) and initial
    state. Short GC and detached intervals so timers fire within the
    compared steps."""
    n = len(regions_list[0])
    clients = n * cpr
    ref = RTempo(keys=1 + clients, pending_per_key=8, detached_slots=6,
                 gap_slots=4)
    port = TempoDev(keys=1 + clients, pending_per_key=8, detached_slots=6,
                    gap_slots=4)
    dims = EngineDims.for_protocol(
        ref, n=n, clients=clients, payload=ref.payload_width(n), regions=n,
        **dims_kw,
    )
    points = [(r, f, c, b) for r in regions_list for f in fs
              for c in conflicts for b in bumps]
    specs = [
        make_lane(
            ref, Planet.new(),
            Config(n=n, f=f, gc_interval_ms=interval,
                   tempo_detached_send_interval_ms=interval,
                   tempo_clock_bump_interval_ms=bump),
            conflict_rate=cf, commands_per_client=commands,
            clients_per_region=cpr, process_regions=regions,
            client_regions=regions, dims=dims, extra_time_ms=100, seed=i,
        )
        for i, (regions, f, cf, bump) in enumerate(points)
    ]
    ctx = stack_lanes(specs)
    T = int(ctx["cmd_budget"].max()) + 2
    kctx = {k: jnp.asarray(ctx[k]) for k in
            ("rng_key", "conflict_rate", "pool_size", "key_gen_kind",
             "zipf_cum")}
    ctx["key_table"] = np.asarray(jax.vmap(key_table_fn(dims.C, T))(kctx))
    return ref, port, dims, ctx, stack_states(ref, dims, specs)


# (a) n = 3, two clients per region, conflict 0 and 100, the clock bump
#     off and every 10 ms: fast-path commits, drains, GC, detached sends;
# (b) n = 5, f = 2: slow-path consensus rounds;
# (c) as (a) with a 2-slot dot window: MCollects bounce off the gate
CASES = {
    "fast": dict(regions_list=[GCP[:3], ["asia-east1", "us-central1",
                                         "us-west1"]],
                 fs=[1], conflicts=[0, 100], cpr=2, commands=6,
                 bumps=(None, 10)),
    "slow": dict(regions_list=[GCP[2:7]], fs=[2], conflicts=[100], cpr=1,
                 commands=4),
    "requeue": dict(regions_list=[GCP[:3]], fs=[1], conflicts=[100],
                    cpr=2, commands=6, dot_slots=2),
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
    ref, port, dims, ctx, state = _batch(**CASES[request.param])
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
    """Within the compared steps votes are counted everywhere; the fast
    case completes commands and GCs them (the clock-bump lanes lift
    their clocks to the wall clock in microseconds, and some overflow
    their detached slots), the slow case takes the slow path and the
    requeue case bounces messages off the readiness gate."""
    name, _port, _dims, ref_states, _p, _s, _c = trajectories
    last = ref_states[-1]
    ps = last["ps"]
    assert (ps["vote_front"].max((1, 2, 3)) > 0).all()
    if name == "fast":
        plain, bump = slice(0, None, 2), slice(1, None, 2)
        assert (last["metrics"]["lat_count"].sum(-1) > 0).all()
        assert (ps["m_stable"][plain].sum(-1) > 0).all()
        assert not last["err"][plain].any()
        assert ps["clocks"][bump].max() >= 1000 > ps["clocks"][plain].max()
        assert (last["err"][bump] == 16).any()          # ERR_CAPACITY
    if name == "slow":
        assert (ps["m_slow"].sum(-1) > 0).all()
        assert (ps["m_stable"].sum(-1) > 0).all()
    if name == "requeue":
        assert last["requeues"].max() > 0
        assert (last["metrics"]["lat_count"].sum(-1) > 0).all()


def test_runner_freezes_finished_lanes(trajectories):
    """The run loop's per-lane freeze on Tempo lanes: cut by
    ``max_steps``, each lane keeps its state exactly, as under the
    reference's vmapped while loop."""
    _name, port, dims, ref_states, _p, state, port_ctx = trajectories
    final = build_runner(port, dims, max_steps=5)(
        carry.to_torch(state, "cpu"), port_ctx
    )
    want = dict(ref_states[4])
    truncated = (want["steps"] >= 5) & (want["done_time"] >= 1 << 30)
    want["err"] = (want["err"] | 2 * truncated).astype(np.int32)
    _assert_tree_equal(want, carry.to_numpy(final))


def test_tempo_tree_fits_the_freeze_plane_table(trajectories):
    """``lane_freeze`` passes one plane table per launch: Tempo's lane
    tree (52 planes, 30 of them protocol planes) fits it, and a tree
    over the limit is refused by name."""
    _name, port, dims, _r, _p, state, port_ctx = trajectories
    old = carry.to_torch(state, "cpu")
    new = lane_step(port, dims, old, port_ctx)
    assert len(_leaves(new, old)) == 52
    assert len(new["ps"]) == 30
    pairs = plane_pairs(new, old)
    assert len(pairs) <= MAX_PLANES
    more = MAX_PLANES + 1 - len(pairs)
    wide = dict(new, extra={f"p{i}": torch.zeros(2) for i in range(more)})
    wide_old = dict(old, extra={f"p{i}": torch.ones(2) for i in range(more)})
    with pytest.raises(TooManyPlanesError, match=f"{MAX_PLANES + 1} planes"):
        plane_pairs(wide, wide_old)


def test_cli_summary_matches_reference(capsys):
    from fantoch_tpu.cli import main as r_main
    from fantoch_tpu_torch.cli import main

    grid = ["sweep", "--protocol", "tempo", "--n", "3", "--subsets", "2",
            "--fs", "1,2", "--commands", "3", "--conflicts", "0,100"]
    r_main(["--platform", "cpu", *grid])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    main(["--device", "cpu", *grid])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want
    assert got["points"] == 8 and got["errors"] == 0


def test_sweep_without_a_gpu_raises(monkeypatch):
    """The Tempo sweep runs on the card unless ``--device cpu``."""
    from fantoch_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["sweep", "--protocol", "tempo", "--n", "3", "--subsets", "1",
              "--commands", "1", "--conflicts", "0"])
