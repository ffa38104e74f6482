"""Atlas and EPaxos one engine step at a time: the port's ``lane_step``
(on the CPU, through the plain twins of ``qualify_pop``,
``graphdep_handle``, ``emit_rewrite`` and ``land_emissions``) against
``jax.jit(jax.vmap(_lane_step))``, starting from the reference's own
lane state and ctx carried across with ``carry.to_torch``; the whole
state tree must be equal after each of the first 64 steps. Also: the
run loop's freeze on these lanes, 64 ``frozen_step``s with every third
lane failed against the reference's trajectory and predicate
(tests/torch_frozen.py), the CLI summary of small Atlas and EPaxos
sweeps against the reference CLI's, and the refusal to run the sweep
without a GPU."""

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
from fantoch_tpu_torch.engine.dims import INF, PA, PMT
from fantoch_tpu.engine.driver import stack_states
from fantoch_tpu.engine.protocols import AtlasDev as RAtlas
from fantoch_tpu.engine.protocols import EPaxosDev as REPaxos
from fantoch_tpu_torch import carry
from fantoch_tpu_torch.engine.core import build_runner, lane_step
from fantoch_tpu_torch.engine.protocols import AtlasDev, EPaxosDev
from torch_frozen import frozen_steps_match
from torch_threads import one_torch_thread  # noqa: F401

STEPS = 64
GCP = Planet.new().regions()
PROTOCOLS = {"atlas": (RAtlas, AtlasDev), "epaxos": (REPaxos, EPaxosDev)}


def _batch(name, regions_list, fs, conflicts, cpr, commands, interval=20,
           **dims_kw):
    """A reference batch: its dims, ctx (with the key table) and initial
    state. A short GC interval, so the timer fires within the compared
    steps."""
    rcls, pcls = PROTOCOLS[name]
    n = len(regions_list[0])
    clients = n * cpr
    ref, port = rcls(keys=1 + clients), pcls(keys=1 + clients)
    dims = EngineDims.for_protocol(
        ref, n=n, clients=clients, payload=ref.payload_width(n), regions=n,
        **dims_kw,
    )
    points = [(r, f, c) for r in regions_list for f in fs for c in conflicts]
    specs = [
        make_lane(
            ref, Planet.new(), Config(n=n, f=f, gc_interval_ms=interval),
            conflict_rate=cf, commands_per_client=commands,
            clients_per_region=cpr, process_regions=regions,
            client_regions=regions, dims=dims, extra_time_ms=100, seed=i,
        )
        for i, (regions, f, cf) in enumerate(points)
    ]
    ctx = stack_lanes(specs)
    T = int(ctx["cmd_budget"].max()) + 2
    kctx = {k: jnp.asarray(ctx[k]) for k in
            ("rng_key", "conflict_rate", "pool_size", "key_gen_kind",
             "zipf_cum")}
    ctx["key_table"] = np.asarray(jax.vmap(key_table_fn(dims.C, T))(kctx))
    return ref, port, dims, ctx, stack_states(ref, dims, specs)


# n = 5 over two region sets, f = 1 and 2, conflict 0 and 100, two
# clients per region: fast and slow paths, merged dep reports, drain
# chains and GC, for each protocol
CASES = {
    name: dict(name=name, regions_list=[GCP[:5], GCP[2:7]], fs=[1, 2],
               conflicts=[0, 100], cpr=2, commands=4)
    for name in PROTOCOLS
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


def test_batches_reach_their_paths(trajectories):
    """Within the compared steps commands complete on the fast path and
    on the slow path, some dep report merges into an entry another
    reporter made (a count above 1), a drain chains (an MDRAIN
    self-message in flight, sent while more than one dot was ready),
    dots execute, and GC advances."""
    _name, _port, _dims, ref_states, _p, _s, _c = trajectories
    last = ref_states[-1]
    ps = last["ps"]
    assert (last["metrics"]["lat_count"].sum(-1) > 0).any()
    assert ps["m_fast"].sum() > 0
    assert ps["m_slow"].sum() > 0
    assert any((st["ps"]["qd_cnt"] > 1).any() for st in ref_states)
    assert any(((st["pool"][..., PMT] == RAtlas.MDRAIN)
                & (st["pool"][..., PA] < INF)).any() for st in ref_states)
    assert (ps["exec_front"] > 0).any()
    assert (ps["m_stable"].sum(-1) > 0).any()
    assert not last["err"].any()


def test_runner_freezes_finished_lanes(trajectories):
    """The run loop's per-lane freeze on these lanes: cut by
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


def test_frozen_steps_match_the_reference(trajectories):
    """With every third lane failed, each of 64 ``frozen_step``s leaves
    the failed lanes' whole tree as it was (no select follows the step),
    steps the others as the reference does, and reports the reference's
    predicate as K2's ``running``."""
    _name, port, dims, ref_states, _p, state, port_ctx = trajectories
    frozen_steps_match(port, dims, state, carry.to_numpy(port_ctx),
                       ref_states)


@pytest.mark.parametrize("name", sorted(PROTOCOLS))
def test_cli_summary_matches_reference(name, capsys):
    from fantoch_tpu.cli import main as r_main
    from fantoch_tpu_torch.cli import main

    grid = ["sweep", "--protocol", name, "--n", "3", "--subsets", "2",
            "--fs", "1,2", "--commands", "3", "--conflicts", "0,100"]
    r_main(["--platform", "cpu", *grid])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    main(["--device", "cpu", *grid])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want
    assert got["points"] == 8 and got["errors"] == 0


@pytest.mark.parametrize("name", sorted(PROTOCOLS))
def test_sweep_without_a_gpu_raises(name, monkeypatch):
    """The sweep runs on the card unless ``--device cpu``."""
    from fantoch_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["sweep", "--protocol", name, "--n", "3", "--subsets", "1",
              "--commands", "1", "--conflicts", "0"])
