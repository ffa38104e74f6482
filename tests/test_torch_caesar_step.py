"""Caesar one engine step at a time: the port's ``lane_step`` (on the CPU,
through the plain twins of ``qualify_pop``, ``caesar_handle``,
``emit_rewrite`` and ``land_emissions``) against
``jax.jit(jax.vmap(_lane_step))``, starting from the reference's own lane
state and ctx carried across with ``carry.to_torch``; the whole state
tree, and each step's handler phase with both outboxes, must be equal
at each of the first 64 steps, on a batch that
reaches a waiting proposal, a reject, an MRetry round, an exec chain,
the notification timer and a GC free. Also: the run loop's freeze on
these lanes (whose tree fits ``lane_freeze``'s plane table), the CLI
summary of small Caesar sweeps (wait condition on and off) against the
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
from fantoch_tpu.engine.core import _lane_step, key_table_fn, run_handlers
from fantoch_tpu.engine.driver import stack_states
from fantoch_tpu.engine.protocols import CaesarDev as RCaesar
from fantoch_tpu_torch import carry
from fantoch_tpu_torch.engine.core import build_runner, lane_step
from fantoch_tpu_torch.engine.dims import INF, PA, PMT, PPAY, PSRC
from fantoch_tpu_torch.engine.protocols import CaesarDev
from fantoch_tpu_torch.kernels.caesar_handle import caesar_handle_plain
from fantoch_tpu_torch.kernels.qualify_pop import qualify_pop
from fantoch_tpu_torch.kernels.lane_freeze import MAX_PLANES, plane_pairs
from torch_threads import one_torch_thread  # noqa: F401

STEPS = 64
GCP = Planet.new().regions()
# the six European regions: short delays, so the compared steps reach an
# executed dot's notification and GC
EUROPE = [r for r in GCP if r.startswith("europe")]


def _batch(regions_list, fs, waits, conflicts, cpr, commands, interval=20,
           notify=10):
    """A reference batch: its dims, ctx (with the key table) and initial
    state. Short GC and notification intervals, so both timers fire and
    a dot is freed within the compared steps."""
    n = len(regions_list[0])
    clients = n * cpr
    ref = RCaesar.for_load(keys=1 + clients, clients=clients)
    port = CaesarDev.for_load(keys=1 + clients, clients=clients)
    dims = EngineDims.for_protocol(
        ref, n=n, clients=clients, payload=ref.payload_width(n), regions=n,
    )
    points = [(r, f, w, c) for r in regions_list for f in fs for w in waits
              for c in conflicts]
    specs = [
        make_lane(
            ref, Planet.new(),
            Config(n=n, f=f, gc_interval_ms=interval,
                   executor_executed_notification_interval_ms=notify,
                   caesar_wait_condition=wait),
            conflict_rate=cf, commands_per_client=commands,
            clients_per_region=cpr, process_regions=regions,
            client_regions=regions, dims=dims, extra_time_ms=100, seed=i,
        )
        for i, (regions, f, wait, cf) in enumerate(points)
    ]
    ctx = stack_lanes(specs)
    T = int(ctx["cmd_budget"].max()) + 2
    kctx = {k: jnp.asarray(ctx[k]) for k in
            ("rng_key", "conflict_rate", "pool_size", "key_gen_kind",
             "zipf_cum")}
    ctx["key_table"] = np.asarray(jax.vmap(key_table_fn(dims.C, T))(kctx))
    return port, dims, ctx, stack_states(ref, dims, specs)


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


def _ref_handlers(proto, dims, ps, has, rows, fire, ep, ctx):
    """One lane's handler phase in the reference (core.py:873-918):
    ``(rdy, ps, periodic outbox, handler outbox)``."""
    procs = jnp.arange(dims.N, dtype=jnp.int32)
    msg = {"valid": has, "src": rows[:, PSRC],
           "mtype": jnp.where(has, rows[:, PMT], proto.NUM_TYPES),
           "payload": rows[:, PPAY:]}
    rdy = jax.vmap(lambda p, m, me: proto.ready(p, m, me, ctx, dims))(
        ps, msg, procs)
    msg = dict(msg, valid=has & rdy,
               mtype=jnp.where(has & rdy, msg["mtype"], proto.NUM_TYPES))
    ps, pout = jax.vmap(
        lambda p, f, me, t: proto.periodic(p, f, me, t, ctx, dims)
    )(ps, fire, procs, ep)
    ps, hout = run_handlers(proto, ps, msg, procs, ep, ctx, dims)
    return rdy, ps, pout, hout


@pytest.fixture(scope="module")
def trajectories():
    """Both engines stepped ``STEPS`` times from one initial state: n = 5
    over two sets of European regions, f = 1 and 2, the wait condition on
    and off, all at conflict 100 with one client per region."""
    port, dims, ctx, state = _batch([EUROPE[:5], EUROPE[1:6]], [1, 2],
                                    [True, False], [100], cpr=1, commands=4)
    ref = RCaesar.for_load(keys=port.K, clients=dims.C)
    step = jax.jit(jax.vmap(functools.partial(_lane_step, ref, dims)))
    handlers = jax.jit(jax.vmap(functools.partial(_ref_handlers, ref, dims)))
    ref_states = []
    st = jax.tree_util.tree_map(jnp.asarray, state)
    jctx = jax.tree_util.tree_map(jnp.asarray, ctx)
    for _ in range(STEPS):
        st = step(st, jctx)
        ref_states.append(jax.tree_util.tree_map(np.asarray, st))
    port_ctx = carry.to_torch(ctx, "cpu")
    port_states, outboxes = [], []
    pst = carry.to_torch(state, "cpu")
    for _ in range(STEPS):
        # each step's handler phase on its own, in both engines: the pop
        # of the step (K1's twin), then the reference's handlers and K10's
        # twin on it
        _a, ep, _n, _act, fire, _s, has, rows, _t = qualify_pop(
            pst["pool"], pst["next_periodic"], port_ctx["lookahead"])
        got = caesar_handle_plain(pst["ps"], has, rows, fire, port_ctx, dims)
        want = handlers(carry.to_numpy(pst["ps"]), has.numpy(), rows.numpy(),
                        fire.numpy(), ep.numpy(), jctx)
        outboxes.append(([carry.to_numpy(x) for x in got],
                         jax.tree_util.tree_map(np.asarray, list(want))))
        pst = lane_step(port, dims, pst, port_ctx)
        port_states.append(carry.to_numpy(pst))
    return port, dims, ref_states, port_states, state, port_ctx, outboxes


def test_whole_state_equal_after_every_step(trajectories):
    _port, _dims, ref_states, port_states, _s, _c, _o = trajectories
    for i, (ref, port) in enumerate(zip(ref_states, port_states)):
        try:
            _assert_tree_equal(ref, port)
        except AssertionError as e:
            raise AssertionError(f"step {i + 1}: {e}") from None


def test_both_outboxes_equal_after_every_step(trajectories):
    """The gate, the periodic and the handler outboxes (every row, the
    invalid ones the scans write too) and the handler phase's state equal
    the reference's at each of the compared steps."""
    _port, dims, _r, _p, _s, _c, outboxes = trajectories
    for i, (got, want) in enumerate(outboxes):
        for name, g, w in zip(("rdy", "ps", "periodic", "handler"), got,
                              want):
            try:
                if isinstance(w, dict):
                    _assert_tree_equal(w, g, name)
                else:
                    assert np.array_equal(w, g), name
            except AssertionError as e:
                raise AssertionError(f"step {i + 1}: {e}") from None
    # the scans' slots were written on every step, valid or not
    hout = outboxes[-1][1][3]
    assert (hout["mtype"][..., dims.F - 2] == RCaesar.MPROPOSEACK).all()


def _in_pool(st, mtype):
    pool = st["pool"]
    return ((pool[..., PMT] == mtype) & (pool[..., PA] < INF)).any()


def test_batch_reaches_its_paths(trajectories):
    """Within the compared steps: a proposal waits on its blockers (a
    WAIT_DRAIN chain too), some proposal is rejected, an MRetry round
    runs, the executor chains (EXEC_DRAIN), the notification timer moves
    executed dots into the GC buffer, a GC free happens, and commands
    complete on the fast and the slow path."""
    _port, _dims, ref_states, _p, _s, _c, _o = trajectories
    X = RCaesar
    ps_all = [st["ps"] for st in ref_states]
    assert any(((ps["status"] == 2) & (ps["bb_seq"] > 0).any(-1)).any()
               for ps in ps_all)
    assert any(_in_pool(st, X.WAIT_DRAIN) for st in ref_states)
    assert any((ps["status"] == 3).any() for ps in ps_all)
    assert any(_in_pool(st, X.MRETRY) for st in ref_states)
    assert any(_in_pool(st, X.MRETRYACK) for st in ref_states)
    assert any(_in_pool(st, X.EXEC_DRAIN) for st in ref_states)
    assert any((ps["gb_n"] > 0).any() for ps in ps_all)
    last = ref_states[-1]
    assert (last["ps"]["m_stable"] > 0).any()
    assert (last["metrics"]["lat_count"].sum(-1) > 0).any()
    assert last["ps"]["m_fast"].sum() > 0 and last["ps"]["m_slow"].sum() > 0
    assert not last["err"].any()


def test_runner_freezes_finished_lanes(trajectories):
    """The run loop's per-lane freeze on these lanes: cut by
    ``max_steps``, each lane keeps its state exactly, as under the
    reference's vmapped while loop."""
    port, dims, ref_states, _p, state, port_ctx, _o = trajectories
    final = build_runner(port, dims, max_steps=5)(
        carry.to_torch(state, "cpu"), port_ctx
    )
    want = dict(ref_states[4])
    truncated = (want["steps"] >= 5) & (want["done_time"] >= 1 << 30)
    want["err"] = (want["err"] | 2 * truncated).astype(np.int32)
    _assert_tree_equal(want, carry.to_numpy(final))


def test_tree_fits_the_freeze_plane_table(trajectories):
    """``lane_freeze`` passes one plane table per launch: the lane tree
    (60 planes, 38 of them protocol planes) fits it."""
    port, dims, _r, _p, state, port_ctx, _o = trajectories
    old = carry.to_torch(state, "cpu")
    new = lane_step(port, dims, old, port_ctx)
    assert len(new["ps"]) == 38
    assert len(plane_pairs(new, old)) <= 60 <= MAX_PLANES


@pytest.mark.parametrize("extra", [[], ["--no-wait-condition"]])
def test_cli_summary_matches_reference(extra, capsys):
    from fantoch_tpu.cli import main as r_main
    from fantoch_tpu_torch.cli import main

    grid = ["sweep", "--protocol", "caesar", "--n", "3", "--subsets", "2",
            "--fs", "1,2", "--commands", "3", "--conflicts", "0,100", *extra]
    r_main(["--platform", "cpu", *grid])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    main(["--device", "cpu", *grid])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want
    assert got["points"] == 8 and got["errors"] == 0


def test_no_wait_condition_reaches_the_lane_ctx():
    from fantoch_tpu_torch import cli

    for extra, wait in (([], True), (["--no-wait-condition"], False)):
        args = cli.parse_args(["sweep", "--protocol", "caesar", "--n", "3",
                               "--subsets", "1", "--commands", "1", *extra])
        _p, _d, specs = cli.sweep_setup(args)
        assert {bool(s.ctx["wait_condition"]) for s in specs} == {wait}
        assert all(s.config.caesar_wait_condition == wait for s in specs)


def test_sweep_without_a_gpu_raises(monkeypatch):
    """The sweep runs on the card unless ``--device cpu``."""
    from fantoch_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["sweep", "--protocol", "caesar", "--n", "3", "--subsets", "1",
              "--commands", "1", "--conflicts", "0"])
