"""The segmented sweep driver through the port on the CPU, against the
reference's (``parallel/sweep.py run_sweep``, ``engine/core.py
build_segment_runner``/``build_window_runner``, ``parallel/pipeline.py
SegmentWindow``), at the shapes of the reference's own tier-1 tests
(``tests/test_scan_window.py``: n = 3, 2 commands a client, 8-step
segments, Basic and Tempo):

- ``to_json()`` byte-identical at every (scan window, pipeline depth)
  and at the defaults, and the ``LAST_STATS`` device-call counts equal
  to the reference's;
- the whole Tempo lane state after each of the first 4 segments equal
  to the reference segment runner's, with a loop body that does not
  divide the segment;
- ``ERR_TRUNCATED`` lanes at ``max_steps = 30``;
- a monitored Tempo sweep in segments against the reference's
  violations, steps and digests (the committed fixture);
- the twin of K14 (``loop_ctl``) against the vmapped ``_lane_running``
  on random states, with and without the horizon flag;
- ``default_scan_window``, ``_window_untils`` and ``SegmentWindow``
  against the reference's;
- ``sweep --pipeline-depth 3 --scan-window 2`` prints the default
  summary.

The CPU runs the device loop's plain twin (``kernels/step_loop.py
HostLoop``): the same control, K14's twin between bodies."""

import functools
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fantoch_tpu.core import Config as RConfig
from fantoch_tpu.core import Planet as RPlanet
from fantoch_tpu.engine import EngineDims as RDims
from fantoch_tpu.engine import protocols as rprotocols
from fantoch_tpu.engine.core import _lane_running, key_table_fn
from fantoch_tpu.engine.core import build_segment_runner as r_segment_runner
from fantoch_tpu.engine.core import finish_segmented as r_finish_segmented
from fantoch_tpu.engine.driver import stack_states
from fantoch_tpu.engine.faults import FaultFlags as RFaultFlags
from fantoch_tpu.engine.results import collect_results as r_collect_results
from fantoch_tpu.engine.spec import stack_lanes as r_stack_lanes
from fantoch_tpu.parallel import pipeline as rpipeline
from fantoch_tpu.parallel import sweep as rsweep
from fantoch_tpu_torch import carry, cli
from fantoch_tpu_torch.core import Config, Planet
from fantoch_tpu_torch.engine import EngineDims
from fantoch_tpu_torch.engine import protocols as pprotocols
from fantoch_tpu_torch.engine.core import (
    build_eager_runner, build_runner, build_segment_runner,
    build_window_runner,
)
from fantoch_tpu_torch.engine.dims import ERR_TRUNCATED, INF
from fantoch_tpu_torch.engine.driver import prepare_batch
from fantoch_tpu_torch.engine.faults import FLAG_HORIZON
from fantoch_tpu_torch.kernels.lane_freeze import lane_running
from fantoch_tpu_torch.kernels.loop_ctl import (
    CTL_ALIVE, CTL_COND, CTL_LIM, CTL_MAXS, CTL_RUNG, CTL_W, loop_ctl,
    new_ctl,
)
from fantoch_tpu_torch.mc import fuzz
from fantoch_tpu_torch.parallel import sweep
from fantoch_tpu_torch.parallel.pipeline import SegmentWindow
from torch_threads import one_torch_thread  # noqa: F401

COMMANDS = 2
SEG = 8  # segments small enough that every lane spans several windows
FIXTURE = Path(__file__).parent / "fixtures" / "torch_fuzz_bug_golden.json"
# the injected-bug point of tests/test_torch_fuzz.py (jitter only)
BUG = dict(protocol="tempo", n=3, f=1, schedules=8, commands_per_client=5,
           seed=3, inject_bug=True, crash_share=0.0, drop_share=0.0)
# (scan window, pipeline depth); None: the default window
SETTINGS = [(1, 1), (2, 1), (4, 2), (8, 2), (None, 2)]
STAT_KEYS = ("scan_window", "device_calls", "segments_covered")

REF = (RConfig, RPlanet, RDims, rprotocols, rsweep)
PORT = (Config, Planet, EngineDims, pprotocols, sweep)


def _specs(pkg, name, commands=COMMANDS):
    """The reference test's sweep (test_scan_window.py ``_specs``): 4
    region subsets × conflict 0 and 100, f = 1, 3 clients."""
    cfg, planet_cls, dims_cls, protos, sweep_mod = pkg
    planet = planet_cls.new()
    regions = planet.regions()
    clients, total = 3, commands * 3
    dev = protos.dev_protocol(name, clients)
    dims = dims_cls.for_protocol(
        dev, n=3, clients=clients, payload=dev.payload_width(3),
        total_commands=total, dot_slots=total + 1, regions=3,
    )
    specs = sweep_mod.make_sweep_specs(
        dev, planet, region_sets=[regions[i:i + 3] for i in range(4)],
        fs=[1], conflicts=[0, 100], commands_per_client=commands,
        clients_per_region=1, dims=dims,
        config_base=cfg(**protos.dev_config_kwargs(name, 3, 1)),
        pool_size=1,
    )
    return dev, dims, specs


def _blob(results) -> str:
    return json.dumps([r.to_json() for r in results], sort_keys=True)


@functools.lru_cache(maxsize=None)
def _reference(name, win, depth, max_steps=1 << 22, commands=COMMANDS):
    """The reference's sweep at one setting: its results and stats."""
    dev, dims, specs = _specs(REF, name, commands)
    out = rsweep.run_sweep(dev, dims, specs, segment_steps=SEG,
                           scan_window=win, pipeline_depth=depth,
                           max_steps=max_steps)
    return _blob(out), {k: rsweep.LAST_STATS[k] for k in STAT_KEYS}


def _port(name, commands=COMMANDS, **kw):
    dev, dims, specs = _specs(PORT, name, commands)
    out = sweep.run_sweep(dev, dims, specs, device="cpu", segment_steps=SEG,
                          **kw)
    return out, dict(sweep.LAST_STATS)


@functools.lru_cache(maxsize=None)
def _serial_calls(name):
    """The port's device calls on the serial segment loop (W = 1,
    depth 1)."""
    return _port(name, scan_window=1, pipeline_depth=1)[1]["device_calls"]


@functools.lru_cache(maxsize=None)
def _reference_segments(name):
    """The reference's segment runner (``build_segment_runner``) driven
    serially from its own initial state and ctx (its key table as its
    sweep computes it), segment after segment until its liveness flag
    is false: the states after the first 4 segments, the number of
    calls (the serial loop's device calls) and the results
    (``finish_segmented``, ``collect_results``)."""
    rdev, rdims, rspecs = _specs(REF, name)
    ctx = r_stack_lanes(rspecs)
    T = int(max(2, ctx["cmd_budget"].max() + 2))
    kctx = {k: jnp.asarray(ctx[k]) for k in
            ("rng_key", "conflict_rate", "pool_size", "key_gen_kind",
             "zipf_cum")}
    ctx["key_table"] = np.asarray(jax.vmap(key_table_fn(rdims.C, T))(kctx))
    state = stack_states(rdev, rdims, rspecs)
    runner, _alive = r_segment_runner(rdev, rdims)
    st = jax.tree_util.tree_map(jnp.asarray, state)
    jctx = jax.tree_util.tree_map(jnp.asarray, ctx)
    states, alive, calls = [], [], 0
    while True:
        calls += 1
        st, any_alive = runner(st, jctx, np.int32(calls * SEG))
        if calls <= 4:
            states.append(jax.tree_util.tree_map(np.asarray, st))
            alive.append(bool(any_alive))
        if not bool(any_alive):
            break
    final = r_finish_segmented(jax.tree_util.tree_map(np.asarray, st),
                               1 << 22)
    blob = _blob(r_collect_results(rdev, rdims, final, rspecs))
    return state, ctx, states, alive, calls, blob


def _reference_run(name, win, depth):
    """The reference's bytes and stats at one setting: Basic's from its
    ``run_sweep`` at that setting; Tempo's from its serial segment loop
    (one trace to compile), whose calls are its (1, 1) device calls."""
    if name == "basic":
        return _reference(name, win, depth)
    *_rest, calls, blob = _reference_segments(name)
    stats = {"scan_window": 1, "device_calls": calls,
             "segments_covered": calls} if (win, depth) == (1, 1) else None
    return blob, stats


@pytest.mark.parametrize("win,depth", SETTINGS)
@pytest.mark.parametrize("name", ["basic", "tempo"])
def test_to_json_matches_the_reference_at_every_window(name, win, depth):
    """Every setting gives the reference's bytes. The device-call counts
    equal the reference's at the same setting (Tempo's on the serial
    loop), and stay within the reference test's cap: ceil(segments / W)
    plus depth − 1 speculative windows."""
    got, stats = _port(name, scan_window=win, pipeline_depth=depth)
    blob, ref_stats = _reference_run(name, win, depth)
    assert _blob(got) == blob
    assert got[0].completed == COMMANDS * 3 and not got[0].err
    if ref_stats is not None:
        assert {k: stats[k] for k in STAT_KEYS} == ref_stats
    serial = _serial_calls(name)
    assert serial > 2, "lanes must span several segments"
    w = stats["scan_window"]
    cap = math.ceil(serial / w) + (depth - 1)
    assert stats["device_calls"] <= cap
    assert stats["segments_covered"] == stats["device_calls"] * w
    assert stats["windows"] <= stats["device_calls"]
    assert stats["batches"] == 1
    assert stats["batch_steps"] == stats["body_iterations"]
    assert stats["overshoot_steps"] == (
        stats["batch_steps"] - max(r.steps for r in got))


def test_body_length_changes_no_result():
    """A body of 3 steps (not a divisor of the 8-step segment), through
    ``run_sweep``'s window loop (3 segments a window, 2 in flight), runs
    frozen steps past each segment's end and ends in the same state as
    the one-step body."""
    dev, dims, specs = _specs(PORT, "tempo")
    finals = []
    for G in (1, 3):
        runner, _alive = build_window_runner(dev, dims, steps_per_body=G)
        state, ctx = prepare_batch(dev, dims, specs, "cpu")
        stats = {}
        st = sweep.run_windows(runner, state, ctx, SEG, 3, 2, 1 << 22, stats)
        finals.append(carry.to_numpy(st))
        # ceil(segments / 3) windows and one speculative
        assert stats["device_calls"] == math.ceil(
            _serial_calls("tempo") / 3) + 1
        assert runner.loop.G == G
        longest = int(st["steps"].max())
        if G == 3:
            assert 3 * runner.bodies() > longest
    _assert_tree_equal(*finals)


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


def test_tempo_state_after_each_segment_matches_the_reference():
    """The whole lane state after each of the first 4 segments, and
    each segment's liveness, from the reference's initial state and ctx,
    with a 3-step body (not a divisor of the segment)."""
    state, ctx, states, alive, _calls, _blob_ = _reference_segments("tempo")
    pdev, pdims, _ = _specs(PORT, "tempo")
    prunner, palive = build_segment_runner(pdev, pdims, steps_per_body=3)
    pst, pctx = carry.to_torch(state, "cpu"), carry.to_torch(ctx, "cpu")
    assert bool(palive(pst, pctx)[0])
    for k in range(1, 5):
        pst, p_any = prunner(pst, pctx, k * SEG)
        try:
            _assert_tree_equal(states[k - 1], carry.to_numpy(pst))
        except AssertionError as e:
            raise AssertionError(f"segment {k}: {e}") from None
        assert alive[k - 1] == bool(p_any[0]), k
        assert int(pst["steps"].max()) == k * SEG


def test_truncated_lanes_match_the_reference():
    """At ``max_steps = 30`` the lanes of 5 commands a client are cut
    before their last command and report ERR_TRUNCATED, as the
    reference's ``finish_segmented`` marks them."""
    got, _stats = _port("basic", commands=5, max_steps=30)
    assert _blob(got) == _reference("basic", None, 2, max_steps=30,
                                    commands=5)[0]
    assert all(r.err & ERR_TRUNCATED and r.steps == 30 for r in got)


def test_monitored_sweep_in_segments():
    """The injected-bug Tempo point, monitored, in 8-step segments 3 a
    window: the reference's per-lane violations, first violating steps
    and digests (the fixture ``tests/test_torch_fuzz.py`` holds to the
    reference's run); the monitors' end-of-run reduction runs once,
    after the last window."""
    proto, dims, specs, _plans, mk = fuzz.point_lanes(fuzz.FuzzSpec(**BUG))
    got = sweep.run_sweep(proto, dims, specs, device="cpu", monitor_keys=mk,
                          segment_steps=SEG, scan_window=3, pipeline_depth=2)
    assert sweep.LAST_STATS["device_calls"] > 2
    assert json.loads(FIXTURE.read_text()) == {
        "violation": [r.violation for r in got],
        "violation_step": [r.violation_step for r in got],
        "digests": [r.coverage for r in got],
        "engine_errors": sorted({r.err_cause for r in got if r.err}),
    }


def test_runner_equals_the_eager_runner():
    """``build_runner`` (one window to ``max_steps``) and the eager host
    loop of wrapper calls end in the same whole state."""
    dev, dims, specs = _specs(PORT, "tempo")
    state, ctx = prepare_batch(dev, dims, specs, "cpu")
    a = carry.to_numpy(build_runner(dev, dims)(state, ctx))
    b = carry.to_numpy(build_eager_runner(dev, dims)(state, ctx))
    _assert_tree_equal(a, b)


def _random_lanes(seed, L=64):
    rng = np.random.default_rng(seed)
    i32 = lambda x: np.asarray(x, np.int32)  # noqa: E731
    done = np.where(rng.random(L) < 0.4, INF, rng.integers(0, 500, L))
    st = {"done_time": i32(done),
          "now": i32(np.where(rng.random(L) < 0.1, INF,
                              rng.integers(0, 900, L))),
          "err": i32(np.where(rng.random(L) < 0.1, 8, 0)),
          "steps": i32(rng.integers(0, 60, L))}
    ctx = {"extra_time": i32(rng.integers(0, 400, L)),
           "fault_horizon": i32(rng.integers(0, 1000, L))}
    return st, ctx


@pytest.mark.parametrize("horizon", [False, True], ids=["plain", "horizon"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loop_ctl_twin_matches_lane_running(seed, horizon):
    """K14's twin: the per-lane predicate equals the vmapped
    ``_lane_running`` at every limit; alive is any of it under
    max_steps, the condition any under the limit after walking the
    ladder past rungs with no active lane, as the reference's scan of
    segments walks it; the body counter counts bodies."""
    st, ctx = _random_lanes(seed)
    faults = RFaultFlags(horizon=horizon)
    flags = FLAG_HORIZON if horizon else 0

    def ref_running(limit):
        return np.asarray(jax.vmap(lambda s, c: _lane_running(
            None, s, c, limit, faults))(st, ctx))

    pst, pctx = carry.to_torch(st, "cpu"), carry.to_torch(ctx, "cpu")
    for limit in (0, 5, 30, 59, 60, 100):
        np.testing.assert_array_equal(
            lane_running(pst, pctx, limit, flags).numpy(), ref_running(limit))
    maxs = 50
    ladders = ([3, 40], [0, 1, 2, 45], [60, 70], [0, 0, 0], [10, 20, 30])
    for ladder in ladders:
        ctl, iters, _ = new_ctl("cpu")
        ctl[CTL_W], ctl[CTL_MAXS] = len(ladder), maxs
        lad = torch.tensor(ladder, dtype=torch.int32)
        cond = loop_ctl(pst, pctx, lad, ctl, iters, flags)
        # the reference's segments in order: the first with a lane
        # stepping (running under its limit), or the last
        rung = 0
        while (rung < len(ladder) - 1
               and not ref_running(min(ladder[rung], maxs)).any()
               and ref_running(maxs).any()):
            rung += 1
        lim = min(ladder[rung], maxs)
        assert int(ctl[CTL_RUNG]) == rung and int(ctl[CTL_LIM]) == lim
        assert cond == bool(ctl[CTL_COND]) == bool(ref_running(lim).any())
        assert bool(ctl[CTL_ALIVE]) == bool(ref_running(maxs).any())
        assert int(iters[0]) == 0
        loop_ctl(pst, pctx, lad, ctl, iters, flags, in_body=True)
        assert int(iters[0]) == 1 and int(ctl[CTL_RUNG]) >= rung


@pytest.mark.parametrize("seg", [1, 8, 100, 4096, 8192, 8193, 1 << 15,
                                 1 << 20])
def test_default_scan_window_and_ladder_match_the_reference(seg):
    for skeleton in (False, True):
        assert (sweep.default_scan_window(seg, skeleton)
                == rsweep.default_scan_window(seg, skeleton))
    assert sweep.SCAN_WINDOW_TARGET_STEPS == rsweep.SCAN_WINDOW_TARGET_STEPS
    assert sweep.SCAN_WINDOW_MAX == rsweep.SCAN_WINDOW_MAX
    for base, win, max_steps in ((0, 4, 1 << 22), (5, 3, 20), (0, 8, 30),
                                 (64, 1, 64)):
        got = sweep._window_untils(base, seg, win, max_steps)
        want = rsweep._window_untils(base, seg, win, max_steps)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_segment_window_keeps_depth_and_monotonicity(depth):
    """The port's window resolves the same flags as the reference's on
    the same pushes: at most depth − 1 in flight after a poll, nothing
    resolved past the first False, everything on drain."""
    flags = [True, True, True, False, True, False]
    port, ref = SegmentWindow(depth), rpipeline.SegmentWindow(depth)
    for f in flags:
        port.push(torch.tensor([int(f)], dtype=torch.int32))
        ref.push(np.bool_(f))
        assert port.poll() == ref.poll()
        assert port.in_flight == ref.in_flight
        assert port.in_flight <= max(1, depth) - 1 or not port.running
    assert port.drain() is ref.drain() is False
    assert port.in_flight == ref.in_flight == 0
    assert port.resolved == flags.index(False) + 1


def test_sweep_flags_give_the_default_summary(capsys):
    argv = ["--device", "cpu", "sweep", "--protocol", "basic", "--n", "3",
            "--subsets", "2", "--fs", "1", "--commands", "2",
            "--conflicts", "0,100"]
    args = cli.parse_args(argv)
    assert args.pipeline_depth == 2 and args.scan_window is None
    cli.main(argv)
    default = capsys.readouterr().out
    cli.main(argv + ["--pipeline-depth", "3", "--scan-window", "2"])
    assert capsys.readouterr().out == default
    assert sweep.LAST_STATS["scan_window"] == 2
    assert json.loads(default)["errors"] == 0
