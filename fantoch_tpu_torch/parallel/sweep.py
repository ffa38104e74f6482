"""Config sweeps: the (region subset × f × conflict) grid, run in lane
batches on one device.

``make_sweep_specs`` enumerates the points — the reference simulation
binary's nested loops — into lanes; ``run_sweep`` runs them
``batch_lanes`` at a time (each batch: key table, stack, run, collect).
Each point runs once per fault plan of ``faults``, every point under one
traffic schedule or open-loop arrival process when given. A batch runs
in segments of ``segment_steps`` steps, ``scan_window`` segments a
device call (one launch of the device loop's graph) and up to
``pipeline_depth`` calls in flight, as the reference's ``run_sweep``
(:355) does. ``hetero=True`` runs mixed-protocol batches
(``engine/hetero.py``). Checkpoints, sharding and storage narrowing are
not ported yet (ROADMAP items 12, 15 and 5).
"""

from __future__ import annotations

import itertools
import time
from typing import List, Optional, Sequence

import numpy as np

from .. import resolve_device
from ..core.config import Config
from ..core.planet import Planet
from ..engine import core as engine_core
from ..engine.dims import EngineDims
from ..engine import hetero as engine_hetero
from ..engine.driver import batch_reorder_flag, prepare_batch
from ..engine.faults import FaultPlan, batch_fault_flags
from ..engine.skeleton import Skeleton
from ..engine.results import LaneResults, collect_results
from ..engine.spec import LaneSpec, make_lane
from .pipeline import SegmentWindow

# scan-fused windows: how many segments one device call covers when the
# caller does not pin ``scan_window`` (the reference's rule,
# sweep.py:142-172): segments packed into a window of about
# SCAN_WINDOW_TARGET_STEPS steps (at the default 8,192-step segment, 4 a
# window), at most SCAN_WINDOW_MAX, so a window stays a bounded device
# execution and a finished batch's overshoot stays at most that many
# no-op segments
SCAN_WINDOW_TARGET_STEPS = 1 << 15
SCAN_WINDOW_MAX = 8


def default_scan_window(segment_steps: int, skeleton: bool = False) -> int:
    """The ``scan_window=None`` resolution rule: segments a window of
    about :data:`SCAN_WINDOW_TARGET_STEPS` steps, 1 to
    :data:`SCAN_WINDOW_MAX` (half that for ``skeleton`` lanes, as the
    reference's rule)."""
    cap = SCAN_WINDOW_MAX // 2 if skeleton else SCAN_WINDOW_MAX
    return max(1, min(max(1, cap),
                      SCAN_WINDOW_TARGET_STEPS // max(1, int(segment_steps))))


def _window_untils(base: int, segment_steps: int, window: int,
                   max_steps: int) -> np.ndarray:
    """One window's ``[W]`` i32 ladder of segment ends after ``base``;
    values past ``max_steps`` clamp to it (a repeated end is a no-op
    segment)."""
    return np.minimum(
        base + segment_steps * np.arange(1, window + 1, dtype=np.int64),
        max_steps,
    ).astype(np.int32)


#: observational stats of the most recent ``run_sweep`` call in this
#: process, summed over its batches, counted as the reference counts
#: them: lane count, the resolved ``scan_window``, ``device_calls`` (host
#: dispatches, one a window), ``segments_covered``, ``windows`` (windows
#: whose liveness came home), and the port's own: ``batches``,
#: ``body_iterations`` (device-loop bodies run), ``batch_steps`` (steps
#: run, frozen ones included: bodies × steps a body), ``overshoot_steps``
#: (those past each batch's longest lane), ``captures`` (device loops
#: captured; a batch of a layout already cached captures none),
#: ``capture_s`` (capture plus instantiate), and the host seconds of each
#: batch's stages, summed: ``prepare_s`` (``prepare_batch``),
#: ``windows_s`` (``run_windows``, the capture included) and
#: ``collect_s`` (``finish_run`` and ``collect_results``), each read on
#: the host clock with no device sync of its own. Not part of any
#: result.
LAST_STATS: dict = {}


def make_sweep_specs(
    protocol,
    planet: Planet,
    *,
    region_sets: Sequence[Sequence[str]],
    fs: Sequence[int],
    conflicts: Sequence[int],
    commands_per_client: int,
    clients_per_region: int,
    dims: EngineDims,
    config_base: Optional[Config] = None,
    extra_time_ms: int = 500,
    zipf=None,
    pool_size: int = 1,
    faults: "Sequence[FaultPlan | None] | None" = None,
    traffic=None,
    arrivals=None,
    arrival_load: int = 100,
    arrival_gap_ms: int = 4,
    open_window: int = 4,
) -> List[LaneSpec]:
    """The sweep grid: one lane per (region set, f, conflict) point,
    replicated once per entry of ``faults`` (None = fault-free); a
    point's lanes share its workload, seeded by the point's index (the
    reference's ``make_sweep_specs``). ``traffic`` (a preset name,
    resolved against each point's own conflict rate, or a schedule) and
    ``arrivals`` (a preset resolved against ``arrival_gap_ms`` and scaled
    by ``arrival_load`` percent, with at most ``open_window`` commands in
    flight per client) apply to every point (``make_lane``)."""
    base = config_base or Config(n=len(region_sets[0]), f=1,
                                 gc_interval_ms=100)
    plans: Sequence["FaultPlan | None"] = faults or [None]
    specs = []
    for i, (regions, f, conflict, plan) in enumerate(
        itertools.product(region_sets, fs, conflicts, plans)
    ):
        specs.append(
            make_lane(
                protocol,
                planet,
                base.with_(n=len(regions), f=f),
                conflict_rate=conflict,
                pool_size=pool_size,
                zipf=zipf,
                commands_per_client=commands_per_client,
                clients_per_region=clients_per_region,
                process_regions=list(regions),
                client_regions=list(regions),
                dims=dims,
                extra_time_ms=extra_time_ms,
                seed=i // len(plans),
                faults=plan,
                traffic=traffic,
                arrivals=arrivals,
                arrival_load=arrival_load,
                arrival_gap_ms=arrival_gap_ms,
                open_window=open_window,
            )
        )
    return specs


def run_windows(runner, state, ctx, segment_steps: int, scan_window: int,
                pipeline_depth: int, max_steps: int, stats=None):
    """One batch through the segment loop: windows of ``scan_window``
    segments (``runner``, an ``engine.core.WindowRunner``) dispatched
    until a resolved liveness flag says no lane is alive or the ladder
    reaches ``max_steps``, up to ``pipeline_depth`` in flight. Returns
    the batch's state after its last window (before
    ``finish_run``); counts ``device_calls``, ``segments_covered`` and
    ``windows`` into ``stats`` (default :data:`LAST_STATS`)."""
    stats = LAST_STATS if stats is None else stats
    window = SegmentWindow(pipeline_depth)
    until = 0
    while window.running and until < max_steps:
        untils = _window_untils(until, segment_steps, scan_window, max_steps)
        until = int(untils[-1])
        state, any_alive = runner(state, ctx, untils)
        window.push(any_alive)
        stats["device_calls"] = stats.get("device_calls", 0) + 1
        stats["segments_covered"] = (stats.get("segments_covered", 0)
                                     + scan_window)
        window.poll()
    window.drain()
    stats["windows"] = stats.get("windows", 0) + window.resolved
    return state


def run_sweep(
    protocol,
    dims: EngineDims,
    specs: Sequence[LaneSpec],
    batch_lanes: int = 512,
    max_steps: int = 1 << 22,
    device=None,
    monitor_keys: int = 0,
    segment_steps: int = 8192,
    pipeline_depth: int = 2,
    scan_window: "int | None" = None,
    hetero: bool = False,
    skeleton: "Skeleton | None" = None,
) -> List[LaneResults]:
    """Run every lane, ``batch_lanes`` per batch, on ``device`` (default:
    the CUDA card), each batch under its reorder flag and fault-flag
    union. ``monitor_keys > 0`` runs the safety monitors (per-lane
    ``violation``, ``violation_step`` and ``coverage``). Results are in
    ``specs`` order and do not depend on the loop settings below.

    Each batch runs in segments of ``segment_steps`` steps; one device
    call (a window, ``engine.core.build_window_runner``) covers
    ``scan_window`` consecutive segments (``None``:
    :func:`default_scan_window`), with the early exit decided on the
    device and liveness home once per window. ``pipeline_depth`` windows
    ride in flight (:class:`~.pipeline.SegmentWindow`): window i+1 is
    dispatched before window i's flag is read, and a window past the
    batch's end is a no-op.

    ``hetero=True`` runs mixed-protocol batches (``engine/hetero.py``):
    ``specs`` is an ordered list of ``(group, LaneSpec)`` pairs whose
    groups may name different protocols, ``protocol`` and ``dims`` map
    each group to its device protocol and dims, and each chunk of
    ``batch_lanes`` pairs (the caller's order) is one batch in which
    every lane runs its own protocol's kernels only. ``skeleton`` (a
    :class:`~..engine.skeleton.Skeleton`, e.g. a grid's
    ``build_grid_skeleton``) fixes every batch's skeleton; ``None``
    derives each batch's own. Each lane's result equals its homogeneous
    run's. Monitored mixed batches are refused."""
    dev = resolve_device(device)
    if hetero:
        if skeleton is not None and not isinstance(skeleton, Skeleton):
            raise ValueError(
                "hetero=True lays lanes out through the skeleton itself; "
                "pass the Skeleton object (or None to derive one from "
                "each batch), not a bare fingerprint string"
            )
    elif skeleton is not None:
        raise ValueError("a skeleton describes mixed batches: pass "
                         "hetero=True with it")
    win = (default_scan_window(segment_steps, skeleton=hetero)
           if scan_window is None else max(1, int(scan_window)))
    LAST_STATS.clear()
    LAST_STATS.update(
        lanes=len(specs), scan_window=win, device_calls=0,
        segments_covered=0, segment_steps=int(segment_steps), windows=0,
        batches=0, body_iterations=0, batch_steps=0, overshoot_steps=0,
        captures=0, capture_s=0.0, prepare_s=0.0, windows_s=0.0,
        collect_s=0.0,
    )
    out: List[LaneResults] = []
    for lo in range(0, len(specs), batch_lanes):
        chunk = specs[lo:lo + batch_lanes]
        t0 = time.perf_counter()
        if hetero:
            hb, state, ctx, _lanes = engine_hetero.prepare_batch(
                protocol, dims, chunk, dev, monitor_keys=monitor_keys,
                skeleton=skeleton)
            bare = [spec for _group, spec in chunk]
            reorder, faults = batch_reorder_flag(bare), batch_fault_flags(bare)
            runner, _alive = engine_hetero.build_hetero_window_runner(
                hb, max_steps, reorder, faults)
            t1 = time.perf_counter()
            state = run_windows(runner, state, ctx, segment_steps, win,
                                pipeline_depth, max_steps)
            t2 = time.perf_counter()
            results = engine_hetero.collect_hetero_results(
                hb, chunk, engine_hetero.result_fetch_tree(hb, state),
                max_steps)
        else:
            reorder = batch_reorder_flag(chunk)
            faults = batch_fault_flags(chunk)
            runner, _alive = engine_core.build_window_runner(
                protocol, dims, max_steps, reorder, faults, monitor_keys)
            state, ctx = prepare_batch(protocol, dims, chunk, dev,
                                       monitor_keys)
            t1 = time.perf_counter()
            state = run_windows(runner, state, ctx, segment_steps, win,
                                pipeline_depth, max_steps)
            t2 = time.perf_counter()
            final = engine_core.finish_run(protocol, state, ctx, max_steps,
                                           reorder, faults, monitor_keys)
            results = collect_results(protocol, dims, final, chunk)
        t3 = time.perf_counter()
        LAST_STATS["prepare_s"] += t1 - t0
        LAST_STATS["windows_s"] += t2 - t1
        LAST_STATS["collect_s"] += t3 - t2
        bodies = runner.bodies()
        LAST_STATS["batches"] += 1
        LAST_STATS["captures"] += runner.captures
        LAST_STATS["capture_s"] += runner.capture_s
        LAST_STATS["body_iterations"] += bodies
        LAST_STATS["batch_steps"] += runner.loop.G * bodies
        LAST_STATS["overshoot_steps"] += runner.loop.G * bodies - max(
            r.steps for r in results)
        out.extend(results)
    return out
