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
(``engine/hetero.py``), partial-replication groups among them.
``checkpoint=`` saves a one-batch sweep at window boundaries and
resumes it bit for bit (``engine/checkpoint.py``). Sharding and storage
narrowing are not ported yet (ROADMAP items 15 and 5).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import signal
import time
from typing import List, Optional, Sequence

import numpy as np

from .. import resolve_device
from ..carry import to_torch
from ..core.config import Config
from ..core.planet import Planet
from ..engine import core as engine_core
from ..engine.checkpoint import (
    CheckpointMismatchError, CheckpointSpec, SweepInterrupted,
    checkpoint_exists, ctx_sha256, discard_checkpoint,
    load_sweep_checkpoint, save_sweep_checkpoint, step_signature,
)
from ..engine.dims import EngineDims
from ..engine import hetero as engine_hetero
from ..engine.driver import batch_reorder_flag, prepare_batch
from ..engine.faults import FaultPlan, batch_fault_flags
from ..engine.skeleton import Skeleton
from ..engine.results import LaneResults, collect_results
from ..engine.spec import LaneSpec, make_lane
from ..kernels.step_loop import link
from .pipeline import CheckpointBuffer, SegmentWindow

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
#: the host clock with no device sync of its own. A checkpointed run
#: adds :meth:`BatchCheckpoint.stats` and ``resume_until`` (also when
#: it is interrupted). Not part of any result.
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
                pipeline_depth: int, max_steps: int, stats=None,
                start: int = 0, saver: "BatchCheckpoint | None" = None):
    """One batch through the segment loop: windows of ``scan_window``
    segments (``runner``, an ``engine.core.WindowRunner``) dispatched
    until a resolved liveness flag says no lane is alive or the ladder
    reaches ``max_steps``, up to ``pipeline_depth`` in flight; the
    ladder starts after step ``start`` (a resumed batch's). Returns
    the batch's state after its last window (before
    ``finish_run``); counts ``device_calls``, ``segments_covered`` and
    ``windows`` into ``stats`` (default :data:`LAST_STATS`). With a
    ``saver`` each window's dispatch is followed by its
    :meth:`BatchCheckpoint.boundary`."""
    stats = LAST_STATS if stats is None else stats
    window = SegmentWindow(pipeline_depth)
    until = int(start)
    while window.running and until < max_steps:
        untils = _window_untils(until, segment_steps, scan_window, max_steps)
        until = int(untils[-1])
        state, any_alive = runner(state, ctx, untils)
        window.push(any_alive)
        stats["device_calls"] = stats.get("device_calls", 0) + 1
        stats["segments_covered"] = (stats.get("segments_covered", 0)
                                     + scan_window)
        if saver is not None and saver.boundary(window, state, until):
            continue
        window.poll()
    window.drain()
    stats["windows"] = stats.get("windows", 0) + window.resolved
    return state


def _checkpoint_meta(specs, hetero: bool, max_steps: int, segment_steps: int,
                     monitor_keys: int, marker: str) -> "tuple[dict, list]":
    """``(meta, expect)``: a checkpoint's meta (the reference's keys but
    ``narrow``: the port stores no narrowed planes) and the keys a
    resume must match by name (``traffic`` and ``arrivals`` only when
    the batch runs a schedule; ``skeleton``, the mixed batch's
    fingerprint, is compared both ways by :class:`BatchCheckpoint`)."""
    bare = [s for _g, s in specs] if hetero else list(specs)
    meta = {
        "lanes": len(specs),
        "max_steps": int(max_steps),
        "segment_steps": int(segment_steps),
        "monitor_keys": int(monitor_keys),
        "traffic": sorted({(s.traffic_meta or {"name": "flat"})["name"]
                           for s in bare}),
        "arrivals": sorted({(s.arrival_meta or {"name": "closed"})["name"]
                            for s in bare}),
        **({"skeleton": marker} if marker else {}),
        "specs": [
            {
                "n": s.config.n,
                "f": s.config.f,
                "conflict": int(s.ctx["conflict_rate"]),
                "regions": list(s.process_regions),
                "faults": s.fault_meta,
                "traffic": s.traffic_meta,
                "arrivals": s.arrival_meta,
                **({"group": str(specs[i][0])} if hetero else {}),
            }
            for i, s in enumerate(bare)
        ],
    }
    expect = ["lanes", "max_steps", "segment_steps", "monitor_keys"]
    if meta["traffic"] != ["flat"]:
        expect.append("traffic")
    if meta["arrivals"] != ["closed"]:
        expect.append("arrivals")
    return meta, expect


class BatchCheckpoint:
    """The checkpointing of one batch (``run_sweep(checkpoint=)``, the
    reference's ``run_sweep`` :1100-1195): the load of a valid artifact
    at resume, a save at every ``spec.every``-th drained window
    boundary (:class:`~.pipeline.CheckpointBuffer`: the copy home and
    the write overlap the next window), a synchronous save and
    :class:`SweepInterrupted` at a stop (a signal, the budget or the
    window limit), and at the end the discard (or, kept or signalled,
    the pending save's flush and the signal's re-delivery).

    ``ctx`` is the batch's ctx as prepared (grouped for a mixed batch);
    its sha256 is saved with every state and compared with the saved
    one at load. ``saves``, ``bytes`` (the last payload's),
    ``load_s`` and the buffer's ``blocking_s``/``overlapped_s`` say what
    the checkpoints cost."""

    def __init__(self, spec: CheckpointSpec, signature: dict, meta: dict,
                 expect: Sequence[str], ctx):
        self.spec, self.signature = spec, signature
        self.meta, self.expect = meta, list(expect)
        self.ctx_digest = ctx_sha256(ctx)
        self.buf = CheckpointBuffer()
        self.windows = 0
        self.saves = 0
        self.bytes = 0
        self.load_s = 0.0
        self.steps0 = 0
        self.signal: "int | None" = None
        self._t0 = time.perf_counter()

    def stats(self) -> dict:
        """The checkpoint counts and seconds, under
        :data:`LAST_STATS`'s ``checkpoint_*`` keys."""
        return {"checkpoint_saves": self.saves,
                "checkpoint_bytes": self.bytes,
                "checkpoint_blocking_s": self.buf.blocking_s,
                "checkpoint_overlapped_s": self.buf.overlapped_s,
                "checkpoint_load_s": self.load_s}

    def load(self, device, grouped: bool):
        """``(state, until)`` of a valid checkpoint at the path (the
        state on ``device``, linked when ``grouped``), or ``(None, 0)``
        without one or when ``spec.resume`` is off. A stale or corrupt
        artifact is refused by name."""
        if not (self.spec.resume and checkpoint_exists(self.spec.path)):
            return None, 0
        t0 = time.perf_counter()
        state, meta = load_sweep_checkpoint(
            self.spec.path, signature=self.signature,
            ctx_digest=self.ctx_digest,
            meta_expect={k: self.meta[k] for k in self.expect})
        saved = str(meta.get("skeleton") or "")
        mine = str(self.meta.get("skeleton") or "")
        if saved != mine:
            raise CheckpointMismatchError(
                f"checkpoint skeleton marker {saved!r} does not match the "
                f"current run's {mine!r}: a mixed batch's grouped state "
                "and a native state are not interchangeable"
            )
        steps = [v["steps"] for v in state.values()] if grouped else [
            state["steps"]]
        self.steps0 = int(max(int(np.max(s)) for s in steps))
        state = to_torch(state, device)
        self.load_s = time.perf_counter() - t0
        return (link(state) if grouped else state), int(meta["until"])

    def _save(self, host_state, until: int) -> None:
        self.bytes = save_sweep_checkpoint(
            self.spec.path, state=host_state, ctx_digest=self.ctx_digest,
            signature=self.signature, until=until, meta=self.meta)
        self.saves += 1

    def boundary(self, window: SegmentWindow, state, until: int) -> bool:
        """After a window's dispatch: write the previous boundary's save
        (it overlaps this window), then at a save boundary drain the
        window and begin this one's save (True: the caller skips its
        poll). At a stop the save is synchronous and
        :class:`SweepInterrupted` is raised once it is on disk."""
        self.buf.flush(self._save)
        self.windows += 1
        spec = self.spec
        stop = None
        if self.signal is not None:
            stop = f"signal {self.signal}"
        elif (spec.stop_after_segments is not None
              and self.windows >= spec.stop_after_segments):
            stop = "segment-limit"
        elif (spec.budget_s is not None
              and time.perf_counter() - self._t0 > spec.budget_s):
            stop = "budget exhausted"
        if stop is None and self.windows % max(1, int(spec.every)):
            return False
        if not window.drain():
            return True  # the batch just finished: nothing to save
        self.buf.begin(state, until)
        if stop is not None:
            self.buf.flush(self._save, overlapped=False)
            raise SweepInterrupted(spec.path, until, stop)
        return True

    @contextlib.contextmanager
    def signals(self):
        """SIGTERM and SIGINT only set :attr:`signal` while the batch
        runs (the save happens at the next window boundary); the
        previous handlers come back at the end. Off the main thread
        there is no signal flush."""
        restores = []

        def on_signal(num, _frame):
            self.signal = num

        try:
            for s in (signal.SIGTERM, signal.SIGINT):
                restores.append((s, signal.signal(s, on_signal)))
        except ValueError:
            pass
        self._t0 = time.perf_counter()
        try:
            yield self
        finally:
            for s, old in restores:
                signal.signal(s, old)

    def finish(self) -> None:
        """After the last window: a kept or signalled run flushes its
        pending save; a signal that landed during the last window is
        re-delivered now that the old handlers are back (before the
        discard: a default handler ends the process with the state on
        disk); then the artifact is discarded unless ``keep``."""
        if self.spec.keep or self.signal is not None:
            self.buf.flush(self._save)
        if self.signal is not None:
            os.kill(os.getpid(), self.signal)
        if not self.spec.keep:
            discard_checkpoint(self.spec.path)


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
    checkpoint: "CheckpointSpec | str | None" = None,
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
    run's, partial-replication lanes' too. Monitored mixed batches are
    refused.

    ``checkpoint`` (a :class:`~..engine.checkpoint.CheckpointSpec` or a
    bare path) makes the run durable (:class:`BatchCheckpoint`): the
    batch's whole state is saved at drained window boundaries (before
    the monitors' end-of-run reduction), flushed on SIGTERM/SIGINT, and
    a valid checkpoint at the path resumes the run where it stopped,
    with byte-identical results; a stale or corrupt one is refused by
    name. A stop at the budget or the window limit raises
    :class:`~..engine.checkpoint.SweepInterrupted` with the state on
    disk; a completed run discards the artifact unless ``keep``. As in
    the reference a checkpointed sweep is one batch: specs past
    ``batch_lanes`` are refused (the campaign layer, ROADMAP item 14,
    splits larger grids into units)."""
    dev = resolve_device(device)
    ck = None
    if checkpoint is not None:
        ck = (checkpoint if isinstance(checkpoint, CheckpointSpec)
              else CheckpointSpec(path=str(checkpoint)))
        if len(specs) > batch_lanes:
            raise ValueError(
                f"a checkpointed sweep is one batch, as the reference's "
                f"run_sweep is: {len(specs)} specs exceed batch_lanes="
                f"{batch_lanes}; split the grid into units (the campaign "
                "layer, ROADMAP item 14) or raise batch_lanes"
            )
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
        else:
            reorder = batch_reorder_flag(chunk)
            faults = batch_fault_flags(chunk)
            runner, _alive = engine_core.build_window_runner(
                protocol, dims, max_steps, reorder, faults, monitor_keys)
            state, ctx = prepare_batch(protocol, dims, chunk, dev,
                                       monitor_keys)
        saver, start = None, 0
        if ck is not None:
            if hetero:
                sig = engine_hetero.hetero_step_signature(
                    hb, reorder=reorder, faults=faults)
            else:
                sig = step_signature(protocol, dims, reorder=reorder,
                                     faults=faults,
                                     monitor_keys=monitor_keys)
            saver = BatchCheckpoint(ck, sig, *_checkpoint_meta(
                chunk, hetero, max_steps, segment_steps, monitor_keys,
                hb.fingerprint if hetero else ""), ctx)
            loaded, start = saver.load(dev, hetero)
            if loaded is not None:
                state = loaded
        t1 = time.perf_counter()
        try:
            with saver.signals() if saver else contextlib.nullcontext():
                state = run_windows(runner, state, ctx, segment_steps, win,
                                    pipeline_depth, max_steps, start=start,
                                    saver=saver)
            if saver is not None:
                saver.finish()
        finally:
            if saver is not None:
                LAST_STATS.update(saver.stats(), resume_until=start)
        t2 = time.perf_counter()
        if hetero:
            results = engine_hetero.collect_hetero_results(
                hb, chunk, engine_hetero.result_fetch_tree(hb, state),
                max_steps)
        else:
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
        steps = runner.loop.G * bodies if bodies else 0
        LAST_STATS["batch_steps"] += steps
        LAST_STATS["overshoot_steps"] += steps - (
            max(r.steps for r in results) - (saver.steps0 if saver else 0))
        out.extend(results)
    return out
