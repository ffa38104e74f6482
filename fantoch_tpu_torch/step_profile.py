"""Where a batch step's time goes on the card.

    python -m fantoch_tpu_torch.step_profile
        [--protocol basic|fpaxos|tempo|atlas|epaxos|caesar|tempo_partial|
                    atlas_partial|tempo_faults|tempo_open|tempo_traffic|
                    hetero|tempo_fuzz]
        [--steps 128] [--warmup 300] [--loop device|eager|both]
        [--lanes L]

Builds the first batch of the protocol's main-path sweep
(``cli.MAIN_PATHS``, the grids ``chip_smoke.py`` drives: ``tempo_open``
is the open-loop ladder's load-100 sweep, ``tempo_traffic`` the churn
sweep, ``hetero`` the mixed batch of Basic, FPaxos, Tempo and Atlas
lanes, 128 each, every group's kernels a step), or for
``tempo_fuzz`` the reference bench's fuzz self-check point
(``cli.BENCH_FUZZ``: 256 schedules, monitored); ``--lanes`` cuts the
batch to its first L lanes (``--protocol basic --lanes 128`` is the
Basic group of the ``hetero`` batch on its own);
:func:`profile` runs ``warmup`` steps of the run loop, then times
``steps`` more twice, under the batch's reorder flag and fault-flag
union: once with
CUDA-synchronised host clocks only, once under ``torch.profiler`` (CPU
and CUDA activities). ``--loop device`` (the default) runs the device
loop the sweeps run (``engine.core.build_segment_runner``, a graph of
``STEPS_PER_BODY``-step bodies), a window of one body at a time; its
steps are the batch steps the bodies ran (bodies × steps a body, frozen
ones included). ``--loop eager`` runs the host loop of wrapper calls
(``frozen_step``); ``both`` prints one line for each.
Prints one JSON line a loop: wall ms per step, device-busy ms per step
(the union of the device activities' intervals), the device's idle
share (1 − busy / unprofiled wall), device activities per step, and
device time and activities per step by kernel name. Runs on the card
unless ``--device cpu`` (no device activities are recorded there).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict

import torch

from . import cli, resolve_device
from .engine import hetero
from .engine.core import build_segment_runner, frozen_step
from .engine.driver import batch_reorder_flag, prepare_batch
from .engine.faults import NO_FAULTS, batch_fault_flags
from .kernels.step_loop import clone_tree, grouped


def _busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _card(dev) -> str:
    if dev.type == "cpu":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _measure(run, dev):
    """``run()`` → batch steps it ran, timed twice: host clocks, then
    under ``torch.profiler``. Returns the measurements as a dict."""
    t0 = time.perf_counter()
    steps = run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps

    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        steps2 = run()
    prof_wall_ms = (time.perf_counter() - t0) * 1e3 / steps2

    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = defaultdict(float)
    count = defaultdict(int)
    for e in device:
        by_name[e.name] += e.time_range.elapsed_us()
        count[e.name] += 1
    busy_ms = _busy_us(
        (e.time_range.start, e.time_range.end) for e in device
    ) / 1e3 / steps2
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {
        "steps": steps,
        "wall_ms_per_step": wall_ms,
        "profiled_wall_ms_per_step": prof_wall_ms,
        "device_busy_ms_per_step": busy_ms if device else None,
        "device_idle_share": 1 - busy_ms / wall_ms if device else None,
        "device_activities_per_step": len(device) / steps2,
        "device_ms_per_step_by_name": {
            name: us / 1e3 / steps2 for name, us in top
        },
        "device_activities_per_step_by_name": {
            name: n / steps2 for name, n in sorted(count.items())
        },
    }


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _name(protocol) -> str:
    if isinstance(protocol, hetero.HeteroBatch):
        return "hetero[" + "+".join(protocol.audits) + "]"
    return getattr(protocol, "__name__", type(protocol).__name__)


def _lanes(state) -> int:
    trees = state.values() if grouped(state) else [state]
    return sum(int(t["now"].shape[0]) for t in trees)


def profile(protocol, dims, state, ctx, dev, steps: int, warmup: int,
            reorder: bool = False, faults=NO_FAULTS, monitor_keys: int = 0):
    """The eager loop: ``warmup`` steps of :func:`frozen_step` (of
    ``hetero_frozen_step`` when ``protocol`` is a mixed batch's
    ``HeteroBatch``), then ``steps`` more timed twice (host clocks, then
    ``torch.profiler``); returns the measurements as a dict."""
    max_steps = 1 << 22

    def run(st, n):
        for _ in range(n):
            if isinstance(protocol, hetero.HeteroBatch):
                st, _running = hetero.hetero_frozen_step(
                    protocol, st, ctx, max_steps, reorder, faults)
            else:
                st, _running = frozen_step(protocol, dims, st, ctx,
                                           max_steps, reorder, faults,
                                           monitor_keys)
        _sync(dev)
        return st

    state = run(state, warmup)
    # a step consumes its input state: each timed run gets its own copy,
    # made here, outside the clocks
    copies = [clone_tree(state) for _ in range(2)]

    def timed():
        run(copies.pop(), steps)
        return steps

    return {
        "card": _card(dev),
        "loop": "eager",
        "protocol": _name(protocol),
        "lanes": _lanes(state),
        "after_steps": warmup,
        **_measure(timed, dev),
    }


def profile_device(protocol, dims, state, ctx, dev, steps: int,
                   warmup: int, reorder: bool = False, faults=NO_FAULTS,
                   monitor_keys: int = 0):
    """The device loop: a segment to ``warmup`` steps (the capture
    included), then ``steps`` more twice, timed (host clocks, then
    ``torch.profiler``), as windows of one body each: the profiler
    records each node of a graph once per launch, so a window of
    several bodies would show the first body's activities only. The
    steps counted are the bodies run × steps a body. Returns the
    measurements as a dict (a mixed batch's ``HeteroBatch`` as
    ``protocol``: its segment runner)."""
    if isinstance(protocol, hetero.HeteroBatch):
        runner, _alive = hetero.build_hetero_segment_runner(
            protocol, 1 << 22, reorder, faults)
    else:
        runner, _alive = build_segment_runner(protocol, dims, 1 << 22,
                                              reorder, faults, monitor_keys)
    box = {"st": runner(state, ctx, warmup)[0], "until": warmup}
    _sync(dev)
    loop = runner.window.loop

    def run():
        before = loop.iterations()
        for _ in range(max(1, steps // loop.G)):
            box["until"] += loop.G
            box["st"], _any = runner(box["st"], ctx, box["until"])
        _sync(dev)
        return (loop.iterations() - before) * loop.G

    return {
        "card": _card(dev),
        "loop": "device",
        "protocol": _name(protocol),
        "lanes": _lanes(state),
        "after_steps": warmup,
        "steps_per_body": loop.G,
        "capture_s": loop.capture_s,
        **_measure(run, dev),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="fantoch_tpu_torch.step_profile")
    ap.add_argument("--protocol",
                    choices=sorted(cli.MAIN_PATHS) + ["tempo_fuzz"],
                    default="basic")
    ap.add_argument("--steps", type=int, default=128)
    ap.add_argument("--warmup", type=int, default=300)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--loop", choices=["device", "eager", "both"],
                    default="device")
    ap.add_argument("--lanes", type=int, default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    monitor_keys = 0
    mixed = None
    if args.protocol == "tempo_fuzz":
        from .mc.fuzz import FuzzSpec, point_lanes

        protocol, dims, batch, _plans, monitor_keys = point_lanes(
            FuzzSpec(**cli.BENCH_FUZZ))
    elif args.protocol == "hetero":
        sweep = cli.parse_args(cli.MAIN_PATHS[args.protocol])
        protocols, dims, mixed = cli.hetero_setup(sweep)
        mixed = mixed[:args.lanes or sweep.batch_lanes]
        batch = [s for _name_, s in mixed]
    else:
        sweep = cli.parse_args(cli.MAIN_PATHS[args.protocol])
        protocol, dims, specs = cli.sweep_setup(sweep)
        batch = specs[:args.lanes or sweep.batch_lanes]
    flags = (batch_reorder_flag(batch), batch_fault_flags(batch))
    modes = ["device", "eager"] if args.loop == "both" else [args.loop]
    for mode in modes:
        if mixed is None:
            state, ctx = prepare_batch(protocol, dims, batch, dev,
                                       monitor_keys)
        else:
            protocol, state, ctx, _lanes_ = hetero.prepare_batch(
                protocols, dims, mixed, dev)
        fn = profile_device if mode == "device" else profile
        print(json.dumps(fn(protocol, dims, state, ctx, dev, args.steps,
                            args.warmup, *flags, monitor_keys)), flush=True)


if __name__ == "__main__":
    main()
