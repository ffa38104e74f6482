"""Where a batch step's time goes on the card.

    python -m fantoch_tpu_torch.step_profile
        [--protocol basic|fpaxos|tempo|atlas|epaxos|caesar|tempo_partial|
                    atlas_partial|tempo_faults|tempo_fuzz]
        [--steps 128] [--warmup 300]

Builds the first batch of the protocol's main-path sweep
(``cli.MAIN_PATHS``, the grids ``chip_smoke.py`` drives), or for
``tempo_fuzz`` the reference bench's fuzz self-check point
(``cli.BENCH_FUZZ``: 256 schedules, monitored);
:func:`profile` runs ``warmup`` steps of the run loop, then times
``steps`` more twice, under the batch's reorder flag and fault-flag
union: once with
CUDA-synchronised host clocks only, once under ``torch.profiler`` (CPU
and CUDA activities).
Prints one JSON line: wall ms per step, device-busy ms per step (the
union of the device activities' intervals), the device's idle share
(1 − busy / unprofiled wall), device activities per step, and device
time and activities per step by kernel name. Runs on the card unless
``--device cpu`` (no device activities are recorded there).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict

import torch

from . import cli, resolve_device
from .engine.core import frozen_step
from .engine.driver import batch_reorder_flag, prepare_batch
from .engine.faults import NO_FAULTS, batch_fault_flags


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


def profile(protocol, dims, state, ctx, dev, steps: int, warmup: int,
            reorder: bool = False, faults=NO_FAULTS, monitor_keys: int = 0):
    """Run ``warmup`` steps of the run loop on a prepared batch, then
    time ``steps`` more twice (host clocks, then ``torch.profiler``);
    returns the measurements as a dict."""
    max_steps = 1 << 22

    def run(st, n):
        for _ in range(n):
            st, _running = frozen_step(protocol, dims, st, ctx, max_steps,
                                       reorder, faults, monitor_keys)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return st

    state = run(state, warmup)
    t0 = time.perf_counter()
    run(state, steps)
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps

    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        run(state, steps)
    prof_wall_ms = (time.perf_counter() - t0) * 1e3 / steps

    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = defaultdict(float)
    count = defaultdict(int)
    for e in device:
        by_name[e.name] += e.time_range.elapsed_us()
        count[e.name] += 1
    busy_ms = _busy_us(
        (e.time_range.start, e.time_range.end) for e in device
    ) / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    card = "cpu" if dev.type == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return {
        "card": card,
        "protocol": getattr(protocol, "__name__", type(protocol).__name__),
        "lanes": int(state["pool"].shape[0]),
        "steps": steps,
        "after_steps": warmup,
        "wall_ms_per_step": wall_ms,
        "profiled_wall_ms_per_step": prof_wall_ms,
        "device_busy_ms_per_step": busy_ms if device else None,
        "device_idle_share": 1 - busy_ms / wall_ms if device else None,
        "device_activities_per_step": len(device) / steps,
        "device_ms_per_step_by_name": {
            name: us / 1e3 / steps for name, us in top
        },
        "device_activities_per_step_by_name": {
            name: n / steps for name, n in sorted(count.items())
        },
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="fantoch_tpu_torch.step_profile")
    ap.add_argument("--protocol",
                    choices=sorted(cli.MAIN_PATHS) + ["tempo_fuzz"],
                    default="basic")
    ap.add_argument("--steps", type=int, default=128)
    ap.add_argument("--warmup", type=int, default=300)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    monitor_keys = 0
    if args.protocol == "tempo_fuzz":
        from .mc.fuzz import FuzzSpec, point_lanes

        protocol, dims, batch, _plans, monitor_keys = point_lanes(
            FuzzSpec(**cli.BENCH_FUZZ))
    else:
        sweep = cli.parse_args(cli.MAIN_PATHS[args.protocol])
        protocol, dims, specs = cli.sweep_setup(sweep)
        batch = specs[:sweep.batch_lanes]
    state, ctx = prepare_batch(protocol, dims, batch, dev, monitor_keys)
    print(json.dumps(
        profile(protocol, dims, state, ctx, dev, args.steps, args.warmup,
                batch_reorder_flag(batch), batch_fault_flags(batch),
                monitor_keys)
    ))


if __name__ == "__main__":
    main()
