"""K6 ``emit_rewrite``'s device time by phase on the card.

    python -m fantoch_tpu_torch.k6_phases
        [--protocol tempo_partial,caesar,atlas_partial] [--warmup 300]
        [--iters 50]

For each protocol, the first batch of its main-path sweep
(``cli.MAIN_PATHS``) runs ``warmup`` steps of the run loop, and the
arguments of the next step's K6 call are kept. The kernel's source
(``kernels/csrc/emit_rewrite.cu``) is then built again once for each of
its phases 1-5, cut at that phase (a ``return`` after the barrier that
ends the phase before it), each by its own ``nvcc`` into
``fantoch_tpu_torch/_build/k6_phases/``; every cut and the whole kernel
run on the kept arguments (a fresh copy of the planes K6 updates in
place each call), and so does the whole kernel with every third lane
failed. Times are device ms a launch under ``torch.profiler``. A cut's
time holds the phases before it, so the difference between two cuts is
the phase between them (phase 0 stages the clients and stages, 1 reads
the rows and folds the results, 2 the clients, 3 the rewrite and the
latency records, 4 the channel keys, the wire draws and the payloads'
sources, 5 the channel counts, the rows' words and the lane words). Prints one JSON line a
protocol, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from . import cli
from .engine import core as engine_core
from .engine.core import frozen_step
from .engine.driver import batch_reorder_flag, prepare_batch
from .engine.faults import batch_fault_flags
from .kernels import build
from .kernels.emit_rewrite import emit_rewrite, rows_per_process
from .kernels.lane_freeze import Cap
from .kernels.step_loop import clone_tree

PHASES = 5
SOURCE = build.CSRC / "emit_rewrite.cu"
OUT = build.BUILD_ROOT / "k6_phases"


def cut_source(phase: int) -> str:
    """The kernel's source cut before ``phase``: its blocks return after
    the barrier that ends phase ``phase - 1``."""
    lines = SOURCE.read_text().splitlines(keepends=True)
    mark = f"  // phase {phase}:"
    at = next(i for i, line in enumerate(lines) if line.startswith(mark))
    return "".join(lines[:at] + ["  return;\n"] + lines[at:])


def build_cuts():
    """``{phase: library}``: one shared library a cut, built in
    parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for phase in range(1, PHASES + 1):
        src = OUT / f"emit_rewrite_cut{phase}.cu"
        src.write_text(cut_source(phase))
        lib = OUT / f"libk6_cut{phase}.so"
        procs[phase] = (lib, subprocess.Popen(
            [build._nvcc(), build.ARCH, "-std=c++17", "-O3", "-Xcompiler",
             "-fPIC", "-shared", f"-I{build.CSRC}", str(src), "-o",
             str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for phase, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for cut {phase}:\n{out}")
        libs[phase] = ctypes.CDLL(str(lib))
    return libs


def step_args(name: str, warmup: int, dev):
    """The arguments of K6's call at step ``warmup + 1`` of path
    ``name``'s first batch, its in-place planes copied before the
    call."""
    args = cli.parse_args(cli.MAIN_PATHS[name])
    protocol, dims, specs = cli.sweep_setup(args)
    batch = specs[:args.batch_lanes]
    flags = (batch_reorder_flag(batch), batch_fault_flags(batch))
    state, ctx = prepare_batch(protocol, dims, batch, dev)
    for _ in range(warmup):
        state, _running = frozen_step(protocol, dims, state, ctx, 1 << 22,
                                      *flags)
    kept = {}
    saved = engine_core.emit_rewrite

    def record(*a):
        kept["args"] = fresh(a)
        return saved(*a)

    engine_core.emit_rewrite = record
    try:
        frozen_step(protocol, dims, state, ctx, 1 << 22, *flags)
    finally:
        engine_core.emit_rewrite = saved
    return kept["args"]


def fresh(a):
    """K6's arguments with the planes it updates in place copied."""
    st = dict(a[0], **{k: clone_tree(a[0][k]) for k in
                       ("clients", "metrics", "pair_cnt", "next_periodic")})
    return (st,) + a[1:]


def third_frozen(a):
    """K6's arguments with a cap that fails every third lane."""
    cap = a[-1]
    st = dict(cap.st, err=cap.st["err"].clone())
    st["err"][::3] = 64
    return a[:-1] + (Cap(st, cap.ctx, cap.lim, cap.flags),)


def device_ms(fn, iters: int) -> float:
    """Device ms a launch of ``emit_rewrite_kernel`` over ``iters`` calls
    of ``fn``, under ``torch.profiler``."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and e.name.startswith("emit_rewrite_kernel")]
    return sum(times) / max(len(times), 1)


def with_library(lib, fn):
    """``fn()`` with K6's entry point bound from ``lib``."""
    saved = build.c_function

    def bind(name, n_ptr, n_int):
        f = getattr(lib, name)
        f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                      + [ctypes.c_void_p])
        f.restype = ctypes.c_int
        return f

    build.c_function = bind
    try:
        return fn()
    finally:
        build.c_function = saved


def measure(name: str, warmup: int, iters: int, libs, dev) -> dict:
    a = step_args(name, warmup, dev)

    def run(args=a):
        return emit_rewrite(*fresh(args))

    ms = {f"cut_before_{p}": with_library(libs[p],
                                          lambda: device_ms(run, iters))
          for p in range(1, PHASES + 1)}
    ms["whole"] = device_ms(run, iters)
    frozen = third_frozen(a)
    ms["whole_third_frozen"] = device_ms(lambda: run(frozen), iters)
    cuts = [ms[f"cut_before_{p}"] for p in range(1, PHASES + 1)]
    cuts.append(ms["whole"])
    by_phase = {"0": cuts[0]}
    by_phase.update({str(p): cuts[p] - cuts[p - 1]
                     for p in range(1, PHASES + 1)})
    L, N, W = a[6].shape
    E = N * rows_per_process(a[10].F, a[12])
    return {"protocol": name, "lanes": L, "rows_a_lane": E, "row_words": W,
            "ms": ms, "ms_by_phase": by_phase}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--protocol", default="tempo_partial,caesar,atlas_partial")
    p.add_argument("--warmup", type=int, default=300)
    p.add_argument("--iters", type=int, default=50)
    args = p.parse_args(argv)
    dev = torch.device("cuda")
    build.library()
    libs = build_cuts()
    for name in args.protocol.split(","):
        print(json.dumps(measure(name, args.warmup, args.iters, libs, dev)),
              flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
