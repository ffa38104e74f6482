#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

Run from the root of a checkout, with one CUDA card and no arguments:

    python3 chip_smoke.py

It builds the engine's thirteen CUDA kernels from
``fantoch_tpu_torch/kernels/csrc`` (one nvcc per source, in parallel),
holds each kernel against its plain PyTorch twin on the card at the
eight main paths' shapes (exact equality: all integer or bool data;
``key_table`` also on a batch of Zipf lanes; ``lane_freeze`` also with
frozen lanes; ``tempo_handle`` over further steps until every Tempo
message type and the GC and detached-send timers have been handled;
``graphdep_handle``, on the Atlas and on the EPaxos path, until every
message type, the GC timer and a drain chain have been;
``caesar_handle`` until every Caesar message type, both timers, an exec
and a wait chain, a reject reply and an MRetry broadcast have been;
``tempo_partial_handle`` until every one of its fifteen message types,
the GC and detached-send timers, a two-shard commit (MShardCommit →
MShardAgg) and a StableAtShard round have been, then on every step of a
small batch whose clock bump fires; ``atlas_partial_handle`` until every
one of its fourteen message types, both timers, a two-shard commit, a
request answered at once and one answered by the cleanup tick, and a
drain chain have been, then on every step of a small batch whose
cleanup tick runs every 5 ms; ``qualify_pop``, ``emit_rewrite`` and
``lane_freeze`` under the fault flags on every step of a fault-coverage
batch until a crash purge, a crashed timer, a halted client, an
unavailable lane, a multiplier and an override window, a partition, an
overflowing multiplier, a jitter multiplier, a drop and a horizon-cut
result have been compared, ``emit_rewrite`` on every step of a small
reorder batch and of a partially replicated reorder lane, and at 1,060
and 1,540 emission rows a lane)
beside the
least time its region's work needs (each kernel module's ``work``,
``kernels/cost.py``) — a kernel's ``ms`` is its device time per launch
under ``torch.profiler``, ``call_ms`` the wrapper's whole call (host
included) — checks the Basic golden numbers and the committed
``tests/fixtures/torch_{basic,fpaxos,tempo,graphdep,caesar,tempo_partial,
atlas_partial,faults}_golden.json`` bytes on the card, then drives the nine
main paths — the
2,048-lane Basic, FPaxos, Tempo, Atlas, EPaxos and Caesar sweeps (n = 5,
256 five-region subsets × f ∈ {1, 2} × conflict ∈ {0, 10, 50, 100}, 50
commands per client, one client per region) and the 512-lane sweep of
Tempo under partial replication (2 shards of 5 rows, 2 keys per command
from a pool of 4, the first 64 subsets, conflict 1 in place of 0) and
the same 512-lane grid of Atlas under partial replication at 9 commands
per client, and the 2,048-lane Tempo grid under four fault plans (the
first 64 subsets, each point once per plan; its fault-free lanes equal
the Tempo sweep's byte for byte) — through ``run_sweep``, each with
every launch counter set to 0 just before and read just after, and
holds sampled lanes of each to the plain twins on the host. Then the
safety monitors' paths: the monitor branches of the five handler
kernels and of ``emit_rewrite`` against their twins on every step of
small monitored batches of all six protocols (until executions, a
monitor-key-range, a missing-execution and, on the injected-bug point,
an order-divergence violation were seen; the injected-bug point's
per-lane violations, steps and digests equal
``tests/fixtures/torch_fuzz_bug_golden.json``), the 2,048-lane Tempo
sweep with the monitors on (equal to the unmonitored sweep outside the
three monitor fields), this slice's main path — the ``mc --no-confirm``
default grid, Tempo, FPaxos and Atlas × n ∈ {3, 5} × 512 schedules,
counted, lanes 0–3 and the last of each point held to the host twins —
and the reference bench's fuzz point (nothing flagged), with
``mon_finalize`` against its twin on the final state of every
monitored batch. The host twins run in worker processes started before
the build, overlapping the card's phases. Any failure raises; nothing
is caught. Each phase prints its seconds. The last two lines
are one JSON object per kernel (``{"kernels": [...]}``) and the verdict
``{"ok": true, ...}``.
Without a CUDA card it exits non-zero and prints no result.
"""

from __future__ import annotations

import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIXTURES = ROOT / "tests" / "fixtures"

GOLDEN_POINTS = [(f, cf) for f in (0, 1, 2) for cf in (0, 100)]
# the FPaxos golden batch: (f, leader), conflict 100
FPAXOS_POINTS = [(1, 1), (1, 3), (2, 2)]
# the Tempo golden batches (tests/test_torch_tempo.py): (n, f, conflict,
# commands, clients per region, clock bump ms) in one batch, and (..., the
# skip_fast_ack knob) in one skip-capable batch
TEMPO_MAIN = [
    (3, 1, 100, 30, 2, None),
    (3, 1, 0, 30, 2, None),
    (5, 1, 100, 10, 1, None),
    (5, 2, 100, 20, 1, None),
    (5, 1, 100, 30, 2, None),
    (3, 1, 100, 30, 2, 50),
]
TEMPO_SKIP = [(3, 1, 100, 20, 1, True), (3, 1, 100, 20, 1, False)]
# the Atlas and EPaxos golden batches (tests/test_torch_graphdep.py):
# (n, f, conflict, commands, clients per region), one batch per protocol
GRAPHDEP_POINTS = [
    (3, 1, 100, 30, 1),
    (3, 1, 0, 30, 2),
    (5, 2, 100, 10, 1),
    (5, 2, 100, 20, 2),
]
# the partial-replication golden batches (tests/test_torch_tempo_partial.py,
# one batch each): (n, f, shards, conflict, pool, keys per command), 10
# commands per client
TEMPO_PARTIAL_POINTS = [(3, 1, 2, 0, 1, 1), (3, 1, 2, 100, 4, 2)]
# the Atlas partial golden batch (tests/test_torch_atlas_partial.py):
# (n, f, shards, conflict, pool, keys per command), 10 commands per
# client, one batch
ATLAS_PARTIAL_POINTS = [(3, 1, 2, 100, 4, 2), (3, 1, 2, 10, 4, 2)]
# the clock-bump batch of tests/test_torch_tempo_partial_step.py:
# (regions, f, conflict, clock bump ms), GC every 10 ms, detached sends
# every 20 ms, 4 commands per client
EU5 = ["europe-west1", "europe-west2", "europe-west3", "europe-west4",
       "europe-west6"]
EU3 = ["europe-west1", "europe-west3", "europe-west4"]
BUMP_POINTS = [(EU5, 2, 100, None), (EU5, 2, 50, 10), (EU3, 1, 100, None),
               (EU3, 1, 10, 10)]
# the batch of tests/test_torch_atlas_partial_step.py, on EU5: (f,
# conflict), GC every 10 ms, the cleanup tick every 5 ms, 4 commands per
# client
REQUEST_POINTS = [(2, 100), (2, 50), (1, 100), (1, 10)]
# the Caesar golden batch (tests/test_torch_caesar.py): (n, f, wait
# condition, conflict, commands, clients per region)
CAESAR_POINTS = [
    (3, 1, True, 100, 30, 1),
    (3, 1, False, 100, 30, 1),
    (3, 1, True, 0, 30, 2),
    (5, 2, True, 100, 10, 1),
    (5, 2, False, 100, 10, 1),
]
# the faults golden batches (tests/test_torch_faults.py): Tempo, n = 3,
# f = 1, one client per region; the fault batch's plans at 15 commands,
# the reorder batch's seeds at 20 commands with 30 s of extra time
FAULT_PLANS = [
    {"crash": {"0": 150}},
    {"crash": {"2": 150}},
    {"windows": [{"src": 0, "dst": 1, "t0": 50, "t1": 400, "mult": 6},
                 {"src": 1, "dst": 0, "t0": 50, "t1": 400, "mult": 6}]},
    {"windows": [{"src": 0, "dst": 1, "t0": 0, "t1": 800,
                  "mult": 1 << 29}], "horizon": 5000},
    {"crash": {"2": 200}},
    {"crash": {"1": 0}},
    {"crash": {"1": 100, "2": 400}},
]
REORDER_SEEDS = [0, 1]
# K6 is held to its twin on every one of a reorder batch's first steps
# (cut from the whole run, 3,584 and 5,184 steps, for the time the
# monitors' phases need)
REORDER_STEPS = 1024
# the fault-coverage batch: Tempo, n = 3, two clients in each of the
# COVERAGE_CLIENTS regions, GC and detached sends every 20 ms; lane i
# runs plan i, each plan made to show its event within a few hundred
# steps (the horizon's on one of three lanes)
COVERAGE_PLANS = [
    ("crash purges, crashed timers, halted clients", {"crash": {"1": 30}}),
    ("multiplier window", {"windows": [{"src": 0, "dst": 1, "t0": 0,
                                        "t1": 300, "mult": 6}]}),
    ("override window", {"windows": [{"src": 2, "dst": 0, "t0": 0,
                                      "t1": 300, "delay": 3}]}),
    ("partition loss", {"windows": [{"src": 1, "dst": 2, "t0": 0,
                                     "t1": 200, "delay": "inf"}],
                        "horizon": 5000}),
    ("overflow-multiplier partition",
     {"windows": [{"src": 0, "dst": 1, "t0": 0, "t1": 800,
                   "mult": 1 << 29}], "horizon": 5000}),
    ("jitter multiplier", {"jitter_max": 8, "jitter_seed": 1}),
    ("drop", {"drop_bp": 3000, "seed": 7, "horizon": 5000}),
    ("unavailable lane (ERR_UNAVAIL)", {"crash": {"1": 100, "2": 400}}),
    ("horizon-cut TO_CLIENT", {"horizon": 100}),
    ("horizon-cut TO_CLIENT", {"horizon": 150}),
    ("horizon-cut TO_CLIENT", {"horizon": 200}),
]
# the fault-coverage batch's client regions: two beside their process
# (rows 0 and 1), one 17 ms from it (row 1), so that a result can reach
# its client past the horizon
COVERAGE_CLIENTS = ["asia-east1", "asia-east2", "asia-southeast1"]
# sampled lanes held to the host's plain twins: (regions, f, conflict) =
# (0, 1, 0), (0, 2, 100), (125, 1, 0), (255, 2, 100); the twins of Tempo,
# Atlas, EPaxos and Caesar are slower on the host, so two of them, both
# f = 2 at conflict 100; a partial lane takes some 11,700 serialized
# steps, so one (subset 0, f = 2, conflict 100); so for Atlas partial;
# under faults the four plans of point 0 (subset 0, f = 1, conflict 0)
# and the drop plan of point 7, whose lane overflows a Tempo table
SAMPLE = {"basic": [0, 7, 1000, 2047], "fpaxos": [0, 7, 1000, 2047],
          "tempo": [7, 2047], "atlas": [7, 2047], "epaxos": [7, 2047],
          "caesar": [7, 2047], "tempo_partial": [7], "atlas_partial": [7],
          "tempo_faults": [0, 1, 2, 3, 31]}

# the reference region each kernel replaces
REPLACES = {
    "qualify_pop": "fantoch_tpu/engine/core.py:811",
    "land_emissions": "fantoch_tpu/engine/core.py:1457",
    "key_table": "fantoch_tpu/engine/core.py:439",
    "basic_handle": "fantoch_tpu/engine/protocols/basic.py:119",
    "fpaxos_handle": "fantoch_tpu/engine/protocols/fpaxos.py:127",
    "emit_rewrite": "fantoch_tpu/engine/core.py:941",
    "lane_freeze": "fantoch_tpu/engine/core.py:1565",
    "tempo_handle": "fantoch_tpu/engine/protocols/tempo.py:226",
    "graphdep_handle": "fantoch_tpu/engine/protocols/graphdep.py:215",
    "caesar_handle": "fantoch_tpu/engine/protocols/caesar.py:239",
    "tempo_partial_handle":
        "fantoch_tpu/engine/protocols/tempo_partial.py:198",
    "atlas_partial_handle":
        "fantoch_tpu/engine/protocols/graphdep_partial.py:219",
    "mon_finalize": "fantoch_tpu/engine/monitor.py:217",
}
HANDLERS = {"basic": "basic_handle", "fpaxos": "fpaxos_handle",
            "tempo": "tempo_handle", "atlas": "graphdep_handle",
            "epaxos": "graphdep_handle", "caesar": "caesar_handle",
            "tempo_partial": "tempo_partial_handle",
            "atlas_partial": "atlas_partial_handle",
            "tempo_faults": "tempo_handle"}
PATHS = ("basic", "fpaxos", "tempo", "atlas", "epaxos", "caesar",
         "tempo_partial", "atlas_partial", "tempo_faults")
# the Tempo sweep's to_json lines: its first 512 lanes are the fault
# path's fault-free lanes, and the monitored Tempo sweep must equal all of
# them outside the monitor fields
TEMPO_LINES = []
OUTBOX_KEYS = ("valid", "dst", "mtype", "payload")


class HostTwins:
    """The host runs of the plain twins that the card's results are held
    to, in worker processes (one torch thread each, at the lowest
    priority) started before the build, so they overlap the card's
    phases: a task runs sampled lanes, or a segment of one, on the CPU. Started with ``spawn`` (the parent holds a CUDA context);
    :meth:`close` stops every worker."""

    def __init__(self, workers: int = 6):
        import concurrent.futures
        import multiprocessing

        self.pool = concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"),
            initializer=_host_worker)
        self.futures = {}

    def submit(self, key, fn, *args):
        self.futures[key] = self.pool.submit(fn, *args)

    def result(self, key):
        return self.futures.pop(key).result()

    def close(self):
        procs = list(getattr(self.pool, "_processes", {}).values())
        self.pool.shutdown(wait=False, cancel_futures=True)
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=30)


def _host_worker() -> None:
    """A host worker yields the CPU to the process that drives the card
    (its host-bound step loop sets the sweeps' points/s) and runs torch
    on one thread."""
    import os

    import torch

    os.nice(19)
    torch.set_num_threads(1)


def _host_sweep_lanes(name, lanes):
    """Worker task: lanes ``lanes`` of main path ``name`` on the host."""
    from fantoch_tpu_torch import cli
    from fantoch_tpu_torch.engine import run_lanes

    t0 = time.perf_counter()
    protocol, dims, specs = cli.sweep_setup(
        cli.parse_args(cli.MAIN_PATHS[name]))
    host = run_lanes(protocol, dims, [specs[i] for i in lanes], device="cpu")
    return ([json.dumps(h.to_json(), sort_keys=True) for h in host],
            time.perf_counter() - t0)


def _host_segment(spec_kw, plan, state, steps, flags, last):
    """Worker task: one sampled mc lane on the host from the card's
    snapshot ``state`` (numpy, one lane), ``steps`` run-loop steps of the
    plain twins under the card batch's ``flags`` (reorder, fault flags,
    monitor keys), stopping early once the lane no longer runs (every
    later step is the identity). Returns the state, and for the ``last``
    segment also the run's end (``finish_run``) as a ``to_json`` line."""
    from fantoch_tpu_torch.carry import to_numpy, to_torch
    from fantoch_tpu_torch.engine.core import finish_run, frozen_step
    from fantoch_tpu_torch.engine.driver import prepare_batch
    from fantoch_tpu_torch.engine.faults import FaultFlags
    from fantoch_tpu_torch.engine.results import collect_results
    from fantoch_tpu_torch.mc.fuzz import FuzzSpec, point_lanes

    t0 = time.perf_counter()
    reorder, faults, mk = flags
    faults = FaultFlags(*faults)
    proto, dims, specs, _plans, _mk = point_lanes(FuzzSpec(**spec_kw),
                                                  plans=[plan])
    _state, ctx = prepare_batch(proto, dims, specs, "cpu", mk)
    st = to_torch(state, "cpu")
    for _ in range(steps):
        st, running = frozen_step(proto, dims, st, ctx, 1 << 22, reorder,
                                  faults, mk)
        if not bool(running.any()):
            break
    line = None
    if last:
        end = finish_run(proto, st, ctx, 1 << 22, reorder, faults, mk)
        line = json.dumps(collect_results(proto, dims, end, specs)[0].to_json(),
                          sort_keys=True)
    return to_numpy(st), line, time.perf_counter() - t0


# the host pool (main() opens it)
HOST = None


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _flatten(x):
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _flatten(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _flatten(v)]
    return [x]


def _clone(x):
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x.clone()


def _compare(got, want) -> float:
    """Exact equality of two output trees; returns the max abs error."""
    import torch

    a, b = _flatten(got), _flatten(want)
    assert len(a) == len(b)
    err = 0.0
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype, (x.shape, y.shape)
        diff = (x.to(torch.float64) - y.to(torch.float64)).abs()
        err = max(err, float(diff.max()) if diff.numel() else 0.0)
        if not torch.equal(x, y):
            raise AssertionError(f"kernel differs from its twin ({err})")
    return err


def _handler_view(out):
    """A handler's outputs with the kernel's outbox planes: the twin
    also carries ``delay``/``src``, which must be all -1."""
    rdy, ps, pout, hout = out
    for ob in (pout, hout):
        for k in ("delay", "src"):
            assert k not in ob or bool((ob[k] == -1).all()), k
    return (rdy, ps, *({k: ob[k] for k in OUTBOX_KEYS}
                       for ob in (pout, hout)))


def _time_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _event_ms(fn, iters: int) -> float:
    """Device time per call of ``fn`` from a CUDA event pair around each
    call. The pairs queue behind a device-side sleep while the host
    issues them, so the host's issue time between calls is not counted;
    each pair also counts its launch's few microseconds on the device."""
    import torch

    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(200_000_000)  # about 0.1 s of the card's cycles
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def _device_ms(fn, kernel: str, iters: int) -> float:
    """Device time per launch of ``kernel`` over ``iters`` calls of
    ``fn``, from ``torch.profiler``: the kernel's own time, without the
    host's time to issue it (``_time_ms`` measures the call as a whole,
    which for a short kernel is the host's). The profiler may lose a few
    of a burst of short launches' records; the time is the mean over the
    launches it recorded, and the line says how many that was. Where it
    recorded none (seen for K3's launches of a few microseconds), the
    time comes from :func:`_event_ms`, and the line says so."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and e.name.startswith(kernel + "_kernel")]
    if not us:
        print(f"profiler: no {kernel} launch of {iters} recorded; ms is "
              f"from CUDA events around each launch instead")
        return _event_ms(fn, iters)
    assert len(us) <= iters, (kernel, len(us))
    if len(us) < iters:
        print(f"profiler: {len(us)} of {iters} {kernel} launches recorded; "
              f"ms is their mean")
    return sum(us) / len(us) / 1e3


def check_kernels(name, dev, rows):
    """Phase 3 for one main path: its first batch, stepped 300 times
    through the run loop, then one step's kernel arguments recorded;
    each kernel of the step against its twin on them. Adds a row per
    kernel to ``rows`` (the last path's row wins for shared kernels)."""
    import torch

    from fantoch_tpu_torch import cli, kernels
    from fantoch_tpu_torch.carry import to_torch
    from fantoch_tpu_torch.engine import core as engine_core
    from fantoch_tpu_torch.engine.driver import (
        batch_reorder_flag, prepare_batch,
    )
    from fantoch_tpu_torch.engine.faults import batch_fault_flags
    from fantoch_tpu_torch.engine.spec import stack_lanes
    from fantoch_tpu_torch.kernels import cost

    argv = cli.MAIN_PATHS[name]
    sweep = cli.parse_args(argv)
    protocol, dims, specs = cli.sweep_setup(sweep)
    max_steps = 1 << 22
    batch = specs[:sweep.batch_lanes]
    # the batch's reorder flag and fault-flag union, as run_sweep's
    flags = (batch_reorder_flag(batch), batch_fault_flags(batch))
    state, ctx = prepare_batch(protocol, dims, batch, dev)
    for _ in range(300):
        state, _running = engine_core.frozen_step(protocol, dims, state,
                                                  ctx, max_steps, *flags)
    handler = HANDLERS[name]
    mods = {k: importlib.import_module(f"fantoch_tpu_torch.kernels.{k}")
            for k in ("qualify_pop", "land_emissions", "emit_rewrite",
                      "lane_freeze", handler, "key_table")}
    patched = {
        "qualify_pop": engine_core,
        "land_emissions": engine_core,
        "emit_rewrite": engine_core,
        "lane_freeze": engine_core,
        handler: mods[handler],
    }
    captured = {}

    def recorder(kname, fn):
        def wrapped(*args):
            # lane_freeze writes into the step's new planes: keep a copy
            captured[kname] = (
                (_clone(args[0]),) + args[1:] if kname == "lane_freeze"
                else args
            )
            return fn(*args)
        # the wrapper counts through its module-global name, which is
        # this recorder while it stands in
        wrapped.launches = 0
        return wrapped

    saved = {k: getattr(m, k) for k, m in patched.items()}
    for k, m in patched.items():
        setattr(m, k, recorder(k, saved[k]))
    state, _running = engine_core.frozen_step(protocol, dims, state, ctx,
                                              max_steps, *flags)
    for k, m in patched.items():
        setattr(m, k, saved[k])
    T = ctx["key_table"].shape[2]
    captured["key_table"] = (
        ctx["rng_key"], ctx["conflict_rate"], ctx["pool_size"],
        ctx["key_gen_kind"], ctx["zipf_cum"], dims.C, T,
    )
    L, M, W = captured["qualify_pop"][0].shape
    shapes = (f"L={L} N={dims.N} M={M} W={W} D={dims.D} F={dims.F} "
              f"E={captured['land_emissions'][2].shape[1]} C={dims.C} T={T}")
    for kname, a in captured.items():
        mod = mods[kname]
        kern, plain = getattr(mod, kname), getattr(mod, kname + "_plain")
        before = kern.launches
        if kname == "lane_freeze":
            got, want = kern(_clone(a[0]), *a[1:]), plain(*a)
            run_kernel = (lambda a=a, new=_clone(a[0]): kern(new, *a[1:]))
        else:
            got, want = kern(*a), plain(*a)
            run_kernel = (lambda a=a: kern(*a))
        if kname == handler:
            got, want = _handler_view(got), _handler_view(want)
        torch.cuda.synchronize()
        err = _compare(got, want)
        ms = _device_ms(run_kernel, kname, 50)
        call_ms = _time_ms(run_kernel, 50)
        plain_ms = _time_ms(lambda a=a: plain(*a), 5)
        # the least bytes and operations the region needs on these inputs
        n_bytes, n_ops = mod.work(*a, got)
        bound_ms, bound_by = cost.bound(n_bytes, n_ops)
        library_ms = None
        if kname == "land_emissions":
            free = a[1] == (1 << 30)
            library_ms = _time_ms(
                lambda: torch.cumsum(free, dim=1, dtype=torch.int32), 50
            )
        rows[kname] = dict(
            path=name, max_abs_err=err, ms=ms, call_ms=call_ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms,
        )
        print(f"kernel {kname} ({name} path): exact=True max_abs_err={err} "
              f"ms={ms:.5f} call_ms={call_ms:.5f} plain_ms={plain_ms:.5f} "
              f"bound_us={1e3 * bound_ms:.3f} ({bound_by}: {n_bytes} "
              f"bytes, {n_ops} ops) library_ms={library_ms} "
              f"launches={kern.launches - before} shapes {shapes}")

    if handler in COVERAGE and name != "tempo_faults":
        rows[handler]["max_abs_err"] = max(
            rows[handler]["max_abs_err"],
            coverage(name, handler, protocol, dims, state, ctx, max_steps,
                     captured[handler], mods[handler]),
        )
    if name == "tempo_partial":
        rows[handler]["max_abs_err"] = max(
            rows[handler]["max_abs_err"], bump_coverage(dev, mods[handler]),
        )
    if name == "atlas_partial":
        rows[handler]["max_abs_err"] = max(
            rows[handler]["max_abs_err"],
            request_coverage(dev, mods[handler]),
        )

    # K7 with frozen lanes (every third lane failed), which it copies
    new, old, fctx, ms_, lflags = captured["lane_freeze"]
    old = dict(old, err=old["err"].clone())
    old["err"][::3] = 64
    lf = mods["lane_freeze"]
    got = lf.lane_freeze(_clone(new), old, fctx, ms_, lflags)
    err = _compare(got, lf.lane_freeze_plain(new, old, fctx, ms_, lflags))
    frozen = int((~got[1]).sum())
    ms = _device_ms(
        lambda n=_clone(new): lf.lane_freeze(n, old, fctx, ms_, lflags),
        "lane_freeze", 50,
    )
    n_bytes, n_ops = lf.work(new, old, fctx, ms_, lflags, got)
    print(f"kernel lane_freeze ({name} path, {frozen} of {L} lanes "
          f"frozen): exact=True max_abs_err={err} ms={ms:.5f} bound_us="
          f"{1e3 * cost.bound(n_bytes, n_ops)[0]:.3f} ({n_bytes} bytes)")

    if name == "basic":
        # K3's Zipf branch, which the main path's ConflictPool lanes do
        # not take: one batch of Zipf lanes (the same grid's first 512
        # points with --zipf 1.0,1000)
        zargv = list(argv)
        zargv[zargv.index("--subsets") + 1] = "64"
        _zp, _zd, zspecs = cli.sweep_setup(
            cli.parse_args(zargv + ["--zipf", "1.0,1000"])
        )
        zctx = to_torch(stack_lanes(zspecs[:sweep.batch_lanes]), dev)
        assert bool((zctx["key_gen_kind"] == 1).all())
        za = (zctx["rng_key"], zctx["conflict_rate"], zctx["pool_size"],
              zctx["key_gen_kind"], zctx["zipf_cum"], dims.C, T)
        got = kernels.key_table(*za)
        want = mods["key_table"].key_table_plain(*za)
        torch.cuda.synchronize()
        err = _compare(got, want)
        assert int(got.max()) > 0 and int(got.min()) >= 0
        print(f"kernel key_table (zipf): exact=True max_abs_err={err} "
              f"L={got.shape[0]} C={dims.C} T={T} "
              f"K={zctx['zipf_cum'].shape[1]} distinct keys "
              f"{int(torch.unique(got).numel())}")


# the message types each handler's coverage phase waits for, in type
# order, the timer rows that must fire, and the further events that must
# have been seen in some compared step: each a count over the twin's
# outputs ``(rdy, ps, periodic outbox, handler outbox)``


def _slot_valid(slot):
    """Valid messages in handler outbox slot ``slot`` (negative: from
    the end)."""
    return lambda out, dims: int(out[3]["valid"][..., slot].sum())


def _tick_answers(out, dims):
    """Valid periodic messages past slot N: the cleanup tick's answers
    to buffered requests."""
    return int(out[2]["valid"][..., dims.N + 1:].sum())


def _sent(mtype, word=None, value=None):
    """Valid handler messages of type ``mtype`` (with payload ``word``
    equal to ``value``)."""
    def count(out, dims):
        hout = out[3]
        hit = hout["valid"] & (hout["mtype"] == mtype)
        if word is not None:
            hit = hit & (hout["payload"][..., word] == value)
        return int(hit.sum())
    return count


COVERAGE = {
    "tempo_handle": (("SUBMIT", "MCOLLECT", "MCOLLECTACK", "MCOMMIT",
                      "MDETACHED", "MCONSENSUS", "MCONSENSUSACK", "MGC",
                      "MDRAIN", "DETACH_DRAIN"), (0, 2), {}),
    "graphdep_handle": (("SUBMIT", "MCOLLECT", "MCOLLECTACK", "MCOMMIT",
                         "MCONSENSUS", "MCONSENSUSACK", "MGC", "MDRAIN"),
                        (0,),
                        {"drain chains (MDRAIN in slot F - 1)":
                         _slot_valid(-1)}),
    # Tempo partial (engine/protocols/tempo_partial.py): MSHARDAGG = 13,
    # which MShardCommit sends once every shard of a command reported;
    # STABLEAT = 14, which a drain sends once a multi-key command is
    # stable at its keys here
    "tempo_partial_handle": (("SUBMIT", "MCOLLECT", "MCOLLECTACK",
                              "MCOMMIT", "MDETACHED", "MCONSENSUS",
                              "MCONSENSUSACK", "MGC", "MDRAIN",
                              "DETACH_DRAIN", "MFWDSUBMIT", "MBUMP",
                              "MSHARDCOMMIT", "MSHARDAGG", "STABLEAT"),
                             (0, 2),
                             {"two-shard commits (MSHARDAGG sent)":
                              _sent(13),
                              "StableAtShard rounds (STABLEAT sent)":
                              _sent(14)}),
    # Atlas partial (engine/protocols/graphdep_partial.py): MDRAIN = 7,
    # which only the drain sends; MSHARDAGG = 10, which MShardCommit sends
    # once every shard of a command reported (the request events are
    # waited for on request_coverage's batch)
    "atlas_partial_handle": (("SUBMIT", "MCOLLECT", "MCOLLECTACK", "MCOMMIT",
                              "MCONSENSUS", "MCONSENSUSACK", "MGC", "MDRAIN",
                              "MFWDSUBMIT", "MSHARDCOMMIT", "MSHARDAGG",
                              "GREQ", "GREPLY", "GREPLYEXEC"),
                             (0, 1),
                             {"two-shard commits (MSHARDAGG sent)":
                              _sent(10),
                              "drain chains (MDRAIN sent)": _sent(7)}),
    # Caesar (engine/protocols/caesar.py): MPROPOSEACK = 2, MRETRY = 4;
    # a reject reply carries 0 in payload word 3 (an accept 1)
    "caesar_handle": (("SUBMIT", "MPROPOSE", "MPROPOSEACK", "MCOMMIT",
                       "MRETRY", "MRETRYACK", "MGC", "WAIT_DRAIN",
                       "EXEC_DRAIN", "GC_DRAIN"), (0, 1),
                      {"exec chains (EXEC_DRAIN in slot F - 3)":
                       _slot_valid(-3),
                       "wait chains (WAIT_DRAIN in slot F - 1)":
                       _slot_valid(-1),
                       "reject replies": _sent(2, 3, 0),
                       "MRETRY broadcasts": _sent(4)}),
}


def coverage(name, kname, protocol, dims, state, ctx, max_steps, first,
             mod, every=25, bound=80, rows_needed=None, start=301,
             extras=None):
    """A handler kernel against its twin, exactly, on the arguments of
    one step in every ``every`` after phase 3's, until each of its
    message types, the timer rows and the further events have been seen
    in some compared step (at most ``bound`` captures; the Tempo main
    paths never fire the clock-bump row, which the golden batch and, for
    the partial twin, :func:`bump_coverage` cover). Returns the max abs
    error."""
    import torch

    from fantoch_tpu_torch.engine import core as engine_core
    from fantoch_tpu_torch.engine.dims import PMT

    names, default_rows, main_extras = COVERAGE[kname]
    rows_needed = default_rows if rows_needed is None else rows_needed
    extras = main_extras if extras is None else extras
    kern, plain = getattr(mod, kname), getattr(mod, kname + "_plain")
    handled = [0] * len(names)
    fired = [0] * dims.R
    seen = dict.fromkeys(extras, 0)
    err, args, captures = 0.0, first, 0
    while True:
        got = kern(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        err = max(err, _compare(_handler_view(got), _handler_view(want)))
        has, rows, fire = args[1], args[2], args[3]
        mt = torch.where(has & want[0], rows[..., PMT], -1)
        for t in range(len(names)):
            handled[t] += int((mt == t).sum())
        for r in range(dims.R):
            fired[r] += int(fire[..., r].sum())
        for label, count in extras.items():
            seen[label] += count(want, dims)
        captures += 1
        if (min(handled) > 0 and all(fired[r] > 0 for r in rows_needed)
                and all(seen.values())):
            break
        if captures >= bound:
            raise AssertionError(
                f"{kname} coverage incomplete after {captures} captures: "
                f"{dict(zip(names, handled))}, timers {fired}, {seen}")
        for _ in range(every - 1):
            state, _running = engine_core.frozen_step(protocol, dims, state,
                                                      ctx, max_steps)
        box = {}

        def record(*a):
            box["args"] = a
            return kern(*a)

        # the wrapper counts through its module-global name
        record.launches = 0
        setattr(mod, kname, record)
        try:
            state, _running = engine_core.frozen_step(protocol, dims, state,
                                                      ctx, max_steps)
        finally:
            setattr(mod, kname, kern)
        args = box["args"]
    print(f"kernel {kname} ({name} path): exact=True over {captures} "
          f"compared steps, one in {every} from step {start}; handled "
          f"{dict(zip(names, handled))}; timer rows fired {fired}"
          + "".join(f"; {label} {n}" for label, n in seen.items())
          + f"; max_abs_err={err}")
    return err


def _batch_coverage(label, kname, proto, dims, specs, dev, mod, **kw):
    """``kname`` against its twin on every step of a small batch, from
    its first step (:func:`coverage` with ``every=1``)."""
    from fantoch_tpu_torch.engine import core as engine_core
    from fantoch_tpu_torch.engine.driver import prepare_batch

    state, ctx = prepare_batch(proto, dims, specs, dev)
    kern = getattr(mod, kname)
    box = {}

    def record(*a):
        box["args"] = a
        return kern(*a)

    record.launches = 0
    setattr(mod, kname, record)
    try:
        state, _running = engine_core.frozen_step(proto, dims, state, ctx,
                                                  1 << 22)
    finally:
        setattr(mod, kname, kern)
    return coverage(label, kname, proto, dims, state, ctx, 1 << 22,
                    box["args"], mod, every=1, start=1, **kw)


def bump_coverage(dev, mod) -> float:
    """K11 against its twin on every step of the clock-bump batch of
    tests/test_torch_tempo_partial_step.py (close regions, GC every 10
    ms, the clock bump every 10 ms on two lanes), until all three timer
    rows and all fifteen types have been compared. Returns the max abs
    error."""
    from fantoch_tpu_torch.core import Config, Planet
    from fantoch_tpu_torch.engine import EngineDims, make_lane
    from fantoch_tpu_torch.engine.protocols import TempoPartialDev

    proto = TempoPartialDev(keys=4 + 5 + 1, shards=2, keys_per_cmd=2,
                            pending_per_key=8, detached_slots=6, gap_slots=4)
    dims = EngineDims.for_partial(proto, 5, 5, 20, regions=5)
    specs = [
        make_lane(proto, Planet.new(),
                  Config(n=len(regions), f=f, shard_count=2,
                         gc_interval_ms=10,
                         tempo_detached_send_interval_ms=20,
                         tempo_clock_bump_interval_ms=bump,
                         executor_executed_notification_interval_ms=100,
                         executor_cleanup_interval_ms=100),
                  conflict_rate=conflict, pool_size=4, commands_per_client=4,
                  clients_per_region=1, process_regions=regions,
                  client_regions=regions, dims=dims, extra_time_ms=100,
                  seed=i)
        for i, (regions, f, conflict, bump) in enumerate(BUMP_POINTS)
    ]
    return _batch_coverage("bump batch", "tempo_partial_handle", proto, dims,
                           specs, dev, mod, rows_needed=(0, 1, 2))


def request_coverage(dev, mod) -> float:
    """K12 against its twin on every step of the batch of
    tests/test_torch_atlas_partial_step.py (close regions, GC every 10
    ms, the cleanup tick every 5 ms, a request buffer of 4), until all
    fourteen types and both timer rows have been compared, and requests
    answered at once with either reply, one answered by the cleanup tick,
    a two-shard commit and a drain chain have been seen. Returns the max
    abs error."""
    from fantoch_tpu_torch.core import Config, Planet
    from fantoch_tpu_torch.engine import EngineDims, make_lane
    from fantoch_tpu_torch.engine.protocols import AtlasPartialDev

    proto = AtlasPartialDev(keys=4 + 5 + 1, shards=2, keys_per_cmd=2,
                            gap_slots=4, req_buffer=4)
    dims = EngineDims.for_partial(proto, 5, 5, 20, regions=5)
    specs = [
        make_lane(proto, Planet.new(),
                  Config(n=5, f=f, shard_count=2, gc_interval_ms=10,
                         executor_executed_notification_interval_ms=100,
                         executor_cleanup_interval_ms=5),
                  conflict_rate=conflict, pool_size=4, commands_per_client=4,
                  clients_per_region=1, process_regions=EU5,
                  client_regions=EU5, dims=dims, extra_time_ms=100, seed=i)
        for i, (f, conflict) in enumerate(REQUEST_POINTS)
    ]
    extras = {
        "two-shard commits (MSHARDAGG sent)": _sent(10),
        "requests answered at once (GREPLY sent)": _sent(12),
        "requests answered at once (GREPLYEXEC sent)": _sent(13),
        "requests answered by the cleanup tick": _tick_answers,
        "drain chains (MDRAIN sent)": _sent(7),
    }
    return _batch_coverage("request batch", "atlas_partial_handle", proto,
                           dims, specs, dev, mod, bound=200, extras=extras)


def _checked(mod_name, kname, compare, clone_first=False):
    """A stand-in for kernel ``kname`` in ``engine.core``: each call runs
    the kernel and its twin on the same arguments, ``compare(args,
    got, want)`` holds them equal, and the kernel's result goes on. The
    stand-in counts nothing (the kernel's own counter does)."""
    mod = importlib.import_module(f"fantoch_tpu_torch.kernels.{mod_name}")
    kern, plain = getattr(mod, kname), getattr(mod, kname + "_plain")

    def run(*a):
        if clone_first:  # lane_freeze writes into the step's new planes
            want = plain(_clone(a[0]), *a[1:])
            got = kern(_clone(a[0]), *a[1:])
        else:
            want = plain(*a)
            got = kern(*a)
        import torch

        torch.cuda.synchronize()
        compare(a, got, want)
        return got

    run.launches = 0
    return run


class _Patched:
    """Swaps ``engine.core``'s kernel names for stand-ins while open."""

    def __init__(self, **stand_ins):
        from fantoch_tpu_torch.engine import core as engine_core

        self.core, self.new = engine_core, stand_ins
        self.old = {k: getattr(engine_core, k) for k in stand_ins}

    def __enter__(self):
        for k, v in self.new.items():
            setattr(self.core, k, v)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            setattr(self.core, k, v)


def _tempo_lanes(plans, commands, cpr=1, seeds=None, reorder=False,
                 extra=1000, interval=100, client_regions=None):
    """``(protocol, dims, specs)``: Tempo lanes at n = 3 on the first
    three GCP regions, one per plan (from_json form or None); clients in
    those regions unless ``client_regions`` names others."""
    from fantoch_tpu_torch.core import Config, Planet
    from fantoch_tpu_torch.engine import EngineDims, make_lane
    from fantoch_tpu_torch.engine.faults import FaultPlan
    from fantoch_tpu_torch.engine.protocols import TempoDev

    n, clients = 3, 3 * cpr
    proto = TempoDev(keys=1 + clients)
    total = commands * clients
    dims = EngineDims.for_protocol(
        proto, n=n, clients=clients, payload=proto.payload_width(n),
        total_commands=total, dot_slots=total + 1, regions=n,
    )
    regions = Planet.new().regions()[:n]
    clients_at = client_regions or regions
    seeds = seeds or [0] * len(plans)
    specs = [
        make_lane(proto, Planet.new(),
                  Config(n=n, f=1, gc_interval_ms=interval,
                         tempo_detached_send_interval_ms=interval),
                  conflict_rate=100, pool_size=1,
                  commands_per_client=commands, clients_per_region=cpr,
                  process_regions=regions, client_regions=clients_at,
                  dims=dims, extra_time_ms=extra, seed=seed,
                  reorder=reorder,
                  faults=FaultPlan.from_json(plan) if plan else None)
        for plan, seed in zip(plans, seeds)
    ]
    return proto, dims, specs


def fault_coverage(dev) -> float:
    """K1, K6 and K7 against their twins under the fault flags on every
    step of the fault-coverage batch (lane i runs COVERAGE_PLANS[i]),
    until each plan's event has been seen in a compared step: the event
    is where the twin's result with the plan's flag differs from it with
    the flag taken away (lost rows for the lossy plans, the error bit for
    the unavailable lane). Returns the max abs error."""
    import torch

    from fantoch_tpu_torch.engine import core as engine_core
    from fantoch_tpu_torch.engine import faults as fm
    from fantoch_tpu_torch.engine.driver import prepare_batch
    from fantoch_tpu_torch.engine.faults import batch_fault_flags

    er = importlib.import_module("fantoch_tpu_torch.kernels.emit_rewrite")
    qp = importlib.import_module("fantoch_tpu_torch.kernels.qualify_pop")
    labels = [label for label, _p in COVERAGE_PLANS]
    proto, dims, specs = _tempo_lanes(
        [plan for _l, plan in COVERAGE_PLANS], 6, cpr=2, interval=20,
        seeds=list(range(len(COVERAGE_PLANS))),
        client_regions=COVERAGE_CLIENTS)
    seen = dict.fromkeys(labels, 0)
    halted = specs[0].fault_meta["halted_clients"]
    errs = [0.0]

    def k1(a, got, want):
        errs[0] = max(errs[0], _compare(got, want))
        off = qp.qualify_pop_plain(*a[:5], a[5] & ~fm.FLAG_CRASH)
        purged = (want[0] >= (1 << 30)) & (off[0] < (1 << 30))
        dead = (want[8] >= (1 << 30)) & (a[1] < (1 << 30))
        seen[labels[0]] += int(purged[0].sum()) + int(dead[0].sum())

    def k6(a, got, want):
        errs[0] = max(errs[0], _compare(got, want))
        lost = (want[2]["fault_dropped"] - a[0]["fault_dropped"]).tolist()
        for i in (3, 4, 6):
            seen[labels[i]] += lost[i]
        for i, bit in ((1, fm.FLAG_WINDOWS), (2, fm.FLAG_WINDOWS),
                       (5, fm.FLAG_JITTER)):
            off = er.emit_rewrite_plain(*a[:12], a[12] & ~bit)
            moved = (off[0][i, :, 0] != want[0][i, :, 0]) & want[1][i]
            seen[labels[i]] += int(moved.sum())
        seen[labels[7]] += int(want[2]["err"][7] & 128 != 0)
        off = er.emit_rewrite_plain(*a[:12], a[12] & ~fm.FLAG_HORIZON)
        done = [x[2]["clients"]["completed"][8:] for x in (off, want)]
        seen[labels[8]] += int((done[0] != done[1]).sum())

    def k7(a, got, want):
        errs[0] = max(errs[0], _compare(got, want))

    flags = batch_fault_flags(specs)
    state, ctx = prepare_batch(proto, dims, specs, dev)
    steps = 0
    with _Patched(
        qualify_pop=_checked("qualify_pop", "qualify_pop", k1),
        emit_rewrite=_checked("emit_rewrite", "emit_rewrite", k6),
        lane_freeze=_checked("lane_freeze", "lane_freeze", k7, True),
    ):
        while not (all(seen.values()) and halted):
            state, running = engine_core.frozen_step(
                proto, dims, state, ctx, 1 << 22, False, flags)
            steps += 1
            if steps >= 600 or not bool(running.any()):
                break
    torch.cuda.synchronize()
    assert halted > 0 and all(seen.values()), (
        f"fault coverage incomplete after {steps} steps: {seen}, "
        f"halted clients {halted}")
    print(f"kernels qualify_pop, emit_rewrite, lane_freeze (fault-coverage "
          f"batch, flags {fm.flag_bits(flags)}): exact=True on every one of "
          f"{steps} steps; seen "
          + "; ".join(f"{k} {v}" for k, v in seen.items())
          + f"; halted clients {halted}; max_abs_err={errs[0]}")
    return errs[0]


def reorder_coverage(dev) -> float:
    """K6 against its twin on every one of the first
    :data:`REORDER_STEPS` steps of the faults golden batch's Tempo
    reorder lanes and of the Tempo partial reorder lane of
    tests/test_torch_faults_reorder.py (2 shards, seed 5); the golden
    phase runs the Tempo lanes to their end against the fixture. Returns
    the max abs error."""
    from fantoch_tpu_torch.core import Config, Planet
    from fantoch_tpu_torch.engine import EngineDims, make_lane
    from fantoch_tpu_torch.engine import core as engine_core
    from fantoch_tpu_torch.engine.driver import prepare_batch
    from fantoch_tpu_torch.engine.protocols import TempoPartialDev

    errs, calls = [0.0], [0]

    def k6(a, got, want):
        errs[0] = max(errs[0], _compare(got, want))
        calls[0] += 1

    batches = [_tempo_lanes([None] * len(REORDER_SEEDS), 20,
                            seeds=REORDER_SEEDS, reorder=True,
                            extra=30_000)]
    regions = Planet.new().regions()[:3]
    proto = TempoPartialDev(keys=4 + 3 + 1, shards=2, keys_per_cmd=2)
    dims = EngineDims.for_partial(proto, 3, 3, 30)
    batches.append((proto, dims, [make_lane(
        proto, Planet.new(),
        Config(n=3, f=1, shard_count=2, gc_interval_ms=100,
               executor_executed_notification_interval_ms=100,
               executor_cleanup_interval_ms=100,
               tempo_detached_send_interval_ms=100),
        conflict_rate=100, pool_size=4, commands_per_client=10,
        clients_per_region=1, process_regions=regions,
        client_regions=regions, dims=dims, extra_time_ms=30_000, seed=5,
        reorder=True)]))
    with _Patched(emit_rewrite=_checked("emit_rewrite", "emit_rewrite", k6)):
        for label, (p, d, specs) in zip(("tempo", "tempo partial"), batches):
            before = calls[0]
            state, ctx = prepare_batch(p, d, specs, dev)
            for _ in range(REORDER_STEPS):
                state, running = engine_core.frozen_step(
                    p, d, state, ctx, 1 << 22, True)
            assert not bool(state["err"].any()), state["err"]
            print(f"kernel emit_rewrite ({label} reorder batch): exact=True "
                  f"on every one of the first {calls[0] - before} steps; "
                  f"lanes' steps {state['steps'].tolist()}, requeues "
                  f"{state['requeues'].tolist()}, running "
                  f"{running.tolist()}")
    return errs[0]


def wide_emit(dev) -> float:
    """K6 at 1,060 and 1,540 emission rows a lane: one step's arguments
    of a small Tempo partial and Atlas partial batch at 4 shards of n = 5
    (N = 20), stepped on the host twins to step 40, on the card against
    the twin. Returns the max abs error."""
    import torch

    from fantoch_tpu_torch.core import Config, Planet
    from fantoch_tpu_torch.engine import EngineDims, make_lane
    from fantoch_tpu_torch.engine import core as engine_core
    from fantoch_tpu_torch.engine.driver import prepare_batch
    from fantoch_tpu_torch.engine.protocols import partial_dev_protocol

    er = importlib.import_module("fantoch_tpu_torch.kernels.emit_rewrite")
    err = 0.0
    regions = Planet.new().regions()[:5]
    for name in ("tempo", "atlas"):
        proto = partial_dev_protocol(name, 5, 4, keys_per_cmd=2, pool_size=4)
        dims = EngineDims.for_partial(proto, 5, 5, 10)
        kw = dict(tempo_detached_send_interval_ms=100) if name == "tempo" \
            else {}
        specs = [
            make_lane(proto, Planet.new(),
                      Config(n=5, f=f, shard_count=4, gc_interval_ms=100,
                             executor_executed_notification_interval_ms=100,
                             executor_cleanup_interval_ms=100, **kw),
                      conflict_rate=100, pool_size=4, commands_per_client=2,
                      clients_per_region=1, process_regions=regions,
                      client_regions=regions, dims=dims, seed=f)
            for f in (1, 2)
        ]
        state, ctx = prepare_batch(proto, dims, specs, "cpu")
        box = {}

        def record(*a):
            box["args"] = a
            return er.emit_rewrite_plain(*a)

        record.launches = 0
        with _Patched(emit_rewrite=record):
            for _ in range(40):
                state, _running = engine_core.frozen_step(
                    proto, dims, state, ctx, 1 << 22)
        a = box["args"]
        args = (*(to_torch_tree(x, dev) for x in a[:10]), *a[10:])
        got = er.emit_rewrite(*args)
        want = er.emit_rewrite_plain(*args)
        torch.cuda.synchronize()
        err = max(err, _compare(got, want))
        E = got[0].shape[1]
        print(f"kernel emit_rewrite ({name} partial, 4 shards of n = 5): "
              f"exact=True at E={E} rows a lane, {int(got[1].sum())} rows "
              f"landing, {er.smem_bytes(dims.N, dims.F, dims.C)} bytes of "
              f"shared memory a block; max_abs_err={err}")
    return err


def to_torch_tree(x, dev):
    """A tree of CPU tensors moved to ``dev`` (ints pass through)."""
    if isinstance(x, dict):
        return {k: to_torch_tree(v, dev) for k, v in x.items()}
    return x.to(dev) if hasattr(x, "to") else x


def golden_faults(dev) -> None:
    """Phase 6: the faults golden batches (tests/test_torch_faults.py:
    the Tempo fault batch and the Tempo reorder batch) against their
    fixture."""
    from fantoch_tpu_torch.engine import run_lanes
    from fantoch_tpu_torch.engine.dims import ERR_UNAVAIL

    results = []
    for batch in (_tempo_lanes(FAULT_PLANS, 15),
                  _tempo_lanes([None] * len(REORDER_SEEDS), 20,
                               seeds=REORDER_SEEDS, reorder=True,
                               extra=30_000)):
        results += run_lanes(*batch, device=dev)
    unavail = results[len(FAULT_PLANS) - 1]
    assert unavail.err & ERR_UNAVAIL and unavail.steps <= 2
    for res in results[:4] + results[4:6] + results[len(FAULT_PLANS):]:
        assert res.err == 0, res.err_cause
    print(f"golden faults on {dev}: "
          + "; ".join(f"{r.faults or 'reorder'}: steps {r.steps} completed "
                      f"{r.completed} dropped {r.dropped} err {r.err}"
                      for r in results))
    _match_fixture(results, "torch_faults_golden.json")


def golden_basic(dev) -> None:
    """Phase 4: the reference's golden Basic numbers and fixture bytes."""
    from fantoch_tpu_torch.core import Config, Planet
    from fantoch_tpu_torch.engine import EngineDims, make_lane, run_lanes
    from fantoch_tpu_torch.engine.protocols import BasicDev

    gdims = EngineDims.for_protocol(
        BasicDev, n=3, clients=2, payload=3, total_commands=200,
        dot_slots=201, regions=2,
    )
    gspecs = [
        make_lane(BasicDev, Planet.new(), Config(n=3, f=f, gc_interval_ms=100),
                  conflict_rate=cf, pool_size=1, commands_per_client=100,
                  clients_per_region=1,
                  process_regions=["asia-east1", "us-central1", "us-west1"],
                  client_regions=["us-west1", "us-west2"], dims=gdims,
                  extra_time_ms=1000, seed=i)
        for i, (f, cf) in enumerate(GOLDEN_POINTS)
    ]
    golden = run_lanes(BasicDev, gdims, gspecs, device=dev)
    expected = {0: (0.0, 24.0), 1: (34.0, 58.0), 2: (118.0, 142.0)}
    for (f, cf), res in zip(GOLDEN_POINTS, golden):
        assert res.err == 0, res.err_cause
        assert list(res.protocol_metrics["stable"]) == [200, 200, 200]
        if cf == 100:
            got = (res.latency_mean("us-west1"), res.latency_mean("us-west2"))
            assert got == expected[f], (f, got)
    print("golden basic n=3 on cuda: means (us-west1, us-west2) "
          + ", ".join(f"f={f} {expected[f]}" for f in (0, 1, 2))
          + "; stable [200, 200, 200] at every f")
    _match_fixture(golden, "torch_basic_golden.json")


def golden_fpaxos(dev) -> None:
    """Phase 5: the FPaxos golden batch (the three configurations of
    tests/test_engine_fpaxos.py in one batch) against its fixture."""
    from fantoch_tpu_torch.core import Config, Planet
    from fantoch_tpu_torch.engine import EngineDims, make_lane, run_lanes
    from fantoch_tpu_torch.engine.protocols import FPaxosDev

    gdims = EngineDims.for_protocol(
        FPaxosDev, n=3, clients=2, payload=3, total_commands=100,
        dot_slots=101, regions=2,
    )
    gspecs = [
        make_lane(FPaxosDev, Planet.new(),
                  Config(n=3, f=f, leader=leader, gc_interval_ms=100),
                  conflict_rate=100, pool_size=1, commands_per_client=50,
                  clients_per_region=1,
                  process_regions=["asia-east1", "us-central1", "us-west1"],
                  client_regions=["us-west1", "us-west2"], dims=gdims,
                  extra_time_ms=1000, seed=i)
        for i, (f, leader) in enumerate(FPAXOS_POINTS)
    ]
    golden = run_lanes(FPaxosDev, gdims, gspecs, device=dev)
    for (f, leader), res in zip(FPAXOS_POINTS, golden):
        assert res.err == 0, res.err_cause
        assert int(res.lat_count.sum()) == 100
        means = (res.latency_mean("us-west1"), res.latency_mean("us-west2"))
        print(f"golden fpaxos n=3 on cuda: f={f} leader={leader} means "
              f"(us-west1, us-west2) {means} stable "
              f"{res.protocol_metrics['stable'].tolist()}")
    _match_fixture(golden, "torch_fpaxos_golden.json")


def golden_tempo(dev) -> None:
    """Phase 6: the Tempo golden batches (the configurations of
    tests/test_engine_tempo.py, a clock-bump lane and a skip-capable
    batch) against their fixture."""
    from fantoch_tpu_torch.core import Config, Planet
    from fantoch_tpu_torch.engine import EngineDims, make_lane, run_lanes
    from fantoch_tpu_torch.engine.protocols import TempoDev

    planet = Planet.new()
    regions = planet.regions()
    results = []
    for points, skip_capable in ((TEMPO_MAIN, False), (TEMPO_SKIP, True)):
        clients = max(n * cpr for n, _f, _c, _k, cpr, _x in points)
        total = max(k * n * cpr for n, _f, _c, k, cpr, _x in points)
        n_max = max(pt[0] for pt in points)
        proto = TempoDev(keys=1 + clients, skip_capable=skip_capable)
        dims = EngineDims.for_protocol(
            proto, n=n_max, clients=clients,
            payload=proto.payload_width(n_max), total_commands=total,
            dot_slots=total + 1, regions=n_max,
        )
        specs = [
            make_lane(
                proto, planet,
                Config(n=n, f=f, gc_interval_ms=100,
                       tempo_detached_send_interval_ms=100,
                       tempo_clock_bump_interval_ms=(
                           None if skip_capable else x),
                       skip_fast_ack=bool(skip_capable and x)),
                conflict_rate=conflict, pool_size=1,
                commands_per_client=commands, clients_per_region=cpr,
                process_regions=regions[:n], client_regions=regions[:n],
                dims=dims, seed=i,
            )
            for i, (n, f, conflict, commands, cpr, x) in enumerate(points)
        ]
        batch = run_lanes(proto, dims, specs, device=dev)
        for (n, f, _c, commands, cpr, x), res in zip(points, batch):
            assert res.err == 0, res.err_cause
            assert res.completed == commands * cpr * n
            m = {k: int(v.sum()) for k, v in res.protocol_metrics.items()}
            print(f"golden tempo on {dev}: n={n} f={f} commands={commands} "
                  f"x{cpr} {'skip' if skip_capable else 'bump'}={x} "
                  f"steps {res.steps} metrics {m}")
        results += batch
    _match_fixture(results, "torch_tempo_golden.json")


def golden_graphdep(dev) -> None:
    """Phase 6: the Atlas and EPaxos golden batches (the configurations
    of tests/test_engine_graphdep.py, one batch per protocol) against
    their fixture."""
    from fantoch_tpu_torch.core import Config, Planet
    from fantoch_tpu_torch.engine import EngineDims, make_lane, run_lanes
    from fantoch_tpu_torch.engine.protocols import AtlasDev, EPaxosDev

    planet = Planet.new()
    regions = planet.regions()
    points = GRAPHDEP_POINTS
    clients = max(n * cpr for n, _f, _c, _k, cpr in points)
    total = max(k * n * cpr for n, _f, _c, k, cpr in points)
    n_max = max(pt[0] for pt in points)
    results = []
    for cls in (AtlasDev, EPaxosDev):
        proto = cls(keys=1 + clients)
        dims = EngineDims.for_protocol(
            proto, n=n_max, clients=clients,
            payload=proto.payload_width(n_max), total_commands=total,
            dot_slots=total + 1, regions=n_max,
        )
        specs = [
            make_lane(proto, planet, Config(n=n, f=f, gc_interval_ms=100),
                      conflict_rate=conflict, pool_size=1,
                      commands_per_client=commands, clients_per_region=cpr,
                      process_regions=regions[:n],
                      client_regions=regions[:n], dims=dims, seed=i)
            for i, (n, f, conflict, commands, cpr) in enumerate(points)
        ]
        batch = run_lanes(proto, dims, specs, device=dev)
        for (n, f, _c, commands, cpr), res in zip(points, batch):
            assert res.err == 0, res.err_cause
            done = commands * cpr * n
            m = {k: int(v.sum()) for k, v in res.protocol_metrics.items()}
            assert m["fast_path"] + m["slow_path"] == done, m
            assert m["stable"] == n * done, m
            print(f"golden {cls.__name__} on {dev}: n={n} f={f} "
                  f"commands={commands} x{cpr} steps {res.steps} "
                  f"metrics {m}")
        results += batch
    _match_fixture(results, "torch_graphdep_golden.json")


def golden_caesar(dev) -> None:
    """Phase 6: the Caesar golden batch (the five configurations of
    tests/test_engine_caesar.py that are not slow, wait condition on and
    off, in one batch) against its fixture."""
    from fantoch_tpu_torch.core import Config, Planet
    from fantoch_tpu_torch.engine import EngineDims, make_lane, run_lanes
    from fantoch_tpu_torch.engine.protocols import CaesarDev

    planet = Planet.new()
    regions = planet.regions()
    points = CAESAR_POINTS
    clients = max(n * cpr for n, _f, _w, _c, _k, cpr in points)
    total = max(k * n * cpr for n, _f, _w, _c, k, cpr in points)
    n_max = max(pt[0] for pt in points)
    proto = CaesarDev.for_load(keys=1 + clients, clients=clients)
    dims = EngineDims.for_protocol(
        proto, n=n_max, clients=clients,
        payload=proto.payload_width(n_max), total_commands=total,
        dot_slots=total + 1, regions=n_max,
    )
    specs = [
        make_lane(proto, planet,
                  Config(n=n, f=f, gc_interval_ms=100,
                         caesar_wait_condition=wait),
                  conflict_rate=conflict, pool_size=1,
                  commands_per_client=commands, clients_per_region=cpr,
                  process_regions=regions[:n], client_regions=regions[:n],
                  dims=dims, seed=i)
        for i, (n, f, wait, conflict, commands, cpr) in enumerate(points)
    ]
    results = run_lanes(proto, dims, specs, device=dev)
    for (n, f, wait, _c, commands, cpr), res in zip(points, results):
        assert res.err == 0, res.err_cause
        done = commands * cpr * n
        m = {k: int(v.sum()) for k, v in res.protocol_metrics.items()}
        assert m["fast_path"] + m["slow_path"] == done, m
        assert m["stable"] == n * done, m
        print(f"golden caesar on {dev}: n={n} f={f} wait={wait} "
              f"commands={commands} x{cpr} steps {res.steps} metrics {m}")
    _match_fixture(results, "torch_caesar_golden.json")


def golden_tempo_partial(dev) -> None:
    """Phase 6: the partial-replication golden batches (the two
    configurations of tests/test_engine_partial.py that are not slow, one
    batch each) against their fixture."""
    from fantoch_tpu_torch.core import Config, Planet
    from fantoch_tpu_torch.engine import EngineDims, make_lane, run_lanes
    from fantoch_tpu_torch.engine.protocols import TempoPartialDev

    planet = Planet.new()
    results = []
    for n, f, shards, conflict, pool, kpc in TEMPO_PARTIAL_POINTS:
        regions = planet.regions()[:n]
        proto = TempoPartialDev(keys=pool + n + 1, shards=shards,
                                keys_per_cmd=kpc)
        dims = EngineDims.for_partial(proto, n, n, 10 * n, regions=n)
        config = Config(n=n, f=f, shard_count=shards, gc_interval_ms=100,
                        executor_executed_notification_interval_ms=100,
                        executor_cleanup_interval_ms=100,
                        tempo_detached_send_interval_ms=100)
        spec = make_lane(proto, planet, config, conflict_rate=conflict,
                         pool_size=pool, commands_per_client=10,
                         clients_per_region=1, process_regions=regions,
                         client_regions=regions, dims=dims)
        (res,) = run_lanes(proto, dims, [spec], device=dev)
        assert res.err == 0, res.err_cause
        assert res.completed == 10 * n
        m = {k: int(v.sum()) for k, v in res.protocol_metrics.items()}
        assert 10 * n <= m["fast_path"] + m["slow_path"] <= 10 * n * shards
        assert m["stable"] == n * 10 * n, m
        print(f"golden tempo partial on {dev}: n={n} f={f} shards={shards} "
              f"conflict={conflict} pool={pool} keys per command={kpc} "
              f"steps {res.steps} metrics {m}")
        results.append(res)
    _match_fixture(results, "torch_tempo_partial_golden.json")


def golden_atlas_partial(dev) -> None:
    """Phase 6: the Atlas partial golden batch (the configuration of
    tests/test_engine_partial.py's Atlas test that is not slow and one at
    conflict 10, in one batch) against its fixture."""
    from fantoch_tpu_torch.core import Config, Planet
    from fantoch_tpu_torch.engine import EngineDims, make_lane, run_lanes
    from fantoch_tpu_torch.engine.protocols import AtlasPartialDev

    planet = Planet.new()
    n, _f, shards, _c, pool, kpc = ATLAS_PARTIAL_POINTS[0]
    regions = planet.regions()[:n]
    proto = AtlasPartialDev(keys=pool + n + 1, shards=shards,
                            keys_per_cmd=kpc)
    dims = EngineDims.for_partial(proto, n, n, 10 * n, regions=n)
    specs = [
        make_lane(proto, planet,
                  Config(n=n, f=f, shard_count=shards, gc_interval_ms=100,
                         executor_executed_notification_interval_ms=100,
                         executor_cleanup_interval_ms=100),
                  conflict_rate=conflict, pool_size=pool,
                  commands_per_client=10, clients_per_region=1,
                  process_regions=regions, client_regions=regions, dims=dims)
        for n, f, shards, conflict, pool, kpc in ATLAS_PARTIAL_POINTS
    ]
    results = run_lanes(proto, dims, specs, device=dev)
    for (n, f, shards, conflict, pool, kpc), res in zip(ATLAS_PARTIAL_POINTS,
                                                        results):
        assert res.err == 0, res.err_cause
        assert res.completed == 10 * n
        m = {k: int(v.sum()) for k, v in res.protocol_metrics.items()}
        assert 10 * n <= m["fast_path"] + m["slow_path"] <= 10 * n * shards
        assert m["stable"] == n * 10 * n, m
        print(f"golden atlas partial on {dev}: n={n} f={f} shards={shards} "
              f"conflict={conflict} pool={pool} keys per command={kpc} "
              f"steps {res.steps} metrics {m}")
    _match_fixture(results, "torch_atlas_partial_golden.json")


def _match_fixture(results, name) -> None:
    text = json.dumps([r.to_json() for r in results], sort_keys=True) + "\n"
    path = FIXTURES / name
    assert text == path.read_text(), f"to_json differs from {name}"
    print(f"fixture {path.relative_to(ROOT)}: byte-identical "
          f"({len(text)} bytes)")


def sweep(name, dev):
    """Phase 7: one main path's sweep, counted; sampled
    lanes against the plain twins on the host. Returns its launches."""
    import torch

    from fantoch_tpu_torch import cli, kernels
    from fantoch_tpu_torch.parallel import run_sweep

    args = cli.parse_args(cli.MAIN_PATHS[name])
    protocol, dims, specs = cli.sweep_setup(args)
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = run_sweep(protocol, dims, specs,
                        batch_lanes=args.batch_lanes, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.counts()
    errors = sum(1 for r in results if r.err)
    steps = [r.steps for r in results]
    total = args.commands * dims.C
    steps_run = launches["qualify_pop"]
    stable = sorted({int(r.protocol_metrics["stable"].sum())
                     for r in results})
    print(f"sweep {name} n=5 (N={dims.N} M={dims.M} D={dims.D}): "
          f"{len(results)} points "
          f"in {wall:.3f} s = {len(results) / wall:.3f} points/s; errors "
          f"{errors} {sorted({r.err_cause for r in results if r.err})}; "
          f"steps per lane max {max(steps)} mean {sum(steps) / len(steps):.1f}"
          f"; batch steps {steps_run}; pool_peak max "
          f"{max(r.pool_peak for r in results)}; requeues "
          f"{sum(r.requeues for r in results)}; stable totals {stable}; "
          f"launches {launches}; launches per batch step "
          f"{ {k: v / steps_run for k, v in launches.items()} }")
    path_kernels = ["qualify_pop", HANDLERS[name], "emit_rewrite",
                    "land_emissions", "lane_freeze", "key_table"]
    assert all(launches[k] > 0 for k in path_kernels), launches
    other = set(HANDLERS.values()) - {HANDLERS[name]}
    assert all(launches[k] == 0 for k in other), launches
    if name == "tempo":
        TEMPO_LINES.extend(json.dumps(r.to_json(), sort_keys=True)
                           for r in results)
    if name == "tempo_faults":
        fault_sweep_checks(specs, results, total, wall, launches)
    else:
        grid = args.subsets * len(args.fs) * len(args.conflicts)
        assert len(results) == grid and grid in (512, 2048) and errors == 0
        main_path_checks(name, dims, specs, results, total)
    t0 = time.perf_counter()
    sample = SAMPLE[name]
    host, secs = HOST.result(("sweep", name))
    for i, line in zip(sample, host):
        assert line == json.dumps(results[i].to_json(), sort_keys=True), (
            f"{name} lane {i} differs from the host run")
    print(f"{name} lanes {sample}: card == host plain twins, byte for byte "
          f"({secs:.1f} s on the host, waited {time.perf_counter() - t0:.1f} "
          f"s)")
    return launches


def fault_sweep_checks(specs, results, total, wall, launches) -> None:
    """The fault path's checks: per plan its lanes, error causes,
    completed commands and lost messages; its fault-free lanes equal the
    Tempo sweep's first 512 lanes byte for byte; the fault-free and crash
    lanes end clean with every surviving client's budget done (the
    contract of test_engine_faults.py test_crash_liveness)."""
    from fantoch_tpu_torch import cli
    from fantoch_tpu_torch.engine.faults import parse_fault_specs

    plans = parse_fault_specs(cli.TEMPO_FAULT_PLANS)
    k = len(plans)
    assert len(results) == 2048 == 512 * k
    for j, plan in enumerate(plans):
        lanes = results[j::k]
        causes = sorted({r.err_cause for r in lanes if r.err})
        print(f"tempo_faults plan {j} {plan.meta() if plan else {}}: "
              f"{len(lanes)} lanes, erring {sum(1 for r in lanes if r.err)} "
              f"{causes}, completed {sum(r.completed for r in lanes)}, "
              f"dropped {sum(r.dropped for r in lanes)}, steps max "
              f"{max(r.steps for r in lanes)}")
    print(f"tempo_faults: {len(results) / wall:.3f} points/s over the four "
          f"plans, batch steps {launches['qualify_pop']}")
    clean = [json.dumps(r.to_json(), sort_keys=True) for r in results[::k]]
    assert len(TEMPO_LINES) == 2048 and clean == TEMPO_LINES[:512], (
        "fault-free lanes differ from the Tempo sweep's")
    for spec, r in zip(specs, results):
        if spec.fault_meta is None or "crash" in spec.fault_meta:
            # halted clients' budgets are zeroed: the survivors' remain
            survivors = int(spec.ctx["cmd_budget"].sum())
            assert r.err == 0, r.err_cause
            assert r.completed == survivors < total or (
                spec.fault_meta is None and r.completed == total)
    print("tempo_faults: the 512 fault-free lanes equal the Tempo sweep's "
          "byte for byte; every fault-free and crash lane clean with its "
          "surviving clients' budgets done")


def main_path_checks(name, dims, specs, results, total) -> None:
    """A fault-free main path's checks on every lane."""
    for spec, r in zip(specs, results):
        assert r.completed == total
        assert int(r.lat_count.sum()) == total
        if name == "basic":
            assert r.requeues == 0
            assert list(r.protocol_metrics["stable"]) == [total] * dims.N
        if name in ("tempo", "atlas", "epaxos", "caesar"):
            # every command committed once, on the fast or the slow path;
            # every process GCs every command; with f = 1, Tempo's and
            # Atlas's fast path always holds (test_engine_tempo.py,
            # test_engine_graphdep.py, test_engine_caesar.py)
            m = {k: int(v.sum()) for k, v in r.protocol_metrics.items()}
            assert m["fast_path"] + m["slow_path"] == total, m
            assert m["stable"] == dims.N * total, m
            if spec.config.f == 1 and name in ("tempo", "atlas"):
                assert m["slow_path"] == 0, m
        if name in ("tempo_partial", "atlas_partial"):
            # a command commits once per shard it touches; the n rows of
            # its dot owner's shard GC it (test_engine_partial.py)
            m = {k: int(v.sum()) for k, v in r.protocol_metrics.items()}
            shards = spec.config.shard_count
            assert total <= m["fast_path"] + m["slow_path"] <= total * shards
            assert m["stable"] == spec.config.n * total, m
    if name in ("tempo", "atlas", "epaxos", "caesar"):
        slow = sum(int(r.protocol_metrics["slow_path"].sum())
                   for r in results)
        print(f"{name}: fast + slow == {total} and stable == "
              f"{dims.N * total} on every lane; slow-path commits {slow}")
    if name in ("tempo_partial", "atlas_partial"):
        commits = sorted({int(r.protocol_metrics["fast_path"].sum()
                              + r.protocol_metrics["slow_path"].sum())
                          for r in results})
        slow = sum(int(r.protocol_metrics["slow_path"].sum())
                   for r in results)
        print(f"{name}: {total} <= fast + slow <= {2 * total} (from "
              f"{commits[0]} to {commits[-1]}) and stable == 5 x {total} on "
              f"every lane; slow-path commits {slow}")


# ----------------------------------------------------------------------
# the safety monitors and the schedule-fuzz fan-out (mc)
# ----------------------------------------------------------------------

# the injected-bug point of tests/test_mc_fuzz.py:291-301 (jitter only)
BUG_POINT = dict(protocol="tempo", n=3, f=1, schedules=8,
                 commands_per_client=5, seed=3, inject_bug=True,
                 crash_share=0.0, drop_share=0.0)
# the monitor-coverage batches: per protocol a small point of jitter and
# crash lanes plus a jitter lane whose drain tail is 1 ms (its executors
# undrained at the end: missing-execution on Basic, Tempo, Atlas, EPaxos
# and Caesar). No drop lanes: a lost message can stall a lane in requeues
# up to its horizon, thousands of steps of the twins; the mc grid's drop
# and horizon lanes go through K13's check
MON_COVERAGE = dict(n=3, f=1, schedules=4, commands_per_client=3, seed=1,
                    crash_share=0.5, drop_share=0.0)
MON_PROTOCOLS = ("basic", "fpaxos", "tempo", "atlas", "epaxos", "caesar")
# every K13 launch of a monitored phase, held against its twin
K13_CHECKED = {"launches": 0, "err": 0.0}


def _k13_stand_in():
    """K13 in ``engine.core`` with its twin compared on every launch: the
    final state of every monitored batch (crash and horizon lanes
    included)."""
    def cmp(a, got, want):
        K13_CHECKED["err"] = max(K13_CHECKED["err"], _compare(got, want))
        K13_CHECKED["launches"] += 1

    return _checked("mon_finalize", "mon_finalize", cmp)


class _PatchedHandler:
    """Swaps a handler kernel's module name for a stand-in while open
    (the protocols import their kernel from its module at each call)."""

    def __init__(self, kname, stand_in):
        self.mod = importlib.import_module(
            f"fantoch_tpu_torch.kernels.{kname}")
        self.kname, self.new = kname, stand_in

    def __enter__(self):
        self.old = getattr(self.mod, self.kname)
        setattr(self.mod, self.kname, self.new)

    def __exit__(self, *exc):
        setattr(self.mod, self.kname, self.old)


def _mon_json(r, drop_monitor=False):
    d = r.to_json()
    if drop_monitor:
        for k in ("violation", "violation_step", "coverage"):
            d.pop(k)
    return json.dumps(d, sort_keys=True)


# the mc grid's sampled lanes of each point, and the batch steps between
# the snapshots of them that the host replays from: a lossy lane may step
# over 100,000 times to its horizon, some 8 ms a step on the host, so each
# segment goes to a worker of its own
MC_SAMPLE = (0, 1, 2, 3, -1)
SEGMENT = 4096


def _lane(tree, i):
    """Lane ``i`` of a state tree on the card, as numpy with a lane axis
    of 1."""
    if isinstance(tree, dict):
        return {k: _lane(v, i) for k, v in tree.items()}
    return tree[i:i + 1].cpu().numpy()


def _tree_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k])
                                            for k in a)
    import numpy as np

    return a.dtype == b.dtype and np.array_equal(a, b)


class _McTaps:
    """The mc grid's sampled lanes, tapped from the card's own run (its
    ``frozen_step`` and K13 calls): each lane's state every
    :data:`SEGMENT` batch steps and when its batch ends. Each segment in
    which a lane changed goes to the host pool, which replays it from the
    card's snapshot with the plain twins; :meth:`check` holds every
    replayed segment's end to the card's next snapshot and the last
    one's ``to_json`` to the card's result, byte for byte. Segments
    where the lane stayed as it was (a finished lane: a running lane
    counts its steps) need no replay."""

    def __init__(self, specs):
        from dataclasses import asdict

        from fantoch_tpu_torch.mc.fuzz import (
            draw_plans, point_config, point_protocol,
        )

        self.points = []
        for spec in specs:
            plans = draw_plans(spec, point_config(spec),
                               point_protocol(spec))
            lanes = [i % spec.schedules for i in MC_SAMPLE]
            self.points.append((asdict(spec), lanes,
                                [plans[i] for i in lanes]))
        self.point, self.steps, self.flags = 0, 0, None
        self.snaps = {}     # (point, lane) -> last (steps, state)
        self.pending = []   # (point, lane, future key, want state, last)
        self.host_s = 0.0

    def _snap(self, st, last):
        spec_kw, lanes, plans = self.points[self.point]
        for lane, plan in zip(lanes, plans):
            state = _lane(st, lane)
            prev = self.snaps.get((self.point, lane))
            self.snaps[(self.point, lane)] = (self.steps, state)
            if prev is None:
                continue
            steps0, state0 = prev
            if not last and _tree_equal(state0, state):
                continue  # a finished lane: nothing to replay
            key = ("mc", self.point, lane, steps0)
            HOST.submit(key, _host_segment, spec_kw, plan, state0,
                        self.steps - steps0, self.flags, last)
            self.pending.append((self.point, lane, key, state, last))

    def frozen_step(self, orig):
        def run(protocol, dims, st, ctx, max_steps, reorder=False,
                faults=None, monitor_keys=0):
            self.flags = (reorder, tuple(faults), monitor_keys)
            if self.steps % SEGMENT == 0:
                self._snap(st, False)
            self.steps += 1
            return orig(protocol, dims, st, ctx, max_steps, reorder, faults,
                        monitor_keys)
        return run

    def finalize(self, stand_in):
        def run(st, ctx, flags, order):
            self._snap(st, True)
            self.point, self.steps = self.point + 1, 0
            return stand_in(st, ctx, flags, order)
        return run

    def check(self, points) -> int:
        """Wait for every replayed segment and hold it to the card;
        returns the number of segments."""
        for point, lane, key, want, last in self.pending:
            got, line, secs = HOST.result(key)
            self.host_s += secs
            assert _tree_equal(got, want), (
                f"mc point {point} lane {lane}: the host twins' segment "
                f"{key[3]}+ differs from the card's state")
            if last:
                card = json.dumps(points[point].lane_results[lane].to_json(),
                                  sort_keys=True)
                assert line == card, (
                    f"mc point {point} lane {lane}: to_json differs from "
                    f"the host run")
        return len(self.pending)


def check_monitored_kernels(dev, rows) -> None:
    """Phase 3 for the monitored paths: the first batch of the mc grid's
    n = 5 points, stepped 300 times with the monitors on, then one
    step's handler and K6 arguments (the monitor branches on) held
    against their twins and timed, and K13 on that state. K13's row goes
    to ``rows``; the handlers' and K6's monitored times go beside their
    rows (``monitored``)."""
    import torch

    from fantoch_tpu_torch import cli
    from fantoch_tpu_torch.engine import core as engine_core
    from fantoch_tpu_torch.engine.driver import (
        batch_reorder_flag, prepare_batch,
    )
    from fantoch_tpu_torch.engine.faults import batch_fault_flags, flag_bits
    from fantoch_tpu_torch.kernels import cost
    from fantoch_tpu_torch.mc.fuzz import point_lanes

    args = cli.parse_args(cli.MAIN_PATH_MC)
    for spec in cli.mc_specs(args):
        if spec.n != 5:
            continue
        proto, dims, specs, _plans, mk = point_lanes(spec)
        batch = specs[:512]
        flags = (batch_reorder_flag(batch), batch_fault_flags(batch))
        state, ctx = prepare_batch(proto, dims, batch, dev, mk)
        for _ in range(300):
            state, _r = engine_core.frozen_step(proto, dims, state, ctx,
                                                1 << 22, *flags, mk)
        handler = HANDLERS[spec.protocol]
        captured = {}
        er = importlib.import_module("fantoch_tpu_torch.kernels.emit_rewrite")
        hm = importlib.import_module(f"fantoch_tpu_torch.kernels.{handler}")

        def rec(mod, kname):
            kern = getattr(mod, kname)

            def wrapped(*a):
                captured[kname] = a
                return kern(*a)
            wrapped.launches = 0
            return wrapped

        with _Patched(emit_rewrite=rec(er, "emit_rewrite")), \
                _PatchedHandler(handler, rec(hm, handler)):
            state, _r = engine_core.frozen_step(proto, dims, state, ctx,
                                                1 << 22, *flags, mk)
        fb = flag_bits(flags[1], flags[0])
        k13 = importlib.import_module("fantoch_tpu_torch.kernels.mon_finalize")
        captured["mon_finalize"] = (state, ctx, fb,
                                    getattr(proto, "MONITOR_ORDER", True))
        for kname, mod in ((handler, hm), ("emit_rewrite", er),
                           ("mon_finalize", k13)):
            a = captured[kname]
            kern, plain = getattr(mod, kname), getattr(mod, kname + "_plain")
            got, want = kern(*a), plain(*a)
            if kname == handler:
                got, want = _handler_view(got), _handler_view(want)
            torch.cuda.synchronize()
            err = _compare(got, want)
            ms = _device_ms(lambda a=a: kern(*a), kname, 50)
            call_ms = _time_ms(lambda a=a: kern(*a), 50)
            plain_ms = _time_ms(lambda a=a: plain(*a), 5)
            n_bytes, n_ops = mod.work(*a, kern(*a))
            bound_ms, bound_by = cost.bound(n_bytes, n_ops)
            label = f"mc {spec.protocol} n={spec.n}"
            print(f"kernel {kname} ({label}, monitored, {mk} keys): "
                  f"exact=True max_abs_err={err} ms={ms:.5f} "
                  f"call_ms={call_ms:.5f} plain_ms={plain_ms:.5f} "
                  f"bound_us={1e3 * bound_ms:.3f} ({bound_by}: {n_bytes} "
                  f"bytes, {n_ops} ops) L={len(batch)} N={dims.N}")
            row = dict(path="mc", max_abs_err=err, ms=ms, call_ms=call_ms,
                       plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=None)
            if kname == "mon_finalize":
                if spec.protocol == "tempo":
                    rows[kname] = row
            else:
                rows[kname].setdefault("monitored", {})[label] = row


def mc_grid(dev):
    """Phase 8, this slice's main path: the mc default grid (the
    reference CLI's defaults: Tempo, FPaxos and Atlas x n in {3, 5}, 512
    schedules a point, 3,072 lanes, seed 0) through ``run_fuzz_point``,
    the function ``mc --no-confirm`` runs, with every launch counter at 0
    just before and read just after; K13 against its twin on every
    batch's final state. Lanes 0-3 and the last lane of each point
    against the host twins. Returns the launches."""
    import torch

    from fantoch_tpu_torch import cli, kernels
    from fantoch_tpu_torch.mc.fuzz import run_fuzz_point

    from fantoch_tpu_torch.engine import core as engine_core

    args = cli.parse_args(cli.MAIN_PATH_MC)
    specs = cli.mc_specs(args)
    assert len(specs) == 6 and args.schedules == 512
    taps = _McTaps(specs)
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _Patched(mon_finalize=taps.finalize(_k13_stand_in()),
                  frozen_step=taps.frozen_step(engine_core.frozen_step)):
        points = [run_fuzz_point(spec, confirm=False, device=dev)
                  for spec in specs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.counts()
    total = sum(p.schedules for p in points)
    for p in points:
        res = p.lane_results
        print(f"mc {p.spec.protocol} n={p.spec.n}: {p.schedules} schedules "
              f"in {p.elapsed_s:.3f} s = {p.schedules_per_sec:.3f} "
              f"schedules/s; flagged {p.flagged} "
              f"{sorted({f.violation_cause for f in p.findings})}; engine "
              f"errors {p.engine_errors}; steps max "
              f"{max(r.steps for r in res)}; distinct digests "
              f"{len(set(p.digests))}")
    print(f"mc grid: {total} schedules in {wall:.3f} s = {total / wall:.3f} "
          f"schedules/s; flagged {sum(p.flagged for p in points)}; batch "
          f"steps {launches['qualify_pop']}; launches {launches}")
    assert total == 3072
    for k in ("qualify_pop", "tempo_handle", "fpaxos_handle",
              "graphdep_handle", "emit_rewrite", "land_emissions",
              "lane_freeze", "key_table"):
        assert launches[k] > 0, launches
    assert launches["mon_finalize"] == len(points), launches
    for k in ("basic_handle", "caesar_handle", "tempo_partial_handle",
              "atlas_partial_handle"):
        assert launches[k] == 0, launches
    assert all(all(r.coverage != 0 for r in p.lane_results) for p in points)
    t0 = time.perf_counter()
    segments = taps.check(points)
    steps = {(p.spec.protocol, p.spec.n): [
        p.lane_results[i % p.schedules].steps for i in MC_SAMPLE]
        for p in points}
    print(f"mc grid lanes 0-3 and the last of each point (steps {steps}): "
          f"card == host plain twins, every {SEGMENT}-step segment replayed "
          f"from the card's snapshot ({segments} segments) and to_json with "
          f"the monitor fields byte for byte ({taps.host_s:.1f} s on the "
          f"host, waited {time.perf_counter() - t0:.1f} s)")
    return launches


def bench_point(dev) -> None:
    """The reference bench's fuzz self-check point (bench.py
    _fuzz_selfcheck): correct Tempo, n = 5, 256 schedules of 10 commands
    a client, seed 0xF022, mixed plans. Nothing flagged, no engine error
    but requeue-livelock."""
    import torch

    from fantoch_tpu_torch import cli
    from fantoch_tpu_torch.mc.fuzz import FuzzSpec, run_fuzz_point

    spec = FuzzSpec(**cli.BENCH_FUZZ)
    with _Patched(mon_finalize=_k13_stand_in()):
        res = run_fuzz_point(spec, confirm=False, device=dev)
    torch.cuda.synchronize()
    bad = {k: v for k, v in res.engine_errors.items()
           if k != "requeue-livelock"}
    print(f"bench fuzz point (tempo n=5, 256 schedules, seed 0xF022): "
          f"{res.schedules_per_sec:.3f} schedules/s ({res.elapsed_s:.3f} s); "
          f"flagged {res.flagged}; engine errors {res.engine_errors}; steps "
          f"max {max(r.steps for r in res.lane_results)}")
    assert res.flagged == 0, res.summary()
    assert not bad, res.engine_errors


def _checked_handler(kname, seen, errs):
    """A stand-in for handler kernel ``kname``: kernel and twin on every
    call, held equal; ``seen`` counts the executions the monitors
    recorded and the guard bits raised."""
    import torch

    mod = importlib.import_module(f"fantoch_tpu_torch.kernels.{kname}")
    kern, plain = getattr(mod, kname), getattr(mod, kname + "_plain")

    def run(*a):
        want = plain(*a)
        got = kern(*a)
        torch.cuda.synchronize()
        errs[kname] = max(errs.get(kname, 0.0),
                          _compare(_handler_view(got), _handler_view(want)))
        ps, new = a[0], want[1]
        seen["executions"] += int((new["_mon_cnt"] - ps["_mon_cnt"]).sum())
        seen["premature guard words"] += int(
            ((new["_mon_flags"] & 1) != 0).sum())
        seen["steps"] += 1
        return got

    run.launches = 0
    return run


def _k6_checked(errs, seen):
    def cmp(a, got, want):
        errs["emit_rewrite"] = max(errs.get("emit_rewrite", 0.0),
                                   _compare(got, want))
        seen["viol words"] += int((want[2]["viol"] != 0).sum())
    return _checked("emit_rewrite", "emit_rewrite", cmp)


def _monitored_run(proto, dims, specs, mk, dev, errs, seen):
    """``run_lanes`` on the card with the monitors on and the handler
    kernel, K6 and K13 held against their twins on every call."""
    from fantoch_tpu_torch.engine import run_lanes

    kname = HANDLERS[{"TempoDev": "tempo", "TempoStabilityBugDev": "tempo",
                      "BasicDev": "basic", "FPaxosDev": "fpaxos",
                      "AtlasDev": "atlas", "EPaxosDev": "epaxos",
                      "CaesarDev": "caesar"}[
        getattr(proto, "__name__", type(proto).__name__)]]
    with _Patched(emit_rewrite=_k6_checked(errs, seen),
                  mon_finalize=_k13_stand_in()), \
            _PatchedHandler(kname, _checked_handler(kname, seen, errs)):
        return run_lanes(proto, dims, specs, device=dev, monitor_keys=mk)


def monitor_coverage(dev) -> dict:
    """The monitor branches of K4, K5, K8, K9, K10 and K6, and K13,
    against their twins on every step of small monitored batches: per
    protocol a point of jitter and crash lanes plus a lane whose drain
    tail is 1 ms (missing-execution); a Tempo batch at conflict 0
    with one monitor key (monitor-key-range); the injected-bug point
    (order-divergence), whose per-lane violations, steps and digests
    must equal the fixture made from the reference. Returns the max abs
    error by kernel."""
    from dataclasses import replace

    from fantoch_tpu_torch.engine.faults import FaultPlan
    from fantoch_tpu_torch.engine.monitor import (
        VIOL_KEYRANGE, VIOL_MISSING, VIOL_ORDER,
    )
    from fantoch_tpu_torch.mc.fuzz import FuzzSpec, point_lanes

    errs = {}
    raised = {VIOL_KEYRANGE: 0, VIOL_MISSING: 0, VIOL_ORDER: 0}
    for name in MON_PROTOCOLS:
        seen = dict.fromkeys(("executions", "premature guard words",
                              "viol words", "steps"), 0)
        spec = FuzzSpec(protocol=name, **MON_COVERAGE)
        proto, dims, specs, plans, mk = point_lanes(spec)
        short = point_lanes(replace(spec, extra_time_ms=1, schedules=1),
                            plans=[FaultPlan(jitter_max=8, jitter_seed=1)])[2]
        res = _monitored_run(proto, dims, specs + short, mk, dev, errs, seen)
        for r in res:
            for bit in raised:
                raised[bit] += bool(r.violation & bit)
        assert seen["executions"] > 0, (name, seen)
        print(f"monitor coverage {name}: kernels exact on every one of "
              f"{seen['steps']} steps; {seen} violations "
              f"{[r.violation for r in res]} steps "
              f"{[r.steps for r in res]}")
    # monitor keys below the lane's keys: conflict 0 draws private keys
    seen = dict.fromkeys(("executions", "premature guard words",
                          "viol words", "steps"), 0)
    spec = FuzzSpec(protocol="tempo", conflict=0, **MON_COVERAGE)
    proto, dims, specs, _plans, _mk = point_lanes(spec)
    res = _monitored_run(proto, dims, specs[:1], 1, dev, errs, seen)
    assert all(r.violation & VIOL_KEYRANGE for r in res), res
    raised[VIOL_KEYRANGE] += len(res)
    print(f"monitor coverage tempo (1 monitor key, conflict 0): {seen}; "
          f"violations {[r.violation for r in res]}")
    # the injected bug: order divergence, against the fixture
    seen = dict.fromkeys(("executions", "premature guard words",
                          "viol words", "steps"), 0)
    spec = FuzzSpec(**BUG_POINT)
    proto, dims, specs, _plans, mk = point_lanes(spec)
    res = _monitored_run(proto, dims, specs, mk, dev, errs, seen)
    got = {"violation": [r.violation for r in res],
           "violation_step": [r.violation_step for r in res],
           "digests": [r.coverage for r in res],
           "engine_errors": sorted({r.err_cause for r in res if r.err})}
    want = json.loads((FIXTURES / "torch_fuzz_bug_golden.json").read_text())
    assert got == want, (got, want)
    raised[VIOL_ORDER] += sum(bool(v & VIOL_ORDER) for v in got["violation"])
    assert all(raised.values()), raised
    print(f"injected-bug point (tempo n=3, 8 schedules, seed 3): equals "
          f"tests/fixtures/torch_fuzz_bug_golden.json; {seen}; lanes with "
          f"order-divergence {sum(bool(v & VIOL_ORDER) for v in got['violation'])}"
          f"; over the phase {raised} lanes raised keyrange/missing/order")
    return errs


def monitored_tempo_sweep(dev):
    """The 2,048-lane Tempo sweep with the monitors on (monitor keys =
    pool + clients), counted: its to_json equals the unmonitored sweep's
    byte for byte outside the three monitor fields, its batch steps equal
    the unmonitored sweep's, and every lane has a digest. Returns the
    launches."""
    import torch

    from fantoch_tpu_torch import cli, kernels
    from fantoch_tpu_torch.parallel import run_sweep

    args = cli.parse_args(cli.MAIN_PATHS["tempo"])
    protocol, dims, specs = cli.sweep_setup(args)
    mk = args.pool_size + args.n * args.clients_per_region
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _Patched(mon_finalize=_k13_stand_in()):
        results = run_sweep(protocol, dims, specs,
                            batch_lanes=args.batch_lanes, device=dev,
                            monitor_keys=mk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.counts()
    lines = [_mon_json(r, drop_monitor=True) for r in results]
    plain = [json.dumps({k: v for k, v in json.loads(line).items()
                         if k not in ("violation", "violation_step",
                                      "coverage")}, sort_keys=True)
             for line in TEMPO_LINES]
    assert len(lines) == 2048 and lines == plain, (
        "the monitored Tempo sweep differs from the unmonitored one")
    assert all(r.coverage != 0 for r in results)
    print(f"sweep tempo monitored ({mk} keys): {len(results)} points in "
          f"{wall:.3f} s = {len(results) / wall:.3f} points/s; batch steps "
          f"{launches['qualify_pop']}; violations "
          f"{sum(1 for r in results if r.violation)}; distinct digests "
          f"{len({r.coverage for r in results})}; launches {launches}; "
          f"equal to the unmonitored sweep outside the monitor fields")
    assert launches["mon_finalize"] == 4, launches
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import fantoch_tpu_torch  # noqa: F401  (alone in a directory: fails)

    dev = torch.device("cuda")
    card = _nvidia_smi()
    global HOST
    HOST = HostTwins()
    try:
        return _main(dev, card)
    finally:
        HOST.close()


def _main(dev, card) -> int:
    import torch

    from fantoch_tpu_torch import kernels
    from fantoch_tpu_torch.kernels import build

    # 1. versions and the card
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} | {torch.cuda.get_device_name(0)}")
    print(card)

    def phase(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"phase {label}: {time.perf_counter() - t0:.1f} s")
        return out

    # the host runs the sampled lanes are held to, in the background (the
    # mc grid's go in segments while it runs)
    for name in PATHS:
        HOST.submit(("sweep", name), _host_sweep_lanes, name, SAMPLE[name])

    # 2. build
    phase("2 build", build.build)
    print(f"build: nvcc+link {build.BUILD_SECONDS} s")

    # 3. every kernel against its plain twin at the main paths' shapes
    rows = {}
    for name in PATHS:
        phase(f"3 kernels ({name} path)", check_kernels, name, dev, rows)
    phase("3 kernels (monitored mc paths)", check_monitored_kernels, dev,
          rows)
    assert sorted(rows) == sorted(kernels.WRAPPERS), sorted(rows)

    # 4-6. golden batches and fixture bytes on the card
    phase("4 golden basic", golden_basic, dev)
    phase("5 golden fpaxos", golden_fpaxos, dev)
    phase("6 golden tempo", golden_tempo, dev)
    phase("6 golden atlas/epaxos", golden_graphdep, dev)
    phase("6 golden caesar", golden_caesar, dev)
    phase("6 golden tempo partial", golden_tempo_partial, dev)
    phase("6 golden atlas partial", golden_atlas_partial, dev)
    phase("6 golden faults", golden_faults, dev)

    # the fault branches of K1, K6 and K7, and K6's reorder draws and wide
    # lanes, each against its twin
    for label, fn, knames in (
        ("fault coverage", fault_coverage,
         ("qualify_pop", "emit_rewrite", "lane_freeze")),
        ("reorder", reorder_coverage, ("emit_rewrite",)),
        ("wide emit", wide_emit, ("emit_rewrite",)),
    ):
        err = phase(f"6 kernels ({label})", fn, dev)
        for kname in knames:
            rows[kname]["max_abs_err"] = max(rows[kname]["max_abs_err"], err)
    # the monitor branches of the handlers and K6, and K13, against their
    # twins on every step of small monitored batches
    for kname, err in phase("6 kernels (monitor coverage)",
                            monitor_coverage, dev).items():
        rows[kname]["max_abs_err"] = max(rows[kname]["max_abs_err"], err)

    # 7. the main paths, each counted on its own
    by_path = {name: phase(f"7 sweep {name}", sweep, name, dev)
               for name in PATHS}
    by_path["tempo_monitored"] = phase("7 sweep tempo monitored",
                                       monitored_tempo_sweep, dev)
    # 8. this slice's main path, the mc default grid, counted; then the
    # bench's fuzz self-check point
    by_path["mc"] = phase("8 mc grid", mc_grid, dev)
    phase("8 mc bench point", bench_point, dev)
    assert K13_CHECKED["launches"] > 0
    rows["mon_finalize"]["max_abs_err"] = max(
        rows["mon_finalize"]["max_abs_err"], K13_CHECKED["err"])
    print(f"kernel mon_finalize: exact=True on the final state of every one "
          f"of {K13_CHECKED['launches']} monitored batches")

    # 9. the kernels line, then the verdict
    out = []
    for kname, row in rows.items():
        counts = {p: c[kname] for p, c in by_path.items()}
        out.append({
            "name": kname,
            "route": "cuda",
            "source": f"fantoch_tpu_torch/kernels/csrc/{kname}.cu",
            "replaces": REPLACES[kname],
            "launches": counts[row["path"]],
            "launches_by_path": counts,
            **row,
        })
    assert all(k["launches"] > 0 for k in out), out
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
