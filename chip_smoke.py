#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

Run from the root of a checkout, with one CUDA card and no arguments:

    python3 chip_smoke.py

It builds the engine's eleven CUDA kernels from
``fantoch_tpu_torch/kernels/csrc`` (one nvcc per source, in parallel),
holds each kernel against its plain PyTorch twin on the card at the
seven main paths' shapes (exact equality: all integer or bool data;
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
small batch whose clock bump fires)
beside the
least time its region's work needs (each kernel module's ``work``,
``kernels/cost.py``) — a kernel's ``ms`` is its device time per launch
under ``torch.profiler``, ``call_ms`` the wrapper's whole call (host
included) — checks the Basic golden numbers and the committed
``tests/fixtures/torch_{basic,fpaxos,tempo,graphdep,caesar,tempo_partial}
_golden.json`` bytes on the card, then drives the seven main paths — the
2,048-lane Basic, FPaxos, Tempo, Atlas, EPaxos and Caesar sweeps (n = 5,
256 five-region subsets × f ∈ {1, 2} × conflict ∈ {0, 10, 50, 100}, 50
commands per client, one client per region) and the 512-lane sweep of
Tempo under partial replication (2 shards of 5 rows, 2 keys per command
from a pool of 4, the first 64 subsets, conflict 1 in place of 0) —
through ``run_sweep``, each with every launch counter set to 0 just
before and read just after, and holds sampled lanes of each to the
plain twins on the host. Any failure raises;
nothing is caught. Each phase prints its seconds. The last two lines
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
# the clock-bump batch of tests/test_torch_tempo_partial_step.py:
# (regions, f, conflict, clock bump ms), GC every 10 ms, detached sends
# every 20 ms, 4 commands per client
EU5 = ["europe-west1", "europe-west2", "europe-west3", "europe-west4",
       "europe-west6"]
EU3 = ["europe-west1", "europe-west3", "europe-west4"]
BUMP_POINTS = [(EU5, 2, 100, None), (EU5, 2, 50, 10), (EU3, 1, 100, None),
               (EU3, 1, 10, 10)]
# the Caesar golden batch (tests/test_torch_caesar.py): (n, f, wait
# condition, conflict, commands, clients per region)
CAESAR_POINTS = [
    (3, 1, True, 100, 30, 1),
    (3, 1, False, 100, 30, 1),
    (3, 1, True, 0, 30, 2),
    (5, 2, True, 100, 10, 1),
    (5, 2, False, 100, 10, 1),
]
# sampled lanes held to the host's plain twins: (regions, f, conflict) =
# (0, 1, 0), (0, 2, 100), (125, 1, 0), (255, 2, 100); the twins of Tempo,
# Atlas, EPaxos and Caesar are slower on the host, so two of them, both
# f = 2 at conflict 100; a partial lane takes some 11,700 serialized
# steps, so one (subset 0, f = 2, conflict 100)
SAMPLE = {"basic": [0, 7, 1000, 2047], "fpaxos": [0, 7, 1000, 2047],
          "tempo": [7, 2047], "atlas": [7, 2047], "epaxos": [7, 2047],
          "caesar": [7, 2047], "tempo_partial": [7]}

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
}
HANDLERS = {"basic": "basic_handle", "fpaxos": "fpaxos_handle",
            "tempo": "tempo_handle", "atlas": "graphdep_handle",
            "epaxos": "graphdep_handle", "caesar": "caesar_handle",
            "tempo_partial": "tempo_partial_handle"}
PATHS = ("basic", "fpaxos", "tempo", "atlas", "epaxos", "caesar",
         "tempo_partial")
OUTBOX_KEYS = ("valid", "dst", "mtype", "payload")


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
    from fantoch_tpu_torch.engine.driver import prepare_batch
    from fantoch_tpu_torch.engine.spec import stack_lanes
    from fantoch_tpu_torch.kernels import cost

    argv = cli.MAIN_PATHS[name]
    sweep = cli.parse_args(argv)
    protocol, dims, specs = cli.sweep_setup(sweep)
    max_steps = 1 << 22
    state, ctx = prepare_batch(protocol, dims, specs[:sweep.batch_lanes],
                               dev)
    for _ in range(300):
        state, _running = engine_core.frozen_step(protocol, dims, state,
                                                  ctx, max_steps)
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
                                              max_steps)
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

    if handler in COVERAGE:
        rows[handler]["max_abs_err"] = max(
            rows[handler]["max_abs_err"],
            coverage(name, handler, protocol, dims, state, ctx, max_steps,
                     captured[handler], mods[handler]),
        )
    if name == "tempo_partial":
        rows[handler]["max_abs_err"] = max(
            rows[handler]["max_abs_err"], bump_coverage(dev, mods[handler]),
        )

    # K7 with frozen lanes (every third lane failed), which it copies
    new, old, fctx, ms_ = captured["lane_freeze"]
    old = dict(old, err=old["err"].clone())
    old["err"][::3] = 64
    lf = mods["lane_freeze"]
    got = lf.lane_freeze(_clone(new), old, fctx, ms_)
    err = _compare(got, lf.lane_freeze_plain(new, old, fctx, ms_))
    frozen = int((~got[1]).sum())
    ms = _device_ms(
        lambda n=_clone(new): lf.lane_freeze(n, old, fctx, ms_),
        "lane_freeze", 50,
    )
    n_bytes, n_ops = lf.work(new, old, fctx, ms_, got)
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
             mod, every=25, bound=80, rows_needed=None, start=301):
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

    names, default_rows, extras = COVERAGE[kname]
    rows_needed = default_rows if rows_needed is None else rows_needed
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


def bump_coverage(dev, mod) -> float:
    """K11 against its twin on every step of the clock-bump batch of
    tests/test_torch_tempo_partial_step.py (close regions, GC every 10
    ms, the clock bump every 10 ms on two lanes), until all three timer
    rows and all fifteen types have been compared. Returns the max abs
    error."""
    from fantoch_tpu_torch.core import Config, Planet
    from fantoch_tpu_torch.engine import EngineDims, make_lane
    from fantoch_tpu_torch.engine import core as engine_core
    from fantoch_tpu_torch.engine.driver import prepare_batch
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
    state, ctx = prepare_batch(proto, dims, specs, dev)
    kname = "tempo_partial_handle"
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
    return coverage("bump batch", kname, proto, dims, state, ctx, 1 << 22,
                    box["args"], mod, every=1, rows_needed=(0, 1, 2),
                    start=1)


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
    from fantoch_tpu_torch.engine import run_lanes
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
    grid = args.subsets * len(args.fs) * len(args.conflicts)
    assert len(results) == grid and grid in (512, 2048) and errors == 0
    path_kernels = ["qualify_pop", HANDLERS[name], "emit_rewrite",
                    "land_emissions", "lane_freeze", "key_table"]
    assert all(launches[k] > 0 for k in path_kernels), launches
    other = set(HANDLERS.values()) - {HANDLERS[name]}
    assert all(launches[k] == 0 for k in other), launches
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
        if name == "tempo_partial":
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
    if name == "tempo_partial":
        commits = sorted({int(r.protocol_metrics["fast_path"].sum()
                              + r.protocol_metrics["slow_path"].sum())
                          for r in results})
        slow = sum(int(r.protocol_metrics["slow_path"].sum())
                   for r in results)
        print(f"{name}: {total} <= fast + slow <= {2 * total} (from "
              f"{commits[0]} to {commits[-1]}) and stable == 5 x {total} on "
              f"every lane; slow-path commits {slow}")
    t0 = time.perf_counter()
    sample = SAMPLE[name]
    host = run_lanes(protocol, dims, [specs[i] for i in sample],
                     device="cpu")
    for i, h in zip(sample, host):
        assert json.dumps(h.to_json(), sort_keys=True) == json.dumps(
            results[i].to_json(), sort_keys=True
        ), f"{name} lane {i} differs from the host run"
    print(f"{name} lanes {sample}: card == host plain twins, byte for byte "
          f"({time.perf_counter() - t0:.1f} s on the host)")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from fantoch_tpu_torch import kernels
    from fantoch_tpu_torch.kernels import build

    dev = torch.device("cuda")
    card = _nvidia_smi()
    # 1. versions and the card
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} | {torch.cuda.get_device_name(0)}")
    print(card)

    def phase(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"phase {label}: {time.perf_counter() - t0:.1f} s")
        return out

    # 2. build
    phase("2 build", build.build)
    print(f"build: nvcc+link {build.BUILD_SECONDS} s")

    # 3. every kernel against its plain twin at the main paths' shapes
    rows = {}
    for name in PATHS:
        phase(f"3 kernels ({name} path)", check_kernels, name, dev, rows)
    assert sorted(rows) == sorted(kernels.WRAPPERS), sorted(rows)

    # 4-6. golden batches and fixture bytes on the card
    phase("4 golden basic", golden_basic, dev)
    phase("5 golden fpaxos", golden_fpaxos, dev)
    phase("6 golden tempo", golden_tempo, dev)
    phase("6 golden atlas/epaxos", golden_graphdep, dev)
    phase("6 golden caesar", golden_caesar, dev)
    phase("6 golden tempo partial", golden_tempo_partial, dev)

    # 7. the main paths, each counted on its own
    by_path = {name: phase(f"7 sweep {name}", sweep, name, dev)
               for name in PATHS}

    # 8. the kernels line, then the verdict
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
