#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

Run from the root of a checkout, with one CUDA card and no arguments:

    python3 chip_smoke.py

It builds the engine's CUDA kernels from ``fantoch_tpu_torch/kernels/csrc``
(one nvcc per source, in parallel), holds each kernel against its plain
PyTorch twin on the card at the main path's shapes (exact equality: all
integer or bit-exact data; ``key_table`` also on a batch of Zipf lanes)
beside the least time its region's work needs (each kernel module's
``work``, ``kernels/cost.py``), checks the Basic golden numbers and the
committed ``tests/fixtures/torch_basic_golden.json`` bytes on the card,
then drives the main path — the 2,048-lane Basic sweep (n = 5, 256
five-region subsets × f ∈ {1, 2} × conflict ∈ {0, 10, 50, 100}, 50
commands per client, one client per region) through ``run_sweep`` — with
every launch counter set to 0 just before and read just after. Any
failure raises; nothing is caught. The last two lines are one JSON object
per kernel (``{"kernels": [...]}``) and the verdict ``{"ok": true, ...}``.
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
FIXTURE = ROOT / "tests" / "fixtures" / "torch_basic_golden.json"

GOLDEN_POINTS = [(f, cf) for f in (0, 1, 2) for cf in (0, 100)]


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from fantoch_tpu_torch import cli, kernels
    from fantoch_tpu_torch.carry import to_torch
    from fantoch_tpu_torch.core import Config, Planet
    from fantoch_tpu_torch.engine import EngineDims, make_lane, run_lanes
    from fantoch_tpu_torch.engine import core as engine_core
    from fantoch_tpu_torch.engine.driver import prepare_batch
    from fantoch_tpu_torch.engine.protocols import BasicDev
    from fantoch_tpu_torch.engine.spec import stack_lanes
    from fantoch_tpu_torch.kernels import build, cost
    from fantoch_tpu_torch.parallel import run_sweep

    mods = {
        name: importlib.import_module(f"fantoch_tpu_torch.kernels.{name}")
        for name in kernels.WRAPPERS
    }
    dev = torch.device("cuda")
    card = _nvidia_smi()
    # 1. versions and the card
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} | {torch.cuda.get_device_name(0)}")
    print(card)

    # 2. build
    t0 = time.perf_counter()
    build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc+link {build.BUILD_SECONDS} s)")

    # 3. every kernel against its plain twin at the main path's shapes:
    # the first batch of the sweep, stepped into the middle of its run,
    # then one step's kernel arguments recorded. The main path takes the
    # CLI's dims and defaults (the reference CLI's: pool and dot window
    # sized by the total command count).
    sweep = cli.parse_args(cli.MAIN_PATH)
    protocol, dims, specs = cli.sweep_setup(sweep)
    assert protocol is BasicDev and len(specs) == 2048
    batch = specs[:sweep.batch_lanes]
    state, ctx = prepare_batch(BasicDev, dims, batch, dev)
    for _ in range(300):
        state = engine_core.lane_step(BasicDev, dims, state, ctx)
    captured = {}
    originals = {
        "qualify_pop": (engine_core, "qualify_pop"),
        "land_emissions": (engine_core, "land_emissions"),
        "basic_handle": (mods["basic_handle"], "basic_handle"),
    }

    def recorder(name, fn):
        def wrapped(*args):
            captured[name] = args
            return fn(*args)
        # the wrapper counts through its module-global name, which is
        # this recorder while it stands in
        wrapped.launches = 0
        return wrapped

    saved = {k: getattr(m, a) for k, (m, a) in originals.items()}
    for k, (m, a) in originals.items():
        setattr(m, a, recorder(k, saved[k]))
    engine_core.lane_step(BasicDev, dims, state, ctx)
    for k, (m, a) in originals.items():
        setattr(m, a, saved[k])
    kt_args = (ctx["rng_key"], ctx["conflict_rate"], ctx["pool_size"],
               ctx["key_gen_kind"], ctx["zipf_cum"], dims.C,
               ctx["key_table"].shape[2])

    L, M, W = captured["qualify_pop"][0].shape
    N, E = dims.N, captured["land_emissions"][2].shape[1]
    C, T, K = dims.C, kt_args[-1], ctx["zipf_cum"].shape[1]
    args = {
        "qualify_pop": captured["qualify_pop"],
        "land_emissions": captured["land_emissions"],
        "key_table": kt_args,
        "basic_handle": captured["basic_handle"],
    }
    rows = {}
    for name, mod in mods.items():
        kern, plain = getattr(mod, name), getattr(mod, name + "_plain")
        a = args[name]
        before = kern.launches
        got, want = kern(*a), plain(*a)
        torch.cuda.synchronize()
        err = _compare(got, want)
        ms = _time_ms(lambda: kern(*a), 50)
        plain_ms = _time_ms(lambda: plain(*a), 5)
        # the least bytes and operations the region needs on these inputs
        n_bytes, n_ops = mod.work(*a, got)
        bound_ms, bound_by = cost.bound(n_bytes, n_ops)
        library_ms = None
        if name == "land_emissions":
            free = a[1] == (1 << 30)
            library_ms = _time_ms(
                lambda: torch.cumsum(free, dim=1, dtype=torch.int32), 50
            )
        rows[name] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=library_ms,
        )
        print(f"kernel {name}: exact=True max_abs_err={err} ms={ms:.5f} "
              f"plain_ms={plain_ms:.5f} bound_us={1e3 * bound_ms:.3f} "
              f"({bound_by}: {n_bytes} bytes, {n_ops} ops) "
              f"library_ms={library_ms} launches={kern.launches - before} "
              f"shapes L={L} N={N} M={M} W={W} E={E} C={C} T={T} K={K}")

    # K3's Zipf branch, which the main path's ConflictPool lanes do not
    # take: one batch of Zipf lanes (the same grid's first 512 points
    # with --zipf 1.0,1000)
    zargv = list(cli.MAIN_PATH)
    zargv[zargv.index("--subsets") + 1] = "64"
    _zp, _zd, zspecs = cli.sweep_setup(
        cli.parse_args(zargv + ["--zipf", "1.0,1000"])
    )
    zctx = to_torch(stack_lanes(zspecs[:sweep.batch_lanes]), dev)
    assert bool((zctx["key_gen_kind"] == 1).all())
    za = (zctx["rng_key"], zctx["conflict_rate"], zctx["pool_size"],
          zctx["key_gen_kind"], zctx["zipf_cum"], dims.C, T)
    got, want = kernels.key_table(*za), mods["key_table"].key_table_plain(*za)
    torch.cuda.synchronize()
    err = _compare(got, want)
    assert int(got.max()) > 0 and int(got.min()) >= 0
    print(f"kernel key_table (zipf): exact=True max_abs_err={err} "
          f"L={got.shape[0]} C={C} T={T} K={zctx['zipf_cum'].shape[1]} "
          f"distinct keys {int(torch.unique(got).numel())}")
    del state, ctx, captured, args, zctx, za, got, want

    # 4. the reference's golden Basic numbers on the card
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

    # 5. byte comparison with the committed reference fixture
    text = json.dumps([r.to_json() for r in golden], sort_keys=True) + "\n"
    assert text == FIXTURE.read_text(), "to_json differs from the fixture"
    print(f"fixture {FIXTURE.relative_to(ROOT)}: byte-identical "
          f"({len(text)} bytes)")

    # 6. the main path: the 2,048-lane sweep, counted
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = run_sweep(BasicDev, dims, specs, batch_lanes=sweep.batch_lanes,
                        device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.counts()
    errors = sum(1 for r in results if r.err)
    steps = [r.steps for r in results]
    total = sweep.commands * dims.C
    steps_run = launches["qualify_pop"]
    print(f"sweep basic n=5 (M={dims.M} D={dims.D}): {len(results)} points "
          f"in {wall:.3f} s = {len(results) / wall:.3f} points/s; errors "
          f"{errors} {sorted({r.err_cause for r in results if r.err})}; "
          f"steps per lane max {max(steps)} mean {sum(steps) / len(steps):.1f}"
          f"; batch steps {steps_run}; pool_peak max "
          f"{max(r.pool_peak for r in results)}; launches {launches}; "
          f"launches per batch step "
          f"{ {k: v / steps_run for k, v in launches.items()} }")
    assert len(results) == 2048 and errors == 0
    assert all(v > 0 for v in launches.values()), launches
    for r in results:
        assert r.completed == total and r.requeues == 0
        assert list(r.protocol_metrics["stable"]) == [total] * dims.N
        assert int(r.lat_count.sum()) == total
    # a sample of lanes against the plain twins on the host
    sample = [0, 7, 1000, 2047]
    host = run_lanes(BasicDev, dims, [specs[i] for i in sample], device="cpu")
    for i, h in zip(sample, host):
        assert json.dumps(h.to_json(), sort_keys=True) == json.dumps(
            results[i].to_json(), sort_keys=True
        ), f"lane {i} differs from the host run"
    print(f"lanes {sample}: card == host plain twins, byte for byte")

    # 7. the kernels line, then the verdict
    sources = {
        "qualify_pop": "fantoch_tpu/engine/core.py:811",
        "land_emissions": "fantoch_tpu/engine/core.py:1457",
        "key_table": "fantoch_tpu/engine/core.py:439",
        "basic_handle": "fantoch_tpu/engine/protocols/basic.py:119",
    }
    out = []
    for name, row in rows.items():
        out.append({
            "name": name,
            "route": "cuda",
            "source": f"fantoch_tpu_torch/kernels/csrc/{name}.cu",
            "replaces": sources[name],
            "launches": launches[name],
            **row,
        })
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
