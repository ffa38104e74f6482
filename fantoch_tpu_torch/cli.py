"""Command line: ``python -m fantoch_tpu_torch [--device cpu] sweep ...``,
``... mc ...``, ``... sim ...``, ``... campaign ...`` and ``... knee ...``.

The ``sweep`` subcommand runs the batched engine over a (region subset
× f × conflict) grid, each point once per fault plan of ``--faults``,
under an optional traffic schedule (``--traffic``) or open-loop arrival
process (``--arrivals``, ``--offered-load``, ``--open-window``,
``--arrival-gap-ms``), each batch in segments of the device loop
(``--scan-window`` segments a device call, ``--pipeline-depth`` calls
in flight), and prints the reference CLI's summary JSON; ``--out``
writes each point's results as a JSONL line (``plot/db.py``). The
``mc`` subcommand fuzzes a (protocol × n) grid of schedules with the
safety monitors on (``mc/fuzz.py``), replays each flagged lane through
the host oracle, shrinks a confirmed violation to a repro artifact
(``--out``; ``--replay`` re-runs one) and prints the reference's summary
JSON; ``--coverage-dir`` steers it by coverage across invocations,
``--farm`` runs the standing fuzz farm (a fuzz campaign) and
``--migrate-covmaps`` converts coverage states to binary maps. The
``campaign`` subcommand runs a journal-backed, resumable sweep or fuzz
campaign (``campaign/``), ``fleet`` runs one over lease-sharded worker
processes (``fleet/``), and ``knee`` the open-loop knee sweep through it
(``serving/knee.py``). ``bote`` ranks region sets with the closed-form
latency model (``bote/``, one launch of K15 per n); ``bote --validate``
measures the top candidates through a campaign. All of these run on the
CUDA card unless ``--device cpu`` is given. The ``sim`` subcommand is
one exact run of the host simulator (``sim/``); it never touches a
device.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
from typing import List

from .core import Config, Planet


# the port's main paths: the reference bench's per-protocol grid
# (bench.py), 2,048 lanes, for Basic, FPaxos, Tempo, Atlas, EPaxos,
# Caesar (with the wait condition, the reference's default), and Tempo
# and Atlas under partial replication; chip_smoke.py and step_profile.py
# drive them
MAIN_PATH = [
    "sweep", "--protocol", "basic", "--n", "5", "--subsets", "256",
    "--fs", "1,2", "--conflicts", "0,10,50,100", "--commands", "50",
    "--clients-per-region", "1", "--batch-lanes", "512",
]
MAIN_PATH_FPAXOS = [
    "fpaxos" if a == "basic" else a for a in MAIN_PATH
]
MAIN_PATH_TEMPO = [
    "tempo" if a == "basic" else a for a in MAIN_PATH
]
MAIN_PATH_ATLAS = [
    "atlas" if a == "basic" else a for a in MAIN_PATH
]
MAIN_PATH_EPAXOS = [
    "epaxos" if a == "basic" else a for a in MAIN_PATH
]
MAIN_PATH_CAESAR = [
    "caesar" if a == "basic" else a for a in MAIN_PATH
]
# Tempo under partial replication: the same grid, every process row
# replicated per shard (2 shards, 2 keys per command, as the reference's
# inter-machine scalability runs); a pool of 4 shared keys, since with
# one conflict 100 could not give 2 unique keys, and conflict 1 where
# the grid has 0: at 0 a client draws only its private key, so no
# command gets 2 unique keys and the workload (the reference's too)
# refuses the lane. Depth is cut to the first 64 region subsets (512
# lanes, one batch): the lanes step in serialized global time (the
# shards' co-region rows sit at distance 0) and take 10,000-13,000
# steps each, so the whole grid would not fit chip_smoke.py's time
MAIN_PATH_TEMPO_PARTIAL = [
    "sweep", "--protocol", "tempo", "--n", "5", "--shards", "2",
    "--keys-per-command", "2", "--pool-size", "4", "--subsets", "64",
    "--fs", "1,2", "--conflicts", "1,10,50,100", "--commands", "50",
    "--clients-per-region", "1", "--batch-lanes", "512",
]
# Atlas under partial replication: the Tempo partial grid with Atlas,
# its two cuts kept (conflict 1 for 0, the first 64 subsets), and 9
# commands per client in place of 50. The reference itself overflows a
# fixed-width table (ERR_CAPACITY) on lanes of this grid at 10 commands
# and more (23 of 512 lanes at 10, 401 at 20): a process's executed set
# of a source in the other shard (G = 8 gap slots) gets a hole for
# every dot of that source that never touches its shard. At 9 the whole
# grid runs clean, so it is the most commands a sweep of only lanes
# that do not err allows
MAIN_PATH_ATLAS_PARTIAL = [
    "sweep", "--protocol", "atlas", "--n", "5", "--shards", "2",
    "--keys-per-command", "2", "--pool-size", "4", "--subsets", "64",
    "--fs", "1,2", "--conflicts", "1,10,50,100", "--commands", "9",
    "--clients-per-region", "1", "--batch-lanes", "512",
]
# Tempo under fault plans: the Tempo grid, each point once per plan. The
# first three plans are the --faults example of the reference CLI's help
# (fault-free, a crash, a partitioned link under a horizon); the fourth
# takes the rest of the fault model at the reference tests' settings (a
# 6x window on one link, drops at 4 % with seed 7, jitter up to 8x, the
# mc subcommand's default). Depth is cut to the first 64 subsets: 4
# plans x 512 points = 2,048 lanes, as many as the other main paths
TEMPO_FAULT_PLANS = (
    '[{}, {"crash": {"1": 200}}, '
    '{"windows": [{"src": 0, "dst": 1, "t0": 0, "t1": 500, '
    '"delay": "inf"}], "horizon": 5000}, '
    '{"windows": [{"src": 1, "dst": 0, "t0": 50, "t1": 400, "mult": 6}], '
    '"drop_bp": 400, "seed": 7, "jitter_max": 8, "jitter_seed": 1, '
    '"horizon": 5000}]'
)
MAIN_PATH_TEMPO_FAULTS = [
    "64" if a == "256" else a for a in MAIN_PATH_TEMPO
] + ["--faults", TEMPO_FAULT_PLANS]
# the open-loop Tempo offered-load ladder: the knee sweep's device work
# (the reference's serving/knee.py DEFAULT_LOADS, Poisson arrivals of
# mean gap 4 ms, a window of 4) over the Tempo grid cut to its first 64
# subsets, 512 lanes a load; MAIN_PATH_TEMPO_OPEN is its load-100 rung
OPEN_LOADS = (50, 100, 200, 400)
MAIN_PATH_TEMPO_OPEN = [
    "64" if a == "256" else a for a in MAIN_PATH_TEMPO
] + ["--arrivals", "poisson", "--offered-load", "100", "--open-window", "4",
     "--arrival-gap-ms", "4"]
# Tempo under the time-varying traffic presets, the same 512-lane grid
TRAFFIC_PATHS = ("diurnal", "flash", "churn")
MAIN_PATH_TEMPO_TRAFFIC = [
    "64" if a == "256" else a for a in MAIN_PATH_TEMPO
] + ["--traffic", "churn"]
# the mc subcommand's default grid: the reference CLI's own defaults
# (Tempo, FPaxos and Atlas x n in {3, 5}, 512 schedules a point)
MAIN_PATH_MC = ["mc", "--no-confirm"]
# the FPaxos half of that grid with host confirmation, n in {3, 5}, 512
# schedules a point
MAIN_PATH_MC_CONFIRM = ["mc", "--protocols", "fpaxos", "--ns", "3,5"]
# the whole default grid with host confirmation (every protocol of it
# has its host oracle): the reference CLI's own defaults, 8 confirmed
# lanes a point at most, 150 host runs a shrink at most
MAIN_PATH_MC_CONFIRM_GRID = ["mc"]
# the reference bench's fuzz self-check point (bench.py _fuzz_selfcheck):
# Tempo, n = 5, 256 schedules of 10 commands a client, mixed plans
BENCH_FUZZ = dict(protocol="tempo", n=5, f=1, schedules=256,
                  commands_per_client=10, seed=0xF022)
# the engine protocols the mc grid takes (the reference's DEV_PROTOCOLS)
ENGINE_PROTOCOLS = ("basic", "fpaxos", "tempo", "atlas", "epaxos", "caesar")
# the mixed path: the reference bench's mixed protocols (bench.py
# HETERO_PROTOCOLS) over the main grid, every point of each, interleaved
# lane by lane (bench.py _hetero_rate) in 512-lane mixed batches, 8,192
# lanes; a library path (run_sweep(hetero=True), hetero_setup): the
# sweep command takes one protocol
HETERO_PROTOCOLS = ("basic", "fpaxos", "tempo", "atlas")
MAIN_PATH_HETERO = [
    ",".join(HETERO_PROTOCOLS) if a == "basic" else a for a in MAIN_PATH
]
MAIN_PATHS = {"basic": MAIN_PATH, "fpaxos": MAIN_PATH_FPAXOS,
              "tempo": MAIN_PATH_TEMPO, "atlas": MAIN_PATH_ATLAS,
              "epaxos": MAIN_PATH_EPAXOS, "caesar": MAIN_PATH_CAESAR,
              "tempo_partial": MAIN_PATH_TEMPO_PARTIAL,
              "atlas_partial": MAIN_PATH_ATLAS_PARTIAL,
              "tempo_faults": MAIN_PATH_TEMPO_FAULTS,
              "tempo_open": MAIN_PATH_TEMPO_OPEN,
              "tempo_traffic": MAIN_PATH_TEMPO_TRAFFIC,
              "hetero": MAIN_PATH_HETERO}


def hetero_setup(args):
    """``(protocols, dims, mixed)`` of a sweep command line whose
    ``--protocol`` is a comma list: each protocol's grid as
    :func:`sweep_setup` builds it, ``protocols`` and ``dims`` by name,
    and ``mixed`` the ``(name, LaneSpec)`` pairs interleaved point by
    point (point 0 of each protocol, then point 1, ...), for
    ``run_sweep(..., hetero=True)``."""
    names = args.protocol.split(",")
    protocols, dims, specs = {}, {}, {}
    for name in names:
        one = argparse.Namespace(**vars(args))
        one.protocol = name
        protocols[name], dims[name], specs[name] = sweep_setup(one)
    mixed = [(name, spec) for point in zip(*(specs[n] for n in names))
             for name, spec in zip(names, point)]
    return protocols, dims, mixed


def _ints(s: str) -> List[int]:
    return [int(x) for x in s.split(",") if x != ""]


def _planet(args) -> Planet:
    """``--aws``: the AWS planet (2021-02-13); else the GCP planet."""
    if getattr(args, "aws", False):
        return Planet.from_dataset("latency_aws_2021_02_13")
    return Planet.new()


def sweep_setup(args):
    """``(protocol, dims, specs)`` of a ``sweep`` command line: the
    region subsets, dims and grid exactly as ``cmd_sweep`` runs them."""
    from .engine import EngineDims
    from .engine.faults import parse_fault_specs
    from .engine.protocols import (
        dev_config_kwargs, dev_protocol, partial_dev_protocol,
    )
    from .parallel.sweep import make_sweep_specs

    fault_plans = None
    if args.faults:
        fault_plans = parse_fault_specs(args.faults)
        if args.shards > 1:
            raise SystemExit("--faults is single-shard for now")
    traffic, traffic_keys = _traffic_setup(args)

    planet = _planet(args)
    all_regions = planet.regions()
    if args.regions:
        region_sets = [args.regions]
    else:
        region_sets = [
            [all_regions[i] for i in combo]
            for combo in itertools.islice(
                itertools.combinations(range(len(all_regions)), args.n),
                args.subsets,
            )
        ]
    clients = args.n * args.clients_per_region
    total = args.commands * clients
    try:
        if args.shards > 1:
            dev = partial_dev_protocol(
                args.protocol, clients, args.shards,
                keys_per_cmd=args.keys_per_command,
                pool_size=args.pool_size,
            )
        else:
            dev = dev_protocol(args.protocol, clients, keys=traffic_keys)
    except (NotImplementedError, ValueError) as e:
        raise SystemExit(str(e))
    if args.shards > 1:
        dims = EngineDims.for_partial(dev, args.n, clients, total,
                                      dot_slots=args.dot_slots)
    else:
        dims = EngineDims.for_protocol(
            dev,
            n=args.n,
            clients=clients,
            payload=dev.payload_width(args.n),
            total_commands=None if args.dot_slots else total,
            dot_slots=args.dot_slots or total + 1,
            regions=args.n,
        )
    fs = args.fs or [1]
    conflicts = (
        [args.conflict] if args.conflict is not None else args.conflicts
    )
    base = Config(**dev_config_kwargs(
        args.protocol, args.n, fs[0], **_config_overrides(args)
    ))
    if args.shards > 1:
        # the reference CLI's shard config
        base = base.with_(
            shard_count=args.shards,
            executor_executed_notification_interval_ms=100,
            executor_cleanup_interval_ms=100,
        )
    specs = make_sweep_specs(
        dev,
        planet,
        region_sets=region_sets,
        fs=fs,
        conflicts=conflicts,
        commands_per_client=args.commands,
        clients_per_region=args.clients_per_region,
        dims=dims,
        config_base=base,
        extra_time_ms=args.extra_time,
        zipf=(
            tuple(
                f(x) for f, x in zip((float, int), args.zipf.split(","))
            )
            if args.zipf
            else None
        ),
        pool_size=args.pool_size,
        faults=fault_plans,
        traffic=traffic,
        arrivals=args.arrivals,
        arrival_load=args.offered_load,
        arrival_gap_ms=args.arrival_gap_ms,
        open_window=args.open_window,
    )
    return dev, dims, specs


def _traffic_setup(args):
    """``(traffic, keys)``: the sweep's traffic preset (None for flat)
    and the protocol's key capacity it needs (None: the default), after
    the reference CLI's refusals of ``--traffic`` and ``--arrivals``."""
    from .traffic import (
        ARRIVAL_PRESETS, TRAFFIC_PRESETS, traffic_key_capacity,
    )

    traffic = args.traffic if args.traffic not in (None, "flat") else None
    traffic_keys = None
    if traffic is not None:
        if traffic not in TRAFFIC_PRESETS:
            raise SystemExit(
                f"unknown traffic preset {traffic!r}; choose from "
                f"{','.join(TRAFFIC_PRESETS)}"
            )
        if args.shards > 1:
            raise SystemExit("--traffic is single-shard for now")
        if args.zipf:
            raise SystemExit(
                "--traffic drives the ConflictPool generator; drop "
                "--zipf"
            )
        traffic_keys = traffic_key_capacity(
            [traffic],
            conflict=args.conflict if args.conflict is not None else 100,
            pool_size=args.pool_size,
            commands=args.commands,
            clients=args.n * args.clients_per_region,
        )
    if args.arrivals is not None:
        if args.arrivals not in ARRIVAL_PRESETS or args.arrivals == "closed":
            open_presets = [a for a in ARRIVAL_PRESETS if a != "closed"]
            raise SystemExit(
                f"unknown arrival preset {args.arrivals!r}; choose "
                f"from {','.join(open_presets)}"
            )
        if args.shards > 1:
            raise SystemExit("--arrivals is single-shard for now")
        if traffic in ("diurnal", "flash"):
            raise SystemExit(
                f"--traffic {traffic} carries think delays, which "
                "open-loop arrivals replace; combine --arrivals with "
                "flat or churn traffic"
            )
        if args.offered_load < 1 or args.open_window < 1:
            raise SystemExit(
                "--offered-load and --open-window must be >= 1"
            )
    return traffic, traffic_keys


def _config_overrides(args) -> dict:
    """The CLI's config knobs, as the reference's ``_build_config``:
    the GC interval, for Tempo and TempoAtomic the detached-send interval
    and the optional real-time clock bump, for Caesar the wait
    condition."""
    kw = dict(gc_interval_ms=args.gc_interval)
    if args.protocol.startswith("tempo"):
        kw["tempo_detached_send_interval_ms"] = args.detached_interval
        if args.clock_bump_interval:
            kw["tempo_clock_bump_interval_ms"] = args.clock_bump_interval
    if args.protocol == "caesar":
        kw["caesar_wait_condition"] = not args.no_wait_condition
    return kw


def cmd_sweep(args) -> None:
    from . import resolve_device
    from .parallel.sweep import run_sweep

    if args.aot_dir:
        _refuse("sweep", "--aot-dir loads or writes a serialized sweep "
                "executable, and the port has none to share: it builds its "
                "CUDA kernels from kernels/csrc/ at first use")
    device = resolve_device(args.device)
    dev, dims, specs = sweep_setup(args)
    results = run_sweep(
        dev, dims, specs, batch_lanes=args.batch_lanes, device=device,
        pipeline_depth=args.pipeline_depth, scan_window=args.scan_window,
    )
    errs = sum(1 for r in results if r.err)
    summary = {
        "protocol": args.protocol,
        "traffic": args.traffic if args.traffic not in (None, "flat")
        else "flat",
        "arrivals": args.arrivals or "closed",
        "points": len(specs),
        "errors": errs,
        "error_causes": sorted({r.err_cause for r in results if r.err}),
        "stalled_lanes": sum(1 for r in results if r.requeues),
    }
    if args.faults:
        summary["fault_lanes"] = sum(
            1 for r in results if r.faults is not None
        )
        summary["unavailable_lanes"] = sum(
            1 for r in results if r.faults and r.faults.get("unavail")
        )
        summary["messages_dropped"] = sum(r.dropped for r in results)
    if args.out:
        from .plot import save_results

        save_results(args.out, sweep_rows(args, specs, results))
        summary["out"] = args.out
    print(json.dumps(summary))


def sweep_rows(args, specs, results):
    """``(attrs, results)`` of every sweep point, the reference CLI's
    ``--out`` rows: protocol, n, f, shards, conflict and regions, and
    the fault, traffic and arrival metadata where a lane has them."""
    rows = []
    for spec, res in zip(specs, results):
        attrs = {
            "protocol": args.protocol,
            "n": spec.config.n,
            "f": spec.config.f,
            "shards": spec.config.shard_count,
            "conflict": int(spec.ctx["conflict_rate"]),
            "regions": spec.process_regions,
        }
        if spec.fault_meta is not None:
            attrs["faults"] = spec.fault_meta
        if spec.traffic_meta is not None:
            attrs["traffic"] = spec.traffic_meta
        if spec.arrival_meta is not None:
            attrs["arrivals"] = spec.arrival_meta
        rows.append((attrs, res))
    return rows


def mc_specs(args):
    """The ``FuzzSpec`` of every (protocol, n) point of an ``mc``
    command line, in grid order."""
    from .mc.fuzz import FuzzSpec

    return [
        FuzzSpec(
            protocol=proto, n=n, f=args.f, conflict=args.conflict,
            pool_size=args.pool_size,
            clients_per_region=args.clients_per_region,
            commands_per_client=args.commands, schedules=args.schedules,
            seed=args.seed, jitter_max=args.jitter_max,
            crash_share=args.crash_share, drop_share=args.drop_share,
            aws=bool(args.aws), inject_bug=args.inject_bug,
        )
        for proto in args.protocols.split(",") for n in args.ns
    ]


def _refuse(cmd: str, e: Exception) -> None:
    print(f"{cmd} refused: {e}", file=sys.stderr)
    raise SystemExit(2)


# the reference CLI's oracle protocol names (its sim command's choices);
# fantoch_tpu_torch/protocol BY_NAME holds the ported ones
ORACLE_PROTOCOLS = ENGINE_PROTOCOLS + ("tempo_atomic",)


def cmd_sim(args) -> None:
    """One exact run of the host simulator (the reference CLI's ``sim``):
    per-region issued counts, mean/p95/p99 latency and the fast/slow path
    totals, as JSON on stdout. A protocol outside ``protocol.BY_NAME`` is
    refused by name (exit 2)."""
    from .client import ConflictPool, Workload, Zipf
    from .engine.protocols import dev_config_kwargs
    from .mc.fuzz import oracle_protocol
    from .protocol.base import ProtocolMetricsKind
    from .sim import Runner
    from .traffic import ARRIVAL_PRESETS

    try:
        protocol_cls = oracle_protocol(args.protocol)
    except ValueError as e:
        _refuse("sim", e)
    planet = _planet(args)
    regions = args.regions or planet.regions()[: args.n]
    config = Config(**dev_config_kwargs(args.protocol, args.n, args.f,
                                        **_config_overrides(args)))
    if args.zipf:
        coef, keys = args.zipf.split(",")
        key_gen = Zipf(coefficient=float(coef), total_keys_per_shard=int(keys))
    else:
        key_gen = ConflictPool(
            conflict_rate=args.conflict, pool_size=args.pool_size
        )
    workload = Workload(
        shard_count=1,
        key_gen=key_gen,
        keys_per_command=1,
        commands_per_client=args.commands,
        payload_size=0,
    )
    if args.arrivals is not None:
        if args.arrivals not in ARRIVAL_PRESETS or args.arrivals == "closed":
            open_presets = [a for a in ARRIVAL_PRESETS if a != "closed"]
            raise SystemExit(
                f"unknown arrival preset {args.arrivals!r}; choose "
                f"from {','.join(open_presets)}"
            )
        if args.reorder:
            raise SystemExit(
                "--arrivals pins FIFO delivery (the open-loop "
                "device/oracle equivalence relies on it); drop "
                "--reorder"
            )
    runner = Runner(
        protocol_cls,
        planet,
        config,
        workload,
        args.clients_per_region,
        list(regions),
        list(regions),
        seed=args.seed,
        arrivals=args.arrivals,
        arrival_load=args.offered_load,
        arrival_gap_ms=args.arrival_gap_ms,
        open_window=args.open_window,
    )
    if args.reorder:
        runner.reorder_messages = True
    metrics, _, latencies = runner.run(extra_sim_time_ms=args.extra_time)
    out = {"protocol": args.protocol, "n": args.n, "f": args.f,
           "conflict": args.conflict, "regions": {}}
    for region, (issued, hist) in latencies.items():
        out["regions"][region] = {
            "issued": issued,
            "mean_ms": hist.mean(),
            "p95_ms": hist.percentile(0.95),
            "p99_ms": hist.percentile(0.99),
        }
    fast = slow = 0
    for pm, _em in metrics.values():
        fast += pm.get_aggregated(ProtocolMetricsKind.FAST_PATH) or 0
        slow += pm.get_aggregated(ProtocolMetricsKind.SLOW_PATH) or 0
    out["fast_path"], out["slow_path"] = fast, slow
    print(json.dumps(out, indent=2))


def cmd_mc(args) -> None:
    """Device-scale schedule fuzzing (``mc/fuzz.py``) over a (protocol ×
    n) grid: per point one batch of perturbed schedules with the safety
    monitors on; prints each point's summary on stderr and the grid's
    summary JSON (the reference's keys) on stdout. Unless
    ``--no-confirm``, each point's flagged lanes (at most
    ``--max-confirm``) replay through the host oracle and a confirmed
    violation shrinks to a repro artifact, written to ``--out``;
    ``--replay`` re-executes one (exit 0 iff a violation reproduces).
    Every protocol of the grid has its host oracle (``--inject-bug``
    confirms through the broken Tempo twin ``TempoStabilityBug``).
    Refused by name, exit 2, before any lane runs: ``--replay`` of an
    artifact whose protocol has no host oracle.

    ``--coverage-dir`` makes repeated invocations coverage-guided
    (``mc/coverage.py``): each point's bucket map, seed pool and
    generator positions persist in the directory, so every session
    mutates the seeds the previous ones found; a stored map whose point
    signature disagrees is refused (exit 2). ``--farm DIR`` runs the
    standing fuzz farm instead: a durable coverage campaign in DIR with
    fault-class-sharded points (``--classes``), frontier-weighted
    mutation, plateau retirement (``--retire-after``) and binary
    coverage maps; re-invoking the same command resumes it (exit 0
    drained, 75 interrupted, 2 refused). ``--migrate-covmaps DIR``
    converts a ``--coverage-dir``'s JSON point states to the binary
    format, proving each conversion lossless."""
    import time

    from . import resolve_device
    from .mc.fuzz import load_artifact, replay_artifact, run_fuzz_point

    if args.migrate_covmaps:
        from .mc import coverage as cov
        from .mc import covmap as cvm

        try:
            written = cvm.migrate_point_states(args.migrate_covmaps)
        except cov.CoverageError as e:
            _refuse("mc", f"{type(e).__name__}: {e}")
        print(json.dumps({"migrated": written, "count": len(written)}))
        return
    if args.farm:
        _mc_farm(args)
        return
    if args.replay:
        try:
            out = replay_artifact(load_artifact(args.replay))
        except ValueError as e:
            _refuse("mc", e)
        print(json.dumps(out, indent=2))
        if not out["reproduced"]:
            raise SystemExit("artifact did not reproduce its violation")
        return
    _mc_protocols(args)
    device = resolve_device(args.device)
    planet = _planet(args)
    points = []
    artifacts = []
    skipped_points = 0
    t0 = time.perf_counter()
    for spec in mc_specs(args):
        if args.budget_s and time.perf_counter() - t0 > args.budget_s:
            skipped_points += 1
            continue
        plans, lane_offset, steering = None, 0, None
        if args.coverage_dir:
            plans, lane_offset, steering = _coverage_plans(args, spec)
        res = run_fuzz_point(
            spec, planet=planet, confirm=not args.no_confirm,
            max_confirmations=args.max_confirm,
            shrink_budget=args.shrink_budget,
            strict_missing=args.strict_missing, plans=plans,
            lane_offset=lane_offset, artifact_dir=args.out, device=device,
        )
        point = res.summary()
        if steering is not None:
            point.update(_coverage_fold(args, spec, steering, res, plans,
                                        lane_offset))
        artifacts += [f.artifact_path for f in res.findings
                      if f.artifact_path]
        points.append(point)
        print(json.dumps(point), file=sys.stderr, flush=True)
    elapsed = time.perf_counter() - t0
    total = sum(p["schedules"] for p in points)
    fuzz_s = sum(p["fuzz_elapsed_s"] for p in points)
    errors: dict = {}
    for p in points:
        for k, v in p["engine_errors"].items():
            errors[k] = errors.get(k, 0) + v
    print(json.dumps({
        "points": len(points),
        "skipped_points": skipped_points,
        "schedules": total,
        "elapsed_s": round(elapsed, 2),
        "fuzz_elapsed_s": round(fuzz_s, 2),
        "schedules_per_sec": round(total / max(fuzz_s, 1e-9), 2),
        "flagged": sum(p["flagged"] for p in points),
        "confirmed": sum(p["confirmed"] for p in points),
        "engine_errors": errors,
        "artifacts": artifacts,
        "grid": points,
    }))


def _mc_protocols(args) -> List[str]:
    """``--protocols`` of an ``mc`` command line, refused (before any
    lane runs) when a name is not an engine protocol or ``--inject-bug``
    is asked of another protocol than Tempo."""
    protocols = args.protocols.split(",")
    unknown = [p for p in protocols if p not in ENGINE_PROTOCOLS]
    if unknown:
        raise SystemExit(
            f"unknown protocol(s) {unknown}; choose from "
            f"{','.join(ENGINE_PROTOCOLS)}"
        )
    if args.inject_bug and protocols != ["tempo"]:
        raise SystemExit(
            "--inject-bug is a Tempo-specific self-check; pass "
            "--protocols tempo"
        )
    return protocols


def _coverage_plans(args, spec):
    """``(plans, lane_offset, steering)`` of one ``mc --coverage-dir``
    point: its stored steering state (a foreign point signature or a
    damaged file is refused, exit 2), the coverage-steered draw of
    ``--schedules`` plans continuing the stored generator positions, and
    the lane offset of the schedules tried before."""
    from .mc import coverage as cov
    from .mc.fuzz import plan_rng, point_config, point_protocol, restore_rng

    try:
        stored = cov.load_point_state(args.coverage_dir, spec)
        cmap, pool, mrng = cov.restore_steering(spec, stored)
    except cov.CoverageError as e:
        _refuse("mc", f"{type(e).__name__}: {e}")
    rng = restore_rng(stored["rng_state"]) if stored else plan_rng(spec)
    plans = cov.draw_steered(spec, point_config(spec), point_protocol(spec),
                             spec.schedules, rng, mrng, pool, cmap=cmap)
    offset = int(stored["tried"]) if stored else 0
    return plans, offset, (cmap, pool, rng, mrng)


def _coverage_fold(args, spec, steering, res, plans, lane_offset) -> dict:
    """Fold one point's digests into its map and seed pool, persist the
    steering state, and return the summary's coverage fields."""
    from .mc import coverage as cov
    from .mc.fuzz import rng_state

    cmap, pool, rng, mrng = steering
    fresh = cov.fold_chunk(cmap, pool, res.digests, plans)
    tried_total = lane_offset + res.schedules
    cov.save_point_state(args.coverage_dir, spec, {
        "kind": cov.COVERAGE_KIND,
        "version": cov.COVERAGE_VERSION,
        "tried": tried_total,
        "rng_state": rng_state(rng),
        "mrng_state": rng_state(mrng),
        "coverage": cmap.to_json(),
        "seeds": pool.to_json(),
        "seed_digests": pool.digests_json(),
    })
    return {"coverage_buckets": cmap.bucket_count,
            "new_buckets": len(fresh), "tried_total": tried_total}


# the exit code of a campaign, knee sweep or farm that stopped with work
# left (re-run to continue), as the reference CLI's
EXIT_INTERRUPTED = 75


def _mc_farm(args) -> None:
    """``mc --farm DIR``: the standing fuzz farm, a coverage-steered,
    class-sharded, binary-mapped fuzz campaign (the reference CLI's grid,
    field for field)."""
    from . import resolve_device
    from .campaign import CampaignError, campaign_from_json, run_campaign
    from .engine.checkpoint import CheckpointError

    protocols = _mc_protocols(args)
    grid = {
        "kind": "fuzz",
        "protocols": protocols,
        "ns": list(args.ns),
        "f": args.f,
        "conflict": args.conflict,
        "pool_size": args.pool_size,
        "clients_per_region": args.clients_per_region,
        "commands_per_client": args.commands,
        "schedules": args.schedules,
        "chunk": args.chunk,
        "seed": args.seed,
        "jitter_max": args.jitter_max,
        "crash_share": args.crash_share,
        "drop_share": args.drop_share,
        "confirm": not args.no_confirm,
        "max_confirm": args.max_confirm,
        "shrink_budget": args.shrink_budget,
        "strict_missing": bool(args.strict_missing),
        "inject_bug": bool(args.inject_bug),
        "aws": bool(args.aws),
        "coverage": True,
        "binary_maps": True,
        "classes": [c for c in args.classes.split(",") if c],
        "retire_after": args.retire_after,
    }
    device = resolve_device(args.device)
    try:
        spec = campaign_from_json(grid)
        summary = run_campaign(args.farm, spec, budget_s=args.budget_s,
                               device=device)
    except (CheckpointError, CampaignError) as e:
        _refuse("mc", f"{type(e).__name__}: {e}")
    print(json.dumps(summary))
    if not summary["done"]:
        print(f"farm interrupted ({summary['interrupted']}); state is "
              "journaled — re-run the same command to continue",
              file=sys.stderr)
        raise SystemExit(EXIT_INTERRUPTED)


def cmd_campaign(args) -> None:
    """Durable, resumable campaigns (``campaign/``): a journal-backed
    manager chunks a sweep or fuzz grid into units, checkpoints the
    in-flight sweep batch at window boundaries (engine/checkpoint.py)
    and resumes exactly where it stopped across process restarts. Exits
    0 when the grid is done, 75 when work remains (re-run with
    ``--resume``), 2 when a stale or corrupt checkpoint, a
    campaign-directory disagreement or a spec field the port does not
    run (``aot``, ``shard_lanes``, ``mesh_shard``) is refused."""
    from . import resolve_device
    from .campaign import CampaignError, campaign_from_json, run_campaign
    from .engine.checkpoint import CheckpointError

    spec = None
    if args.grid:
        text = args.grid
        if text.startswith("@"):
            with open(text[1:]) as fh:
                text = fh.read()
        try:
            spec = campaign_from_json(json.loads(text))
        except (ValueError, CampaignError) as e:
            raise SystemExit(f"bad --grid spec: {e}")
    device = resolve_device(args.device)
    try:
        summary = run_campaign(
            args.dir, spec, resume=args.resume, budget_s=args.budget_s,
            stop_after_segments=args.stop_after_segments, device=device,
        )
    except (CheckpointError, CampaignError) as e:
        _refuse("campaign", f"{type(e).__name__}: {e}")
    print(json.dumps(summary))
    if not summary["done"]:
        print(f"campaign interrupted ({summary['interrupted']}); state is "
              "checkpointed — re-run with --resume to continue",
              file=sys.stderr)
        raise SystemExit(EXIT_INTERRUPTED)


def cmd_knee(args) -> None:
    """The measured throughput–latency knee sweep (``serving/knee.py``):
    one open-loop arrival preset at a ladder of offered loads per
    (protocol, region set, traffic) point, through the campaign manager;
    once the grid completes the curves and the located knee are written
    as one canonical ``knee.json``. ``--dryrun`` writes the parameter
    shell with ``points: null``. Exits 0 done, 75 interrupted, 2
    refused."""
    from . import resolve_device
    from .campaign import CampaignError
    from .engine.checkpoint import CheckpointError
    from .serving import run_knee_sweep
    from .traffic import ARRIVAL_PRESETS, TRAFFIC_PRESETS

    protocols = args.protocols.split(",")
    unknown = [p for p in protocols if p not in ENGINE_PROTOCOLS]
    if unknown:
        raise SystemExit(
            f"unknown protocol(s) {unknown}; choose from "
            f"{','.join(ENGINE_PROTOCOLS)}"
        )
    if args.arrival not in ARRIVAL_PRESETS or args.arrival == "closed":
        open_presets = [a for a in ARRIVAL_PRESETS if a != "closed"]
        raise SystemExit(
            f"unknown arrival preset {args.arrival!r}; choose from "
            f"{','.join(open_presets)}"
        )
    traffic = args.traffic.split(",")
    bad = [t for t in traffic if t not in TRAFFIC_PRESETS]
    if bad:
        raise SystemExit(
            f"unknown traffic preset(s) {bad}; choose from "
            f"{','.join(TRAFFIC_PRESETS)}"
        )
    carry_think = [t for t in traffic if t in ("diurnal", "flash")]
    if carry_think:
        raise SystemExit(
            f"--traffic {','.join(carry_think)} carries think delays, "
            "which open-loop arrivals replace; combine with flat or "
            "churn traffic"
        )
    device = None if args.dryrun else resolve_device(args.device)
    try:
        artifact, summary = run_knee_sweep(
            args.dir,
            protocols=protocols,
            ns=args.ns,
            region_sets=[args.regions] if args.regions else None,
            arrival=args.arrival,
            loads=args.loads,
            traffic=traffic,
            fs=args.fs or [1],
            conflicts=args.conflicts,
            commands_per_client=args.commands,
            clients_per_region=args.clients_per_region,
            open_window=args.open_window,
            mean_gap_ms=args.mean_gap_ms,
            batch_lanes=args.batch_lanes,
            segment_steps=args.segment_steps,
            knee_mult=args.knee_mult,
            aws=bool(args.aws),
            resume=args.resume,
            budget_s=args.budget_s,
            dryrun=args.dryrun,
            out=args.out,
            device=device,
        )
    except (CheckpointError, CampaignError) as e:
        _refuse("knee sweep", f"{type(e).__name__}: {e}")
    print(json.dumps(summary))
    if artifact is None:
        print(f"knee sweep interrupted ({summary['interrupted']}); the "
              "campaign is checkpointed — re-run with --resume to "
              "continue", file=sys.stderr)
        raise SystemExit(EXIT_INTERRUPTED)


def _spawn_fleet_workers(args, grid_text) -> "tuple[bool, bool]":
    """The ``--workers N`` convenience mode: N subprocess workers
    (``python -m fantoch_tpu_torch --device <this one's> fleet``) drain
    the campaign concurrently, re-spawned in rounds while they make
    progress (a round where a worker dies or exits with units still
    leased leaves reclaimable work for the next). Returns ``(done,
    refused)``."""
    import subprocess

    base = [
        sys.executable, "-m", "fantoch_tpu_torch",
        "--device", args.device, "fleet", "--dir", args.dir,
    ]
    if args.ttl_s is not None:
        base += ["--ttl-s", str(args.ttl_s)]
    if args.budget_s is not None:
        base += ["--budget-s", str(args.budget_s)]
    done = False
    for round_no in range(5):
        cmds = []
        for i in range(args.workers):
            cmd = list(base) + ["--worker-id", f"w{i}"]
            # only the first touch needs the grid; later rounds (and
            # late-starting workers) resume the stored campaign.json
            if grid_text and round_no == 0:
                cmd += ["--grid", grid_text]
            cmds.append(cmd)
        procs = [subprocess.Popen(c) for c in cmds]
        rcs = [p.wait() for p in procs]
        print(
            f"fleet round {round_no + 1}: worker exits {rcs}",
            file=sys.stderr,
        )
        if any(rc == 2 for rc in rcs):
            return False, True
        if any(rc == 0 for rc in rcs):
            done = True
            break
        if all(rc not in (0, EXIT_INTERRUPTED) for rc in rcs):
            # every worker crashed outright — re-spawning would loop
            return False, True
    return done, False


def cmd_fleet(args) -> None:
    """Lease-sharded multi-worker campaigns (``fleet/``): workers claim
    grid units from a shared campaign dir via atomic-rename leases with
    heartbeat TTLs, journal into worker-scoped journals, and any worker
    resumes any abandoned unit's signed checkpoint; ``--merge`` writes
    the deterministic merged output (byte-identical to a 1-worker
    control). ``--workers N`` builds the kernels once (on the card)
    before it spawns its workers. Exits 0 done, 75 with work remaining,
    2 refused (a spec field the port does not run — ``aot``,
    ``shard_lanes``, ``mesh_shard`` — among the refusals)."""
    import os

    from . import resolve_device
    from .campaign import CampaignError, campaign_from_json
    from .campaign.manager import _CAMPAIGN
    from .engine.checkpoint import CheckpointError
    from .fleet import (
        DEFAULT_TTL_S,
        FleetError,
        merge_campaign,
        run_fleet_worker,
    )

    grid_text = None
    spec = None
    if args.grid:
        grid_text = args.grid
        if grid_text.startswith("@"):
            with open(grid_text[1:]) as fh:
                grid_text = fh.read()
        try:
            spec = campaign_from_json(json.loads(grid_text))
        except (ValueError, CampaignError) as e:
            raise SystemExit(f"bad --grid spec: {e}")
    if args.workers and args.worker_id:
        raise SystemExit("--workers spawns its own worker ids; drop "
                         "--worker-id")
    if not (args.workers or args.worker_id or args.merge):
        raise SystemExit("fleet needs --workers N, --worker-id ID, "
                         "and/or --merge")
    if args.farm:
        # the farm contract is asserted up front, against --grid or
        # the stored campaign.json, so no worker claims a unit of a
        # grid that silently lacks the farm posture
        fspec = spec
        if fspec is None:
            cpath = os.path.join(args.dir, _CAMPAIGN)
            if os.path.exists(cpath):
                try:
                    fspec = campaign_from_json(json.load(open(cpath)))
                except (ValueError, CampaignError) as e:
                    _refuse("fleet", f"{type(e).__name__}: {e}")
        shape = (
            fspec is not None
            and getattr(fspec, "kind", None) == "fuzz"
            and bool(getattr(fspec, "coverage", False))
            and bool(getattr(fspec, "binary_maps", False))
        )
        if not shape:
            _refuse(
                "fleet",
                "--farm needs a standing-farm fuzz grid (coverage + "
                'binary_maps, docs/MC.md "Standing farm"); got '
                + ("no campaign spec" if fspec is None
                   else f"kind={getattr(fspec, 'kind', None)!r}"),
            )
    device = None
    if args.workers or args.worker_id:
        device = resolve_device(args.device)

    done = True
    try:
        if args.worker_id:
            summary = run_fleet_worker(
                args.dir,
                spec,
                worker_id=args.worker_id,
                budget_s=args.budget_s,
                ttl_s=(
                    args.ttl_s if args.ttl_s is not None
                    else DEFAULT_TTL_S
                ),
                stop_after_units=args.stop_after_units,
                stop_after_segments=args.stop_after_segments,
                device=device,
            )
            print(json.dumps(summary))
            done = summary["done"]
            if not done:
                reason = summary["interrupted"] or "units leased elsewhere"
                print(
                    f"fleet worker stopped ({reason}); every completed "
                    "unit is journaled — re-run (any worker id) to "
                    "continue",
                    file=sys.stderr,
                )
        elif args.workers:
            if device.type == "cuda":
                # one build before N processes load the library
                from .kernels import build

                build.build()
            done, refused = _spawn_fleet_workers(args, grid_text)
            if refused:
                print(
                    "fleet refused or crashed in a worker (see above)",
                    file=sys.stderr,
                )
                raise SystemExit(2)
        if args.merge:
            merged = merge_campaign(args.dir)
            print(json.dumps(merged))
            if not merged["merged"]:
                print(
                    "fleet merge incomplete: units missing — run more "
                    "workers, then --merge again",
                    file=sys.stderr,
                )
                raise SystemExit(EXIT_INTERRUPTED)
            return
    except (CheckpointError, CampaignError, FleetError, ValueError) as e:
        # refusal, not recovery: stale/corrupt checkpoints, campaign
        # disagreements, unported spec fields, bad worker ids,
        # conflicting journals — named
        _refuse("fleet", f"{type(e).__name__}: {e}")
    if not done:
        raise SystemExit(EXIT_INTERRUPTED)


def cmd_bote(args) -> None:
    """The closed-form region-set search (``bote/search.py``): every
    n-subset of the planet's regions for odd n in ``--min-n..--max-n``,
    one K15 launch per n, ranked on the host; prints the top ``--top``
    of each n as the reference CLI does. ``--validate`` measures the
    top candidates at ``--n`` instead."""
    from . import resolve_device
    from .bote.search import RankingParams, Search

    if args.validate:
        return cmd_bote_validate(args)
    device = resolve_device(args.device)
    search = Search(planet=_planet(args))
    params = RankingParams(
        min_mean_fpaxos_improv=args.min_mean_improv,
        min_fairness_fpaxos_improv=args.min_fairness_improv,
        min_n=args.min_n,
        max_n=args.max_n,
        ft_metric=args.metric,
    )
    ranked = search.rank(params, device=device)
    out = {}
    for n, configs in sorted(ranked.items()):
        out[n] = [
            {"regions": list(c.config), "score": float(c.score)}
            for c in configs[: args.top]
        ]
    print(json.dumps(out, indent=2))


def cmd_bote_validate(args) -> None:
    """Measured validation of the closed-form frontier
    (``bote/validate.py``): top-K ranked candidates at --n each get a
    sweep campaign (protocols × f × conflict × traffic) over their region
    sub-matrix, resumable across SIGKILL via the campaign manager; once
    complete, a frontier artifact compares closed-form vs measured
    p50/p99 per candidate. --dryrun emits the artifact with measured:
    null. Exits 0 done, 75 interrupted, 2 refused."""
    from . import resolve_device
    from .bote.search import RankingParams
    from .bote.validate import frontier_candidates, validate_frontier
    from .campaign import CampaignError
    from .engine.checkpoint import CheckpointError
    from .traffic import ARRIVAL_PRESETS, TRAFFIC_PRESETS

    protocols = args.protocols.split(",")
    unknown = [p for p in protocols if p not in ENGINE_PROTOCOLS]
    if unknown:
        raise SystemExit(
            f"unknown protocol(s) {unknown}; choose from "
            f"{','.join(ENGINE_PROTOCOLS)}"
        )
    traffic = args.traffic.split(",")
    bad = [t for t in traffic if t not in TRAFFIC_PRESETS]
    if bad:
        raise SystemExit(
            f"unknown traffic preset(s) {bad}; choose from "
            f"{','.join(TRAFFIC_PRESETS)}"
        )
    if args.rank_by == "knee":
        if args.arrival not in ARRIVAL_PRESETS or args.arrival == "closed":
            open_presets = [a for a in ARRIVAL_PRESETS if a != "closed"]
            raise SystemExit(
                f"unknown arrival preset {args.arrival!r}; choose "
                f"from {','.join(open_presets)}"
            )
        carry_think = [t for t in traffic if t in ("diurnal", "flash")]
        if carry_think:
            raise SystemExit(
                f"--traffic {','.join(carry_think)} carries think "
                "delays, which open-loop arrivals replace; --rank-by "
                "knee combines with flat or churn traffic"
            )
    device = resolve_device(args.device)
    planet = _planet(args)
    params = RankingParams(
        min_mean_fpaxos_improv=args.min_mean_improv,
        min_fairness_fpaxos_improv=args.min_fairness_improv,
        min_n=args.n,
        max_n=args.n,
        ft_metric=args.metric,
    )
    try:
        candidates = frontier_candidates(
            planet, args.n, args.top, params=params, device=device
        )
    except ValueError as e:
        raise SystemExit(str(e))
    try:
        artifact, summary = validate_frontier(
            args.dir,
            planet=planet,
            candidates=candidates,
            protocols=protocols,
            fs=args.fs or [1],
            conflicts=args.conflicts,
            traffic=traffic,
            commands=args.commands,
            clients_per_region=args.clients_per_region,
            pool_size=args.pool_size,
            batch_lanes=args.batch_lanes,
            segment_steps=args.segment_steps,
            aws=bool(args.aws),
            resume=args.resume,
            budget_s=args.budget_s,
            dryrun=args.dryrun,
            out=args.out,
            rank_by=args.rank_by,
            arrival=args.arrival,
            loads=args.loads,
            open_window=args.open_window,
            mean_gap_ms=args.mean_gap_ms,
            knee_mult=args.knee_mult,
            device=device,
        )
    except (CheckpointError, CampaignError) as e:
        _refuse("bote validate", f"{type(e).__name__}: {e}")
    print(json.dumps(summary))
    if artifact is None:
        print(
            f"validation interrupted ({summary['interrupted']}); the "
            "campaign is checkpointed — re-run with --resume to "
            "continue",
            file=sys.stderr,
        )
        raise SystemExit(EXIT_INTERRUPTED)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="fantoch_tpu_torch")
    parser.add_argument(
        "--device", default="cuda",
        help="torch device (default cuda; 'cpu' runs the plain PyTorch "
        "twins of the kernels)",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    sw = sub.add_parser("sweep", help="batched device-engine sweep")
    sw.add_argument("--protocol", required=True)
    sw.add_argument("--n", type=int, default=3)
    sw.add_argument("--regions", type=lambda s: s.split(","), default=None,
                    help="comma-separated region names (one region set)")
    sw.add_argument("--aws", action="store_true",
                    help="use the AWS planet instead of GCP")
    sw.add_argument("--commands", type=int, default=100,
                    help="commands per client")
    sw.add_argument("--clients-per-region", type=int, default=1)
    sw.add_argument("--conflict", type=int, default=None)
    sw.add_argument("--conflicts", type=_ints, default=[0, 10, 50, 100])
    sw.add_argument("--fs", type=_ints, default=None)
    sw.add_argument("--subsets", type=int, default=16,
                    help="number of n-region subsets when --regions unset")
    sw.add_argument("--pool-size", type=int, default=1,
                    help="ConflictPool shared-key pool size")
    sw.add_argument("--zipf", default=None,
                    help="coef,keys — Zipf key generator instead of pool")
    sw.add_argument("--gc-interval", type=int, default=100)
    sw.add_argument("--detached-interval", type=int, default=100,
                    help="Tempo: ms between detached-vote sends")
    sw.add_argument("--clock-bump-interval", type=int, default=None,
                    help="Tempo: ms between real-time clock bumps "
                    "(default: none)")
    sw.add_argument("--no-wait-condition", action="store_true",
                    help="Caesar: reply to a blocked proposal at once "
                    "(reject) instead of waiting")
    sw.add_argument("--extra-time", type=int, default=1000)
    sw.add_argument("--dot-slots", type=int, default=None)
    sw.add_argument("--shards", type=int, default=1,
                    help="partial replication: shard count (tempo, "
                    "atlas)")
    sw.add_argument("--keys-per-command", type=int, default=2,
                    help="keys per command when --shards > 1")
    sw.add_argument("--batch-lanes", type=int, default=512,
                    help="lanes per device batch")
    sw.add_argument(
        "--pipeline-depth",
        type=int,
        default=2,
        help="segments kept in flight by the sweep driver "
        "(parallel/pipeline.py): dispatch overlaps device execution; "
        "1 = the serial reference loop (byte-identical results)",
    )
    sw.add_argument(
        "--scan-window",
        type=int,
        default=None,
        help="segments scan-fused into ONE device call "
        "(parallel/sweep.py): host round-trips drop from per-segment "
        "to per-window, byte-identical results; default derives from "
        "segment_steps, 1 = the serial segment loop",
    )
    sw.add_argument(
        "--faults", default=None,
        help="fault-plan spec: JSON object/list or @file; each sweep "
        'point runs once per plan ({} = fault-free), e.g. '
        '\'[{}, {"crash": {"1": 200}}, {"windows": [{"src": 0, '
        '"dst": 1, "t0": 0, "t1": 500, "delay": "inf"}], '
        '"horizon": 5000}]\' (lossy plans need a horizon)',
    )
    sw.add_argument(
        "--traffic", default=None,
        help="time-varying traffic preset applied to every sweep point "
        "(flat,diurnal,flash,churn); presets compose with each point's "
        "conflict rate; flat/omitted = the static workload",
    )
    sw.add_argument(
        "--arrivals", default=None,
        help="open-loop arrival preset applied to every sweep point "
        "(poisson,burst,ramp): commands are timestamped by seeded "
        "arrival draws independent of completion, a bounded in-flight "
        "window queues the rest, and queue delay counts into latency; "
        "omitted = closed loop",
    )
    sw.add_argument(
        "--offered-load", type=int, default=100,
        help="open-loop offered load as a percent of the preset's base "
        "arrival rate (100 = as authored; 200 = halved gaps)",
    )
    sw.add_argument(
        "--open-window", type=int, default=4,
        help="open-loop in-flight cap per client; arrivals beyond it "
        "wait in the arrival queue (their wait lands in latency)",
    )
    sw.add_argument(
        "--arrival-gap-ms", type=int, default=4,
        help="open-loop base mean inter-arrival gap in ms at 100%% load",
    )
    sw.add_argument(
        "--aot-dir", default=None,
        help="the reference's serialized sweep executable; refused (exit "
        "2): the port builds its CUDA kernels at first use and has no "
        "executable to share",
    )
    sw.add_argument("--out", default=None, help="results JSONL path")
    sw.set_defaults(fn=cmd_sweep)

    mc = sub.add_parser(
        "mc",
        help="device-scale schedule fuzzing with safety monitors "
        "(mc/fuzz.py); --replay re-executes a repro artifact",
    )
    mc.add_argument("--protocols", default="tempo,fpaxos,atlas",
                    help="comma-separated engine protocols to fuzz")
    mc.add_argument("--ns", type=_ints, default=[3, 5],
                    help="replica counts (one fuzz point per value)")
    mc.add_argument("--f", type=int, default=1)
    mc.add_argument("--conflict", type=int, default=100)
    mc.add_argument("--pool-size", type=int, default=1)
    mc.add_argument("--commands", type=int, default=5,
                    help="commands per client")
    mc.add_argument("--clients-per-region", type=int, default=1)
    mc.add_argument("--schedules", type=int, default=512,
                    help="perturbed schedules per (protocol, n) point")
    mc.add_argument("--seed", type=int, default=0,
                    help="root PRNG key (plans + workload)")
    mc.add_argument("--jitter-max", type=int, default=8,
                    help="per-message delay multiplier bound")
    mc.add_argument("--crash-share", type=float, default=0.2)
    mc.add_argument("--drop-share", type=float, default=0.15)
    mc.add_argument("--budget-s", type=float, default=None,
                    help="wall-clock guard: skip grid points past this "
                    "(--farm: stop at the next chunk boundary, exit 75)")
    mc.add_argument("--max-confirm", type=int, default=8,
                    help="flagged lanes host-confirmed per point")
    mc.add_argument("--shrink-budget", type=int, default=150,
                    help="host-oracle runs per shrink")
    mc.add_argument("--strict-missing", action="store_true",
                    help="treat missing-execution as a finding")
    mc.add_argument("--no-confirm", action="store_true",
                    help="skip host confirmation (device flags only)")
    mc.add_argument("--inject-bug", action="store_true",
                    help="fuzz the deliberately broken Tempo twin "
                    "(pipeline self-check)")
    mc.add_argument("--aws", action="store_true")
    mc.add_argument("--out", default=None,
                    help="directory for repro artifacts")
    mc.add_argument("--replay", default=None,
                    help="re-execute a repro artifact (host oracle)")
    mc.add_argument(
        "--coverage-dir", default=None,
        help="persist per-point coverage maps + seed pools here and "
        "draw coverage-steered plans (mc/coverage.py): repeated "
        "invocations accumulate distinct-interleaving coverage; a "
        "stored map whose point signature disagrees is refused (exit 2)",
    )
    mc.add_argument(
        "--farm", default=None, metavar="DIR",
        help="run the standing fuzz farm in DIR instead of a one-shot "
        "grid: a durable coverage campaign with fault-class-sharded "
        "points (--classes), frontier-weighted mutation, plateau "
        "retirement (--retire-after) and binary coverage maps; "
        "re-running the identical command resumes, a drifted one is "
        "refused (exit 2); exits 0 drained, 75 interrupted",
    )
    mc.add_argument("--chunk", type=int, default=128,
                    help="farm mode: schedules per journaled chunk")
    mc.add_argument(
        "--classes", default="crash,drop,jitter,mixed",
        help="farm mode: comma-separated fault classes to shard each "
        "(protocol, n) point into, each with its own PRNG streams and "
        "coverage map; 'mixed' alone is the unsharded unit",
    )
    mc.add_argument(
        "--retire-after", type=int, default=0,
        help="farm mode: retire a point after this many consecutive "
        "chunks with zero new coverage buckets; 0 = never retire",
    )
    mc.add_argument(
        "--migrate-covmaps", default=None, metavar="DIR",
        help="convert a --coverage-dir's JSON point states to the "
        "binary covmap format (mc/covmap.py), proving each conversion "
        "lossless by round trip; the JSON files are left untouched",
    )
    mc.set_defaults(fn=cmd_mc)

    ca = sub.add_parser(
        "campaign",
        help="durable, resumable sweep/fuzz campaigns with "
        "checkpoint/restore (campaign/)",
    )
    ca.add_argument("--dir", required=True,
                    help="campaign directory (journal, checkpoints, "
                    "artifacts, results)")
    ca.add_argument(
        "--grid", default=None,
        help="campaign spec: JSON object or @file, e.g. "
        '\'{"kind": "sweep", "protocols": ["tempo"], "ns": [3, 5], '
        '"conflicts": [0, 100], "subsets": 4}\' or '
        '\'{"kind": "fuzz", "protocols": ["tempo"], "ns": [3], '
        '"schedules": 2048, "chunk": 256}\' (required for a new '
        "campaign; optional but verified with --resume)",
    )
    ca.add_argument("--resume", action="store_true",
                    help="continue the campaign stored in --dir exactly "
                    "where it stopped")
    ca.add_argument("--budget-s", type=float, default=None,
                    help="wall-clock budget: make at least one unit of "
                    "progress, then checkpoint and exit 75 at the next "
                    "boundary once exceeded")
    ca.add_argument("--stop-after-segments", type=int, default=None,
                    help="deterministic interruption: checkpoint and "
                    "exit 75 after N sweep segments")
    ca.set_defaults(fn=cmd_campaign)

    fl = sub.add_parser(
        "fleet",
        help="lease-sharded multi-worker campaigns over one shared "
        "campaign dir (fleet/): preemptible workers claim, checkpoint, "
        "resume and journal units; --merge writes the deterministic "
        "merged results",
    )
    fl.add_argument("--dir", required=True,
                    help="shared campaign directory (spec, leases, "
                    "worker journals, checkpoints, merged results)")
    fl.add_argument("--grid", default=None,
                    help="campaign spec: JSON object or @file (same "
                    "schema as `campaign --grid`, incl. fuzz-grid "
                    '"coverage": true for fleet-steered budgets; '
                    '"aot", "shard_lanes" and "mesh_shard" are refused); '
                    "required on first touch, optional-but-verified "
                    "afterwards")
    fl.add_argument("--worker-id", default=None,
                    help="run ONE worker loop in this process under "
                    "this id ([A-Za-z0-9_-], at most 64, not lock, stale "
                    "or tmp); exits 0 when the whole grid is journaled, "
                    "75 with work remaining")
    fl.add_argument("--workers", type=int, default=None,
                    help="convenience mode: spawn N subprocess workers "
                    "(ids w0..wN-1) and wait; re-spawns in rounds "
                    "while progress is possible")
    fl.add_argument("--budget-s", type=float, default=None,
                    help="per-worker wall-clock budget: at least one "
                    "unit of progress, then checkpoint + release at "
                    "the next boundary")
    fl.add_argument("--ttl-s", type=float, default=None,
                    help="lease TTL seconds (default "
                    "fleet.DEFAULT_TTL_S); a dead worker's unit is "
                    "reclaimable once its lease mtime is older than "
                    "this — heartbeats refresh it at TTL/4")
    fl.add_argument("--merge", action="store_true",
                    help="after any workers finish: merge every worker "
                    "journal into the canonical results.jsonl/"
                    "summary.json (byte-identical to a 1-worker "
                    "control); exits 75 if units are missing")
    fl.add_argument("--stop-after-units", type=int, default=None,
                    help="test hook: stop this worker after N "
                    "completed units")
    fl.add_argument("--stop-after-segments", type=int, default=None,
                    help="test hook: interrupt each claimed sweep unit "
                    "after N segments (checkpoint durable, lease "
                    "released — the unit returns to the pool)")
    fl.add_argument(
        "--farm", action="store_true",
        help="assert the campaign is a standing fuzz farm (a fuzz "
        "grid with coverage + binary_maps); a non-farm spec is refused "
        "(exit 2) before any worker claims a unit",
    )
    fl.set_defaults(fn=cmd_fleet)

    kn = sub.add_parser(
        "knee",
        help="measured throughput-latency knee sweep: an open-loop "
        "arrival preset at a ladder of offered loads, through the "
        "campaign manager, emitting latency-vs-offered-load curves and "
        "the located knee as knee.json (serving/knee.py)",
    )
    kn.add_argument("--dir", required=True,
                    help="campaign/artifact directory")
    kn.add_argument("--protocols", default="tempo,fpaxos",
                    help="comma-separated engine protocols")
    kn.add_argument("--ns", type=_ints, default=[3],
                    help="region-set sizes when --regions unset")
    kn.add_argument("--regions", type=lambda s: s.split(","),
                    default=None,
                    help="comma-separated region names (default: the "
                    "campaign manager's per-n default sets)")
    kn.add_argument("--arrival", default="poisson",
                    help="open-loop arrival preset (poisson,burst,ramp)")
    kn.add_argument("--loads", type=_ints, default=[50, 100, 200, 400],
                    help="offered-load ladder as percent of the preset's "
                    "base rate")
    kn.add_argument("--traffic", default="flat",
                    help="comma-separated traffic presets (flat,churn; "
                    "diurnal/flash carry think delays and are refused)")
    kn.add_argument("--fs", type=_ints, default=None)
    kn.add_argument("--conflicts", type=_ints, default=[100])
    kn.add_argument("--commands", type=int, default=20,
                    help="commands per client per lane")
    kn.add_argument("--clients-per-region", type=int, default=1)
    kn.add_argument("--open-window", type=int, default=4,
                    help="open-loop in-flight cap per client")
    kn.add_argument("--mean-gap-ms", type=int, default=4,
                    help="base mean inter-arrival gap in ms at 100%% "
                    "load")
    kn.add_argument("--knee-mult", type=float, default=3.0,
                    help="knee threshold: first load whose p99 exceeds "
                    "this multiple of the lowest load's p99")
    kn.add_argument("--batch-lanes", type=int, default=64)
    kn.add_argument("--segment-steps", type=int, default=2048)
    kn.add_argument("--aws", action="store_true")
    kn.add_argument("--resume", action="store_true",
                    help="continue an interrupted knee campaign")
    kn.add_argument("--budget-s", type=float, default=None)
    kn.add_argument("--dryrun", action="store_true",
                    help="skip the device sweeps; emit the artifact shell "
                    "with points: null (schema-check path)")
    kn.add_argument("--out", default=None,
                    help="knee artifact path (default <dir>/knee.json)")
    kn.set_defaults(fn=cmd_knee)

    bt = sub.add_parser(
        "bote",
        help="closed-form latency config search (one K15 launch per n); "
        "--validate runs measured sweep campaigns over the top "
        "candidates and emits a closed-form-vs-measured frontier "
        "artifact (bote/validate.py)",
    )
    bt.add_argument("--metric", default="f1", choices=["f1", "f1f2"])
    bt.add_argument("--min-mean-improv", type=float, default=0.0)
    bt.add_argument("--min-fairness-improv", type=float, default=0.0)
    bt.add_argument("--min-n", type=int, default=3)
    bt.add_argument("--max-n", type=int, default=7)
    bt.add_argument("--top", type=int, default=3)
    bt.add_argument("--aws", action="store_true")
    bt.add_argument("--validate", action="store_true",
                    help="validate the top candidates with measured "
                    "sweep campaigns (resumable; exits 75 when "
                    "interrupted — re-run with --resume)")
    bt.add_argument("--dir", default=None,
                    help="campaign/artifact directory (required with "
                    "--validate)")
    bt.add_argument("--n", type=int, default=5,
                    help="candidate region-set size to validate")
    bt.add_argument("--protocols", default="atlas,fpaxos",
                    help="engine protocols for the measured sweeps")
    bt.add_argument("--fs", type=_ints, default=None)
    bt.add_argument("--conflicts", type=_ints, default=[0, 100])
    bt.add_argument("--traffic", default="flat",
                    help="comma-separated traffic presets "
                    "(flat,diurnal,flash,churn) — one measured axis "
                    "per preset")
    bt.add_argument("--commands", type=int, default=20,
                    help="commands per client per measured lane")
    bt.add_argument("--clients-per-region", type=int, default=1)
    bt.add_argument("--pool-size", type=int, default=1)
    bt.add_argument("--batch-lanes", type=int, default=64)
    bt.add_argument("--segment-steps", type=int, default=2048)
    bt.add_argument("--rank-by", default="score",
                    choices=["score", "knee"],
                    help="knee: replace the closed-loop conflict grid "
                    "with an open-loop offered-load ladder "
                    "(serving/knee.py) and re-rank candidates by their "
                    "measured throughput-latency knee")
    bt.add_argument("--arrival", default="poisson",
                    help="open-loop arrival preset for --rank-by knee "
                    "(poisson,burst,ramp)")
    bt.add_argument("--loads", type=_ints, default=None,
                    help="offered-load ladder (percent of base rate) "
                    "for --rank-by knee; default 50,100,200,400")
    bt.add_argument("--open-window", type=int, default=4,
                    help="open-loop in-flight cap per client "
                    "(--rank-by knee)")
    bt.add_argument("--mean-gap-ms", type=int, default=4,
                    help="base mean inter-arrival gap in ms at 100%% "
                    "load (--rank-by knee)")
    bt.add_argument("--knee-mult", type=float, default=None,
                    help="knee threshold: first load whose p99 exceeds "
                    "this multiple of the lowest load's p99 "
                    "(default 3.0)")
    bt.add_argument("--resume", action="store_true",
                    help="continue an interrupted validation campaign")
    bt.add_argument("--budget-s", type=float, default=None)
    bt.add_argument("--dryrun", action="store_true",
                    help="skip the measured sweeps; emit the frontier "
                    "artifact with measured: null (schema-check path)")
    bt.add_argument("--out", default=None,
                    help="frontier artifact path (default "
                    "<dir>/frontier.json)")
    bt.set_defaults(fn=cmd_bote)

    sim = sub.add_parser(
        "sim", help="one exact run of the host simulator (no device)")
    sim.add_argument("--protocol", required=True, choices=ORACLE_PROTOCOLS)
    sim.add_argument("--n", type=int, default=3)
    sim.add_argument("--regions", type=lambda s: s.split(","), default=None,
                     help="comma-separated region names (default: first n "
                     "of planet)")
    sim.add_argument("--aws", action="store_true",
                     help="use the AWS planet instead of GCP")
    sim.add_argument("--commands", type=int, default=100,
                     help="commands per client")
    sim.add_argument("--clients-per-region", type=int, default=1)
    sim.add_argument("--conflict", type=int, default=100)
    sim.add_argument("--pool-size", type=int, default=1,
                     help="ConflictPool shared-key pool size")
    sim.add_argument("--zipf", default=None,
                     help="coef,keys — Zipf key generator instead of pool")
    sim.add_argument("--gc-interval", type=int, default=100)
    sim.add_argument("--detached-interval", type=int, default=100)
    sim.add_argument("--clock-bump-interval", type=int, default=None)
    sim.add_argument("--no-wait-condition", action="store_true")
    sim.add_argument("--extra-time", type=int, default=1000)
    sim.add_argument("--seed", type=int, default=0)
    sim.add_argument("--arrivals", default=None,
                     help="open-loop arrival preset (poisson,burst,ramp); "
                     "mirrors the engine's open-loop client mode exactly")
    sim.add_argument("--offered-load", type=int, default=100,
                     help="open-loop offered load (percent of base)")
    sim.add_argument("--open-window", type=int, default=4,
                     help="open-loop in-flight cap per client")
    sim.add_argument("--arrival-gap-ms", type=int, default=4,
                     help="base mean inter-arrival gap (ms) at 100%% load")
    sim.add_argument("--f", type=int, default=1)
    sim.add_argument("--reorder", action="store_true")
    sim.set_defaults(fn=cmd_sim)
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
