"""Command line: ``python -m fantoch_tpu_torch [--device cpu] sweep ...``
and ``... mc --no-confirm ...``.

The ``sweep`` subcommand runs the batched engine over a (region subset
× f × conflict) grid, each point once per fault plan of ``--faults``,
under an optional traffic schedule (``--traffic``) or open-loop arrival
process (``--arrivals``, ``--offered-load``, ``--open-window``,
``--arrival-gap-ms``), each batch in segments of the device loop
(``--scan-window`` segments a device call, ``--pipeline-depth`` calls
in flight), and prints the reference CLI's summary JSON. The
``mc`` subcommand fuzzes a
(protocol × n) grid of schedules with the safety monitors on
(``mc/fuzz.py``) and prints the reference's summary JSON; it runs only
under ``--no-confirm``, since confirmation needs the host oracle. Both
run on the CUDA card unless ``--device cpu`` is given.
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

    planet = (
        Planet.from_dataset("latency_aws_2021_02_13") if args.aws
        else Planet.new()
    )
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
    the GC interval, for Tempo the detached-send interval and the
    optional real-time clock bump, for Caesar the wait condition."""
    kw = dict(gc_interval_ms=args.gc_interval)
    if args.protocol == "tempo":
        kw["tempo_detached_send_interval_ms"] = args.detached_interval
        if args.clock_bump_interval:
            kw["tempo_clock_bump_interval_ms"] = args.clock_bump_interval
    if args.protocol == "caesar":
        kw["caesar_wait_condition"] = not args.no_wait_condition
    return kw


def cmd_sweep(args) -> None:
    from . import resolve_device
    from .parallel.sweep import run_sweep

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
    print(json.dumps(summary))


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


def _mc_refuse(what: str, item: str) -> None:
    print(f"mc refused: {what} is not ported yet (ROADMAP Queue A item "
          f"{item})", file=sys.stderr)
    raise SystemExit(2)


def cmd_mc(args) -> None:
    """Device-scale schedule fuzzing (``mc/fuzz.py``) over a (protocol ×
    n) grid: per point one batch of perturbed schedules with the safety
    monitors on; prints each point's summary on stderr and the grid's
    summary JSON (the reference's keys) on stdout. Confirmation,
    shrinking and ``--replay`` need the host oracle (item 17), the
    coverage map and the farm the campaign drivers (item 14): each is
    refused by name, exit 2, before any lane runs."""
    import time

    from . import resolve_device
    from .mc.fuzz import HOST_ORACLE_ITEM, run_fuzz_point

    if args.replay:
        _mc_refuse("--replay (the host oracle)", HOST_ORACLE_ITEM)
    for flag, value in (("--farm", args.farm),
                        ("--coverage-dir", args.coverage_dir),
                        ("--migrate-covmaps", args.migrate_covmaps)):
        if value:
            _mc_refuse(f"{flag} (the campaign drivers)", "14")
    if not args.no_confirm:
        _mc_refuse("host confirmation (run with --no-confirm)",
                   HOST_ORACLE_ITEM)
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
    device = resolve_device(args.device)
    planet = (Planet.from_dataset("latency_aws_2021_02_13") if args.aws
              else Planet.new())
    points = []
    skipped_points = 0
    t0 = time.perf_counter()
    for spec in mc_specs(args):
        if args.budget_s and time.perf_counter() - t0 > args.budget_s:
            skipped_points += 1
            continue
        res = run_fuzz_point(
            spec, planet=planet, confirm=False,
            max_confirmations=args.max_confirm,
            strict_missing=args.strict_missing, device=device,
        )
        point = res.summary()
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
        # repro artifacts come from confirmed, shrunk lanes only
        "artifacts": [],
        "grid": points,
    }))


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
    sw.set_defaults(fn=cmd_sweep)

    mc = sub.add_parser(
        "mc",
        help="device-scale schedule fuzzing with safety monitors "
        "(mc/fuzz.py); runs under --no-confirm",
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
                    help="wall-clock guard: skip grid points past this")
    mc.add_argument("--max-confirm", type=int, default=8,
                    help="flagged lanes listed per point")
    mc.add_argument("--strict-missing", action="store_true",
                    help="treat missing-execution as a finding")
    mc.add_argument("--no-confirm", action="store_true",
                    help="skip host confirmation (device flags only); "
                    "required: confirmation needs the host oracle")
    mc.add_argument("--inject-bug", action="store_true",
                    help="fuzz the deliberately broken Tempo twin "
                    "(pipeline self-check)")
    mc.add_argument("--aws", action="store_true")
    for flag in ("--replay", "--coverage-dir", "--farm",
                 "--migrate-covmaps"):
        mc.add_argument(flag, default=None,
                        help="refused: not ported yet")
    mc.set_defaults(fn=cmd_mc)
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
