"""Command line: ``python -m fantoch_tpu_torch [--device cpu] sweep ...``.

The ``sweep`` subcommand runs the batched engine over a (region subset
× f × conflict) grid and prints the reference CLI's summary JSON (the
keys that apply to this slice: closed-loop, flat-traffic, fault-free
sweeps). It runs on the CUDA card unless ``--device cpu`` is given.
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
# Caesar (with the wait condition, the reference's default) and Tempo
# under partial replication; chip_smoke.py and step_profile.py drive them
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
MAIN_PATHS = {"basic": MAIN_PATH, "fpaxos": MAIN_PATH_FPAXOS,
              "tempo": MAIN_PATH_TEMPO, "atlas": MAIN_PATH_ATLAS,
              "epaxos": MAIN_PATH_EPAXOS, "caesar": MAIN_PATH_CAESAR,
              "tempo_partial": MAIN_PATH_TEMPO_PARTIAL}


def _ints(s: str) -> List[int]:
    return [int(x) for x in s.split(",") if x != ""]


def sweep_setup(args):
    """``(protocol, dims, specs)`` of a ``sweep`` command line: the
    region subsets, dims and grid exactly as ``cmd_sweep`` runs them."""
    from .engine import EngineDims
    from .engine.protocols import (
        dev_config_kwargs, dev_protocol, partial_dev_protocol,
    )
    from .parallel.sweep import make_sweep_specs

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
            dev = dev_protocol(args.protocol, clients)
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
    )
    return dev, dims, specs


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
        dev, dims, specs, batch_lanes=args.batch_lanes, device=device
    )
    errs = sum(1 for r in results if r.err)
    print(json.dumps({
        "protocol": args.protocol,
        "traffic": "flat",
        "arrivals": "closed",
        "points": len(specs),
        "errors": errs,
        "error_causes": sorted({r.err_cause for r in results if r.err}),
        "stalled_lanes": sum(1 for r in results if r.requeues),
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
                    help="partial replication: shard count (tempo)")
    sw.add_argument("--keys-per-command", type=int, default=2,
                    help="keys per command when --shards > 1")
    sw.add_argument("--batch-lanes", type=int, default=512,
                    help="lanes per device batch")
    sw.set_defaults(fn=cmd_sweep)
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
