"""The measured throughput–latency knee (the port's copy of the JAX
package's ``serving/knee.py``; its sweeps run open-loop batches, K6's
open-loop branch, on the CUDA card unless given ``device="cpu"``).

A knee sweep runs one open-loop arrival preset at a ladder of offered
loads (percent of the preset's base rate) per (protocol, planet,
traffic) point, through the campaign manager — every batch is
journaled, the in-flight batch checkpoints at segment boundaries, and
a SIGKILLed sweep resumes byte-identically. Once the grid completes,
the per-point latency-vs-offered-load curves (p50/p99/mean + goodput)
and the located knee — the first load whose p99 exceeds
``knee_mult`` × the lowest load's p99 — are written as one canonical
atomic ``knee.json`` artifact.

Latency here is the open loop's queue-delay-inclusive latency
(engine/core.py step 5): completion time minus *arrival* time, so a
saturated point's arrival-queue wait lands in the curve instead of
being coordinated-omission'd away. Goodput is completed commands per
second of offered window (the span of the lane's arrival table), a
host-side derivation from journaled lane results — no extra device
work.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.metrics import Histogram

KNEE_ARTIFACT = "knee.json"
KNEE_KIND = "serving-knee"
KNEE_VERSION = 1

# offered-load ladder (percent of the arrival preset's base rate) and
# the knee multiplier: p99(load) > KNEE_MULT * p99(loads[0]) locates it
DEFAULT_LOADS = (50, 100, 200, 400)
DEFAULT_KNEE_MULT = 3.0


def knee_campaign(
    *,
    protocols: Sequence[str],
    ns: Sequence[int] = (3,),
    region_sets=None,
    arrival: str = "poisson",
    loads: Sequence[int] = DEFAULT_LOADS,
    traffic: Sequence[str] = ("flat",),
    fs: Sequence[int] = (1,),
    conflicts: Sequence[int] = (100,),
    commands_per_client: int = 20,
    clients_per_region: int = 1,
    open_window: int = 4,
    mean_gap_ms: int = 4,
    batch_lanes: int = 64,
    segment_steps: int = 2048,
    aws: bool = False,
):
    """The knee sweep's campaign spec: the arrival preset at every
    offered load, each (preset, load) point its own batch group
    (campaign/manager.py ``arrivals`` axis)."""
    from ..campaign.manager import SweepCampaign

    assert arrival != "closed", (
        "a knee sweep needs an open-loop arrival process; 'closed' "
        "has no offered-load axis"
    )
    kw = dict(
        protocols=tuple(protocols),
        ns=tuple(int(n) for n in ns),
        fs=tuple(int(f) for f in fs),
        conflicts=tuple(int(c) for c in conflicts),
        traffic=tuple(traffic),
        arrivals=(arrival,),
        offered_loads=tuple(int(l) for l in loads),
        open_window=int(open_window),
        mean_gap_ms=int(mean_gap_ms),
        commands_per_client=int(commands_per_client),
        clients_per_region=int(clients_per_region),
        batch_lanes=int(batch_lanes),
        segment_steps=int(segment_steps),
        aws=aws,
    )
    if region_sets is not None:
        kw["region_sets"] = tuple(tuple(r) for r in region_sets)
    return SweepCampaign(**kw)


def _arrival_load(meta: dict) -> int:
    """The offered load of a lane's arrival meta: ``scale`` renames a
    scaled schedule to ``<preset>@<load>`` (traffic/schedule.py);
    an unsuffixed name is the base 100% point."""
    name = meta["name"]
    return int(name.split("@", 1)[1]) if "@" in name else 100


def _offered_span_ms(lane) -> int:
    """The offered window of a lane: the latest per-client arrival of
    a budgeted command (columns 1..commands of the ctx table; the
    final column is the staging lookahead slot, never offered)."""
    table = lane.ctx["ol_arrival"]
    commands = table.shape[1] - 2
    return max(1, int(table[:, commands].max()))


def collect_curves(path: str, spec) -> Dict[Tuple[str, ...], dict]:
    """Aggregate a completed knee campaign's journal into measured
    curves: candidate regions → protocol → load → {mean, p50, p99,
    count, goodput_cps, lanes, errors}. Lane → (protocol, load)
    attribution re-enumerates the deterministic batch order (the same
    alignment ``_run_sweep_campaign`` journals by); each point's lanes
    (fault plans, conflicts, fs) merge into one histogram."""
    from ..campaign.manager import _read_journal, _sweep_batches
    from ..engine.results import LaneResults

    done: Dict[str, List[dict]] = {}
    for entry in _read_journal(path):
        if entry.get("kind") == "batch":
            done[entry["id"]] = entry["results"]

    hists: Dict[tuple, Histogram] = {}
    acc: Dict[tuple, dict] = {}
    for key, _dev, _dims, lanes in _sweep_batches(spec):
        rows = done.get(key)
        assert rows is not None and len(rows) == len(lanes), (
            f"campaign journal incomplete at batch {key!r}; collect "
            "knee curves only from a completed campaign"
        )
        proto = key.split("/", 1)[0]
        for lane, row in zip(lanes, rows):
            assert lane.arrival_meta is not None, (
                f"closed-loop lane in knee batch {key!r}"
            )
            res = LaneResults.from_json(row)
            point = (
                tuple(lane.process_regions),
                proto,
                _arrival_load(lane.arrival_meta),
            )
            hist = hists.setdefault(point, Histogram())
            slot = acc.setdefault(
                point,
                {
                    "lanes": 0,
                    "errors": 0,
                    "completed": 0,
                    "span_ms": 0,
                    "error_cause": None,
                },
            )
            slot["lanes"] += 1
            if res.err:
                # an errored lane's partial histogram must never shape
                # a curve point — carry the cause, null the stats below
                slot["errors"] += 1
                slot["error_cause"] = res.err_cause
                continue
            for region in lane.region_rows:
                hist.merge(res.histogram(region))
            slot["completed"] += int(res.completed)
            slot["span_ms"] = max(slot["span_ms"], _offered_span_ms(lane))

    out: Dict[Tuple[str, ...], dict] = {}
    for (regions, proto, load), slot in acc.items():
        hist = hists[(regions, proto, load)]
        if slot["errors"]:
            stats = {
                "mean": None,
                "p50": None,
                "p99": None,
                "count": hist.count(),
                "goodput_cps": None,
                "error_cause": slot["error_cause"],
            }
        else:
            stats = {
                "mean": round(hist.mean(), 3),
                "p50": round(hist.percentile(0.5), 3),
                "p99": round(hist.percentile(0.99), 3),
                "count": hist.count(),
                "goodput_cps": round(
                    slot["completed"] * 1000.0 / slot["span_ms"], 3
                ),
            }
        stats["lanes"] = slot["lanes"]
        stats["errors"] = slot["errors"]
        out.setdefault(regions, {}).setdefault(proto, {})[
            str(load)
        ] = stats
    return out


def locate_knee(
    curve: Dict[str, dict], knee_mult: float = DEFAULT_KNEE_MULT
) -> Optional[int]:
    """The knee of one measured curve (load → stats): the first load,
    ascending, whose p99 exceeds ``knee_mult`` × the lowest load's
    p99. None when the curve never leaves the baseline envelope (not
    saturated within the swept ladder) or the baseline itself errored."""
    loads = sorted(int(l) for l in curve)
    base = curve[str(loads[0])].get("p99")
    if base is None:
        return None
    for load in loads[1:]:
        p99 = curve[str(load)].get("p99")
        if p99 is not None and p99 > knee_mult * max(base, 1e-9):
            return load
    return None


def build_knee_artifact(
    spec,
    *,
    measured: "Dict[Tuple[str, ...], dict] | None",
    knee_mult: float = DEFAULT_KNEE_MULT,
    dryrun: bool = False,
) -> dict:
    """The canonical knee artifact (docs/CAMPAIGN.md "Knee
    artifacts"): sweep parameters, per-(regions, protocol) curves, and
    each curve's located knee. ``dryrun`` emits the parameter shell
    with ``points: null`` — the CI schema check's fast path."""
    points = None
    if measured is not None:
        points = [
            {
                "regions": list(regions),
                "protocol": proto,
                "curve": {
                    str(load): curve[str(load)]
                    for load in sorted(int(l) for l in curve)
                },
                "knee": locate_knee(curve, knee_mult),
            }
            for regions, protos in sorted(measured.items())
            for proto, curve in sorted(protos.items())
        ]
    return {
        "kind": KNEE_KIND,
        "version": KNEE_VERSION,
        "planet": "aws" if spec.aws else "gcp",
        "protocols": list(spec.protocols),
        "arrival": spec.arrivals[0],
        "loads": [int(l) for l in spec.offered_loads],
        "knee_mult": float(knee_mult),
        "open_window": int(spec.open_window),
        "mean_gap_ms": int(spec.mean_gap_ms),
        "traffic": list(spec.traffic),
        "fs": [int(f) for f in spec.fs],
        "conflicts": [int(c) for c in spec.conflicts],
        "commands_per_client": int(spec.commands_per_client),
        "clients_per_region": int(spec.clients_per_region),
        "dryrun": bool(dryrun),
        "points": points,
    }


def check_knee_artifact(obj: dict) -> None:
    """Schema gate for the knee artifact (the CI openloop-smoke job
    pins this): required keys, per-point curves covering every swept
    load with numeric p50/p99/goodput (or nulls + a cause on errored
    points), and a knee that is either null or one of the swept
    loads."""
    for k in (
        "kind", "version", "planet", "protocols", "arrival", "loads",
        "knee_mult", "open_window", "mean_gap_ms", "traffic", "fs",
        "conflicts", "commands_per_client", "clients_per_region",
        "dryrun", "points",
    ):
        assert k in obj, f"knee artifact missing {k!r}"
    assert obj["kind"] == KNEE_KIND, obj["kind"]
    assert obj["arrival"] != "closed", "knee artifacts are open-loop"
    assert obj["loads"], "knee artifact has no offered-load ladder"
    if obj["dryrun"]:
        assert obj["points"] is None, (
            "dryrun artifacts must not claim measured curves"
        )
        return
    points = obj["points"]
    assert points, "knee artifact has no measured points"
    seen = set()
    for point in points:
        for k in ("regions", "protocol", "curve", "knee"):
            assert k in point, f"knee point missing {k!r}"
        seen.add(point["protocol"])
        curve = point["curve"]
        for load in obj["loads"]:
            stats = curve.get(str(load))
            assert stats is not None, (
                f"curve missing load {load} for {point['protocol']} "
                f"{point['regions']}"
            )
            if stats.get("errors"):
                assert stats.get("error_cause"), stats
                for field in ("mean", "p50", "p99", "goodput_cps"):
                    assert stats.get(field) is None, (field, stats)
                continue
            for field in ("mean", "p50", "p99", "goodput_cps"):
                assert isinstance(stats.get(field), (int, float)), (
                    point["protocol"], load, field,
                )
        assert point["knee"] is None or point["knee"] in obj["loads"], (
            point["knee"]
        )
    missing = set(obj["protocols"]) - seen
    assert not missing, f"no measured points for protocol(s) {missing}"


def run_knee_sweep(
    path: str,
    *,
    protocols: Sequence[str],
    ns: Sequence[int] = (3,),
    region_sets=None,
    arrival: str = "poisson",
    loads: Sequence[int] = DEFAULT_LOADS,
    traffic: Sequence[str] = ("flat",),
    fs: Sequence[int] = (1,),
    conflicts: Sequence[int] = (100,),
    commands_per_client: int = 20,
    clients_per_region: int = 1,
    open_window: int = 4,
    mean_gap_ms: int = 4,
    batch_lanes: int = 64,
    segment_steps: int = 2048,
    knee_mult: float = DEFAULT_KNEE_MULT,
    aws: bool = False,
    resume: bool = False,
    budget_s: Optional[float] = None,
    dryrun: bool = False,
    out: Optional[str] = None,
    device=None,
) -> Tuple[Optional[dict], dict]:
    """Run (or resume) a knee sweep and, once the campaign grid
    completes, write the knee artifact.

    Returns ``(artifact, campaign_summary)``; ``artifact`` is None
    when the campaign was interrupted (budget/signal) — re-invoke with
    ``resume=True`` to continue exactly where it stopped. ``dryrun``
    skips the device sweeps and emits the parameter shell with
    ``points: null``. The sweeps run on ``device`` (default: the CUDA
    card, which raises without a GPU)."""
    spec = knee_campaign(
        protocols=protocols, ns=ns, region_sets=region_sets,
        arrival=arrival, loads=loads, traffic=traffic, fs=fs,
        conflicts=conflicts, commands_per_client=commands_per_client,
        clients_per_region=clients_per_region, open_window=open_window,
        mean_gap_ms=mean_gap_ms, batch_lanes=batch_lanes,
        segment_steps=segment_steps, aws=aws,
    )
    out = out or os.path.join(path, KNEE_ARTIFACT)
    if dryrun:
        artifact = build_knee_artifact(
            spec, measured=None, knee_mult=knee_mult, dryrun=True
        )
        check_knee_artifact(artifact)
        _write_artifact(out, artifact)
        return artifact, {"done": True, "dryrun": True, "artifact": out}

    from ..campaign.manager import run_campaign

    summary = run_campaign(path, spec, resume=resume, budget_s=budget_s,
                           device=device)
    if not summary["done"]:
        return None, summary

    measured = collect_curves(path, spec)
    artifact = build_knee_artifact(
        spec, measured=measured, knee_mult=knee_mult, dryrun=False
    )
    check_knee_artifact(artifact)
    _write_artifact(out, artifact)
    return artifact, dict(summary, artifact=out)


def _write_artifact(path: str, artifact: dict) -> None:
    from ..engine.checkpoint import atomic_write, canonical_json

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    atomic_write(path, canonical_json(artifact, indent=2))
