"""Device-validated bote frontier search (the port's copy of the JAX
package's ``bote/validate.py``; the closed-form search and the measured
campaigns run on the CUDA card unless the caller passes
``device="cpu"``).

``bote/search.py`` ranks (region-set, n, f) candidates with the
reference's *closed-form* latency model (``fantoch_bote``): client →
closest server → quorum, pure ping arithmetic. That model ignores
conflicts and queuing entirely, and both Atlas (EuroSys'20) and Tempo
(EuroSys'21) show conflict rate dominates tail latency — so a config
chosen closed-form can rank very differently once commands actually
contend. This module closes the loop: take the search's top-K
candidates, build their latency sub-matrices from ``core/planet.py``,
run *measured* device sweeps per candidate — millions of simulated
commands through the batched engine, with a traffic axis
(``traffic/``) so candidates are judged under diurnal/flash/
churn workloads too — and emit a frontier artifact comparing
closed-form vs measured latency percentiles per candidate.

The measured campaigns run through the PR-5 campaign manager
(``campaign/manager.py``): every batch is journaled, the in-flight
batch checkpoints at segment boundaries, and a SIGKILLed validation
resumes exactly where it stopped (``cli.py bote --validate --resume``).
The frontier artifact is written atomically once the grid completes.

``rank_by="knee"`` swaps the closed-loop conflict grid for an
open-loop offered-load ladder (``serving/knee.py``): every candidate
is driven with the same seeded arrival process at each load, and the
candidates are re-ranked by where their measured throughput–latency
knee sits — a candidate that sustains more offered load before its
p99 leaves the unloaded envelope outranks one that saturates early,
regardless of what the closed-form score said. The closed-form score
is still carried per candidate so the re-ranking itself is the result.

Closed-form and measured numbers are NOT the same quantity: the model
returns one commit latency per client region (no conflicts, no
queuing, fast path always), while the measured side reports the
engine's end-to-end client latency distribution under the given
conflict rate and schedule. The artifact carries both so the *gap* is
the result.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.metrics import Histogram
from ..core.planet import Planet

FRONTIER_ARTIFACT = "frontier.json"
FRONTIER_KIND = "bote-frontier"
FRONTIER_VERSION = 1

# measured device protocol → the closed-form stats key it validates
# (bote/search.py compute_stats naming: af<f> Atlas, ff<f> FPaxos,
# e EPaxos; protocols without a closed-form twin map to None)
MODEL_KEYS = {"atlas": "af{f}", "fpaxos": "ff{f}", "epaxos": "e"}


def _hist_stats(hist: Histogram) -> dict:
    return {
        "mean": round(hist.mean(), 3),
        "p50": round(hist.percentile(0.5), 3),
        "p99": round(hist.percentile(0.99), 3),
        "count": hist.count(),
    }


def closed_form_stats(
    planet: Planet, regions: Sequence[str], clients: Sequence[str]
) -> Dict[str, dict]:
    """The reference model's per-config stats (search.rs:262-319) as
    mean/p50/p99 dicts keyed like ProtocolStats (af1/ff1/e + the
    colocated-client C variants)."""
    from .model import Bote
    from .search import compute_stats

    stats = compute_stats(list(regions), list(clients), Bote(planet))
    return {k: _hist_stats(h) for k, h in sorted(stats.items())}


@dataclass
class FrontierCandidate:
    """One ranked (region-set, n) candidate with its closed-form
    latency stats."""

    regions: Tuple[str, ...]
    score: float
    closed_form: Dict[str, dict]


def frontier_candidates(
    planet: Planet,
    n: int,
    top: int,
    params=None,
    servers: "Sequence[str] | None" = None,
    clients: "Sequence[str] | None" = None,
    device=None,
) -> List[FrontierCandidate]:
    """Top-``top`` candidates of the closed-form search at ``n``
    (search.rs ranking, on ``device``: ``Search.rank``), each annotated
    with its model stats."""
    from .search import RankingParams, Search

    if params is None:
        params = RankingParams(
            min_mean_fpaxos_improv=float("-inf"),
            min_fairness_fpaxos_improv=float("-inf"),
            min_n=n,
            max_n=n,
        )
    search = Search(planet=planet, servers=servers, clients=clients)
    ranked = search.rank(params, device=device).get(n, [])
    if not ranked:
        raise ValueError(
            f"the closed-form search returned no config at n={n} "
            "passing the improvement filters; relax them"
        )
    return [
        FrontierCandidate(
            regions=tuple(c.config),
            score=float(c.score),
            closed_form=closed_form_stats(
                planet, c.config, search.clients
            ),
        )
        for c in ranked[:top]
    ]


def _measured_campaign(
    candidates: Sequence[FrontierCandidate],
    *,
    protocols: Sequence[str],
    fs: Sequence[int],
    conflicts: Sequence[int],
    traffic: Sequence[str],
    commands: int,
    clients_per_region: int,
    pool_size: int,
    batch_lanes: int,
    segment_steps: int,
    aws: bool,
    arrivals: Sequence[str] = ("closed",),
    offered_loads: Sequence[int] = (100,),
    open_window: int = 4,
    mean_gap_ms: int = 4,
):
    from ..campaign.manager import SweepCampaign

    # the defaults reproduce the legacy closed-loop grid byte-for-byte
    # (campaign/manager.py keeps "closed" batch ids unsegmented), so a
    # pre-knee journal still resumes under rank_by="score"
    return SweepCampaign(
        protocols=tuple(protocols),
        fs=tuple(fs),
        conflicts=tuple(conflicts),
        traffic=tuple(traffic),
        arrivals=tuple(arrivals),
        offered_loads=tuple(offered_loads),
        open_window=int(open_window),
        mean_gap_ms=int(mean_gap_ms),
        region_sets=tuple(c.regions for c in candidates),
        commands_per_client=commands,
        clients_per_region=clients_per_region,
        pool_size=pool_size,
        batch_lanes=batch_lanes,
        segment_steps=segment_steps,
        aws=aws,
    )


def _collect_measured(path: str, spec) -> Dict[Tuple[str, ...], dict]:
    """Aggregate the completed campaign's journal into per-candidate
    measured stats: candidate regions → protocol → f<f> → traffic →
    conflict → {mean, p50, p99, count, lanes, errors}. Lane → grid
    point attribution re-enumerates the deterministic batch order
    (the same alignment `_run_sweep_campaign` journals by)."""
    from ..campaign.manager import _read_journal, _sweep_batches
    from ..engine.results import LaneResults

    done: Dict[str, List[dict]] = {}
    for entry in _read_journal(path):
        if entry.get("kind") == "batch":
            done[entry["id"]] = entry["results"]

    out: Dict[Tuple[str, ...], dict] = {}
    for key, _dev, _dims, lanes in _sweep_batches(spec):
        rows = done.get(key)
        assert rows is not None and len(rows) == len(lanes), (
            f"campaign journal incomplete at batch {key!r}; collect "
            "measured stats only from a completed campaign"
        )
        # find the protocol name from the batch id (proto/n.../b...)
        proto = key.split("/", 1)[0]
        for lane, row in zip(lanes, rows):
            res = LaneResults.from_json(row)
            hist = Histogram()
            for region in lane.region_rows:
                hist.merge(res.histogram(region))
            if res.err:
                # an errored lane's (empty/partial) histogram must
                # never masquerade as a measured percentile — a 0.0 ms
                # p99 would make the candidate look impossibly good.
                # Null the stats and carry the cause instead; the
                # schema gate enforces exactly this shape.
                stats = {
                    "mean": None, "p50": None, "p99": None,
                    "count": hist.count(), "error_cause": res.err_cause,
                }
            else:
                stats = _hist_stats(hist)
            stats["lanes"] = 1
            stats["errors"] = 1 if res.err else 0
            tname = (lane.traffic_meta or {"name": "flat"})["name"]
            slot = (
                out.setdefault(tuple(lane.process_regions), {})
                .setdefault(proto, {})
                .setdefault(f"f{lane.config.f}", {})
                .setdefault(tname, {})
            )
            conflict = str(int(lane.ctx["conflict_rate"]))
            assert conflict not in slot, (
                f"duplicate grid point in batch enumeration: {key} "
                f"{lane.process_regions} f{lane.config.f} {tname} "
                f"conflict={conflict}"
            )
            slot[conflict] = stats
    return out


def build_frontier_artifact(
    candidates: Sequence[FrontierCandidate],
    *,
    n: int,
    protocols: Sequence[str],
    fs: Sequence[int],
    conflicts: Sequence[int],
    traffic: Sequence[str],
    commands: int,
    clients_per_region: int,
    aws: bool,
    measured: "Dict[Tuple[str, ...], dict] | None",
    dryrun: bool,
    rank_by: str = "score",
    serving: "dict | None" = None,
) -> dict:
    # per-(protocol, f) closed-form key, so a consumer comparing the
    # measured f=2 stats is pointed at af2/ff2, never at fs[0]'s model
    model_keys = {
        p: (
            {f"f{f}": MODEL_KEYS[p].format(f=f) for f in fs}
            if p in MODEL_KEYS
            else None
        )
        for p in protocols
    }
    assert rank_by in ("score", "knee"), rank_by
    assert (serving is not None) == (rank_by == "knee"), (
        "serving parameters accompany exactly the knee re-ranking"
    )
    rows = [
        {
            "regions": list(c.regions),
            "score": c.score,
            "closed_form": c.closed_form,
            "measured": (
                None if measured is None else measured.get(tuple(c.regions))
            ),
        }
        for c in candidates
    ]
    if rank_by == "knee" and measured is not None:
        from ..serving.knee import locate_knee

        for row in rows:
            curves = row["measured"] or {}
            row["knee"] = {
                proto: locate_knee(curve, serving["knee_mult"])
                for proto, curve in sorted(curves.items())
            }
        # a candidate's rank key is its *worst* protocol: the smallest
        # load at which any swept protocol's p99 leaves the unloaded
        # envelope. A never-located knee means the candidate sustained
        # the whole ladder — it outranks every saturated one. Python's
        # sort is stable, so closed-form order breaks ties.
        def _rank_key(row: dict) -> float:
            knees = [
                k if k is not None else float("inf")
                for k in row["knee"].values()
            ] or [float("-inf")]
            return -min(knees)

        rows.sort(key=_rank_key)
    return {
        "kind": FRONTIER_KIND,
        "version": FRONTIER_VERSION,
        "n": int(n),
        "planet": "aws" if aws else "gcp",
        "protocols": list(protocols),
        "fs": [int(f) for f in fs],
        "conflicts": [int(c) for c in conflicts],
        "traffic": list(traffic),
        "commands_per_client": int(commands),
        "clients_per_region": int(clients_per_region),
        "dryrun": bool(dryrun),
        "rank_by": rank_by,
        "serving": serving,
        "model_keys": model_keys,
        "candidates": rows,
    }


def check_frontier_artifact(obj: dict) -> None:
    """Schema check for the frontier artifact (the CI traffic-smoke
    job pins this on a --dryrun run): required keys, per-candidate
    closed-form p50/p99, and — unless dryrun — measured p50/p99 for
    every (protocol, f, traffic, conflict) grid point, or (under
    ``rank_by: knee``) a measured curve covering every offered load
    plus a knee that is null or one of the swept loads."""
    for k in (
        "kind", "version", "n", "planet", "protocols", "fs",
        "conflicts", "traffic", "commands_per_client", "dryrun",
        "model_keys", "candidates",
    ):
        assert k in obj, f"frontier artifact missing {k!r}"
    assert obj["kind"] == FRONTIER_KIND, obj["kind"]
    assert obj["candidates"], "frontier artifact has no candidates"
    # pre-knee artifacts carry neither key: score-ranked by construction
    rank_by = obj.get("rank_by", "score")
    assert rank_by in ("score", "knee"), rank_by
    serving = obj.get("serving")
    if rank_by == "knee":
        assert serving, "knee-ranked artifacts carry serving parameters"
        for k in (
            "arrival", "loads", "knee_mult", "open_window", "mean_gap_ms"
        ):
            assert k in serving, f"serving parameters missing {k!r}"
        assert serving["arrival"] != "closed", serving
        assert serving["loads"], "knee re-ranking needs a load ladder"
    else:
        assert serving is None, "score-ranked artifacts carry no serving"
    for cand in obj["candidates"]:
        for k in ("regions", "score", "closed_form", "measured"):
            assert k in cand, f"candidate missing {k!r}"
        assert len(cand["regions"]) == obj["n"], cand["regions"]
        assert cand["closed_form"], "candidate has no closed-form stats"
        for key, stats in cand["closed_form"].items():
            for field in ("mean", "p50", "p99"):
                assert isinstance(stats.get(field), (int, float)), (
                    f"closed_form[{key!r}] missing {field}"
                )
        if obj["dryrun"]:
            assert cand["measured"] is None, (
                "dryrun artifacts must not claim measured values"
            )
            continue
        measured = cand["measured"]
        assert measured, "measured artifact has no sweep stats"
        if rank_by == "knee":
            assert "knee" in cand, "knee-ranked candidate missing knee"
            for proto in obj["protocols"]:
                curve = measured.get(proto)
                assert curve is not None, (
                    f"measured curve missing for {proto} {cand['regions']}"
                )
                for load in serving["loads"]:
                    stats = curve.get(str(load))
                    assert stats is not None, (
                        f"curve missing load {load} for {proto} "
                        f"{cand['regions']}"
                    )
                    if stats.get("errors"):
                        assert stats.get("error_cause"), stats
                        for field in ("mean", "p50", "p99", "goodput_cps"):
                            assert stats.get(field) is None, (field, stats)
                        continue
                    for field in ("mean", "p50", "p99", "goodput_cps"):
                        assert isinstance(stats.get(field), (int, float)), (
                            proto, load, field,
                        )
                knee = cand["knee"].get(proto)
                assert knee is None or knee in serving["loads"], knee
            continue
        for proto in obj["protocols"]:
            for f in obj["fs"]:
                for tname in obj["traffic"]:
                    for conflict in obj["conflicts"]:
                        stats = (
                            measured.get(proto, {})
                            .get(f"f{f}", {})
                            .get(tname, {})
                            .get(str(conflict))
                        )
                        assert stats is not None, (
                            f"measured stats missing for {proto} f{f} "
                            f"{tname} conflict={conflict}"
                        )
                        if stats.get("errors"):
                            # errored points must carry nulls + a
                            # cause, never fake percentiles
                            assert stats.get("error_cause"), stats
                            for field in ("mean", "p50", "p99"):
                                assert stats.get(field) is None, (
                                    proto, f, tname, conflict, field,
                                )
                            continue
                        for field in ("mean", "p50", "p99"):
                            assert isinstance(
                                stats.get(field), (int, float)
                            ), (proto, f, tname, conflict, field)


def validate_frontier(
    path: str,
    *,
    planet: Planet,
    candidates: Sequence[FrontierCandidate],
    protocols: Sequence[str] = ("atlas", "fpaxos"),
    fs: Sequence[int] = (1,),
    conflicts: Sequence[int] = (0, 100),
    traffic: Sequence[str] = ("flat",),
    commands: int = 20,
    clients_per_region: int = 1,
    pool_size: int = 1,
    batch_lanes: int = 64,
    segment_steps: int = 2048,
    aws: bool = False,
    resume: bool = False,
    budget_s: Optional[float] = None,
    dryrun: bool = False,
    out: Optional[str] = None,
    rank_by: str = "score",
    arrival: str = "poisson",
    loads: Optional[Sequence[int]] = None,
    open_window: int = 4,
    mean_gap_ms: int = 4,
    knee_mult: Optional[float] = None,
    device=None,
) -> Tuple[Optional[dict], dict]:
    """Run (or resume) the measured validation of ``candidates`` and,
    once the campaign grid completes, write the frontier artifact.

    Returns ``(artifact, campaign_summary)``; ``artifact`` is None when
    the campaign was interrupted (budget/signal) — re-invoke with
    ``resume=True`` to continue exactly where it stopped (the PR-5
    checkpoint/journal machinery). ``dryrun`` skips the device sweeps
    and emits the artifact with ``measured: null`` per candidate —
    the CI schema check's fast path.

    ``rank_by="knee"`` replaces the closed-loop conflict grid with an
    open-loop offered-load ladder (``serving/knee.py``) and re-orders
    the artifact's candidates by their measured knee position —
    worst-protocol knee descending, never-saturated first; the
    closed-form ``score`` rides along unranked.

    The measured campaign runs on ``device`` (default the CUDA card,
    which raises without a GPU; ``"cpu"`` runs the kernels' plain
    twins)."""
    assert candidates, "nothing to validate"
    assert rank_by in ("score", "knee"), rank_by
    ns = {len(c.regions) for c in candidates}
    assert len(ns) == 1, f"candidates span multiple n: {sorted(ns)}"
    n = ns.pop()

    serving = None
    if rank_by == "knee":
        from ..serving.knee import DEFAULT_KNEE_MULT, DEFAULT_LOADS

        serving = {
            "arrival": arrival,
            "loads": [int(l) for l in (loads or DEFAULT_LOADS)],
            "knee_mult": float(
                DEFAULT_KNEE_MULT if knee_mult is None else knee_mult
            ),
            "open_window": int(open_window),
            "mean_gap_ms": int(mean_gap_ms),
        }

    out = out or os.path.join(path, FRONTIER_ARTIFACT)
    if dryrun:
        artifact = build_frontier_artifact(
            candidates, n=n, protocols=protocols, fs=fs,
            conflicts=conflicts, traffic=traffic, commands=commands,
            clients_per_region=clients_per_region, aws=aws,
            measured=None, dryrun=True, rank_by=rank_by, serving=serving,
        )
        check_frontier_artifact(artifact)
        _write_artifact(out, artifact)
        return artifact, {"done": True, "dryrun": True, "artifact": out}

    from ..campaign.manager import run_campaign

    spec = _measured_campaign(
        candidates, protocols=protocols, fs=fs, conflicts=conflicts,
        traffic=traffic, commands=commands,
        clients_per_region=clients_per_region, pool_size=pool_size,
        batch_lanes=batch_lanes, segment_steps=segment_steps, aws=aws,
        **(
            {}
            if serving is None
            else {
                "arrivals": (serving["arrival"],),
                "offered_loads": tuple(serving["loads"]),
                "open_window": serving["open_window"],
                "mean_gap_ms": serving["mean_gap_ms"],
            }
        ),
    )
    summary = run_campaign(path, spec, resume=resume, budget_s=budget_s,
                           device=device)
    if not summary["done"]:
        return None, summary

    if rank_by == "knee":
        from ..serving.knee import collect_curves

        measured = collect_curves(path, spec)
    else:
        measured = _collect_measured(path, spec)
    artifact = build_frontier_artifact(
        candidates, n=n, protocols=protocols, fs=fs,
        conflicts=conflicts, traffic=traffic, commands=commands,
        clients_per_region=clients_per_region, aws=aws,
        measured=measured, dryrun=False, rank_by=rank_by, serving=serving,
    )
    check_frontier_artifact(artifact)
    _write_artifact(out, artifact)
    summary = dict(summary, artifact=out)
    return artifact, summary


def _write_artifact(path: str, artifact: dict) -> None:
    from ..engine.checkpoint import atomic_write, canonical_json

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    atomic_write(path, canonical_json(artifact, indent=2))
