"""Deterministic merge of fleet worker journals (the port's copy of the
JAX package's ``fleet/merge.py``; no device).

Completion order across workers is racy by nature; the merge erases
it. Completed units are collected from **every** journal in the
campaign dir (legacy single-process journal included), validated —
duplicate completions of one unit must agree exactly, or the merge
refuses (``FleetError``) — and written in the **canonical unit
enumeration order** (the same deterministic ``_sweep_batches`` /
point enumeration the workers claimed from). The result:

* a sweep campaign's merged ``results.jsonl`` is **byte-identical**
  between a 1-worker control and any N-worker, any-interleaving,
  any-kill-pattern fleet run — and byte-identical to the
  single-process ``cli.py campaign`` output for the same grid, since
  both write the same lines in the same order;
* a fuzz campaign's merged ``summary.json`` carries each point's
  final cumulative state (counters, artifacts, violations — no
  wall-clock fields), equally worker-count-invariant.

What the merge does NOT guarantee: it never *completes* work (missing
units ⇒ ``merged: False`` and no results file — run more workers), it
cannot merge across campaign specs (the stored ``campaign.json`` is
the single source of the unit enumeration), and it inherits the
checkpoint layer's version posture — journals written under a
different protocol/engine build are not detectable here (the refusal
happened earlier, at unit resume time, via the signed checkpoints).
"""

from __future__ import annotations

import json
import os
from typing import List

from .worker import (
    fuzz_point_progress,
    fuzz_points,
    read_all_journals,
    sweep_done_units,
)


def _merge_sweep(path: str, spec) -> dict:
    from ..campaign.manager import _RESULTS, _atomic_write, _sweep_batches

    batches = _sweep_batches(spec)
    if getattr(spec, "hetero", False):
        # mixed-unit layout: workers journal under the plan's
        # `hetero/b<u>` unit ids; the merge regroups the unit rows back
        # into the homogeneous enumeration, so the merged results.jsonl
        # is byte-identical to a homogeneous-layout campaign (or merge)
        # of the same grid
        from ..campaign.manager import hetero_plan, hetero_regroup

        _protos, _dmap, _reps, units, positions = hetero_plan(spec, batches)
        done = sweep_done_units(read_all_journals(path))
        missing = [key for key, _ in units if key not in done]
        summary = {
            "kind": "sweep",
            "units_total": len(units),
            "units_done": len(units) - len(missing),
            "merged": not missing,
            "dir": path,
        }
        if missing:
            summary["missing_units"] = missing[:8]
            return summary
        done = hetero_regroup(batches, units, positions, done)
    else:
        done = sweep_done_units(read_all_journals(path))
        missing = [key for key, *_ in batches if key not in done]
        summary = {
            "kind": "sweep",
            "units_total": len(batches),
            "units_done": len(batches) - len(missing),
            "merged": not missing,
            "dir": path,
        }
        if missing:
            summary["missing_units"] = missing[:8]
            return summary
    from ..engine.checkpoint import canonical_json

    lines: List[str] = []
    for key, *_ in batches:
        for lane, res in enumerate(done[key]):
            lines.append(
                canonical_json(
                    {"batch": key, "lane": lane, "result": res}
                )
            )
    _atomic_write(
        os.path.join(path, _RESULTS), "".join(x + "\n" for x in lines)
    )
    summary["results"] = os.path.join(path, _RESULTS)
    summary["lanes"] = sum(len(done[k]) for k, *_ in batches)
    summary["errors"] = sum(
        1 for k, *_ in batches for res in done[k] if res["err"]
    )
    return summary


def _merge_fuzz(path: str, spec) -> dict:
    from ..campaign.manager import (
        _SUMMARY,
        _atomic_write,
        fuzz_point_keys,
        fuzz_retired,
        point_class_key,
    )

    points = fuzz_points(spec)
    keys = fuzz_point_keys(spec)
    assert keys == [point_class_key(*t) for t in points]
    entries = read_all_journals(path)
    progress = fuzz_point_progress(entries)
    # a retired point counts as settled: its budget was recycled by
    # design, so the merge must not report it as missing work
    retired = set(fuzz_retired(spec, entries))
    missing = [
        key
        for key in keys
        if key not in retired
        and int(progress.get(key, {}).get("tried", 0)) < spec.schedules
    ]
    summary = {
        "kind": "fuzz",
        "points_total": len(keys),
        "points_done": len(keys) - len(missing),
        "merged": not missing,
        "dir": path,
    }
    if missing:
        summary["missing_points"] = missing[:8]
        return summary
    from ..campaign.manager import _FUZZ_INTERNAL_KEYS

    # the merged artifact: per-point final cumulative state in
    # canonical point order, minus the generator positions and raw
    # seed pool (internal steering state) and minus any path that
    # would vary by campaign dir — everything left, the coverage maps
    # included, is deterministic across worker counts and
    # interleavings (the union of per-worker journals always converges
    # to the same cumulative per-point entries)
    merged = {
        "kind": "fuzz",
        # total schedules run, from the JOURNALED counters — never
        # chunk-count × chunk-size, which would over-count a final
        # chunk smaller than `chunk`
        "schedules_tried": sum(
            int(progress[key].get("tried", 0))
            for key in keys
            if key in progress
        ),
        "points": {
            key: {
                k: v
                for k, v in progress[key].items()
                if k not in _FUZZ_INTERNAL_KEYS
            }
            for key in keys
            if key in progress
        },
    }
    if int(getattr(spec, "retire_after", 0)):
        # present only for retirement-enabled farms (mirrors the
        # single-process summary's conditional), so every legacy
        # merged summary's bytes are untouched
        merged["retired"] = sorted(retired)
    if getattr(spec, "binary_maps", False):
        # binary-map farms: settle each point's final `.covmap` under
        # its canonical name before the summary references it — the
        # same idempotent, sha-verified materialization the
        # single-process manager runs, so a fleet merge and a solo
        # campaign leave byte-identical map files behind
        from ..campaign.manager import materialize_final_maps

        materialize_final_maps(path, progress)
    from ..engine.checkpoint import canonical_json

    _atomic_write(
        os.path.join(path, _SUMMARY),
        canonical_json(merged, indent=2),
    )
    summary["summary"] = os.path.join(path, _SUMMARY)
    return summary


def merge_campaign(path: str) -> dict:
    """Merge the campaign in ``path``. Returns a summary dict with
    ``merged: True`` and the output path when every unit is journaled;
    ``merged: False`` (plus what's missing) otherwise. Conflicting
    duplicate unit completions raise :class:`FleetError`."""
    from ..campaign.manager import _CAMPAIGN, CampaignError, campaign_from_json

    cpath = os.path.join(path, _CAMPAIGN)
    if not os.path.exists(cpath):
        raise CampaignError(f"nothing to merge: no {_CAMPAIGN} in {path}")
    spec = campaign_from_json(json.load(open(cpath)))
    if spec.kind == "sweep":
        return _merge_sweep(path, spec)
    return _merge_fuzz(path, spec)
