"""JSONL results store, the port's copy of the reference's
``fantoch_tpu/plot/db.py``.

One JSON line per lane: ``{"attrs": ..., "results": ...}``, the lane's
search attributes (protocol, n, f, shards, conflict, regions, and the
fault, traffic and arrival metadata where present) beside its
``LaneResults``. For the same rows the bytes are the reference's.
"""

from __future__ import annotations

import json
from dataclasses import asdict
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..engine.results import LaneResults


def _encode(obj):
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    raise TypeError(f"unserializable {type(obj)}")


def save_results(
    path: "str | Path",
    rows: Iterable[Tuple[Dict, LaneResults]],
    append: bool = False,
) -> None:
    """Write ``rows``, (attributes, results) pairs, one line each."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("a" if append else "w") as f:
        for attrs, res in rows:
            f.write(
                json.dumps(
                    {"attrs": attrs, "results": asdict(res)},
                    default=_encode,
                )
                + "\n"
            )


def load_results(
    path: "str | Path",
    match: Optional[Dict] = None,
) -> List[Tuple[Dict, LaneResults]]:
    """The rows whose attributes hold every ``match`` key's value."""
    out = []
    with Path(path).open() as f:
        for line in f:
            row = json.loads(line)
            attrs = row["attrs"]
            if match and any(attrs.get(k) != v for k, v in match.items()):
                continue
            r = row["results"]
            out.append(
                (
                    attrs,
                    LaneResults(
                        region_rows=r["region_rows"],
                        hist=np.asarray(r["hist"], np.int64),
                        lat_sum=np.asarray(r["lat_sum"], np.int64),
                        lat_count=np.asarray(r["lat_count"], np.int64),
                        protocol_metrics={
                            k: np.asarray(v)
                            for k, v in r["protocol_metrics"].items()
                        },
                        steps=r["steps"],
                        err=r["err"],
                        completed=r["completed"],
                        pool_peak=r.get("pool_peak", 0),
                        requeues=r.get("requeues", 0),
                        faults=r.get("faults"),
                        dropped=r.get("dropped", 0),
                    ),
                )
            )
    return out
