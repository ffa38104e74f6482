"""Host-side result collection: device state → the same shapes the
oracle runner reports (per-region latency histograms, per-process
protocol metrics; fantoch/src/sim/runner.rs:597-681)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from ..carry import to_numpy
from ..core.metrics import Histogram
from .dims import INF, EngineDims, err_names
from .spec import LaneSpec


@dataclass
class LaneResults:
    """One lane's outputs in oracle-comparable form."""

    region_rows: List[str]
    hist: np.ndarray        # [RR, H] 1 ms buckets
    lat_sum: np.ndarray     # [RR]
    lat_count: np.ndarray   # [RR]
    protocol_metrics: Dict[str, np.ndarray]  # name → per-process [N]
    steps: int
    err: int  # error bitmask (dims.ERR_*); 0 = clean run
    completed: int
    pool_peak: int = 0  # max in-flight messages (EngineDims.M sizing)
    # readiness-gate bounces; > 0 in a FIFO lane means the dot window
    # (EngineDims.D) stalled deliveries
    requeues: int = 0
    # fault-plan metadata (None for fault-free lanes) and messages lost
    faults: "dict | None" = None
    dropped: int = 0
    # safety-monitor outputs (monitored runs only; not ported yet)
    violation: int = 0
    violation_step: int = INF
    coverage: int = 0

    @property
    def err_cause(self) -> str:
        return err_names(self.err)

    def latency_mean(self, region: str) -> float:
        row = self.region_rows.index(region)
        assert self.lat_count[row] > 0
        return float(self.lat_sum[row]) / float(self.lat_count[row])

    def histogram(self, region: str) -> Histogram:
        row = self.region_rows.index(region)
        h = Histogram()
        for ms, count in enumerate(self.hist[row]):
            if count:
                h.increment(ms, int(count))
        return h

    def issued(self, region: str) -> int:
        row = self.region_rows.index(region)
        return int(self.lat_count[row])

    def to_json(self) -> dict:
        """Deterministic JSON-able form: every array as nested int
        lists, metrics in sorted key order — byte-identical to the
        reference's under ``json.dumps(..., sort_keys=True)``."""
        return {
            "region_rows": list(self.region_rows),
            "hist": np.asarray(self.hist).tolist(),
            "lat_sum": np.asarray(self.lat_sum).tolist(),
            "lat_count": np.asarray(self.lat_count).tolist(),
            "protocol_metrics": {
                k: np.asarray(v).tolist()
                for k, v in sorted(self.protocol_metrics.items())
            },
            "steps": int(self.steps),
            "err": int(self.err),
            "completed": int(self.completed),
            "pool_peak": int(self.pool_peak),
            "requeues": int(self.requeues),
            "faults": self.faults,
            "dropped": int(self.dropped),
            "violation": int(self.violation),
            "violation_step": int(self.violation_step),
            "coverage": int(self.coverage),
        }


def collect_results(
    protocol,
    dims: EngineDims,
    final_state,
    specs: Sequence[LaneSpec],
) -> List[LaneResults]:
    """Fetch the final state to the host once and split it per lane."""
    del dims  # the state's own shapes carry the bounds
    st = to_numpy({
        k: final_state[k]
        for k in ("ps", "metrics", "steps", "err", "clients", "pool_peak",
                  "requeues", "fault_dropped")
    })
    out: List[LaneResults] = []
    for lane, spec in enumerate(specs):
        ps = {k: v[lane] for k, v in st["ps"].items()}
        out.append(
            LaneResults(
                region_rows=spec.region_rows,
                hist=st["metrics"]["hist"][lane],
                lat_sum=st["metrics"]["lat_sum"][lane],
                lat_count=st["metrics"]["lat_count"][lane],
                protocol_metrics=protocol.metrics(ps),
                steps=int(st["steps"][lane]),
                err=int(st["err"][lane]),
                completed=int(st["clients"]["completed"][lane].sum()),
                pool_peak=int(st["pool_peak"][lane]),
                requeues=int(st["requeues"][lane]),
                faults=spec.fault_meta,
                dropped=int(st["fault_dropped"][lane]),
            )
        )
    return out
