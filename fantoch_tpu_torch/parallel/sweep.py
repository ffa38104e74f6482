"""Config sweeps: the (region subset × f × conflict) grid, run in lane
batches on one device.

``make_sweep_specs`` enumerates the points — the reference simulation
binary's nested loops — into lanes; ``run_sweep`` runs them
``batch_lanes`` at a time (each batch: key table, stack, run, collect).
Each point runs once per fault plan of ``faults``, every point under one
traffic schedule or open-loop arrival process when given. Segments, scan
windows, checkpoints, sharding and mixed-protocol batches are not ported
yet.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence

from .. import resolve_device
from ..core.config import Config
from ..core.planet import Planet
from ..engine.dims import EngineDims
from ..engine.driver import batch_runner, prepare_batch
from ..engine.faults import FaultPlan
from ..engine.results import LaneResults, collect_results
from ..engine.spec import LaneSpec, make_lane


def make_sweep_specs(
    protocol,
    planet: Planet,
    *,
    region_sets: Sequence[Sequence[str]],
    fs: Sequence[int],
    conflicts: Sequence[int],
    commands_per_client: int,
    clients_per_region: int,
    dims: EngineDims,
    config_base: Optional[Config] = None,
    extra_time_ms: int = 500,
    zipf=None,
    pool_size: int = 1,
    faults: "Sequence[FaultPlan | None] | None" = None,
    traffic=None,
    arrivals=None,
    arrival_load: int = 100,
    arrival_gap_ms: int = 4,
    open_window: int = 4,
) -> List[LaneSpec]:
    """The sweep grid: one lane per (region set, f, conflict) point,
    replicated once per entry of ``faults`` (None = fault-free); a
    point's lanes share its workload, seeded by the point's index (the
    reference's ``make_sweep_specs``). ``traffic`` (a preset name,
    resolved against each point's own conflict rate, or a schedule) and
    ``arrivals`` (a preset resolved against ``arrival_gap_ms`` and scaled
    by ``arrival_load`` percent, with at most ``open_window`` commands in
    flight per client) apply to every point (``make_lane``)."""
    base = config_base or Config(n=len(region_sets[0]), f=1,
                                 gc_interval_ms=100)
    plans: Sequence["FaultPlan | None"] = faults or [None]
    specs = []
    for i, (regions, f, conflict, plan) in enumerate(
        itertools.product(region_sets, fs, conflicts, plans)
    ):
        specs.append(
            make_lane(
                protocol,
                planet,
                base.with_(n=len(regions), f=f),
                conflict_rate=conflict,
                pool_size=pool_size,
                zipf=zipf,
                commands_per_client=commands_per_client,
                clients_per_region=clients_per_region,
                process_regions=list(regions),
                client_regions=list(regions),
                dims=dims,
                extra_time_ms=extra_time_ms,
                seed=i // len(plans),
                faults=plan,
                traffic=traffic,
                arrivals=arrivals,
                arrival_load=arrival_load,
                arrival_gap_ms=arrival_gap_ms,
                open_window=open_window,
            )
        )
    return specs


def run_sweep(
    protocol,
    dims: EngineDims,
    specs: Sequence[LaneSpec],
    batch_lanes: int = 512,
    max_steps: int = 1 << 22,
    device=None,
    monitor_keys: int = 0,
) -> List[LaneResults]:
    """Run every lane, ``batch_lanes`` per batch, on ``device`` (default:
    the CUDA card), each batch under its reorder flag and fault-flag
    union. ``monitor_keys > 0`` runs the safety monitors (per-lane
    ``violation``, ``violation_step`` and ``coverage``). Results are in
    ``specs`` order."""
    dev = resolve_device(device)
    out: List[LaneResults] = []
    for lo in range(0, len(specs), batch_lanes):
        chunk = specs[lo:lo + batch_lanes]
        runner = batch_runner(protocol, dims, chunk, max_steps, monitor_keys)
        state, ctx = prepare_batch(protocol, dims, chunk, dev, monitor_keys)
        out.extend(collect_results(protocol, dims, runner(state, ctx), chunk))
    return out
