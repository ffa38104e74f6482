"""Convenience driver: build, run, and collect a batch of lanes."""

from __future__ import annotations

from typing import List, Sequence

from .. import resolve_device
from ..carry import stack_trees, to_torch
from ..kernels.key_table import key_table, traffic_tables
from .core import build_runner, init_lane_state
from .dims import EngineDims
from .faults import batch_fault_flags
from .results import LaneResults, collect_results
from .spec import LaneSpec, command_tables, stack_lanes


# the ctx planes the key stream is drawn from
KEY_CTX = ("rng_key", "conflict_rate", "pool_size", "key_gen_kind",
           "zipf_cum")


def _keys(ctx, dims: EngineDims, T: int):
    """Every lane's (client, draw) key stream ``[L, C, T]`` (the
    ``key_table`` kernel on the ctx's device), under the lanes' traffic
    schedule when they carry one."""
    return key_table(
        ctx["rng_key"], ctx["conflict_rate"], ctx["pool_size"],
        ctx["key_gen_kind"], ctx["zipf_cum"], dims.C, T,
        traffic_tables(ctx),
    )


def partial_tables(protocol, dims: EngineDims, specs: Sequence[LaneSpec],
                   ctx):
    """The per-command shard/key tables of partial-replication lanes
    (``spec.command_tables``), stacked: the key stream is drawn on the
    ctx's device (the ``key_table`` kernel), copied to the host and
    replayed there; a lane whose redraws outrun the stream draws it
    again at twice the width, as the reference's ``_partial_tables``
    does. Every lane shares the batch's command budget T."""
    T = int(max(s.ctx["cmd_budget"].max() for s in specs))
    width = T * protocol.KPC * 4 + 1
    draws = _keys(ctx, dims, width).cpu().numpy()
    tables = []
    for i in range(len(specs)):
        def more(w, i=i):
            lane = {k: ctx[k][i:i + 1] for k in KEY_CTX}
            return _keys(lane, dims, 2 * w)[0].cpu().numpy()

        tables.append(command_tables(draws[i], protocol.S, protocol.KPC, T,
                                     more))
    return tables


def batch_reorder_flag(specs: Sequence[LaneSpec]) -> bool:
    """A batch runs one step, so every lane must agree on the reorder
    perturbation (the reference's trace-time flag)."""
    flags = {bool(s.ctx["reorder"]) for s in specs}
    assert len(flags) == 1, "cannot mix reorder and FIFO lanes in a batch"
    return flags.pop()


def batch_runner(protocol, dims: EngineDims, specs: Sequence[LaneSpec],
                 max_steps: int = 1 << 22, monitor_keys: int = 0):
    """The run loop of one batch, under its reorder flag and the union
    of its lanes' fault flags; ``monitor_keys > 0`` runs the safety
    monitors."""
    return build_runner(protocol, dims, max_steps,
                        reorder=batch_reorder_flag(specs),
                        faults=batch_fault_flags(specs),
                        monitor_keys=monitor_keys)


def prepare_batch(protocol, dims: EngineDims, specs: Sequence[LaneSpec],
                  device, monitor_keys: int = 0, T: "int | None" = None):
    """Stack the lanes' ctx onto ``device``, compute every lane's
    (client, seq) key table there (``key_table`` kernel; T = max budget
    + 2 columns, as the reference's sweep does, unless ``T`` is given:
    a key does not depend on T) and build the initial
    state from its first column. Partial-replication lanes also get
    their per-command tables (:func:`partial_tables`), and their first
    SUBMITs go to the first command's target shard. ``monitor_keys > 0``
    adds the monitor planes. Returns ``(state, ctx)`` tensor trees."""
    ctx_np = stack_lanes(specs)
    ctx = to_torch(ctx_np, device)
    lane_ctx = [s.ctx for s in specs]
    if "shard_of" in ctx_np:
        tables = partial_tables(protocol, dims, specs, ctx)
        lane_ctx = [dict(c, **t) for c, t in zip(lane_ctx, tables)]
        ctx.update(to_torch(stack_trees(tables), device))
    if T is None:
        T = int(max(2, ctx_np["cmd_budget"].max() + 2))
    ctx["key_table"] = _keys(ctx, dims, T)
    first = ctx["key_table"][:, :, 1].cpu().numpy()
    state = stack_trees([
        init_lane_state(protocol, dims, c, first[i], monitor_keys)
        for i, c in enumerate(lane_ctx)
    ])
    return to_torch(state, device), ctx


def run_lanes(
    protocol,
    dims: EngineDims,
    specs: Sequence[LaneSpec],
    max_steps: int = 1 << 22,
    device=None,
    monitor_keys: int = 0,
) -> List[LaneResults]:
    """Run one batch of lanes to completion on ``device`` (default: the
    CUDA card; ``"cpu"`` runs the plain twins); ``monitor_keys > 0``
    runs the safety monitors with that key capacity."""
    dev = resolve_device(device)
    runner = batch_runner(protocol, dims, specs, max_steps, monitor_keys)
    state, ctx = prepare_batch(protocol, dims, specs, dev, monitor_keys)
    final = runner(state, ctx)
    return collect_results(protocol, dims, final, specs)

