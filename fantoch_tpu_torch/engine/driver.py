"""Convenience driver: build, run, and collect a batch of lanes."""

from __future__ import annotations

from typing import List, Sequence

from .. import resolve_device
from ..carry import stack_trees, to_torch
from ..kernels.key_table import key_table
from .core import build_runner, init_lane_state
from .dims import EngineDims
from .results import LaneResults, collect_results
from .spec import LaneSpec, stack_lanes


def prepare_batch(protocol, dims: EngineDims, specs: Sequence[LaneSpec],
                  device):
    """Stack the lanes' ctx onto ``device``, compute every lane's
    (client, seq) key table there (``key_table`` kernel; T = max budget
    + 2 columns, as the reference's sweep does) and build the initial
    state from its first column. Returns ``(state, ctx)`` tensor trees."""
    ctx_np = stack_lanes(specs)
    ctx = to_torch(ctx_np, device)
    T = int(max(2, ctx_np["cmd_budget"].max() + 2))
    ctx["key_table"] = key_table(
        ctx["rng_key"], ctx["conflict_rate"], ctx["pool_size"],
        ctx["key_gen_kind"], ctx["zipf_cum"], dims.C, T,
    )
    first = ctx["key_table"][:, :, 1].cpu().numpy()
    state = stack_trees([
        init_lane_state(protocol, dims, s.ctx, first[i])
        for i, s in enumerate(specs)
    ])
    return to_torch(state, device), ctx


def run_lanes(
    protocol,
    dims: EngineDims,
    specs: Sequence[LaneSpec],
    max_steps: int = 1 << 22,
    device=None,
) -> List[LaneResults]:
    """Run one batch of lanes to completion on ``device`` (default: the
    CUDA card; ``"cpu"`` runs the plain twins)."""
    dev = resolve_device(device)
    state, ctx = prepare_batch(protocol, dims, specs, dev)
    final = build_runner(protocol, dims, max_steps)(state, ctx)
    return collect_results(protocol, dims, final, specs)

