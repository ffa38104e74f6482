"""Host-side lane construction: planet + config + workload → ctx arrays.

Mirrors the oracle runner's wiring (fantoch/src/sim/runner.rs:64-190):
processes are placed one per region, discovery sorts processes by distance
with id tie-breaks (util.rs:153-186), clients connect to the closest
process (util.rs:188-230), and message delay is half the ping latency
(runner.rs:575-595). The output is a dict of fixed-shape numpy arrays — a
*lane context* — equal key for key and dtype for dtype to the JAX
reference's, ready to be stacked into a batch and moved to the device.

This port builds closed-loop lanes with the static key generator,
single-shard or partially replicated (one process row per (shard,
region), per-shard client attachment and per-command shard/key tables:
:func:`command_tables`, filled in by ``driver.prepare_batch`` from the
batch's key stream), with an optional fault plan (single-shard,
``engine/faults.py``) and the reorder perturbation; the other lane kinds
raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np

from .. import random as rnd
from ..client.key_gen import zipf_weights
from ..core.config import Config
from ..core.planet import Planet
from ..core.util import key_hash
from .dims import INF, EngineDims
from .faults import (
    NO_FAULTS, FaultFlags, FaultPlan, fault_ctx, halted_client_mask,
    min_link_delays, reorder_doomed_last, unavailable,
)


@dataclass
class LaneSpec:
    """One configuration of the sweep: device ctx + host-side metadata."""

    ctx: Dict[str, np.ndarray]
    config: Config
    region_rows: List[str]  # row index → client region name
    process_regions: List[str] = field(default_factory=list)
    # fault-plan capabilities and compact metadata (engine/faults.py);
    # NO_FAULTS / None for fault-free lanes
    fault_flags: FaultFlags = NO_FAULTS
    fault_meta: "dict | None" = None


def _sorted_indices(planet: Planet, process_regions: Sequence[str]) -> np.ndarray:
    """For each process, all processes ordered by (distance, id) from its
    region — the discovery order (util.rs:153-186). 0-based indices."""
    n = len(process_regions)
    out = np.zeros((n, n), np.int32)
    for p, region in enumerate(process_regions):
        order = {r: i for i, (_lat, r) in enumerate(planet.sorted(region))}
        ranked = sorted(range(n), key=lambda q: (order[process_regions[q]], q))
        out[p] = ranked
    return out


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue A item {item})"
    )


def make_lane(
    protocol,
    planet: Planet,
    config: Config,
    *,
    conflict_rate: int = 100,
    pool_size: int = 1,
    zipf: "tuple[float, int] | None" = None,
    commands_per_client: int,
    clients_per_region: int,
    process_regions: Sequence[str],
    client_regions: Sequence[str],
    dims: EngineDims,
    extra_time_ms: int = 1000,
    seed: int = 0,
    reorder: bool = False,
    faults: "FaultPlan | None" = None,
    traffic=None,
    arrivals=None,
) -> LaneSpec:
    """``zipf=(coefficient, total_keys)`` switches the workload from the
    ConflictPool generator to Zipf sampling over ``total_keys`` keys
    (key_gen.rs:113-119); lanes batched together must share the same
    zipf table size.

    ``reorder`` scales every message delay by a uniform [0, 10) draw per
    step (runner.rs:520-524); such lanes run serialized (lookahead 0).
    ``faults`` attaches a single-shard :class:`FaultPlan`; lanes with and
    without plans share a batch, run under the batch's flag union."""
    if traffic not in (None, "flat"):
        raise _not_ported("a non-flat traffic= schedule", "11")
    if arrivals not in (None, "closed"):
        raise _not_ported("open-loop arrivals=", "11")
    n = config.n
    S = config.shard_count
    partial = S > 1 or getattr(protocol, "KPC", 1) > 1
    if partial:
        assert getattr(protocol, "S", 1) == S, (
            "protocol shards must match config.shard_count"
        )
    assert len(process_regions) == n
    assert S * n <= dims.N
    N, C = dims.N, dims.C
    total = S * n  # live process rows; row = shard * n + region index

    if faults is not None and faults.is_noop():
        faults = None
    if faults is not None:
        assert S == 1, "fault plans are single-shard for now"
        assert all(r < n for r in faults.crashes), (
            f"crash rows {sorted(faults.crashes)} out of range for n={n}"
        )
        assert all(
            w.src < n and w.dst < n for w in faults.windows
        ), "window endpoints out of range"
    # crashes beyond what the protocol tolerates: the lane ends at once
    # with ERR_UNAVAIL, so quorum selection keeps its fault-free default
    unavail = faults is not None and unavailable(faults, protocol, config)

    def row_region(row: int) -> str:
        return process_regions[row % n]

    # process↔process delays: half the ping latency (runner.rs:575-595)
    delay_pp = np.zeros((N, N), np.int32)
    for i in range(total):
        for j in range(total):
            delay_pp[i, j] = (
                planet.ping_latency(row_region(i), row_region(j)) // 2
            )

    # conservative-lookahead matrix: lookahead[q, p] = minimum time any
    # chain of messages starting at q can take to reach p (all-pairs
    # shortest path over delay_pp). The diagonal and padded rows are INF.
    lookahead = np.full((N, N), INF, np.int64)
    if faults is not None and faults.windows:
        # a window override may undercut the base delay: the bound is
        # taken over each pair's least delay across the run
        sp = min_link_delays(faults, delay_pp, total)
    else:
        sp = delay_pp[:total, :total].astype(np.int64)
    for k in range(total):
        sp = np.minimum(sp, sp[:, k, None] + sp[None, k, :])
    lookahead[:total, :total] = sp
    np.fill_diagonal(lookahead[:total, :total], INF)
    # with a zero inter-process delay (colocated regions, and always the
    # co-region rows of two shards) fall back to serialized global-time
    # stepping — such schedules are inherently tied; so do reorder
    # lanes, whose random delays void the lookahead bound
    offdiag = delay_pp[:total, :total][~np.eye(total, dtype=bool)]
    if (total > 1 and offdiag.min() < 1) or reorder:
        lookahead[:total, :total] = 0
        np.fill_diagonal(lookahead[:total, :total], INF)

    sorted_idx = _sorted_indices(planet, process_regions)
    if faults is not None and faults.crashes and not unavail:
        # doomed processes are suspected from the start: last in every
        # discovery order, so no quorum includes them
        sorted_idx = reorder_doomed_last(sorted_idx, faults.crashes)

    # clients: clients_per_region per region, attached to the closest
    # process
    region_rows = list(dict.fromkeys(client_regions))
    assert len(region_rows) <= dims.RR
    client_attach = np.zeros((C,), np.int32)
    client_attach_s = np.zeros((C, S), np.int32)
    client_region_row = np.full((C,), dims.RR, np.int32)
    client_delay = np.zeros((C, N), np.int32)
    cmd_budget = np.zeros((C,), np.int32)
    c = 0
    for region in client_regions:
        order = {r: i for i, (_lat, r) in enumerate(planet.sorted(region))}
        closest = min(range(n), key=lambda q: (order[process_regions[q]], q))
        for _ in range(clients_per_region):
            assert c < C, "raise EngineDims.C"
            client_attach[c] = closest
            # the connected process of every shard: shards share the
            # region layout, so the closest row repeats per shard block
            for s in range(S):
                client_attach_s[c, s] = s * n + closest
            client_region_row[c] = region_rows.index(region)
            for p in range(total):
                client_delay[c, p] = (
                    planet.ping_latency(region, row_region(p)) // 2
                )
            cmd_budget[c] = commands_per_client
            c += 1

    halted = 0
    if faults is not None and faults.crashes:
        # clients of a doomed process (every client under a doomed
        # leader) are halted: no budget, excused from termination
        mask = halted_client_mask(faults, config, client_attach[:c])
        cmd_budget[:c][mask] = 0
        halted = int(mask.sum())

    intervals = np.asarray(
        protocol.periodic_intervals(config, dims), np.int32
    )
    assert intervals.shape == (dims.R,)

    # workload switch (key_gen.rs:113-119): kind 0 = ConflictPool, kind
    # 1 = Zipf via inverse-CDF over the cumulative weight table; pool
    # lanes carry a 1-element dummy table so shapes stay static
    if zipf is None:
        key_gen_kind = np.int32(0)
        zipf_cum = np.ones((1,), np.float32)
    else:
        coefficient, total_keys = zipf
        key_gen_kind = np.int32(1)
        zipf_cum = np.cumsum(
            zipf_weights(total_keys, coefficient)
        ).astype(np.float32)

    ctx: Dict[str, np.ndarray] = {
        "n": np.int32(n),
        "rows": np.int32(total),
        "f": np.int32(config.f),
        "delay_pp": delay_pp,
        "lookahead": np.minimum(lookahead, INF).astype(np.int32),
        "client_delay": client_delay,
        "client_attach": client_attach,
        "client_attach_s": client_attach_s,
        "client_region_row": client_region_row,
        "cmd_budget": cmd_budget,
        "conflict_rate": np.int32(conflict_rate),
        "pool_size": np.int32(pool_size),
        "key_gen_kind": key_gen_kind,
        "zipf_cum": zipf_cum,
        "rng_key": rnd.PRNGKey(seed),
        "reorder": np.int32(1 if reorder else 0),
        # distinct stream from the workload key generator
        "reorder_key": rnd.fold_in(rnd.PRNGKey(seed), 0x5EED),
        "periodic_intervals": intervals,
        "extra_time": np.int32(extra_time_ms),
    }
    ctx.update(fault_ctx(faults, dims))
    ctx["fault_unavail"] = np.int32(1 if unavail else 0)
    if partial:
        ctx.update(_shard_tables(planet, process_regions, n, S, N))
    ctx.update(protocol.lane_ctx(config, dims, sorted_idx))
    return LaneSpec(
        ctx=ctx,
        config=config,
        region_rows=region_rows,
        process_regions=list(process_regions),
        fault_flags=faults.flags if faults is not None else NO_FAULTS,
        fault_meta=(
            faults.meta(halted_clients=halted, unavail=unavail)
            if faults is not None
            else None
        ),
    )


def _shard_tables(planet: Planet, process_regions: Sequence[str], n: int,
                  S: int, N: int) -> Dict[str, np.ndarray]:
    """Per-row shard id and the closest process of every shard (the
    discovery view each process routes cross-shard messages through,
    util.rs:188-230; ties break by process id). Pad rows carry the
    invalid shard id S, so no shard-membership mask includes them."""
    shard_of = np.full((N,), S, np.int32)
    closest = np.zeros((N, S), np.int32)
    for p in range(S * n):
        shard_of[p] = p // n
        order = {
            r: i
            for i, (_l, r) in enumerate(planet.sorted(process_regions[p % n]))
        }
        i_star = min(range(n), key=lambda i: (order[process_regions[i]], i))
        for s in range(S):
            closest[p, s] = s * n + i_star
    return {"shard_of": shard_of, "closest": closest}


def command_tables(draws: np.ndarray, S: int, KPC: int, T: int,
                   more) -> Dict[str, np.ndarray]:
    """One lane's per-command shard/key tables, replayed on the host from
    its key stream ``draws`` ``[C, W]`` (column i = the i-th draw of the
    client's counter stream, as the ``key_table`` kernel gives it).

    A command is fully determined by (client, seq): ``KPC`` unique keys
    (a duplicate draw is redrawn, workload.rs:156-186), each on shard
    ``key_hash(str(key)) % S`` (client/workload.py:106-107), grouped:
    ``cmd_skey[c, j, s, :]`` = the command's keys on shard s (-1 pad),
    ``cmd_kmask`` the touched-shard bitmask, ``cmd_parts`` the key count
    (the client's expected result parts), ``cmd_target`` the first key's
    shard (the submit target, client/workload.py:84). When a client's
    redraws run past the stream's width, ``more(width)`` returns the
    lane's stream at twice that width (the reference's table grows the
    same way)."""
    C = draws.shape[0]
    kmask = np.zeros((C, T + 1), np.int32)
    skey = np.full((C, T + 1, S, KPC), -1, np.int32)
    parts = np.ones((C, T + 1), np.int32)
    target = np.zeros((C, T + 1), np.int32)
    shard_cache: Dict[int, int] = {}
    for c in range(C):
        i = 1  # draw counter, 1-based like the engine's key stream
        for j in range(1, T + 1):
            keys: List[int] = []
            redraws = 0
            while len(keys) < KPC:
                if i >= draws.shape[1]:
                    draws = more(draws.shape[1])
                k = int(draws[c, i])
                i += 1
                if k in keys:
                    redraws += 1
                    assert redraws < 10_000, (
                        "workload cannot produce unique keys (pool too "
                        "small for keys_per_command at this conflict "
                        "rate)"
                    )
                    continue
                keys.append(k)
            mask, tgt = 0, None
            per_shard: Dict[int, List[int]] = {}
            for k in keys:
                s = shard_cache.get(k)
                if s is None:
                    s = key_hash(str(k)) % S
                    shard_cache[k] = s
                if tgt is None:
                    tgt = s
                mask |= 1 << s
                per_shard.setdefault(s, []).append(k)
            kmask[c, j] = mask
            parts[c, j] = len(keys)
            target[c, j] = tgt
            for s, ks in per_shard.items():
                for d, k in enumerate(ks):
                    skey[c, j, s, d] = k
    return {"cmd_kmask": kmask, "cmd_skey": skey, "cmd_parts": parts,
            "cmd_target": target}


def stack_lanes(specs: Sequence[LaneSpec]) -> Dict[str, np.ndarray]:
    """Stack per-lane ctx dicts into one batched ctx (leading lane axis).
    Every lane must carry the same ctx fields."""
    keys = specs[0].ctx.keys()
    for i, s in enumerate(specs[1:], start=1):
        assert s.ctx.keys() == keys, (
            f"lane {i} ctx fields differ from lane 0 "
            f"({sorted(set(s.ctx) ^ set(keys))})"
        )
    return {k: np.stack([s.ctx[k] for s in specs]) for k in keys}
