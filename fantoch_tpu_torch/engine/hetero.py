"""Mixed-protocol batches (B14): each lane runs only its own protocol.

The counterpart of the reference's ``engine/hetero.py``. There a mixed
batch's lanes are packed into one union tree (``engine/skeleton.py``)
and stepped by one ``lax.switch`` on each lane's ``protocol_id``
(``hetero_switch_step``), which under ``vmap`` computes every
protocol's step for every lane and selects. A lane's protocol never
changes during a run, so here the dispatch happens once, when the batch
is built:

- :func:`prepare_batch` groups the lanes by protocol (``(group,
  LaneSpec)`` pairs, the caller's order), prepares each group as the
  native driver does (its ctx stacked, its key table by K3 under the
  batch's T rule, its initial states; a partial-replication group, such
  as the reference grids' ``tempo@2shards`` and ``atlas@2shards``, also
  its per-command shard and key tables and its first SUBMITs to each
  first command's target shard) at its own dims, and lays the
  groups one after another: the state and ctx are grouped trees
  ``{group: native tree}`` in skeleton audit order, each group's
  liveness planes views of the batch's ``[L]`` buffers
  (``kernels/step_loop.py link``) that K14 reads for the whole batch;
- :func:`hetero_step` is one step of the batch: for each group,
  ``lane_step`` on that group's lanes at its dims, so K1, the group's
  handler kernel, K6 and K2 launch once a group and touch no lane of
  another protocol; :func:`hetero_frozen_step` runs each group's step
  under its cap and returns K2's ``running`` by group;
- :func:`build_hetero_window_runner` (and the segment and eager
  runners) run that step in the native loop: on the card one window is
  one launch of a CUDA graph whose 64-step body holds every group's
  kernels, each group's on a stream of its own, K14 deciding the whole
  batch's early exit;
- :func:`collect_hetero_results` runs each group's lanes through the
  unchanged ``collect_results`` and puts them back in the caller's
  order.

The skeleton (:class:`HeteroBatch`) names the batch: its audits, their
``(protocol, dims)`` and its fingerprint, the reference's for the same
trees. Nothing is padded to union extents; the packed tree exists only
where a caller asks for it (``carry.groups_to_packed``). As in the
reference, every group runs under the batch's reorder flag and fault
flag union, and monitored batches are refused.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence, Tuple

import torch

from .. import resolve_device
from ..kernels.step_loop import clone_tree, link, tree_device
from .checkpoint import canonical_json, run_flags, step_signature
from .core import (
    STEPS_PER_BODY, WindowRunner, finish_segmented, frozen_step, lane_step,
)
from .driver import prepare_batch as native_prepare_batch
from .faults import NO_FAULTS, FaultFlags, flag_bits
from .results import collect_results
from .skeleton import (
    SHARED, Skeleton, SkeletonMismatchError, build_skeleton,
    classify_planes, dtype_name, skeleton_fingerprint, walk_planes,
)

#: the liveness planes of the state K14 reads, from the union's SHARED
#: slots in the reference's loop condition
_RUNNING_STATE_PLANES = ("done_time", "err", "now", "steps")


class HeteroBatchError(RuntimeError):
    """A mixed batch cannot be built or run as asked; always refused by
    name."""


class HeteroBatch:
    """The identity of a mixed batch: the :class:`Skeleton` and each
    audit's ``(protocol, dims)``, in skeleton audit order (index =
    ``protocol_id``). Hashable through the fingerprint and the
    protocols' and dims' values: it keys the cached device loops."""

    def __init__(self, skeleton: Skeleton, protocols: Mapping[str, Any],
                 dims: Mapping[str, Any]):
        missing = sorted(
            set(skeleton.audits) - (set(protocols) & set(dims))
        )
        if missing:
            raise HeteroBatchError(
                f"skeleton grid audits {missing} have no (protocol, "
                "dims) mapping entry: the batch must name every audit "
                "of the skeleton, present in this batch or not"
            )
        slashed = sorted(a for a in skeleton.audits if "/" in a)
        if slashed:
            raise HeteroBatchError(
                f"audit key(s) {slashed} contain '/', the checkpoint "
                "flattener's path separator: state keyed by them would "
                "not survive a checkpoint round trip; rename the groups"
            )
        self.skeleton = skeleton
        self.audits: Tuple[str, ...] = skeleton.audits
        self.protocols = {a: protocols[a] for a in self.audits}
        self.dims = {a: dims[a] for a in self.audits}
        self.fingerprint = skeleton_fingerprint(skeleton)
        self._key = (
            self.fingerprint,
            self.audits,
            tuple(self.protocols[a] for a in self.audits),
            tuple(self.dims[a] for a in self.audits),
        )

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, HeteroBatch) and self._key == other._key

    def __repr__(self):
        return (
            f"HeteroBatch(audits={list(self.audits)}, "
            f"skeleton={self.fingerprint[:12]}...)"
        )


def _check_unmonitored(monitor_keys: int) -> None:
    if monitor_keys:
        raise HeteroBatchError(
            "monitored fuzz states carry planes outside the skeleton; "
            "run monitored batches homogeneous"
        )


# ----------------------------------------------------------------------
# the grouped step (B14)
# ----------------------------------------------------------------------

def hetero_step(hb: HeteroBatch, reorder: bool = False,
                faults: FaultFlags = NO_FAULTS, monitor_keys: int = 0):
    """One step of a mixed batch, ``step(state, ctx) -> state`` on
    grouped trees: each group present, in skeleton audit order, through
    ``lane_step`` at its own dims, under the batch's ``reorder`` flag
    and fault flag union (the counterpart of the reference's
    ``hetero_switch_step``, whose switch computes every audit's step for
    every lane)."""
    _check_unmonitored(monitor_keys)

    def step(st, ctx):
        return {a: lane_step(hb.protocols[a], hb.dims[a], st[a], ctx[a],
                             reorder, faults)
                for a in hb.audits if a in st}

    return step


def hetero_frozen_step(hb: HeteroBatch, st, ctx, lim, reorder: bool = False,
                       faults: FaultFlags = NO_FAULTS, streams=None):
    """One step of the run loop on a mixed batch: ``(state, running)``,
    ``running`` by group; each group's ``frozen_step`` (K1, its handler,
    K6, K2) in skeleton audit order, every kernel handed the group's
    views of the linked liveness planes in the cap (K1 and K6 skip the
    group's frozen lanes, K2, K6 and the handler update the group's
    pool, process state and lane state in place, and each writes a
    frozen lane's planes as they were; ``running`` is K2's). With
    ``streams`` (a dict, on the card) each
    group steps on a CUDA stream of its own, kept there by group, forked
    from and joined to the current stream: the groups share no plane, so
    a group whose kernels leave the card idle (few lanes, or little
    parallel work) overlaps the others."""
    main = None if streams is None else torch.cuda.current_stream()
    out, running = {}, {}
    for a in hb.audits:
        if a not in st:
            continue
        side = None
        if main is not None:
            side = streams.setdefault(a, torch.cuda.Stream(main.device))
            side.wait_stream(main)
        with torch.cuda.stream(side):
            out[a], running[a] = frozen_step(
                hb.protocols[a], hb.dims[a], st[a], ctx[a], lim, reorder,
                faults)
    for a in out if main is not None else ():
        main.wait_stream(streams[a])
    return out, running


def _check_running_planes(skeleton: Skeleton, faults: FaultFlags) -> None:
    """Every liveness plane the loop condition reads must be SHARED (the
    same dtype and extent in every audit), so one ``[L]`` buffer holds
    it for the whole batch; anything else is refused by name."""
    needed = [("state", n) for n in _RUNNING_STATE_PLANES]
    needed.append(("ctx", "extra_time"))
    if faults.horizon:
        needed.append(("ctx", "fault_horizon"))
    for prefix, name in needed:
        ent = skeleton.planes.get(f"{prefix}.{name}")
        verdict = ent["verdict"] if ent else "ABSENT"
        if verdict != SHARED:
            raise HeteroBatchError(
                f"the loop condition reads {prefix}.{name} from the "
                f"batch's shared planes, but this skeleton stores it as "
                f"{verdict}: liveness must be SHARED across every audit "
                "of the grid"
            )


def build_hetero_window_runner(
    hb: HeteroBatch, max_steps: int = 1 << 22, reorder: bool = False,
    faults: FaultFlags = NO_FAULTS, monitor_keys: int = 0,
    steps_per_body: "int | None" = None,
):
    """``(runner, alive)`` with the native ``build_window_runner``'s
    contract on grouped trees: ``runner(state, ctx, untils) -> (state,
    any_alive)`` runs every group's lanes through the ladder of segment
    ends in one host dispatch (on the card one graph launch: a body of
    ``steps_per_body`` mixed steps, K14 over the whole batch), and a
    finished batch re-running a window is a no-op."""
    _check_unmonitored(monitor_keys)
    _check_running_planes(hb.skeleton, faults)
    streams: Dict[str, Any] = {}

    def step(st, ctx, lim):
        on_card = tree_device(st).type == "cuda"
        return hetero_frozen_step(hb, st, ctx, lim, reorder, faults,
                                  streams if on_card else None)[0]

    runner = WindowRunner(("hetero", hb, reorder, faults), step,
                          flag_bits(faults, reorder), max_steps,
                          steps_per_body)
    return runner, runner.alive


def build_hetero_segment_runner(
    hb: HeteroBatch, max_steps: int = 1 << 22, reorder: bool = False,
    faults: FaultFlags = NO_FAULTS, monitor_keys: int = 0,
    steps_per_body: "int | None" = None,
):
    """``(runner, alive)``: ``runner(state, ctx, until) -> (state,
    any_alive)`` advances every running lane of the mixed batch to at
    most ``until`` steps (a window of one segment)."""
    window, alive = build_hetero_window_runner(
        hb, max_steps, reorder, faults, monitor_keys, steps_per_body)

    def runner(state, ctx, until):
        return window(state, ctx, [until])

    runner.window = window
    return runner, alive


def finish_hetero(state, max_steps: int):
    """Each group's ``finish_segmented``: ``ERR_TRUNCATED`` on lanes cut
    by ``max_steps``."""
    return {a: finish_segmented(st, max_steps) for a, st in state.items()}


def build_hetero_eager_runner(
    hb: HeteroBatch, max_steps: int = 1 << 22, reorder: bool = False,
    faults: FaultFlags = NO_FAULTS, monitor_keys: int = 0,
):
    """``run(state, ctx) -> final state``: the host loop of
    :func:`hetero_frozen_step` calls, each kernel launched by its
    wrapper, liveness read every ``STEPS_PER_BODY`` steps, then
    :func:`finish_hetero`; for callers that hold each launch against its
    twin. The caller's state is cloned once, at entry (the steps
    consume theirs)."""
    _check_unmonitored(monitor_keys)

    def run(state, ctx):
        st = clone_tree(state)
        while True:
            for _ in range(STEPS_PER_BODY):
                st, running = hetero_frozen_step(hb, st, ctx, max_steps,
                                                 reorder, faults)
            if not any(bool(r.any()) for r in running.values()):
                break
        return finish_hetero(st, max_steps)

    return run


# ----------------------------------------------------------------------
# batch preparation
# ----------------------------------------------------------------------

def _group_lanes(lane_specs) -> "Dict[str, list]":
    groups: Dict[str, list] = {}
    for i, item in enumerate(lane_specs):
        try:
            audit, spec = item
        except (TypeError, ValueError):
            raise HeteroBatchError(
                "hetero batches take (group, LaneSpec) pairs: got "
                f"{type(item).__name__} at lane {i}"
            ) from None
        groups.setdefault(str(audit), []).append((i, spec))
    return groups


def _keys_budget_T(groups: Mapping[str, list]) -> int:
    """One key-table extent for the whole batch, the reference's rule:
    the largest command budget + 2, at least 2 (a key does not depend on
    T)."""
    return int(max([2] + [int(s.ctx["cmd_budget"].max()) + 2
                          for items in groups.values() for _, s in items]))


def _classify_specs(gstate: Mapping[str, dict],
                    gctx: Mapping[str, dict]) -> Dict[str, dict]:
    """``{group: {plane: (shape, dtype)}}`` of a lane of each group (the
    lane axis dropped)."""
    out: Dict[str, dict] = {}
    for a in sorted(gstate):
        leaves = {**walk_planes(gstate[a], "state"),
                  **walk_planes(gctx[a], "ctx")}
        out[a] = {n: (tuple(v.shape[1:]), dtype_name(v))
                  for n, v in leaves.items()}
    return out


def _check_native(skeleton: Skeleton, audit: str, spec: dict) -> None:
    """A group's planes must be the skeleton's native spec of its audit,
    plane for plane."""
    want = {n: (tuple(e["native"][audit]["shape"]),
                e["native"][audit]["dtype"])
            for n, e in skeleton.planes.items() if audit in e["native"]}
    if want != spec:
        diff = sorted(set(want.items()) ^ set(spec.items()))
        raise SkeletonMismatchError(
            f"{audit}: the group's planes differ from the skeleton's "
            f"native spec: {diff[:4]}"
        )


def _table_T(skeleton: "Skeleton | None", audit: str, T: int) -> int:
    """The group's key-table extent: ``T``, or the skeleton's."""
    if skeleton is None:
        return T
    ent = skeleton.planes.get("ctx.key_table")
    if ent is None:
        raise HeteroBatchError(
            "the skeleton carries no ctx.key_table: the port draws every "
            "key from the key table (in-loop key generation is not "
            "ported)"
        )
    nat = ent["native"].get(audit)
    if nat is None:
        raise SkeletonMismatchError(
            f"skeleton carries ctx.key_table but has no native spec for "
            f"group {audit!r}"
        )
    return int(nat["shape"][1])


def _prepare_groups(protocols, dims, groups, device, skeleton):
    """Each group prepared as the native driver prepares a batch, under
    the batch's key-table extent: ``(states, ctxs)`` by group. A
    partial-replication group's per-command tables come from its own key
    stream, drawn and regrown at widths of its own command budget
    (``driver.partial_tables``), whatever the batch's extent."""
    for a in sorted(groups):
        if a not in protocols or a not in dims:
            raise HeteroBatchError(
                f"mixed batch names group {a!r} with no (protocol, dims) "
                "mapping entry"
            )
    if skeleton is not None:
        stray = sorted(set(groups) - set(skeleton.audits))
        if stray:
            raise SkeletonMismatchError(
                f"batch carries groups {stray} outside the skeleton grid "
                f"{list(skeleton.audits)}"
            )
    T = _keys_budget_T(groups)
    gstate, gctx = {}, {}
    for a in sorted(groups):
        gstate[a], gctx[a] = native_prepare_batch(
            protocols[a], dims[a], [s for _, s in groups[a]], device,
            T=_table_T(skeleton, a, T))
    return gstate, gctx


def prepare_batch(
    protocols: Mapping[str, Any],
    dims: Mapping[str, Any],
    lane_specs: Sequence[tuple],
    device=None,
    *,
    monitor_keys: int = 0,
    skeleton: "Skeleton | None" = None,
):
    """One mixed batch on ``device`` (default: the CUDA card).
    ``lane_specs`` is the ordered ``[(group, LaneSpec), ...]`` list;
    ``protocols``/``dims`` map every group (and, when ``skeleton`` is
    given, every skeleton audit) to its device protocol and dims.

    Returns ``(hb, state, ctx, lanes)``: the :class:`HeteroBatch`, the
    grouped state and ctx trees (groups in skeleton audit order, their
    liveness planes linked) and ``lanes``, each group's lanes' indices
    in ``lane_specs``. Without ``skeleton`` it is derived from the
    batch (a lane of each group classified across groups, audits
    sorted); a given one fixes each group's key-table extent, and a
    group outside it, or whose planes differ from its native spec, is
    refused by name."""
    _check_unmonitored(monitor_keys)
    dev = resolve_device(device)
    groups = _group_lanes(lane_specs)
    gstate, gctx = _prepare_groups(protocols, dims, groups, dev, skeleton)
    specs = _classify_specs(gstate, gctx)
    if skeleton is None:
        skeleton = build_skeleton(classify_planes(specs),
                                  audits=tuple(sorted(groups)))
    else:
        for a, spec in specs.items():
            _check_native(skeleton, a, spec)
    hb = HeteroBatch(skeleton, protocols, dims)
    order = [a for a in hb.audits if a in groups]
    state = link({a: gstate[a] for a in order})
    ctx = link({a: gctx[a] for a in order})
    lanes = {a: [i for i, _ in groups[a]] for a in order}
    return hb, state, ctx, lanes


def build_grid_skeleton(
    protocols: Mapping[str, Any],
    dims: Mapping[str, Any],
    rep_specs: Mapping[str, Any],
    device=None,
) -> Skeleton:
    """The skeleton of a whole grid: one representative lane of each
    group classified into the union, so every batch of the grid,
    whatever its composition, carries the same skeleton. (The reference
    also decides there whether the grid's batches carry a key table;
    the port's always do.)"""
    order = sorted(rep_specs)
    if not order:
        raise HeteroBatchError("a hetero grid needs at least one group")
    groups = {a: [(0, rep_specs[a])] for a in order}
    gstate, gctx = _prepare_groups(protocols, dims, groups,
                                   resolve_device(device), None)
    return build_skeleton(classify_planes(_classify_specs(gstate, gctx)),
                          audits=tuple(order))


# ----------------------------------------------------------------------
# the checkpoint signature
# ----------------------------------------------------------------------

def hetero_step_signature(hb: HeteroBatch, *, reorder: bool,
                          faults: FaultFlags) -> Dict[str, str]:
    """The mixed twin of ``engine/checkpoint.py step_signature`` (the
    reference's ``hetero_step_signature``; mixed batches run no
    monitors): the batch's run flags, the skeleton's fingerprint as its
    marker, and one native signature per skeleton audit, present in the
    batch or not (``group <audit>``, its canonical JSON), so every batch
    of one grid signs alike."""
    sig = run_flags(reorder, faults, 0)
    sig["protocol"] = "hetero[" + "+".join(hb.audits) + "]"
    sig["skeleton"] = hb.fingerprint
    for a in hb.audits:
        sig[f"group {a}"] = canonical_json(step_signature(
            hb.protocols[a], hb.dims[a], reorder=reorder, faults=faults,
            monitor_keys=0))
    return sig


# ----------------------------------------------------------------------
# results
# ----------------------------------------------------------------------

def result_fetch_tree(hb: HeteroBatch, state) -> dict:
    """The planes result collection reads, by group: the engine's
    result planes and each protocol's ``ps.m_*`` metrics (the
    reference's fetch sub-tree, grouped)."""
    del hb  # every group present carries the same result planes
    out = {}
    for a, st in state.items():
        out[a] = {
            **{k: st[k] for k in ("done_time", "err", "fault_dropped",
                                  "pool_peak", "requeues", "steps")},
            "clients": {"completed": st["clients"]["completed"]},
            "metrics": {k: st["metrics"][k]
                        for k in ("hist", "lat_count", "lat_sum")},
            "ps": {k: v for k, v in st["ps"].items() if k.startswith("m_")},
        }
    return out


def collect_hetero_results(hb: HeteroBatch, lane_specs: Sequence[tuple],
                           fetched, max_steps: int) -> List[Any]:
    """Each group's lanes of ``fetched`` (grouped, e.g.
    :func:`result_fetch_tree`) through ``finish_segmented`` and the
    unchanged ``collect_results``; results in ``lane_specs`` order."""
    out: List[Any] = [None] * len(lane_specs)
    groups = _group_lanes(lane_specs)
    for a in hb.audits:
        if a not in groups:
            continue
        items = groups[a]
        res = collect_results(
            hb.protocols[a], hb.dims[a],
            finish_segmented(fetched[a], max_steps), [s for _, s in items])
        for (i, _), r in zip(items, res):
            out[i] = r
    return out
