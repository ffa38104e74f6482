"""The fleet worker loop: claim units, run them, journal them (the
port's copy of the JAX package's ``fleet/worker.py``; units run on the
CUDA card unless the caller passes ``device="cpu"``).

One worker = one process = one worker-scoped journal
(``journals/<worker_id>.jsonl``). The single-process campaign manager
appends + fsyncs one shared ``journal.jsonl`` (campaign/manager.py)
— that file cannot be shared between writers (interleaved appends tear
each other), so each fleet worker owns its journal exclusively and
readers union all of them (plus the legacy single-process journal, so
a campaign started under ``cli.py campaign`` can be *finished* by a
fleet).

Unit execution is exactly the manager's: a sweep unit runs through
``run_sweep(checkpoint=...)`` with a per-unit checkpoint dir under the
shared campaign dir, so when a worker dies (or a budget stop raises
``SweepInterrupted``) the unit's durable state is already where the
NEXT claimer will look — any worker resumes any unit, and the signed
checkpoint manifest (engine/checkpoint.py) refuses a resume across
protocol/dims drift by name. The reference's sharding and serialized
executables (``shard_lanes``, ``mesh_shard``, ``aot``) have no
counterpart: :func:`run_fleet_worker` refuses a spec that sets them
(``campaign/manager.py check_ported``) before anything is written. Fuzz units lease a whole
(protocol, n) point (chunks within a point are sequential by
construction — chunk k's plans depend on the generator position after
chunk k−1) and persist the cumulative point state per chunk.

Budget semantics mirror the manager's: at least one unit of progress
per invocation, then stop at the next boundary; SIGTERM/SIGINT stop
at the next boundary with the in-flight sweep unit checkpoint-flushed
by ``run_sweep``'s own handlers.
"""

from __future__ import annotations

import json
import os
import time
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

from .leases import DEFAULT_TTL_S, FleetError, check_worker_id, claim_unit

JOURNALS_DIR = "journals"
_LEGACY_JOURNAL = "journal.jsonl"


def worker_scan_order(keys: Sequence[str], worker_id: str) -> List[str]:
    """Lease-aware work-stealing scan order: rotate the canonical unit
    enumeration by a worker-id-derived offset so concurrent workers
    start their claim scans at *different* units instead of all racing
    unit 0 and cascading down the list one contended claim at a time.
    Purely a throughput hint — which worker runs which unit was never
    part of any contract; the deterministic output order still comes
    from the canonical enumeration at merge time (fleet/merge.py), so
    merge order and byte-identity guarantees are untouched."""
    if not keys:
        return list(keys)
    off = zlib.crc32(worker_id.encode("utf-8")) % len(keys)
    return list(keys[off:]) + list(keys[:off])


# lease-claim backoff bounds (claim_backoff_s): base doubles per
# consecutive miss up to this cap — long enough to let a holder finish
# a chunk, short enough that a freed unit is picked up promptly
_BACKOFF_BASE_S = 0.01
_BACKOFF_CAP_S = 0.25


def claim_backoff_s(worker_id: str, misses: int) -> float:
    """Bounded deterministic backoff after ``misses`` consecutive lost
    lease claims: exponential in the miss streak with a worker-id-keyed
    phase (crc32 — no wall clock, no ``random.*``; GL402 keeps ambient
    nondeterminism out of journaled artifacts, and this function's
    output only ever feeds ``time.sleep``) so contending workers
    desynchronize instead of re-colliding in lockstep. Pure function
    of (worker_id, misses): the same worker backs off the same way in
    every replay."""
    if misses <= 0:
        return 0.0
    step = min(int(misses), 5)
    phase = (
        zlib.crc32(f"{worker_id}:{misses}".encode("utf-8")) % 1024
    ) / 1024.0
    return min(
        _BACKOFF_BASE_S * (1 << step) * (0.5 + 0.5 * phase),
        _BACKOFF_CAP_S,
    )


def worker_journal_path(path: str, worker: str) -> str:
    return os.path.join(path, JOURNALS_DIR, f"{worker}.jsonl")


def append_worker_journal(path: str, worker: str, entry: dict) -> None:
    """Append-fsync one entry to the worker's own journal (the same
    torn-final-line crash contract as the manager's journal)."""
    from ..engine.checkpoint import canonical_json

    os.makedirs(os.path.join(path, JOURNALS_DIR), exist_ok=True)
    with open(worker_journal_path(path, worker), "a") as fh:
        fh.write(canonical_json(entry) + "\n")
        fh.flush()
        os.fsync(fh.fileno())


def read_all_journals(path: str) -> List[dict]:
    """Union of every journal in the campaign dir: the legacy
    single-process ``journal.jsonl`` plus every worker journal, each
    read with the per-file torn-final-line tolerance. Order: legacy
    first, then workers sorted by id — readers must not depend on
    cross-journal order (completion order is racy by nature); the
    deterministic order comes from the canonical unit enumeration at
    merge time."""
    from ..campaign.manager import _read_journal_file

    entries: List[dict] = []
    legacy = os.path.join(path, _LEGACY_JOURNAL)
    if os.path.exists(legacy):
        entries.extend(_read_journal_file(legacy))
    jdir = os.path.join(path, JOURNALS_DIR)
    if os.path.isdir(jdir):
        for name in sorted(os.listdir(jdir)):
            if name.endswith(".jsonl"):
                entries.extend(
                    _read_journal_file(os.path.join(jdir, name))
                )
    return entries


def sweep_done_units(entries: List[dict]) -> Dict[str, List[dict]]:
    """Completed sweep units across all journals. Duplicate entries
    for one unit (two workers both completed it — possible when a
    lease expired under a live-but-slow worker) must carry identical
    results: unit execution is deterministic, so a mismatch means the
    determinism contract itself is broken and the merge must refuse
    rather than pick a winner."""
    done: Dict[str, List[dict]] = {}
    for entry in entries:
        if entry.get("kind") != "batch":
            continue
        key, rows = entry["id"], entry["results"]
        if key in done and done[key] != rows:
            raise FleetError(
                f"unit {key!r} was journaled twice with DIFFERING "
                "results — unit execution must be deterministic; "
                "refusing to merge"
            )
        done.setdefault(key, rows)
    return done


def fuzz_point_progress(entries: List[dict]) -> Dict[str, dict]:
    """Latest fuzz state per point across all journals: entries are
    cumulative, so the one with the highest ``tried`` wins (ties are
    identical by determinism — same plans, same counters)."""
    progress: Dict[str, dict] = {}
    for entry in entries:
        if entry.get("kind") != "fuzz":
            continue
        key = entry["point"]
        prev = progress.get(key)
        if prev is None or int(entry["tried"]) > int(prev["tried"]):
            progress[key] = entry
    return progress


def fuzz_points(spec) -> List[Tuple[str, int, str]]:
    """The canonical (protocol, n, fault class) unit triples — the
    fleet twin of ``campaign.manager.fuzz_point_keys`` (legacy specs
    carry ``classes=("mixed",)``, collapsing to the pre-split pairs
    under the legacy keys)."""
    classes = tuple(getattr(spec, "classes", ("mixed",)))
    return [
        (p, n, c)
        for p in spec.protocols
        for n in spec.ns
        for c in classes
    ]


def _run_sweep_units(path, spec, worker_id, deadline, stop_flag,
                     ttl_s, stop_after_units, stop_after_segments,
                     device):
    from ..campaign.manager import _CKPT, _sweep_batches
    from ..engine.checkpoint import (
        CheckpointSpec,
        SweepInterrupted,
        discard_checkpoint,
    )
    from ..parallel.sweep import run_sweep

    batches = _sweep_batches(spec)
    hetero = bool(getattr(spec, "hetero", False))
    hetero_kwargs = {}
    positions = None
    if hetero:
        # mixed-unit layout: every worker derives the SAME plan and
        # skeleton from the stored spec (a pure function of it), so
        # every unit — whatever its protocol composition — runs through
        # the one mixed runner
        from ..campaign.manager import _hetero_grid

        protos, dmap, units, positions, skeleton = \
            _hetero_grid(spec, batches, device=device)
        work = [(key, protos, dmap, lanes) for key, lanes in units]
        hetero_kwargs = {"hetero": True, "skeleton": skeleton}
    else:
        work = batches
    by_key = {key: (dev, dims, lanes) for key, dev, dims, lanes in work}
    # work-stealing scan: each worker walks the SAME unit set in a
    # worker-id-rotated order, so early canonical units stop being a
    # contention hot spot (every claim miss is a wasted lease-dir
    # round trip); completion/merge order is unaffected
    scan_keys = worker_scan_order(
        [key for key, *_ in work], worker_id
    )
    interrupted = None
    completed = 0
    skipped_held = 0
    claim_attempts = 0
    misses = 0
    # repeated passes over the grid: a unit leased elsewhere on pass k
    # may be journaled, abandoned (checkpointed + released), or
    # expired by pass k+1 — the worker keeps sweeping as long as it
    # makes progress, and exits 75 (not blocks) once a full pass
    # completes nothing, leaving any still-held units to their holders
    # (or to the next invocation after their TTL)
    while True:
        pass_completed = 0
        pass_held = 0
        # one journal scan per pass (a per-unit rescan would make the
        # claim loop O(units² × journal bytes)); the done-set then
        # grows incrementally from this worker's own completions, and
        # is re-read in full only on the rare event that matters — a
        # successful claim of a unit someone else may just have
        # finished
        done = sweep_done_units(read_all_journals(path))
        for key in scan_keys:
            dev, dims, lanes = by_key[key]
            if stop_flag["sig"] is not None:
                interrupted = f"signal {stop_flag['sig']}"
                break
            if stop_after_units is not None and (
                completed >= stop_after_units
            ):
                interrupted = "unit-limit"
                break
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0 and completed:
                    interrupted = "budget exhausted"
                    break
                remaining = max(remaining, 0.0)
            if key in done:
                continue
            claim_attempts += 1
            lease = claim_unit(path, key, worker_id, ttl_s)
            if lease is None:
                # a lost claim used to retry the next unit immediately
                # — a hot spin when most of the grid is held. Back off
                # (bounded, worker-keyed, deterministic) and spend the
                # bought time refreshing the done-set: units whose
                # holders finished during the backoff are skipped
                # without burning another claim on them
                pass_held += 1
                misses += 1
                time.sleep(claim_backoff_s(worker_id, misses))
                done = sweep_done_units(read_all_journals(path))
                continue
            misses = 0
            try:
                # the unit may have been journaled between the pass
                # scan and the claim (its previous holder finishing):
                # refresh and never re-run
                done = sweep_done_units(read_all_journals(path))
                if key in done:
                    continue
                ckpt_path = os.path.join(
                    path, _CKPT, key.replace("/", "_")
                )
                ck = CheckpointSpec(
                    path=ckpt_path,
                    every=spec.checkpoint_every,
                    budget_s=remaining,
                    stop_after_segments=stop_after_segments,
                    keep=True,  # durable until the journal append lands
                )
                try:
                    # a unit is one batch, as in the manager's loop
                    with lease.heartbeater():
                        results = run_sweep(
                            dev,
                            dims,
                            lanes,
                            batch_lanes=max(len(lanes), 1),
                            max_steps=spec.max_steps,
                            device=device,
                            segment_steps=spec.segment_steps,
                            checkpoint=ck,
                            pipeline_depth=spec.pipeline_depth,
                            scan_window=spec.scan_window,
                            **hetero_kwargs,
                        )
                except SweepInterrupted as e:
                    # the unit's state is durably checkpointed under
                    # the SHARED dir: releasing the lease (the finally
                    # below) puts it straight back into the pool for
                    # any worker
                    interrupted = e.reason
                    break
                rows = [r.to_json() for r in results]
                if positions is not None:
                    # drop the final unit's padding rows — only the
                    # plan's real (batch, lane) rows are journaled, so
                    # duplicate completions across workers stay
                    # byte-identical and the merge regroups cleanly
                    rows = rows[: len(positions[key])]
                append_worker_journal(
                    path, worker_id,
                    {"kind": "batch", "id": key, "results": rows},
                )
                done[key] = rows
                discard_checkpoint(ckpt_path)
                completed += 1
                pass_completed += 1
            finally:
                lease.release()
            if stop_flag["sig"] is not None:
                interrupted = f"signal {stop_flag['sig']}"
                break
        done = sweep_done_units(read_all_journals(path))
        if interrupted or not pass_completed or all(
            k in done for k, *_ in work
        ):
            skipped_held = pass_held
            break

    return {
        "kind": "sweep",
        "worker": worker_id,
        "units_total": len(work),
        "units_done": sum(1 for k, *_ in work if k in done),
        "units_completed_here": completed,
        "units_held_elsewhere": skipped_held,
        "claim_attempts": claim_attempts,
        "done": all(k in done for k, *_ in work),
        "interrupted": interrupted,
        "dir": path,
    }


def _fuzz_retired_set(spec, entries) -> set:
    from ..campaign.manager import fuzz_retired

    return set(fuzz_retired(spec, entries))


def _heal_retirements(path, spec, worker_id, progress, retired) -> None:
    """Append any retirement entries the journaled dryness counters
    already imply (campaign.manager.retire_entry): self-healing like
    the manager loop — a worker killed between a dry chunk's append
    and its retirement entry leaves the next reader to write the
    identical entry, and duplicates across worker journals are
    identical content by construction."""
    from ..campaign.manager import point_class_key, retire_entry

    if not int(getattr(spec, "retire_after", 0)):
        return
    for proto, n, cls in fuzz_points(spec):
        key = point_class_key(proto, n, cls)
        e = progress.get(key)
        if (
            e is not None
            and key not in retired
            and int(e.get("tried", 0)) < spec.schedules
            and int(e.get("cov_dry", 0)) >= int(spec.retire_after)
        ):
            append_worker_journal(
                path, worker_id, retire_entry(key, e)
            )
            retired.add(key)


def _run_fuzz_units(path, spec, worker_id, deadline, stop_flag, ttl_s,
                    stop_after_units, device):
    from ..campaign.manager import (
        _fuzz_chunk,
        _planet,
        point_class_key,
    )

    planet = _planet(spec.aws)
    points = fuzz_points(spec)
    keys = [point_class_key(p, n, c) for p, n, c in points]
    steered = bool(spec.coverage)
    interrupted = None
    chunks_done = 0
    completed_points = 0
    claim_attempts = 0
    misses = 0

    def settled(progress, retired):
        # a point is settled once fully fuzzed OR retired — retired
        # budget recycles into the live grid instead of blocking done
        return [
            k in retired
            or int(progress.get(k, {}).get("tried", 0))
            >= spec.schedules
            for k in keys
        ]

    # the same pass discipline as the sweep loop: keep sweeping while
    # progressing, exit (not block) once a pass advances nothing
    while True:
        pass_chunks = chunks_done
        journal = read_all_journals(path)
        progress = fuzz_point_progress(journal)
        retired = _fuzz_retired_set(spec, journal)
        _heal_retirements(path, spec, worker_id, progress, retired)
        if steered:
            # fleet-steered budgets: every worker ranks the SAME
            # union-of-journals state (mc/coverage.py rank_points —
            # recent bucket-discovery rate + starvation floor), so the
            # fleet collectively pushes budget where coverage still
            # climbs; the lease layer resolves two workers picking the
            # same point
            from ..mc.coverage import rank_points

            scan = rank_points(
                points, progress, spec.schedules,
                min_share=spec.min_share, retired=retired,
            )
        else:
            # blind mode: the canonical enumeration, rotated per
            # worker like the sweep unit scan
            scan = worker_scan_order(
                [
                    k
                    for k in keys
                    if int(progress.get(k, {}).get("tried", 0))
                    < spec.schedules
                ],
                worker_id,
            )
        for key in scan:
            if interrupted:
                break
            if stop_after_units is not None and (
                completed_points >= stop_after_units
            ):
                interrupted = "unit-limit"
                break
            proto, n, cls = _parse_key(key)
            claim_attempts += 1
            lease = claim_unit(path, key, worker_id, ttl_s)
            if lease is None:
                # bounded deterministic backoff instead of the old
                # immediate retry on the next ranked point — see
                # claim_backoff_s; nothing journaled depends on it
                misses += 1
                time.sleep(claim_backoff_s(worker_id, misses))
                continue
            misses = 0
            try:
                # re-read under the lease: the previous holder may
                # have advanced (or finished/retired) the point before
                # releasing — the journaled cumulative state (root +
                # mutator generator positions, coverage map, seed
                # pool) crosses workers through the journals
                journal = read_all_journals(path)
                prev = fuzz_point_progress(journal).get(key)
                if key in _fuzz_retired_set(spec, journal):
                    continue
                tried = int(prev["tried"]) if prev else 0
                if tried >= spec.schedules:
                    completed_points += 1
                    continue
                with lease.heartbeater():
                    while tried < spec.schedules:
                        if stop_flag["sig"] is not None:
                            interrupted = f"signal {stop_flag['sig']}"
                            break
                        if (
                            deadline is not None
                            and time.monotonic() > deadline
                            and chunks_done
                        ):
                            interrupted = "budget exhausted"
                            break
                        entry = _fuzz_chunk(
                            spec, proto, n, prev, planet, path,
                            fault_class=cls, device=device,
                        )
                        append_worker_journal(path, worker_id, entry)
                        prev = entry
                        tried = int(entry["tried"])
                        chunks_done += 1
                        if int(getattr(spec, "retire_after", 0)) and (
                            int(entry.get("cov_dry", 0))
                            >= int(spec.retire_after)
                        ):
                            # plateaued under our own lease: journal
                            # the retirement immediately so the next
                            # ranking (ours or any peer's) recycles
                            # this point's budget
                            break
                        if steered and tried < spec.schedules:
                            # one chunk per claim: re-rank against the
                            # fleet's fresh journals instead of
                            # draining the point while its coverage
                            # curve may have gone cold
                            break
                    else:
                        completed_points += 1
            finally:
                lease.release()
            if steered:
                break  # re-rank after every claimed chunk
        journal = read_all_journals(path)
        progress = fuzz_point_progress(journal)
        retired = _fuzz_retired_set(spec, journal)
        _heal_retirements(path, spec, worker_id, progress, retired)
        if interrupted or all(settled(progress, retired)) or (
            chunks_done == pass_chunks
        ):
            break

    journal = read_all_journals(path)
    progress = fuzz_point_progress(journal)
    retired = _fuzz_retired_set(spec, journal)
    state = settled(progress, retired)
    return {
        "kind": "fuzz",
        "worker": worker_id,
        "points_total": len(points),
        "points_done": sum(1 for s in state if s),
        "points_retired": len(retired),
        "claim_attempts": claim_attempts,
        "done": all(state),
        "interrupted": interrupted,
        "dir": path,
    }


def _parse_key(key: str) -> Tuple[str, int, str]:
    from ..campaign.manager import parse_point_key

    return parse_point_key(key)


def run_fleet_worker(
    path: str,
    spec=None,
    *,
    worker_id: str,
    budget_s: Optional[float] = None,
    ttl_s: float = DEFAULT_TTL_S,
    stop_after_units: Optional[int] = None,
    stop_after_segments: Optional[int] = None,
    device=None,
) -> dict:
    """Run one fleet worker over the campaign in ``path`` until the
    grid is drained (``done: True`` — every unit journaled by
    *someone*), the budget/signal stops it, or only leased-elsewhere
    units remain. ``spec=None`` resumes the stored campaign (like
    ``campaign --resume``); passing a spec creates the campaign dir on
    first touch — concurrent first touches write the identical bytes,
    so worker start order never matters.

    ``stop_after_units`` / ``stop_after_segments`` are the
    deterministic-interruption test hooks (the latter is threaded into
    the per-unit ``engine/checkpoint.py CheckpointSpec``, stopping
    mid-unit with the checkpoint durable).

    The units run on ``device`` (default the CUDA card, which raises
    without a GPU; ``"cpu"`` runs the kernels' plain twins). A spec that
    sets a field the port does not run (``aot``, ``shard_lanes``,
    ``mesh_shard``) is refused by name before anything is written."""
    from .. import resolve_device
    from ..campaign.manager import _load_or_init_spec, check_ported

    device = resolve_device(device)
    check_worker_id(worker_id)
    if spec is not None:
        check_ported(spec)
    spec = _load_or_init_spec(path, spec, resume=spec is None)
    check_ported(spec)
    deadline = (
        time.monotonic() + budget_s if budget_s is not None else None
    )
    stop_flag = {"sig": None}
    restores = []
    import signal as _signal

    def _on_signal(num, _frame):
        stop_flag["sig"] = num

    try:
        for s in (_signal.SIGTERM, _signal.SIGINT):
            restores.append((s, _signal.signal(s, _on_signal)))
    except ValueError:
        restores = []  # not the main thread: unit-boundary stops only
    try:
        if spec.kind == "sweep":
            return _run_sweep_units(
                path, spec, worker_id, deadline, stop_flag, ttl_s,
                stop_after_units, stop_after_segments, device,
            )
        return _run_fuzz_units(
            path, spec, worker_id, deadline, stop_flag, ttl_s,
            stop_after_units, device,
        )
    finally:
        for s, old in restores:
            _signal.signal(s, old)
