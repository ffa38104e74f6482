"""Coverage-guided continuous fuzzing: AFL-style interleaving coverage (the
port's copy of the JAX package's ``mc/coverage.py``; on the card the
digests are K13 ``mon_finalize``'s ``cov_digest``).

The fuzzer's device fan-out already computes the richest signal a
schedule produces for free: each lane's per-process rolling
execution-order hashes, folded on device into one i32 **coverage
digest** per lane (``engine/monitor.py cov_digest``, surfaced through
``LaneResults.coverage``). Two schedules with the same digest drove
the executors through the same per-key interleaving — so the digest is
the greybox-fuzzing coverage signal (AFL/libFuzzer style), with PCT
randomized scheduling (Burckhardt et al., ASPLOS'10) as the sampling
substrate underneath. This module turns it into a feedback loop:

* :class:`CoverageMap` — the persistent digest → hit-count bucket map.
  ``observe(digests)`` folds a batch in and returns the digests that
  opened **new** buckets; the map serializes to JSON, rides the fuzz
  campaign journal next to the PRNG position (campaign/manager.py),
  and resumes bit-exact across SIGKILL. Maps carry a **point
  signature** (protocol/dims identity plus the digest scheme version)
  and loading against a different signature is *refused by name*
  (:class:`CoverageMismatchError`) — exactly the checkpoint layer's
  posture, because digests from different protocols, fleet sizes or
  workloads live in incomparable spaces;
* **seed mutation** — a plan whose schedule hit a new bucket becomes a
  seed (:class:`SeedPool`, bounded FIFO, journaled as canonical plan
  JSON). ``draw_steered`` draws the next chunk's plans by mutating
  seeds (:func:`mutate_plan`: jitter perturbation, drop toggle,
  crash-time shift — every mutation stays within the protocol's
  ``min_live`` and produces only *seeded* plan forms, so every mutant
  is host-replayable by construction and confirmation/shrink/replay
  work unchanged), falling back to the root-PRNG stream when the pool
  is dry. The mutator RNG's position is journaled like the root
  generator's, so chunked draws equal one-shot draws whoever resumes;
* **budget steering** — :func:`rank_points` orders a campaign's
  (protocol, n) points by their recent bucket-discovery rate (buckets
  found per schedule over the last ``steer_window`` chunks), with a
  starvation floor: any point more than ``1 - min_share`` behind the
  most-fuzzed point is served first, so no point starves however cold
  its coverage curve. The ranking reads only journaled counters, so a
  resumed session — or any worker of a fleet reading the union of
  worker journals (fleet/worker.py) — steers identically.

What a bucket does and does NOT distinguish is documented in
docs/MC.md ("Coverage-guided fuzzing").
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# parse_point_key / point_class_key are re-exported here for
# coverage-centric callers; their canonical definitions live in
# campaign/manager.py
from ..campaign.manager import (
    CampaignError,
    parse_point_key,
    point_class_key,
)
from ..engine.faults import FaultPlan, unavailable
from ..engine.monitor import HASH_MUL

COVERAGE_KIND = "fantoch-fuzz-coverage"
#: bump when the digest construction changes — maps across versions
#: are incomparable and must refuse, like checkpoints across builds
COVERAGE_VERSION = 1

#: seed pool bound (FIFO, newest kept): enough diversity to keep the
#: mutator productive, small enough that journaling the pool per chunk
#: stays cheap
MAX_SEEDS = 32

#: share of a steered chunk drawn by mutating seeds (the rest keeps
#: sampling the root-PRNG stream so exploration never collapses onto
#: the pool)
MUTATE_SHARE = 0.75

#: default chunks of history the discovery rate averages over
STEER_WINDOW = 4

#: default starvation floor: every incomplete point is kept within
#: this share of the most-fuzzed point's schedule count
MIN_SHARE = 0.25


class CoverageError(CampaignError):
    """A coverage artifact and the request disagree — refused loudly,
    never silently rebuilt (the map IS the campaign's accumulated
    coverage; dropping it on a mismatch would restart from zero).
    Subclasses :class:`~fantoch_tpu_torch.campaign.manager.CampaignError` so
    the campaign/fleet CLIs surface it as the standard exit-2 refusal
    naming the reason."""


class CoverageMismatchError(CoverageError):
    """The stored map's point signature (protocol/dims identity +
    digest version) does not match the requesting fuzz point."""


def point_key(protocol: str, n: int) -> str:
    return f"{protocol}/n{n}"


def point_signature(spec) -> dict:
    """The identity a coverage map is bound to: everything the digest
    space depends on — protocol + shape (digests fold per-process
    matrices whose meaning changes with n/clients/keys), the fixed
    workload (seed/conflict/commands), the digest scheme version, AND
    the fault envelope (jitter/crash/drop knobs): seeds pooled under
    one envelope must never re-mutate under another (a pooled crash
    seed would keep its crashes in a ``crash_share=0`` point — the
    introduction guards in :func:`mutate_plan` cannot catch a fault
    class the pool already carries). Two points with equal signatures
    draw digests AND seeds from the same space; anything else is
    refused by name at load."""
    out = {
        "kind": COVERAGE_KIND,
        "version": COVERAGE_VERSION,
        "hash_mul": HASH_MUL,
        "protocol": spec.protocol,
        "n": int(spec.n),
        "f": int(spec.f),
        "conflict": int(spec.conflict),
        "pool_size": int(spec.pool_size),
        "clients_per_region": int(spec.clients_per_region),
        "commands_per_client": int(spec.commands_per_client),
        "seed": int(spec.seed),
        "jitter_max": int(spec.jitter_max),
        "crash_share": float(spec.crash_share),
        "drop_share": float(spec.drop_share),
        "drop_bp": int(spec.drop_bp),
        "drop_horizon_ms": int(spec.drop_horizon_ms),
        "aws": bool(spec.aws),
        "inject_bug": bool(spec.inject_bug),
    }
    # the class key is signature identity too (a crash-class map and a
    # drop-class map of one point live in different seed/digest
    # spaces), but "mixed" is elided so every legacy map — written
    # before the class split existed — keeps matching byte-for-byte
    cls = getattr(spec, "fault_class", "mixed")
    if cls != "mixed":
        out["fault_class"] = str(cls)
    return out


# ----------------------------------------------------------------------
# the persistent coverage map
# ----------------------------------------------------------------------


@dataclass
class CoverageMap:
    """Digest → hit-count buckets for one fuzz point. One bucket = one
    distinct interleaving signature; hit counts record how often the
    campaign re-derived it (re-drawing the same schedules forever shows
    up as counts climbing while the bucket count plateaus)."""

    signature: dict
    buckets: Dict[int, int] = field(default_factory=dict)

    @property
    def bucket_count(self) -> int:
        return len(self.buckets)

    def observe(self, digests: Sequence[int]) -> List[int]:
        """Fold a batch of per-lane digests in. Returns the digests
        that opened NEW buckets, in first-hit order (deduplicated) —
        the plans behind them are the next seeds."""
        fresh: List[int] = []
        for d in digests:
            d = int(d)
            if d in self.buckets:
                self.buckets[d] += 1
            else:
                self.buckets[d] = 1
                fresh.append(d)
        return fresh

    def new_buckets(self, digests: Sequence[int]) -> int:
        """How many of ``digests`` would open new buckets — detection
        without mutation (duplicates within the batch count once)."""
        return len({int(d) for d in digests} - set(self.buckets))

    def to_json(self) -> dict:
        """Deterministic JSON form: buckets in sorted digest order so
        identical maps serialize to identical bytes under
        ``json.dumps(..., sort_keys=True)`` — the fleet-merge and
        resume byte-identity contracts lean on this."""
        return {
            "kind": COVERAGE_KIND,
            "version": COVERAGE_VERSION,
            "signature": dict(self.signature),
            "buckets": {
                str(d): int(c) for d, c in sorted(self.buckets.items())
            },
        }

    @staticmethod
    def from_json(obj: dict, signature: Optional[dict] = None
                  ) -> "CoverageMap":
        """Inverse of :meth:`to_json`. ``signature`` (the requesting
        point's :func:`point_signature`) makes the load refuse a map
        built for a different protocol/dims/digest-version BY NAME."""
        if obj.get("kind") != COVERAGE_KIND:
            raise CoverageError(
                f"not a coverage map (kind={obj.get('kind')!r})"
            )
        if int(obj.get("version", -1)) != COVERAGE_VERSION:
            raise CoverageMismatchError(
                f"coverage map version {obj.get('version')!r} != "
                f"{COVERAGE_VERSION} — digests across versions are "
                "incomparable; start a fresh map"
            )
        stored = obj.get("signature") or {}
        if signature is not None and stored != signature:
            diff = sorted(
                k
                for k in set(stored) | set(signature)
                if stored.get(k) != signature.get(k)
            )
            raise CoverageMismatchError(
                "coverage map was built for a different fuzz point "
                f"(mismatched: {diff}); refusing to mix digest spaces"
            )
        buckets = obj.get("buckets")
        if not isinstance(buckets, dict):
            raise CoverageError(
                "coverage map has no bucket table — truncated or "
                "foreign artifact"
            )
        return CoverageMap(
            signature=dict(stored),
            buckets={int(d): int(c) for d, c in buckets.items()},
        )


# ----------------------------------------------------------------------
# seeds + mutation
# ----------------------------------------------------------------------


def plan_to_json(plan: FaultPlan) -> dict:
    """Canonical JSON form of a seed plan: ``FaultPlan.meta()`` plus
    the jitter fields meta elides at their disabled values — the pool
    stores ONLY this form and mutation re-parses it, so the in-memory
    stream and a journal-round-tripped stream are identical by
    construction (resume determinism)."""
    out = plan.meta()
    out["jitter_max"] = int(plan.jitter_max)
    out["jitter_seed"] = int(plan.jitter_seed)
    return out


@dataclass
class SeedPool:
    """Bounded FIFO of plans that opened new coverage buckets, stored
    as canonical plan JSON (:func:`plan_to_json`) in insertion order;
    the newest ``MAX_SEEDS`` survive. Each seed optionally remembers
    the digest of the bucket it opened (``digests``, parallel to
    ``plans``) — the frontier-weighted draw's anchor. The digest list
    journals as a separate entry key (``seed_digests``) so the pool's
    own JSON form — and with it every pre-frontier journal — is
    unchanged; seeds restored from a legacy journal carry ``None`` and
    weigh like any non-frontier seed."""

    plans: List[dict] = field(default_factory=list)
    digests: List[Optional[int]] = field(default_factory=list)

    def __post_init__(self):
        # legacy constructors pass plans only
        while len(self.digests) < len(self.plans):
            self.digests.append(None)

    def __len__(self) -> int:
        return len(self.plans)

    def add(self, plan: FaultPlan,
            digest: Optional[int] = None) -> None:
        obj = plan_to_json(plan)
        if obj in self.plans:
            return
        self.plans.append(obj)
        self.digests.append(None if digest is None else int(digest))
        del self.plans[:-MAX_SEEDS]
        del self.digests[:-MAX_SEEDS]

    def get(self, index: int) -> FaultPlan:
        return FaultPlan.from_json(self.plans[index])

    def to_json(self) -> list:
        return [dict(p) for p in self.plans]

    def digests_json(self) -> list:
        return [None if d is None else int(d) for d in self.digests]

    @staticmethod
    def from_json(obj: Sequence[dict],
                  digests: Optional[Sequence[Optional[int]]] = None,
                  ) -> "SeedPool":
        plans = [dict(p) for p in obj]
        if digests is None or len(digests) != len(plans):
            # legacy journal (or a foreign-length list): no anchors
            return SeedPool(plans=plans)
        return SeedPool(
            plans=plans,
            digests=[None if d is None else int(d) for d in digests],
        )


def mutation_rng(spec) -> np.random.Generator:
    """The mutator's own PCG64 stream — independent of the root plan
    generator (``mc/fuzz.py plan_rng``) so steered and blind draws
    never perturb each other's positions. Campaigns journal its state
    (``rng_state``/``restore_rng``) alongside the root's."""
    return np.random.default_rng(
        [(spec.seed ^ 0x5EED) & 0x7FFFFFFF, spec.n, spec.f, spec.conflict]
    )


def _crashable_rows(spec, config) -> List[int]:
    leader_row = None if config.leader is None else config.leader - 1
    return [r for r in range(spec.n) if r != leader_row]


def mutate_plan(plan: FaultPlan, rng: np.random.Generator, spec,
                config, protocol) -> FaultPlan:
    """One mutation of a seed plan, drawn from ``rng``:

    * **jitter perturbation** — re-seed the jitter stream, or nudge
      ``jitter_max`` by ±1 (clamped to [1, spec.jitter_max]);
    * **drop toggle** — add a seeded drop mask (with the mandatory
      horizon) to a lossless seed, or strip it from a lossy one;
    * **crash-time shift** — shift an existing crash's instant by a
      bounded delta, or introduce a crash on a non-leader row.

    Mutation respects the point's configured fault envelope: a spec
    with ``drop_share == 0`` (resp. ``crash_share == 0``) never gains
    a drop mask (resp. a new crash) through mutation — the blind
    root stream could not have drawn one, and steered-vs-blind
    comparisons assume both draw from the same plan space. A choice
    its envelope forbids degrades to a jitter re-seed. Fault classes
    stay disjoint like ``draw_plans``'s (a mutant carries crashes XOR
    drops), every output is a *seeded* plan — device-runnable and
    host-replayable by construction — and any mutant whose crashes
    exceed ``min_live`` falls back to its jitter-only core, exactly
    the root draw's posture."""
    jmax_cap = max(int(spec.jitter_max), 1)
    kw = dict(
        jitter_max=min(max(int(plan.jitter_max), 1), jmax_cap),
        jitter_seed=int(plan.jitter_seed),
    )
    crashes = {int(r): int(t) for r, t in plan.crashes.items()}
    has_drop = plan.drop_bp > 0
    choice = int(rng.integers(3))
    if choice == 1 and not has_drop and spec.drop_share <= 0:
        choice = 0  # drop introduction is outside the fault envelope
    if choice == 2 and not crashes and (
        spec.crash_share <= 0
        or config.f < 1
        or not _crashable_rows(spec, config)
    ):
        choice = 0  # crash introduction is outside the fault envelope
    if choice == 0:  # jitter perturbation
        if rng.random() < 0.5:
            kw["jitter_seed"] = int(rng.integers(1 << 31))
        else:
            delta = 1 if rng.random() < 0.5 else -1
            kw["jitter_max"] = min(max(kw["jitter_max"] + delta, 1),
                                   jmax_cap)
    elif choice == 1:  # drop toggle
        has_drop = not has_drop
        if has_drop:
            crashes = {}
    else:  # crash-time shift / introduction
        rows = _crashable_rows(spec, config)
        if crashes:
            row = sorted(crashes)[int(rng.integers(len(crashes)))]
            crashes[row] = max(
                0, crashes[row] + int(rng.integers(-500, 501))
            )
        else:
            row = rows[int(rng.integers(len(rows)))]
            crashes = {int(row): int(rng.integers(0, 2000))}
        has_drop = False
    if has_drop:
        kw["drop_bp"] = int(plan.drop_bp) or int(spec.drop_bp)
        kw["drop_seed"] = (
            int(plan.drop_seed) if plan.drop_bp
            else int(rng.integers(1 << 31))
        )
        kw["horizon_ms"] = (
            int(plan.horizon_ms)
            if plan.horizon_ms is not None
            else int(spec.drop_horizon_ms)
        )
        crashes = {}
    if crashes:
        kw["crashes"] = crashes
    out = FaultPlan(**kw)
    if out.crashes and unavailable(out, protocol, config):
        out = FaultPlan(
            jitter_max=kw["jitter_max"], jitter_seed=kw["jitter_seed"]
        )
    return out


def _popcount32(a: np.ndarray) -> np.ndarray:
    """Per-element popcount of a uint32 array (the classic SWAR
    bit-twiddle) — integer-only, so the frontier metric is exactly
    reproducible on every host."""
    a = a.astype(np.uint32, copy=True)
    a -= (a >> np.uint32(1)) & np.uint32(0x55555555)
    a = (a & np.uint32(0x33333333)) + (
        (a >> np.uint32(2)) & np.uint32(0x33333333)
    )
    a = (a + (a >> np.uint32(4))) & np.uint32(0x0F0F0F0F)
    return (a * np.uint32(0x01010101)) >> np.uint32(24)


def frontier_weights(pool: SeedPool, cmap: Optional[CoverageMap]
                     ) -> List[int]:
    """Integer draw weight per pooled seed: ``1 + Hamming distance``
    (popcount of the 32-bit xor) from the seed's opening digest to the
    NEAREST other already-hit bucket. A seed whose bucket sits far
    from everything else the map has hit is a frontier seed — its
    interleaving neighborhood is under-explored — and draws
    proportionally more mutation budget. Seeds without a recorded
    digest (legacy journals) and every seed when the map holds fewer
    than two buckets weigh 1, which makes the weighted draw consume
    the mutator stream *identically* to the historical uniform draw.
    Pure integer function of journaled pool + map state: every fleet
    worker and every resume weighs identically."""
    if not len(pool):
        return []
    weights = [1] * len(pool)
    if cmap is None or cmap.bucket_count < 2:
        return weights
    hit = np.fromiter(
        (d & 0xFFFFFFFF for d in cmap.buckets), dtype=np.uint32,
        count=cmap.bucket_count,
    )
    for i, d in enumerate(pool.digests):
        if d is None:
            continue
        x = _popcount32(hit ^ np.uint32(int(d) & 0xFFFFFFFF))
        # distance to the nearest OTHER bucket: the seed's own bucket
        # xors to 0 — mask it out instead of letting it zero the min
        x = x[x > 0]
        if x.size:
            weights[i] = 1 + int(x.min())
    return weights


def draw_steered(spec, config, protocol, count: int,
                 rng: np.random.Generator, mrng: np.random.Generator,
                 pool: SeedPool,
                 cmap: Optional[CoverageMap] = None) -> List[FaultPlan]:
    """The coverage-steered analog of ``draw_plans``: each plan is a
    mutation of a pooled seed with probability :data:`MUTATE_SHARE`
    (when the pool holds any), else the next root-PRNG draw. Seed
    selection is frontier-weighted (:func:`frontier_weights`) when the
    caller passes the point's coverage map; without one — or when no
    seed carries a digest anchor — every weight is 1 and the draw is
    bit-identical to the historical uniform selection. Both
    generators advance deterministically, so chunked draws against
    journaled positions equal one-shot draws — the same contract the
    blind stream carries."""
    from .fuzz import draw_plans

    weights = frontier_weights(pool, cmap)
    cum = np.cumsum(weights) if weights else None
    total = int(cum[-1]) if weights else 0
    plans: List[FaultPlan] = []
    for _ in range(count):
        if len(pool) and mrng.random() < MUTATE_SHARE:
            r = int(mrng.integers(total))
            seed = pool.get(int(np.searchsorted(cum, r, side="right")))
            plans.append(
                mutate_plan(seed, mrng, spec, config, protocol)
            )
        else:
            plans.append(
                draw_plans(spec, config, protocol, count=1, rng=rng)[0]
            )
    return plans


def restore_steering(spec, stored: Optional[dict]
                     ) -> Tuple[CoverageMap, SeedPool,
                                np.random.Generator]:
    """(map, seed pool, mutator generator) restored from a persisted
    steering-state dict — a campaign journal entry or an
    ``mc --coverage-dir`` point file, both carrying the keys
    ``coverage`` / ``seeds`` / ``mrng_state`` — or fresh when
    ``stored`` is None. The single restore policy shared by the
    campaign chunk engine, the CLI and the bench self-check (the
    restore half of :func:`fold_chunk`'s contract); the map load
    refuses a foreign point signature by name."""
    sig = point_signature(spec)
    if not stored:
        return CoverageMap(signature=sig), SeedPool(), mutation_rng(spec)
    from .fuzz import restore_rng

    cmap = CoverageMap.from_json(stored["coverage"], signature=sig)
    pool = SeedPool.from_json(
        stored.get("seeds", []), digests=stored.get("seed_digests")
    )
    mrng = (
        restore_rng(stored["mrng_state"])
        if "mrng_state" in stored
        else mutation_rng(spec)
    )
    return cmap, pool, mrng


def fold_chunk(cmap: CoverageMap, pool: SeedPool,
               digests: Sequence[int],
               plans: Sequence[FaultPlan]) -> List[int]:
    """Fold one chunk's per-lane digests into the map and seed the
    pool with the first plan behind each NEW bucket. The single
    seeding policy shared by the campaign chunk engine
    (campaign/manager.py), ``cli.py mc --coverage-dir`` and the bench
    self-check — change it here, every path follows. Returns the new
    digests (first-hit order)."""
    fresh = cmap.observe(digests)
    remaining = set(fresh)
    for i, d in enumerate(digests):
        if int(d) in remaining:
            pool.add(plans[i], digest=int(d))
            remaining.discard(int(d))
    return fresh


# ----------------------------------------------------------------------
# budget steering
# ----------------------------------------------------------------------


def discovery_rate(entry: Optional[dict]) -> float:
    """Recent buckets-per-schedule of one point's journaled state:
    the sum over its ``cov_recent`` window ([schedules, new-buckets]
    pairs, newest last). A point with no recorded window rates 0 —
    the starvation floor (not the rate) is what bootstraps it."""
    recent = (entry or {}).get("cov_recent") or []
    sched = sum(int(s) for s, _ in recent)
    if not sched:
        return 0.0
    return sum(int(b) for _, b in recent) / sched


def rank_points(points: Sequence[Tuple],
                progress: Dict[str, dict], schedules: int,
                min_share: float = MIN_SHARE,
                retired: Optional[Sequence[str]] = None,
                composition: Optional[Dict[str, int]] = None) -> List[str]:
    """Order a campaign's incomplete points for the next chunk of
    budget: starved points first (never tried, or more than
    ``1 - min_share`` behind the most-fuzzed point — the floor that
    keeps every point progressing), then by recent bucket-discovery
    rate descending; all ties break on the canonical enumeration.
    ``points`` holds ``(protocol, n)`` pairs or farm-mode
    ``(protocol, n, fault_class)`` triples; ``retired`` keys (plateau
    retirement, docs/MC.md "Standing farm") drop out entirely — their
    counts no longer feed the starvation floor, so their budget
    recycles into the live grid.

    ``composition`` makes the ranking skeleton-aware for heterogeneous
    megabatch campaigns: a protocol-name → journaled-lane-count map
    (the running mixed batch's protocol composition). Among unstarved
    points, protocols over-represented in the batch rank later — their
    share of the composition sorts ascending ahead of the discovery
    rate — so steered points rebalance *within* the mixed batch rather
    than piling onto the protocol that already fills it. ``None`` (the
    default, and every homogeneous campaign) leaves the legacy order
    untouched. Pure function of journaled counters either way — every
    resumed session and every fleet worker reading the same journals
    ranks identically."""
    keys = [
        point_key(*p) if len(p) == 2 else point_class_key(*p)
        for p in points
    ]
    gone = set(retired or ())
    keys = [k for k in keys if k not in gone]
    tried = {
        k: int((progress.get(k) or {}).get("tried", 0)) for k in keys
    }
    todo = [k for k in keys if tried[k] < schedules]
    floor = min_share * max(tried.values(), default=0)
    comp_total = sum(int(v) for v in (composition or {}).values())

    def comp_share(k: str) -> float:
        if not comp_total:
            return 0.0
        return int(composition.get(k.split("/", 1)[0], 0)) / comp_total

    def order(k: str):
        starved = tried[k] == 0 or tried[k] < floor
        # starved points rank purely by canonical position (the floor
        # is about fairness, not promise); only unstarved points
        # compete on composition balance, then their discovery rate
        return (
            0 if starved else 1,
            0.0 if starved else comp_share(k),
            0.0 if starved else -discovery_rate(progress.get(k)),
            keys.index(k),
        )

    return sorted(todo, key=order)


# ----------------------------------------------------------------------
# standalone persistence (cli.py mc --coverage-dir)
# ----------------------------------------------------------------------


def point_state_path(directory: str, spec) -> str:
    import os

    return os.path.join(
        directory, f"cov_{spec.protocol}_n{spec.n}.json"
    )


def load_point_state(directory: str, spec) -> Optional[dict]:
    """The persisted steering state of one fuzz point (map + seed pool
    + both generator positions + counters), or None on first touch.
    Structural damage (unreadable JSON, no map) refuses here; the
    signature check — a stored map from a different fuzz point is
    refused by name, never silently rebuilt — happens when the caller
    hands the state to :func:`restore_steering`, so the map is parsed
    exactly once."""
    import json
    import os

    path = point_state_path(directory, spec)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as fh:
            obj = json.load(fh)
        if "coverage" not in obj:
            raise CoverageError(
                f"{path} is not a coverage point state (no map)"
            )
    except (OSError, ValueError) as e:
        # a truncated/hand-mangled file is a refusal, not a traceback
        # (and never a silent from-scratch restart)
        raise CoverageError(
            f"unreadable coverage state {path}: {e}"
        ) from e
    return obj


def save_point_state(directory: str, spec, state: dict) -> str:
    """Atomically persist one point's steering state (crash-safe, like
    every other campaign artifact)."""
    import json
    import os

    from ..engine.checkpoint import atomic_write, canonical_json

    os.makedirs(directory, exist_ok=True)
    path = point_state_path(directory, spec)
    atomic_write(path, canonical_json(state, indent=2))
    return path
