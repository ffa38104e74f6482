"""The journal-backed campaign manager (the port's copy of the JAX
package's ``campaign/manager.py``; its units run on the port's
``run_sweep`` and ``run_fuzz_point``, on the CUDA card unless the caller
passes ``device="cpu"``).

A campaign directory is the durable unit::

    <dir>/campaign.json   # the immutable spec (kind + grid)
    <dir>/journal.jsonl   # append-only: one line per completed unit
    <dir>/ckpt/<batch>/   # in-flight sweep-batch checkpoint (transient)
    <dir>/artifacts/      # fuzz repro artifacts (persisted on confirm)
    <dir>/results.jsonl   # sweep output, written once the grid is done
    <dir>/summary.json    # fuzz output, written once the grid is done

Two campaign kinds share the machinery:

* **sweep** — the (protocol × n × f × conflict × fault-plan × region
  subset) grid is enumerated deterministically, chunked into batches of
  ``batch_lanes`` lanes, and each batch runs through
  ``run_sweep(checkpoint=...)``. A completed batch appends its
  serialized ``LaneResults`` to the journal; the in-flight batch
  checkpoints at segment boundaries, so a SIGKILL loses at most one
  segment of device work. The final ``results.jsonl`` of an
  interrupted-and-resumed campaign is byte-identical to an
  uninterrupted control run.
* **fuzz** — each (protocol, n) point fuzzes ``schedules`` perturbed
  schedules in chunks; the journal carries the schedules-tried counter
  and the plan generator's exact position (``mc/fuzz.py rng_state``),
  so a resumed session draws the identical remaining per-lane plans
  instead of restarting coverage. Confirmed-violation artifacts are
  written to ``artifacts/`` the moment they exist.

Crash model: journal appends are flushed+fsynced and a torn final line
is ignored on replay (that unit simply reruns — deterministically).
Checkpoint staleness/corruption is *refused* with a named error
(engine/checkpoint.py), never silently misloaded; the CLI surfaces it
as a non-zero exit naming the reason.

Budget semantics (``budget_s``): at least one unit of progress per
invocation (a sweep segment or a fuzz chunk), then stop at the next
boundary once the budget is exhausted — so repeated budgeted
invocations always converge.

The spec keeps every field of the reference's, so ``campaign.json`` is
the reference's byte for byte; the fields the port cannot run are
refused by name before any lane runs (:func:`check_ported`): ``aot``
(the port has no serialized executable) and ``shard_lanes`` /
``mesh_shard`` (lane sharding, ROADMAP Queue A item 15). The device a
campaign runs on is written neither to ``campaign.json`` nor to the
journal.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Tuple

from ..cli import ENGINE_PROTOCOLS as DEV_PROTOCOLS
from ..mc.fuzz import _CLASS_SEED_SALT
from ..traffic import ARRIVAL_PRESETS, TRAFFIC_PRESETS

_JOURNAL = "journal.jsonl"
_CAMPAIGN = "campaign.json"
_RESULTS = "results.jsonl"
_SUMMARY = "summary.json"
_CKPT = "ckpt"
_ARTIFACTS = "artifacts"

# the reference registry's FAULT_CLASSES: mc/fuzz.py's salted classes
# (DEV_PROTOCOLS is the CLI's ENGINE_PROTOCOLS)
FAULT_CLASSES = tuple(sorted(_CLASS_SEED_SALT))


class CampaignError(RuntimeError):
    """The campaign directory and the request disagree (nothing to
    resume, spec mismatch, unknown kind/protocol) — refused loudly."""


def point_class_key(protocol: str, n: int,
                    fault_class: str = "mixed") -> str:
    """Journal/lease key of one (protocol, n, fault class) fuzz unit.
    ``mixed`` is deliberately the bare legacy ``<proto>/n<n>`` key —
    every pre-split journal entry and lease name IS the mixed class,
    so legacy farms resume without rewriting a byte. Jax-free here
    (not mc/coverage.py, which re-exports it) so the fleet merge can
    enumerate farm units without importing the engine."""
    base = f"{protocol}/n{int(n)}"
    if fault_class == "mixed":
        return base
    return f"{base}/{fault_class}"


def parse_point_key(key: str) -> Tuple[str, int, str]:
    """Inverse of :func:`point_class_key`:
    ``(protocol, n, fault_class)`` — 2-segment keys are the legacy
    ``mixed`` class."""
    parts = key.split("/")
    if len(parts) == 2:
        proto, rest, cls = parts[0], parts[1], "mixed"
    elif len(parts) == 3:
        proto, rest, cls = parts
    else:
        raise ValueError(f"malformed fuzz point key {key!r}")
    if not rest.startswith("n") or not rest[1:].isdigit():
        raise ValueError(f"malformed fuzz point key {key!r}")
    return proto, int(rest[1:]), cls


# ----------------------------------------------------------------------
# campaign specs (JSON round-trip, value equality)
# ----------------------------------------------------------------------


@dataclass(frozen=True)
class SweepCampaign:
    """A (protocol × n × traffic × f × conflict × fault-plan ×
    region-subset) sweep grid, chunked into resumable batches."""

    protocols: Tuple[str, ...]
    ns: Tuple[int, ...] = (3,)
    fs: Tuple[int, ...] = (1,)
    conflicts: Tuple[int, ...] = (0, 100)
    # fault-plan JSON objects (engine/faults.py FaultPlan.from_json);
    # None/{} = fault-free. Every grid point runs once per entry.
    faults: Tuple[Optional[dict], ...] = (None,)
    # traffic-schedule axis: named presets (traffic.TRAFFIC_PRESETS),
    # one batch group per entry — lanes with and without epoch tables
    # trace different graphs so they never share a batch. "flat" is the
    # static path (byte-identical to a traffic-less campaign).
    traffic: Tuple[str, ...] = ("flat",)
    # open-loop arrival axis (traffic.ARRIVAL_PRESETS): each preset
    # runs once per entry of ``offered_loads`` (percent of the preset's
    # base offered load — the knee sweep's load axis, serving/knee.py).
    # Like traffic, open-loop lanes trace a different graph than
    # closed-loop lanes, so every (preset, load) point gets its own
    # batch group and an ``/a<name>l<load>`` batch-id segment;
    # "closed" keeps the legacy ids so pre-arrivals journals resume.
    arrivals: Tuple[str, ...] = ("closed",)
    offered_loads: Tuple[int, ...] = (100,)
    open_window: int = 4      # per-client in-flight cap (GL202 plane)
    mean_gap_ms: int = 4      # base mean inter-arrival gap at load 100
    subsets: int = 1          # region subsets per n
    # explicit region sets (e.g. bote frontier candidates,
    # bote/validate.py); overrides the ns × subsets enumeration — each
    # set's length is its n
    region_sets: Optional[Tuple[Tuple[str, ...], ...]] = None
    commands_per_client: int = 5
    clients_per_region: int = 1
    pool_size: int = 1
    extra_time_ms: int = 500
    batch_lanes: int = 64     # lanes per journal unit
    segment_steps: int = 2048
    max_steps: int = 1 << 22
    # checkpoint WINDOWS between in-flight saves (a window is one
    # host round-trip of the sweep loop — scan_window segments)
    checkpoint_every: int = 1
    # segments kept in flight per batch (parallel/pipeline.py): the
    # dispatch tax overlaps device execution between checkpoint
    # boundaries (raise checkpoint_every past 1 to let the window
    # breathe); 1 = the serial reference loop. Either setting resumes
    # the other's checkpoints — saves always happen on drained,
    # determinate boundaries.
    pipeline_depth: int = 2
    shard_lanes: Optional[bool] = None
    # explicit shard_map partitioning of each unit's lane batch over
    # the named device mesh (parallel/partition.py; GL203-gated like
    # shard_lanes). Like pipeline_depth, NOT a checkpoint meta key —
    # a unit checkpointed under one layout resumes under the other
    # bit-exactly, so fleet workers on heterogeneous device counts
    # still interchange units.
    mesh_shard: Optional[bool] = None
    # segments scan-fused into one device call (parallel/sweep.py
    # scan_window): host round-trips drop from per-segment to
    # per-window, results stay byte-identical. None = the
    # segment_steps-derived default; 1 = the serial segment loop. Like
    # pipeline_depth, NOT a checkpoint meta key — units checkpointed
    # under one window size resume under another bit-exactly.
    scan_window: Optional[int] = None
    # serialize the sweep executable into <dir>/aot and load it
    # instead of tracing on later invocations / other fleet workers
    # (parallel/aot.py; signature drift refused by name). The first
    # worker pays the one trace+compile, the fleet shares it.
    aot: bool = False
    # heterogeneous megabatch packing (engine/hetero.py): the grid's
    # per-protocol batches are interleaved into always-full mixed
    # units of `batch_lanes` lanes, all advanced by ONE compiled
    # protocol_id-switched runner over the grid-wide union skeleton —
    # with `aot`, ONE serialized executable serves every unit and
    # every fleet worker. Per-lane results (and the merged
    # results.jsonl) stay byte-identical to the homogeneous layout
    # (the GL605 pin); only unit ids/journal layout differ.
    hetero: bool = False
    aws: bool = False

    kind = "sweep"

    def to_json(self) -> dict:
        out = {"kind": self.kind}
        out.update(asdict(self))
        return _plain(out)


@dataclass(frozen=True)
class FuzzCampaign:
    """A (protocol × n) schedule-fuzz grid; each point accumulates
    ``schedules`` perturbed schedules in resumable chunks."""

    protocols: Tuple[str, ...]
    ns: Tuple[int, ...] = (3,)
    f: int = 1
    conflict: int = 100
    pool_size: int = 1
    clients_per_region: int = 1
    commands_per_client: int = 5
    schedules: int = 512      # total per (protocol, n) point
    chunk: int = 128          # schedules per journal unit
    seed: int = 0
    jitter_max: int = 8
    crash_share: float = 0.2
    drop_share: float = 0.15
    confirm: bool = True
    max_confirm: int = 8
    shrink_budget: int = 150
    strict_missing: bool = False
    inject_bug: bool = False
    aws: bool = False
    # coverage-guided mode (mc/coverage.py, docs/MC.md): bucket every
    # lane's interleaving digest into a journaled persistent map, seed
    # host-replayable mutators from plans that open new buckets, and
    # steer each chunk of budget toward the point with the highest
    # recent bucket-discovery rate. False = the blind root-PRNG
    # stream: the exact pre-coverage plan sequence and point order
    # (pre-coverage journals resume seamlessly), though entries now
    # record `first_confirmed_at` on confirmation and summaries carry
    # the journal-derived `schedules_tried` total.
    coverage: bool = False
    # chunks of history the per-point discovery rate averages over
    steer_window: int = 4
    # starvation floor: every incomplete point is kept within this
    # share of the most-fuzzed point's schedule count
    min_share: float = 0.25
    # fault-class shards (FAULT_CLASSES): each (protocol, n)
    # point splits into one independently journaled/leasable unit per
    # class, with its own PCG64 streams and coverage signature
    # (mc/fuzz.py class_spec). ("mixed",) is the legacy single-unit
    # full envelope — pre-split journals resume byte-compatibly.
    classes: Tuple[str, ...] = ("mixed",)
    # plateau retirement (docs/MC.md "Standing farm"): retire a point
    # after this many CONSECUTIVE chunks that opened zero new coverage
    # buckets, recycling its budget into the live grid via a journaled
    # retirement entry. 0 = never retire (the legacy posture);
    # requires coverage.
    retire_after: int = 0
    # persist each point's coverage map as a compacted binary covmap
    # file (mc/covmap.py) instead of inline journal JSON — the farm
    # format for maps too large to rewrite per chunk. Requires
    # coverage.
    binary_maps: bool = False

    kind = "fuzz"

    def to_json(self) -> dict:
        out = {"kind": self.kind}
        out.update(asdict(self))
        return _plain(out)


def _plain(obj):
    """Tuples -> lists so to_json/from_json round-trips to equality."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def campaign_from_json(obj: dict):
    """Parse a campaign spec dict (the CLI ``--grid`` value / the
    stored ``campaign.json``)."""
    kinds = {"sweep": SweepCampaign, "fuzz": FuzzCampaign}
    kind = obj.get("kind")
    if kind not in kinds:
        raise CampaignError(
            f"unknown campaign kind {kind!r}; expected one of "
            f"{sorted(kinds)}"
        )
    cls = kinds[kind]
    fields = {f.name for f in cls.__dataclass_fields__.values()}
    unknown = sorted(set(obj) - fields - {"kind"})
    if unknown:
        raise CampaignError(
            f"unknown campaign field(s) {unknown} for kind {kind!r}"
        )
    kw = {}
    for name in cls.__dataclass_fields__:
        if name not in obj:
            continue
        val = obj[name]
        if isinstance(val, list):  # JSON arrays -> the tuple fields
            val = tuple(
                tuple(v) if isinstance(v, list) else v for v in val
            )
        kw[name] = val
    spec = cls(**kw)

    bad = [p for p in spec.protocols if p not in DEV_PROTOCOLS]
    if bad:
        raise CampaignError(
            f"unknown protocol(s) {bad}; choose from "
            f"{','.join(DEV_PROTOCOLS)}"
        )
    if not spec.protocols:
        raise CampaignError("campaign needs at least one protocol")
    if kind == "sweep":
        bad_t = [t for t in spec.traffic if t not in TRAFFIC_PRESETS]
        if bad_t:
            raise CampaignError(
                f"unknown traffic preset(s) {bad_t}; choose from "
                f"{','.join(TRAFFIC_PRESETS)}"
            )
        if not spec.traffic:
            raise CampaignError(
                "the traffic axis needs at least one preset "
                '(use ["flat"] for the static path)'
            )
        bad_a = [a for a in spec.arrivals if a not in ARRIVAL_PRESETS]
        if bad_a:
            raise CampaignError(
                f"unknown arrival preset(s) {bad_a}; choose from "
                f"{','.join(ARRIVAL_PRESETS)}"
            )
        if not spec.arrivals:
            raise CampaignError(
                "the arrivals axis needs at least one preset "
                '(use ["closed"] for the closed-loop path)'
            )
        bad_l = [
            l for l in spec.offered_loads
            if not isinstance(l, int) or l < 1
        ]
        if bad_l or not spec.offered_loads:
            raise CampaignError(
                "offered_loads must be a non-empty list of positive "
                f"load percentages, got {list(spec.offered_loads)}"
            )
        if spec.open_window < 1:
            raise CampaignError(
                f"open_window must be >= 1, got {spec.open_window}"
            )
        if spec.mean_gap_ms < 1:
            raise CampaignError(
                "mean_gap_ms must be >= 1 (the engine clock is "
                f"integer ms), got {spec.mean_gap_ms}"
            )
        if any(a != "closed" for a in spec.arrivals):
            # open-loop lanes own the issue clock: traffic think delays
            # are asserted zero in make_lane, so refuse the grid here
            # by name instead of dying mid-campaign
            thinky = [
                t for t in spec.traffic if t in ("diurnal", "flash")
            ]
            if thinky:
                raise CampaignError(
                    f"traffic preset(s) {thinky} carry think delays, "
                    "which open-loop arrivals replace; combine "
                    'arrivals with ["flat"] or ["churn"] traffic'
                )
        if spec.region_sets is not None and not spec.region_sets:
            raise CampaignError("region_sets must not be empty when set")
        if spec.aot and spec.mesh_shard:
            raise CampaignError(
                "aot serializes the jit window runner; the shard_map "
                "mesh_shard layout is not serializable — drop one"
            )
        if spec.scan_window is not None and int(spec.scan_window) < 1:
            raise CampaignError("scan_window must be >= 1 when set")
        if spec.hetero and spec.mesh_shard:
            raise CampaignError(
                "hetero packs mixed units through the protocol_id-"
                "switched runner, which is not proven for the "
                "shard_map mesh_shard layout — drop one"
            )
    if kind == "fuzz":
        bad_c = [c for c in spec.classes if c not in FAULT_CLASSES]
        if bad_c:
            raise CampaignError(
                f"unknown fault class(es) {bad_c}; choose from "
                f"{','.join(FAULT_CLASSES)}"
            )
        if not spec.classes:
            raise CampaignError(
                "the fault-class axis needs at least one class "
                '(use ["mixed"] for the legacy full envelope)'
            )
        if len(set(spec.classes)) != len(spec.classes):
            raise CampaignError(
                "duplicate fault classes in the campaign grid"
            )
        if int(spec.retire_after) < 0:
            raise CampaignError("retire_after must be >= 0")
        if spec.retire_after and not spec.coverage:
            raise CampaignError(
                "retire_after reads the coverage discovery signal; "
                "set coverage=true (or retire_after=0)"
            )
        if spec.binary_maps and not spec.coverage:
            raise CampaignError(
                "binary_maps persists coverage maps; set "
                "coverage=true (or binary_maps=false)"
            )
    return spec


# ----------------------------------------------------------------------
# journal + campaign-file plumbing
# ----------------------------------------------------------------------


def _append_journal(path: str, entry: dict) -> None:
    with open(os.path.join(path, _JOURNAL), "a") as fh:
        fh.write(_canonical_json(entry) + "\n")
        fh.flush()
        os.fsync(fh.fileno())


def _read_journal_file(jpath: str) -> List[dict]:
    """One journal file's entries, tolerating a torn FINAL line (the
    shared crash contract of the single-process journal and every
    fleet worker journal — fleet/worker.py reads each through this)."""
    if not os.path.exists(jpath):
        return []
    entries: List[dict] = []
    with open(jpath) as fh:
        lines = fh.read().splitlines()
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            entries.append(json.loads(line))
        except ValueError:
            if i == len(lines) - 1:
                # a SIGKILL can tear the final append; that unit simply
                # reruns (deterministically) — earlier corruption is a
                # real problem and must surface
                break
            raise CampaignError(
                f"campaign journal {jpath} corrupted at line {i + 1} "
                "(only the final line may be torn)"
            )
    return entries


def _read_journal(path: str) -> List[dict]:
    return _read_journal_file(os.path.join(path, _JOURNAL))


def _atomic_write(path: str, text: str) -> None:
    from ..engine.checkpoint import atomic_write

    atomic_write(path, text)


def _canonical_json(obj, *, indent=None) -> str:
    # lazy for the same reason as _atomic_write: campaign spec/journal
    # plumbing must import jax-free
    from ..engine.checkpoint import canonical_json

    return canonical_json(obj, indent=indent)


def _load_or_init_spec(path: str, spec, resume: bool):
    cpath = os.path.join(path, _CAMPAIGN)
    if resume:
        if not os.path.exists(cpath):
            raise CampaignError(
                f"nothing to resume: no {_CAMPAIGN} in {path}"
            )
        stored = campaign_from_json(json.load(open(cpath)))
        if spec is not None and stored != spec:
            raise CampaignError(
                "--grid disagrees with the stored campaign spec; "
                "resume without --grid or start a fresh directory"
            )
        return stored
    if spec is None:
        raise CampaignError("a new campaign needs a --grid spec")
    if os.path.exists(cpath):
        stored = campaign_from_json(json.load(open(cpath)))
        if stored != spec:
            raise CampaignError(
                f"{path} already holds a different campaign; pass "
                "--resume to continue it or use a fresh directory"
            )
        return stored  # identical spec: behave like resume
    os.makedirs(path, exist_ok=True)
    _atomic_write(cpath, _canonical_json(spec.to_json(), indent=2))
    return spec


# the spec fields the port keeps for byte-identical campaign.json files
# but cannot run: field -> why (ROADMAP Queue A)
UNPORTED_FIELDS = {
    "aot": "the port has no serialized sweep executable to share",
    "shard_lanes": "lane sharding is ROADMAP Queue A item 15",
    "mesh_shard": "lane sharding is ROADMAP Queue A item 15",
}


def check_ported(spec) -> None:
    """Refuse, by name and before any lane runs, a sweep spec that sets
    a field the port cannot run (:data:`UNPORTED_FIELDS`)."""
    for name, why in UNPORTED_FIELDS.items():
        if getattr(spec, name, None):
            raise CampaignError(
                f"campaign field {name!r} is set but not ported: {why}"
            )


def _planet(aws: bool):
    from ..core.planet import Planet

    if aws:
        return Planet.from_dataset("latency_aws_2021_02_13")
    return Planet.new()


# ----------------------------------------------------------------------
# sweep campaigns
# ----------------------------------------------------------------------


def _sweep_groups(spec: SweepCampaign, planet):
    """The (n → region sets) groups the grid enumerates: either the
    default first-``subsets`` n-combinations per entry of ``ns``, or —
    when ``region_sets`` pins explicit sets (bote/validate.py frontier
    candidates) — the sets grouped by their length."""
    if spec.region_sets is not None:
        by_n: Dict[int, list] = {}
        for rs in spec.region_sets:
            by_n.setdefault(len(rs), []).append(list(rs))
        return sorted(by_n.items())
    all_regions = planet.regions()
    return [
        (
            n,
            [
                [all_regions[i] for i in combo]
                for combo in itertools.islice(
                    itertools.combinations(range(len(all_regions)), n),
                    spec.subsets,
                )
            ],
        )
        for n in spec.ns
    ]


def _sweep_batches(spec: SweepCampaign):
    """Deterministic batch enumeration: one (protocol, n, traffic,
    arrival, load) group shares a compiled runner; its grid chunks into
    ``batch_lanes`` units. Traffic presets get their own groups (and a
    ``/t<name>`` batch-id segment) because schedule tables change the
    traced graph — "flat" lanes keep the legacy ids, so pre-traffic
    journals still resume. The open-loop arrival axis works the same
    way: each (preset, offered load) point is its own ``/a<name>l<load>``
    group, "closed" keeps the legacy ids."""
    from ..engine import EngineDims
    from ..engine.faults import FaultPlan
    from ..engine.protocols import dev_config_kwargs, dev_protocol
    from ..core.config import Config
    from ..parallel.sweep import make_sweep_specs

    planet = _planet(spec.aws)
    plans = [
        None if not entry else FaultPlan.from_json(entry)
        for entry in spec.faults
    ]
    plans = [None if p is not None and p.is_noop() else p for p in plans]
    batches = []
    for proto in spec.protocols:
        for n, region_sets in _sweep_groups(spec, planet):
            clients = n * spec.clients_per_region
            total = spec.commands_per_client * clients
            # key capacity must cover the widest preset's rotated pool
            # (churn moves the shared pool across [0, pool_span)):
            # private keys sit at pool_span + client. All of a
            # (proto, n) group's traffic variants share one capacity so
            # they share dims; flat-only grids get None and keep the
            # legacy 1 + clients default, so pre-traffic campaign
            # journals resume onto bit-identical lane shapes.
            from ..traffic.schedule import traffic_key_capacity

            keys = traffic_key_capacity(
                spec.traffic,
                conflict=spec.conflicts[0],
                pool_size=spec.pool_size,
                commands=spec.commands_per_client,
                clients=clients,
            )
            dev = dev_protocol(proto, clients, keys=keys)
            dims = EngineDims.for_protocol(
                dev,
                n=n,
                clients=clients,
                payload=dev.payload_width(n),
                total_commands=total,
                dot_slots=total + 1,
                regions=n,
            )
            base = Config(**dev_config_kwargs(proto, n, spec.fs[0]))
            # arrival axis points: "closed" runs once (offered load is
            # meaningless without an arrival process); open presets run
            # once per offered_loads entry — the knee sweep's load axis
            arrival_points = []
            for aname in spec.arrivals:
                if aname == "closed":
                    arrival_points.append(("closed", 100))
                else:
                    arrival_points.extend(
                        (aname, load) for load in spec.offered_loads
                    )
            for tname in spec.traffic:
                for aname, load in arrival_points:
                    lanes = make_sweep_specs(
                        dev,
                        planet,
                        region_sets=region_sets,
                        fs=list(spec.fs),
                        conflicts=list(spec.conflicts),
                        commands_per_client=spec.commands_per_client,
                        clients_per_region=spec.clients_per_region,
                        dims=dims,
                        config_base=base,
                        extra_time_ms=spec.extra_time_ms,
                        pool_size=spec.pool_size,
                        faults=plans,
                        traffic=tname,
                        arrivals=None if aname == "closed" else aname,
                        arrival_load=load,
                        arrival_gap_ms=spec.mean_gap_ms,
                        open_window=spec.open_window,
                    )
                    tseg = "" if tname == "flat" else f"/t{tname}"
                    aseg = (
                        "" if aname == "closed" else f"/a{aname}l{load}"
                    )
                    for j in range(0, len(lanes), spec.batch_lanes):
                        batches.append(
                            (
                                f"{proto}/n{n}{tseg}{aseg}"
                                f"/b{j // spec.batch_lanes}",
                                dev,
                                dims,
                                lanes[j : j + spec.batch_lanes],
                            )
                        )
    return batches


def hetero_plan(spec: SweepCampaign, batches):
    """Mixed-unit packing of a sweep grid (``hetero: true``): the
    homogeneous batch enumeration is flattened to per-lane rows,
    round-robin interleaved across the grid's (protocol, n, traffic,
    arrival) groups in first-appearance order, and re-chunked into
    ALWAYS-FULL units of ``batch_lanes`` mixed lanes (the final unit
    pads with copies of its own last row; padded results are dropped
    at regroup time). Returns ``(protocols, dims, reps, units,
    positions)``:

    * ``protocols``/``dims`` — group key → device protocol / dims (the
      mappings ``run_sweep(hetero=True)`` takes),
    * ``reps`` — group key → one representative ``LaneSpec`` (what
      ``engine.hetero.build_grid_skeleton`` classifies),
    * ``units`` — ordered ``(unit_key, [(group, LaneSpec), ...])``
      with ids in their own ``hetero/b<u>`` namespace (never colliding
      with homogeneous journal ids),
    * ``positions`` — unit_key → ``[(homog_batch_key, lane_idx), ...]``
      for the unit's REAL rows (pads excluded), the permutation
      :func:`hetero_regroup` inverts so ``results.jsonl`` comes out in
      the homogeneous enumeration's exact order and bytes.

    Deterministic pure function of (spec, batches): the manager, every
    fleet worker and the merge all derive the identical plan."""
    groups: Dict[str, tuple] = {}
    order: List[str] = []
    rows_by_g: Dict[str, list] = {}
    for key, dev, dims, lanes in batches:
        # group names become skeleton audit keys, which live inside
        # checkpointed pytrees — "/" would collide with the checkpoint
        # flattener's path separator, so it is mapped out here
        gkey = key.rsplit("/b", 1)[0].replace("/", "_")
        if gkey not in groups:
            groups[gkey] = (dev, dims)
            order.append(gkey)
        rows_by_g.setdefault(gkey, []).extend(
            (key, li, lane) for li, lane in enumerate(lanes)
        )
    flat = []
    cursors = {g: 0 for g in order}
    remaining = sum(len(v) for v in rows_by_g.values())
    while remaining:
        for g in order:
            rows = rows_by_g[g]
            c = cursors[g]
            if c < len(rows):
                bk, li, lane = rows[c]
                flat.append((g, bk, li, lane))
                cursors[g] = c + 1
                remaining -= 1
    units = []
    positions: Dict[str, list] = {}
    B = int(spec.batch_lanes)
    for u in range(0, len(flat), B):
        chunk = flat[u : u + B]
        ukey = f"hetero/b{u // B}"
        positions[ukey] = [(bk, li) for _, bk, li, _ in chunk]
        lanes_u = [(g, lane) for g, _, _, lane in chunk]
        while len(lanes_u) < B:
            lanes_u.append(lanes_u[-1])
        units.append((ukey, lanes_u))
    protocols = {g: groups[g][0] for g in order}
    dims = {g: groups[g][1] for g in order}
    reps = {g: rows_by_g[g][0][2] for g in order}
    return protocols, dims, reps, units, positions


def hetero_regroup(batches, units, positions, done):
    """Invert :func:`hetero_plan`'s permutation: journaled mixed-unit
    result rows → per-homogeneous-batch row lists in the homogeneous
    enumeration's lane order — so a hetero campaign's ``results.jsonl``
    (and the fleet merge's) is byte-identical to the homogeneous
    layout's, line for line. Every unit must be present in ``done``."""
    by_batch = {key: [None] * len(lanes) for key, _, _, lanes in batches}
    for ukey, _lanes in units:
        rows = done[ukey]
        pos = positions[ukey]
        if len(rows) != len(pos):
            raise CampaignError(
                f"unit {ukey!r} journaled {len(rows)} rows but the "
                f"plan places {len(pos)} — the stored campaign and "
                "the journal disagree"
            )
        for (bk, li), row in zip(pos, rows):
            by_batch[bk][li] = row
    for key, rows in by_batch.items():
        if any(r is None for r in rows):
            raise CampaignError(
                f"hetero regroup left holes in batch {key!r} — the "
                "plan does not cover the grid"
            )
    return by_batch


def _hetero_grid(spec: SweepCampaign, batches, device=None):
    """The per-campaign hetero setup shared by the manager loop, every
    fleet worker and the merge: the plan plus the grid-wide skeleton
    (engine/hetero.py build_grid_skeleton — ONE skeleton for every unit
    whatever its composition; the port's batches always carry a key
    table and are never narrowed, so the reference's narrowing spec has
    no counterpart)."""
    from ..engine.hetero import build_grid_skeleton

    protocols, dims, reps, units, positions = hetero_plan(spec, batches)
    skeleton = build_grid_skeleton(protocols, dims, reps, device=device)
    return protocols, dims, units, positions, skeleton


def _run_sweep_campaign(path: str, spec: SweepCampaign, deadline,
                        stop_after_segments, stop_flag,
                        device=None) -> dict:
    from ..engine.checkpoint import (
        CheckpointSpec,
        SweepInterrupted,
        discard_checkpoint,
    )
    from ..parallel.sweep import run_sweep

    batches = _sweep_batches(spec)
    hetero = bool(getattr(spec, "hetero", False))
    if hetero:
        # mixed-unit layout: the work list is the plan's always-full
        # units; every unit runs through the ONE switch-dispatched
        # runner (one skeleton), and results.jsonl is regrouped back
        # into the homogeneous enumeration below — byte-identical output
        protos, dmap, units, positions, skeleton = \
            _hetero_grid(spec, batches, device)
        work = [(key, protos, dmap, lanes) for key, lanes in units]
    else:
        work = batches
    done: Dict[str, List[dict]] = {}
    for entry in _read_journal(path):
        if entry.get("kind") == "batch":
            done[entry["id"]] = entry["results"]

    interrupted = None
    progressed = 0
    for key, dev, dims, lanes in work:
        if key in done:
            continue
        if stop_flag["sig"] is not None:
            interrupted = f"signal {stop_flag['sig']}"
            break
        remaining = None
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0 and progressed:
                interrupted = "budget exhausted"
                break
            remaining = max(remaining, 0.0)
        # per-batch checkpoint dir: a leftover checkpoint of an
        # already-journaled batch (kill between journal append and
        # discard) can never be mistaken for the next batch's
        ckpt_path = os.path.join(path, _CKPT, key.replace("/", "_"))
        ck = CheckpointSpec(
            path=ckpt_path,
            every=spec.checkpoint_every,
            budget_s=remaining,
            stop_after_segments=stop_after_segments,
            # keep until the journal append lands: a kill in between
            # re-runs at most one segment (resume from the final
            # boundary), never the whole batch
            keep=True,
        )
        try:
            # a unit is one batch (a checkpointed run_sweep is one
            # batch, as the reference's is); the reference's sharding,
            # aot and narrow arguments have no counterpart (check_ported
            # refused the first two, narrow changes no result)
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
                **(
                    {"hetero": True, "skeleton": skeleton}
                    if hetero
                    else {}
                ),
            )
        except SweepInterrupted as e:
            interrupted = e.reason
            break
        assert len(results) == len(lanes)
        rows = [r.to_json() for r in results]
        if hetero:
            # the final unit is padded to batch_lanes with copies of
            # its own last row; only the plan's REAL rows are journaled
            rows = rows[: len(positions[key])]
        _append_journal(path, {"kind": "batch", "id": key, "results": rows})
        discard_checkpoint(ckpt_path)
        done[key] = rows
        progressed += 1
        if stop_flag["sig"] is not None:
            interrupted = f"signal {stop_flag['sig']}"
            break

    summary = {
        "kind": "sweep",
        "batches_total": len(work),
        "batches_done": sum(1 for k, *_ in work if k in done),
        "done": interrupted is None,
        "interrupted": interrupted,
        "dir": path,
    }
    if interrupted is None:
        import shutil

        # the journal is the durable output now; orphaned per-batch
        # checkpoints (kill between a journal append and its discard)
        # go with the transient directory
        shutil.rmtree(os.path.join(path, _CKPT), ignore_errors=True)
        if hetero:
            # invert the mixed-unit permutation: results.jsonl is
            # written in the homogeneous enumeration's exact order with
            # homogeneous batch keys — byte-identical to the legacy
            # layout's output for the same grid
            by_batch = hetero_regroup(batches, units, positions, done)
            done = by_batch
        lines = []
        for key, *_ in batches:
            for lane, res in enumerate(done[key]):
                lines.append(
                    _canonical_json(
                        {"batch": key, "lane": lane, "result": res}
                    )
                )
        _atomic_write(
            os.path.join(path, _RESULTS), "".join(x + "\n" for x in lines)
        )
        summary["results"] = os.path.join(path, _RESULTS)
        errs = sum(
            1
            for key, *_ in batches
            for res in done[key]
            if res["err"]
        )
        summary["lanes"] = sum(len(done[k]) for k, *_ in batches)
        summary["errors"] = errs
    return summary


# ----------------------------------------------------------------------
# fuzz campaigns
# ----------------------------------------------------------------------


def _fuzz_point_spec(spec: FuzzCampaign, proto: str, n: int, chunk: int,
                     fault_class: str = "mixed"):
    from ..mc.fuzz import FuzzSpec, class_spec

    base = FuzzSpec(
        protocol=proto,
        n=n,
        f=spec.f,
        conflict=spec.conflict,
        pool_size=spec.pool_size,
        clients_per_region=spec.clients_per_region,
        commands_per_client=spec.commands_per_client,
        schedules=chunk,
        seed=spec.seed,
        jitter_max=spec.jitter_max,
        crash_share=spec.crash_share,
        drop_share=spec.drop_share,
        aws=spec.aws,
        inject_bug=spec.inject_bug,
    )
    return class_spec(base, fault_class)


# journal-entry keys that never reach summaries: internal generator
# positions, the raw seed pool and its digest anchors (the coverage
# map itself DOES reach the summary — it is the merged,
# worker-count-invariant artifact the fleet and resume byte-identity
# contracts pin)
_FUZZ_INTERNAL_KEYS = (
    "kind", "point", "rng_state", "mrng_state", "seeds", "seed_digests",
)


def _restore_binary_map(path: str, key: str, prev: dict, pspec) -> dict:
    """Binary-maps mode: the journal entry carries only the map's
    SHA-256; rehydrate the steering state by loading the journaled
    generation's covmap file and refusing — by name — a file whose
    bytes do not hash to what the journal recorded (a torn farm
    directory, or the documented stale-worker race one generation past
    the compaction window)."""
    import hashlib

    from ..mc import covmap as cvm
    from ..mc.coverage import point_signature

    cmap = cvm.load_point_map(
        path, key, int(prev["tried"]),
        signature=point_signature(pspec),
    )
    want = prev.get("cov_sha256")
    got = hashlib.sha256(cvm.covmap_bytes(cmap)).hexdigest()
    if want is not None and got != want:
        raise cvm.CovmapError(
            f"covmap for {key} at tried={prev['tried']} hashes to "
            f"{got[:12]}… but the journal recorded {want[:12]}… — "
            "the map file and journal disagree; refusing to continue "
            "from inconsistent coverage"
        )
    stored = dict(prev)
    stored["coverage"] = cmap.to_json()
    return stored


def _fuzz_chunk(spec: FuzzCampaign, proto: str, n: int,
                prev: Optional[dict], planet, path: str,
                fault_class: str = "mixed", device=None) -> dict:
    """Draw, run and fold ONE chunk of (proto, n, fault class) into a
    new cumulative journal entry, continuing exactly from ``prev``
    (None = fresh point). This is the single shared chunk engine of
    the single-process manager AND every fleet worker
    (fleet/worker.py): chunk k's plans depend only on the journaled
    state after chunk k−1 — the root generator position, and in
    coverage mode the map, seed pool and mutator position — so the
    plan stream is identical whichever process draws it, and chunked
    ≡ one-shot stays true across SIGKILL and worker handoffs."""
    from ..mc.fuzz import (
        draw_plans,
        plan_rng,
        point_config,
        point_protocol,
        restore_rng,
        rng_state,
        run_fuzz_point,
    )

    key = point_class_key(proto, n, fault_class)
    tried = int(prev["tried"]) if prev else 0
    size = min(spec.chunk, spec.schedules - tried)
    pspec = _fuzz_point_spec(spec, proto, n, size, fault_class)
    config = point_config(pspec)
    dev = point_protocol(pspec)
    # the journaled generator position — restored, never recomputed
    # from the root seed, so the remaining plan sequence is identical
    # to what an uninterrupted session would have drawn
    rng = (
        restore_rng(prev["rng_state"])
        if prev
        else plan_rng(
            _fuzz_point_spec(spec, proto, n, spec.chunk, fault_class)
        )
    )
    cmap = pool = mrng = None
    if spec.coverage:
        from ..mc import coverage as cov

        stored = prev
        if prev and spec.binary_maps and "coverage" not in prev:
            # write-ahead binary map: rehydrate from the covmap file
            # the journaled generation references (hash-checked)
            stored = _restore_binary_map(path, key, prev, pspec)
        # the map/pool/mutator-position travel the journal like the
        # root PRNG position; a map journaled under a different point
        # signature refuses by name (CoverageMismatchError)
        cmap, pool, mrng = cov.restore_steering(pspec, stored)
        plans = cov.draw_steered(
            pspec, config, dev, size, rng, mrng, pool, cmap=cmap
        )
    else:
        plans = draw_plans(pspec, config, dev, count=size, rng=rng)
    res = run_fuzz_point(
        pspec,
        planet=planet,
        confirm=spec.confirm,
        max_confirmations=spec.max_confirm,
        shrink_budget=spec.shrink_budget,
        strict_missing=spec.strict_missing,
        plans=plans,
        lane_offset=tried,
        artifact_dir=os.path.join(path, _ARTIFACTS),
        device=device,
    )
    tried += size
    entry = {
        "kind": "fuzz",
        "point": key,
        "tried": tried,
        "rng_state": rng_state(rng),
        "flagged": (prev["flagged"] if prev else 0) + res.flagged,
        "confirmed": (
            (prev["confirmed"] if prev else 0) + res.confirmed
        ),
        "unprocessed": (
            (prev.get("unprocessed", 0) if prev else 0)
            + res.unprocessed
        ),
        "engine_errors": _merge_counts(
            prev.get("engine_errors", {}) if prev else {},
            res.engine_errors,
        ),
        "artifacts": sorted(
            set(prev.get("artifacts", []) if prev else [])
            | {
                os.path.relpath(f.artifact_path, path)
                for f in res.findings
                if f.artifact_path
            }
        ),
        "violations": (
            (prev.get("violations", []) if prev else [])
            + res.summary()["violations"]
        ),
    }
    # schedules-until-first-confirmation (exact: lane indices are
    # campaign-global via lane_offset) — what the CI injected-bug
    # self-check compares steered vs blind on
    first = prev.get("first_confirmed_at") if prev else None
    confirmed_lanes = [f.lane for f in res.findings if f.confirmed]
    if first is None and confirmed_lanes:
        first = min(confirmed_lanes) + 1
    if first is not None:
        entry["first_confirmed_at"] = int(first)
    if spec.coverage:
        from ..mc.coverage import fold_chunk

        fresh = fold_chunk(cmap, pool, res.digests, plans)
        recent = list(prev.get("cov_recent", []) if prev else [])
        recent.append([size, len(fresh)])
        if spec.binary_maps:
            # write-ahead: the map lands durably (atomic, versioned)
            # BEFORE the journal entry referencing it — a kill in
            # between leaves an orphan covmap the deterministic rerun
            # overwrites with identical bytes
            import hashlib

            from ..mc import covmap as cvm

            cvm.save_point_map(path, key, tried, cmap)
            entry["cov_sha256"] = hashlib.sha256(
                cvm.covmap_bytes(cmap)
            ).hexdigest()
            # compaction cadence: keep this generation + its
            # predecessor; everything older is re-derivable from the
            # journal and no live reader references it
            cvm.compact_point_maps(path, key, keep=2)
        else:
            entry["coverage"] = cmap.to_json()
        entry["seeds"] = pool.to_json()
        entry["seed_digests"] = pool.digests_json()
        entry["mrng_state"] = rng_state(mrng)
        entry["cov_recent"] = recent[-max(int(spec.steer_window), 1):]
        entry["cov_buckets"] = cmap.bucket_count
        # consecutive chunks with zero new buckets — the plateau
        # signal retire_after reads; pure function of journaled
        # history, so resumes and fleet workers agree on dryness
        entry["cov_dry"] = (
            0 if fresh
            else int(prev.get("cov_dry", 0) if prev else 0) + 1
        )
    return entry


def fuzz_point_keys(spec: FuzzCampaign) -> List[str]:
    """The canonical (protocol × n × fault class) unit enumeration —
    shared by the manager loop, every fleet worker and the merge, so
    ranking/lease/summary orders agree everywhere."""
    return [
        point_class_key(p, n, c)
        for p in spec.protocols
        for n in spec.ns
        for c in spec.classes
    ]


def fuzz_retired(spec: FuzzCampaign, entries) -> List[str]:
    """The journaled retirement set, in first-retirement order (the
    order is cosmetic — membership is what ranking consumes).
    Duplicate retirement entries are expected under the fleet: any
    worker that derives eligibility from the journal may append one,
    and identical-content duplicates are harmless."""
    if not int(spec.retire_after):
        return []
    out: List[str] = []
    for e in entries:
        if e.get("kind") == "retire" and e.get("point") not in out:
            out.append(e["point"])
    return out


def retire_entry(key: str, entry: dict) -> dict:
    """The journaled retirement record for one plateaued point —
    derived purely from that point's own journaled state, so every
    worker/resume that finds it eligible writes the identical entry."""
    return {
        "kind": "retire",
        "point": key,
        "tried": int(entry.get("tried", 0)),
        "cov_dry": int(entry.get("cov_dry", 0)),
    }


def materialize_final_maps(path: str, progress) -> None:
    """Materialize each finished point's binary map under its canonical
    (unversioned) name — the file CI `cmp`s across farms — and drop the
    remaining versioned generations: the journal no longer needs them.
    Idempotent: an already-materialized final map is sha-verified
    against the journal instead of rewritten (and a mismatch refuses),
    so re-summarizing a compacted farm is safe."""
    import hashlib

    from ..mc import covmap as cvm

    for key in sorted(progress):
        entry = progress[key]
        if "cov_sha256" not in entry:
            continue
        fpath = cvm.final_map_path(path, key)
        if os.path.exists(fpath):
            with open(fpath, "rb") as fh:
                got = hashlib.sha256(fh.read()).hexdigest()
            if got != entry["cov_sha256"]:
                raise cvm.CovmapError(
                    f"final covmap for {key} hashes to "
                    f"{got[:12]}… but the journal recorded "
                    f"{entry['cov_sha256'][:12]}…; refusing"
                )
            continue
        cmap = cvm.load_point_map(path, key, int(entry["tried"]))
        cvm.save_covmap(fpath, cmap)
        cvm.compact_point_maps(path, key, keep=0)


def _fuzz_summary(path: str, spec: FuzzCampaign, points, progress,
                  interrupted, retired=()) -> dict:
    keys = fuzz_point_keys(spec)
    retired = [k for k in sorted(retired)]
    done = interrupted is None and all(
        k in retired
        or int(progress.get(k, {}).get("tried", 0)) >= spec.schedules
        for k in keys
    )
    summary = {
        "kind": "fuzz",
        "points_total": len(keys),
        "done": done,
        "interrupted": interrupted,
        "dir": path,
        # total schedules actually run, read from the JOURNALED
        # per-point counters — never re-derived from chunk sizes, so a
        # budget-truncated campaign (or a final chunk smaller than
        # `chunk` when schedules % chunk != 0) is never over-counted
        "schedules_tried": sum(
            int(e.get("tried", 0)) for e in progress.values()
        ),
        "points": {
            key: {
                k: v
                for k, v in progress[key].items()
                if k not in _FUZZ_INTERNAL_KEYS
            }
            for key in sorted(progress)
        },
    }
    if int(spec.retire_after):
        # present only for retirement-enabled farms, so every legacy
        # summary's bytes are untouched
        summary["retired"] = retired
    if done and spec.binary_maps:
        materialize_final_maps(path, progress)
    if done:
        # the persisted artifact is dir-invariant (no absolute paths),
        # so a control campaign and a SIGKILLed+resumed one in ANOTHER
        # directory produce byte-identical summary.json — the resume
        # determinism contract tests/CI cmp against
        _atomic_write(
            os.path.join(path, _SUMMARY),
            _canonical_json(
                {k: v for k, v in summary.items() if k != "dir"},
                indent=2,
            ),
        )
        summary["summary"] = os.path.join(path, _SUMMARY)
    return summary


def _run_fuzz_campaign(path: str, spec: FuzzCampaign, deadline,
                       stop_flag, device=None) -> dict:
    planet = _planet(spec.aws)
    points = [
        (p, n, c)
        for p in spec.protocols
        for n in spec.ns
        for c in spec.classes
    ]
    keys = fuzz_point_keys(spec)
    progress: Dict[str, dict] = {}
    journal = _read_journal(path)
    for entry in journal:
        if entry.get("kind") == "fuzz":
            progress[entry["point"]] = entry  # latest line wins
    retired = set(fuzz_retired(spec, journal))

    interrupted = None
    progressed = 0
    while True:
        if stop_flag["sig"] is not None:
            interrupted = f"signal {stop_flag['sig']}"
            break
        if (
            deadline is not None
            and time.monotonic() > deadline
            and progressed
        ):
            interrupted = "budget exhausted"
            break
        # plateau retirement is self-healing: eligibility is derived
        # from each point's own journaled dryness counter at every
        # loop top, so a session killed between a dry chunk's append
        # and its retirement entry retires the identical point at the
        # identical chunk on resume (and a fleet peer may have done it
        # already — the duplicate entry is identical content)
        if int(spec.retire_after):
            for k in keys:
                e = progress.get(k)
                if (
                    e is not None
                    and k not in retired
                    and int(e.get("tried", 0)) < spec.schedules
                    and int(e.get("cov_dry", 0))
                    >= int(spec.retire_after)
                ):
                    _append_journal(path, retire_entry(k, e))
                    retired.add(k)
        # next chunk's point: the coverage allocator's pick (recent
        # bucket-discovery rate with the starvation floor), or — blind
        # — the first incomplete point of the canonical enumeration,
        # which reproduces the legacy point-by-point order exactly
        if spec.coverage:
            from ..mc.coverage import rank_points

            order = rank_points(
                points, progress, spec.schedules,
                min_share=spec.min_share, retired=retired,
            )
        else:
            order = [
                k
                for k in keys
                if int(progress.get(k, {}).get("tried", 0))
                < spec.schedules
            ]
        if not order:
            break
        key = order[0]
        proto, n, cls = parse_point_key(key)
        entry = _fuzz_chunk(
            spec, proto, n, progress.get(key), planet, path,
            fault_class=cls, device=device,
        )
        _append_journal(path, entry)
        progress[key] = entry
        progressed += 1

    return _fuzz_summary(
        path, spec, points, progress, interrupted, retired=retired
    )


def _merge_counts(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0) + v
    return out


# ----------------------------------------------------------------------
# the entry point
# ----------------------------------------------------------------------


def run_campaign(
    path: str,
    spec=None,
    *,
    resume: bool = False,
    budget_s: Optional[float] = None,
    stop_after_segments: Optional[int] = None,
    device=None,
) -> dict:
    """Run (or resume) a campaign in ``path``. Returns a summary dict
    with ``done`` False when interrupted (budget, signal, or the
    ``stop_after_segments`` test hook) — invoke again with
    ``resume=True`` to continue exactly where it stopped.

    SIGTERM/SIGINT stop the campaign at the next unit boundary with
    everything journaled (the in-flight sweep batch additionally
    flushes its segment checkpoint — run_sweep's own handlers); the
    summary reports ``interrupted: "signal N"``.

    Checkpoint refusals (stale/corrupt — engine/checkpoint.py) and
    campaign-directory disagreements (:class:`CampaignError`) raise;
    they are never silently recovered from. So do the spec fields the
    port does not run (:func:`check_ported`), before anything is
    written.

    The units run on ``device`` (default: the CUDA card, which raises
    without a GPU; ``"cpu"`` runs the kernels' plain twins)."""
    from .. import resolve_device

    device = resolve_device(device)
    if spec is not None:
        check_ported(spec)
    spec = _load_or_init_spec(path, spec, resume)
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
            return _run_sweep_campaign(
                path, spec, deadline, stop_after_segments, stop_flag,
                device,
            )
        return _run_fuzz_campaign(path, spec, deadline, stop_flag, device)
    finally:
        for s, old in restores:
            _signal.signal(s, old)
