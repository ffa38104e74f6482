"""Device-scale schedule fuzzing (the reference's ``fantoch_tpu/mc/fuzz.py``).

Per (protocol, config) point:

1. a :class:`FuzzSpec` draws one :class:`FaultPlan` per schedule from a
   root PRNG (numpy's PCG64, as the reference's, so the plans are the
   reference's): always a seeded jitter plan (each wire hop's delay x a
   threefry draw in [1, jitter_max], keyed on (src, dst, channel
   index)), plus threefry drop masks on a share of the lanes and crash
   plans within the protocol's ``min_live`` on another;
2. the whole batch runs through ``run_sweep(monitor_keys=...)``: every
   lane returns its violation word, first violating step and coverage
   digest (:class:`FuzzPointResult`);
3. every flagged lane (at most ``max_confirmations``) replays through
   the host oracle (``sim/runner.py`` with the ``DeviceStream`` workload
   and the lane's fault plan, :func:`host_check`), which confirms it
   against the protocol's execution monitors;
4. a confirmed violation shrinks (``shrink.py``) to a minimal explicit
   perturbation set, a JSON repro artifact that :func:`replay_artifact`
   (``mc --replay``) re-executes on the host.

Every protocol of the mc grid has its host oracle (``protocol.BY_NAME``):
Basic, FPaxos, Tempo, Atlas, EPaxos and Caesar confirm, shrink and
replay. A protocol name outside ``BY_NAME`` is refused by name.

``TempoStabilityBugDev`` and its host twin ``TempoStabilityBug`` are the
reference's deliberately broken Tempo (stability threshold off by one),
the self-check that the monitors catch, the oracle confirms and the
shrinker reduces an ordering bug (``--inject-bug``).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..client import DeviceStream, Workload
from ..core.config import Config
from ..core.planet import Planet
from ..engine.dims import INF, EngineDims
from ..engine.faults import FaultPlan, unavailable
from ..engine.monitor import VIOL_MISSING, viol_names
from ..engine.protocols import dev_config_kwargs, dev_protocol
from ..engine.protocols.tempo import TempoDev
from ..engine.spec import make_lane
from ..executor.table import TableExecutor
from ..parallel.sweep import run_sweep
from ..protocol import BY_NAME as ORACLES
from ..protocol import Tempo
from ..sim import Runner
from .shrink import (
    ARTIFACT_KIND,
    RecordingPlan,
    ShrinkResult,
    artifact as make_artifact,
    shrink as shrink_plan,
)

# host replays of lossless plans still get a horizon: a buggy protocol
# can deadlock the oracle loop (a client that never completes keeps
# periodic events flowing forever); past the lane's natural end the
# horizon changes nothing
REPLAY_HORIZON_MS = 600_000


def oracle_protocol(name: str, inject_bug: bool = False):
    """The host oracle class of a protocol (the injected bug's broken
    Tempo twin when asked, as the reference's ``_protocol_pair``); a name
    outside ``protocol.BY_NAME`` raises ``ValueError`` naming it."""
    if inject_bug:
        if name != "tempo":
            raise ValueError(
                f"--inject-bug is a Tempo-specific self-check, not {name!r}"
            )
        return TempoStabilityBug
    cls = ORACLES.get(name)
    if cls is None:
        raise ValueError(
            f"no host oracle for protocol {name!r}; choose from "
            f"{', '.join(ORACLES)}"
        )
    return cls


# ----------------------------------------------------------------------
# the deliberately broken twins (--inject-bug)
# ----------------------------------------------------------------------


class TempoStabilityBugDev(TempoDev):
    """Tempo with the executor's stability threshold off by one: the
    stable clock becomes a higher order statistic of the per-voter
    frontiers, so one fast voter can make a timestamp "stable" before
    every lower-timestamp conflicting command is known, and two
    processes can execute one key in different orders. Never registered
    in ``dev_protocol``."""

    def lane_ctx(self, config, dims, sorted_idx):
        ctx = dict(super().lane_ctx(config, dims, sorted_idx))
        ctx["threshold"] = np.int32(max(int(ctx["threshold"]) - 1, 1))
        return ctx


class _BuggyTableExecutor(TableExecutor):
    def __init__(self, process_id, shard_id, config, **kw):
        super().__init__(process_id, shard_id, config, **kw)
        self.stability_threshold = max(self.stability_threshold - 1, 1)


class TempoStabilityBug(Tempo):
    """Host twin of :class:`TempoStabilityBugDev` (the same off-by-one in
    the table executor), so the injected bug's flagged lanes confirm
    through the ordinary host replay. Never registered in ``BY_NAME``."""

    EXECUTOR = _BuggyTableExecutor


# ----------------------------------------------------------------------
# fuzz specification and perturbation drawing
# ----------------------------------------------------------------------


@dataclass(frozen=True)
class FuzzSpec:
    """One (protocol, config) fuzz point: the workload is fixed, every
    schedule gets an independently drawn perturbation plan (the
    reference's ``FuzzSpec``, field for field)."""

    protocol: str
    n: int = 3
    f: int = 1
    conflict: int = 100
    pool_size: int = 1
    clients_per_region: int = 1
    commands_per_client: int = 5
    schedules: int = 512
    seed: int = 0                  # root PRNG key (plans + workload)
    jitter_max: int = 8            # per-message delay x U{1..jitter_max}
    crash_share: float = 0.2       # fraction of lanes with crash plans
    drop_share: float = 0.15       # fraction of lanes with drop masks
    drop_bp: int = 200             # drop probability (basis points)
    drop_horizon_ms: int = 20_000  # lossy lanes end here at the latest
    extra_time_ms: int = 0         # 0 = auto (scales with jitter_max)
    regions: Tuple[str, ...] = ()  # () = first n of the planet
    aws: bool = False              # AWS planet dataset (else GCP)
    inject_bug: bool = False       # the broken Tempo twin
    # the slice of the fault envelope this point fuzzes ("mixed" = the
    # full envelope); derived by class_spec, never set by hand
    fault_class: str = "mixed"

    def planet(self) -> Planet:
        if self.aws:
            return Planet.from_dataset("latency_aws_2021_02_13")
        return Planet.new()

    @property
    def extra_ms(self) -> int:
        # the drain tail must cover a jittered RTT plus a few periodic
        # intervals, else correct protocols report missing executions
        return self.extra_time_ms or (1000 + 500 * self.jitter_max)


def _oracle(spec: FuzzSpec):
    """The oracle half of the reference's ``_protocol_pair``: the host
    class the spec's flagged lanes replay through."""
    return oracle_protocol(spec.protocol, spec.inject_bug)


def _device_protocol(spec: FuzzSpec, clients: int):
    """The device protocol of the spec (the injected-bug twin when
    asked), with capacities sized as for 4x the clients, as the
    reference's ``_protocol_pair``: fuzz jitter stretches the stability
    lag past what ``for_load`` sizes for."""
    keys = spec.pool_size + clients
    sized = max(clients * 4, clients + 8)
    if spec.inject_bug:
        assert spec.protocol == "tempo", (
            "--inject-bug is a Tempo-specific self-check"
        )
        return TempoStabilityBugDev.for_load(keys=keys, clients=sized)
    return dev_protocol(spec.protocol, sized, keys=keys)


# per-class seed salts: each non-mixed fault class owns an independent
# PCG64 stream; "mixed" is unsalted
_CLASS_SEED_SALT = {
    "mixed": 0x0,
    "crash": 0x0C7A54,
    "drop": 0x00D709,
    "jitter": 0x3177E7,
}


def class_spec(spec: FuzzSpec, fault_class: str) -> FuzzSpec:
    """The per-fault-class point of a grid-level spec: ``mixed`` returns
    the spec unchanged; ``crash``/``drop``/``jitter`` zero the excluded
    shares and re-salt the seed."""
    salt = _CLASS_SEED_SALT.get(fault_class)
    if salt is None:
        raise ValueError(
            f"unknown fault class {fault_class!r}; choose from "
            "crash, drop, jitter, mixed (registry.FAULT_CLASSES)"
        )
    if fault_class == "mixed":
        return spec
    kw = {
        "fault_class": fault_class,
        "seed": (spec.seed ^ salt) & 0x7FFFFFFF,
    }
    if fault_class == "crash":
        kw["drop_share"] = 0.0
    elif fault_class == "drop":
        kw["crash_share"] = 0.0
    else:  # jitter
        kw["crash_share"] = 0.0
        kw["drop_share"] = 0.0
    return replace(spec, **kw)


def plan_rng(spec: FuzzSpec) -> np.random.Generator:
    """The root PRNG of a fuzz point's perturbation plans."""
    return np.random.default_rng(
        [spec.seed & 0x7FFFFFFF, spec.n, spec.f, spec.conflict]
    )


def rng_state(rng: np.random.Generator) -> dict:
    """JSON-able bit-generator state (plain ints/strs)."""
    return rng.bit_generator.state


def restore_rng(state: dict) -> np.random.Generator:
    """Inverse of :func:`rng_state`: a generator that continues the
    stream exactly where it stopped."""
    bg_cls = getattr(np.random, state["bit_generator"])
    bg = bg_cls()
    bg.state = state
    return np.random.Generator(bg)


def point_config(spec: FuzzSpec) -> Config:
    """The device Config of one fuzz point."""
    return Config(**dev_config_kwargs(spec.protocol, spec.n, spec.f))


def point_protocol(spec: FuzzSpec):
    """The device protocol of one fuzz point (the injected-bug twin when
    asked): what :func:`draw_plans` needs for its ``min_live`` bound."""
    return _device_protocol(spec, spec.clients_per_region * spec.n)


def draw_plans(spec: FuzzSpec, config: Config, protocol,
               count: "int | None" = None,
               rng: "np.random.Generator | None" = None,
               ) -> List[FaultPlan]:
    """Per-lane perturbation plans from the root PRNG: always seeded
    jitter; a slice of lanes adds threefry drop masks (with the
    mandatory horizon); another adds crash plans within what the
    protocol tolerates that never target the leader. Drawing in chunks
    from one generator (``rng``/``count``) gives the one-shot
    sequence."""
    if rng is None:
        rng = plan_rng(spec)
    leader_row = None if config.leader is None else config.leader - 1
    crashable = [r for r in range(spec.n) if r != leader_row]
    plans: List[FaultPlan] = []
    for _ in range(spec.schedules if count is None else count):
        kw = dict(
            jitter_max=spec.jitter_max,
            jitter_seed=int(rng.integers(1 << 31)),
        )
        u = rng.random()
        if u < spec.crash_share and config.f >= 1 and crashable:
            k = int(rng.integers(1, config.f + 1))
            rows = rng.choice(
                crashable, size=min(k, len(crashable)), replace=False
            )
            kw["crashes"] = {
                int(r): int(rng.integers(0, 2000)) for r in rows
            }
        elif u < spec.crash_share + spec.drop_share:
            kw["drop_bp"] = spec.drop_bp
            kw["drop_seed"] = int(rng.integers(1 << 31))
            kw["horizon_ms"] = spec.drop_horizon_ms
        plan = FaultPlan(**kw)
        if plan.crashes and unavailable(plan, protocol, config):
            # only for protocols whose min_live exceeds n - f: a
            # jitter-only lane instead
            plan = FaultPlan(
                jitter_max=kw["jitter_max"], jitter_seed=kw["jitter_seed"]
            )
        plans.append(plan)
    return plans


def point_lanes(spec: FuzzSpec, planet: Optional[Planet] = None,
                plans: Optional[Sequence[FaultPlan]] = None):
    """``(protocol, dims, lane specs, plans, monitor_keys)`` of one fuzz
    point, exactly as :func:`run_fuzz_point` runs it (``plans`` default:
    :func:`draw_plans`)."""
    planet = planet or spec.planet()
    regions = list(spec.regions or planet.regions()[: spec.n])
    assert len(regions) == spec.n
    clients = spec.clients_per_region * spec.n
    dev = _device_protocol(spec, clients)
    config = point_config(spec)
    total = spec.commands_per_client * clients
    dims = EngineDims.for_protocol(
        dev,
        n=spec.n,
        clients=clients,
        payload=dev.payload_width(spec.n),
        total_commands=total,
        dot_slots=total + 1,
        regions=spec.n,
    )
    plans = (
        list(plans) if plans is not None else draw_plans(spec, config, dev)
    )
    lane_specs = [
        make_lane(
            dev,
            planet,
            config,
            conflict_rate=spec.conflict,
            pool_size=spec.pool_size,
            commands_per_client=spec.commands_per_client,
            clients_per_region=spec.clients_per_region,
            process_regions=regions,
            client_regions=regions,
            dims=dims,
            extra_time_ms=spec.extra_ms,
            seed=spec.seed,
            faults=plan,
        )
        for plan in plans
    ]
    return dev, dims, lane_specs, plans, spec.pool_size + clients


# ----------------------------------------------------------------------
# host-oracle confirmation
# ----------------------------------------------------------------------


def _live_pids(plan: Optional[FaultPlan], n: int) -> List[int]:
    doomed = set() if plan is None else {r + 1 for r in plan.crashes}
    return [pid for pid in range(1, n + 1) if pid not in doomed]


def check_host_monitors(
    monitors: dict,
    live_pids: Sequence[int],
    expected_total: Optional[int],
    lossless: bool,
) -> Optional[str]:
    """The host-side violation check over the oracle's per-process
    ExecutionOrderMonitors: the reference ``check_monitors`` plus
    exactly-once, with the device monitors' loss gating (order and count
    comparisons bind only on lossless runs: a dropped commit can skip
    one process for good)."""
    orders = {}
    for pid in live_pids:
        m = monitors.get(pid)
        if m is None:
            return f"process {pid}: no execution monitor"
        orders[pid] = {k: list(m.get_order(k)) for k in m.keys()}
    for pid, od in sorted(orders.items()):
        for key, order in od.items():
            if len(set(order)) != len(order):
                return f"process {pid} key {key!r}: duplicate execution"
    if not lossless:
        return None
    pids = sorted(orders)
    for i, pa in enumerate(pids):
        for pb in pids[i + 1:]:
            a, b = orders[pa], orders[pb]
            for key in sorted(set(a) | set(b), key=str):
                oa, ob = a.get(key, []), b.get(key, [])
                m = min(len(oa), len(ob))
                bad = next(
                    (x for x in range(m) if oa[x] != ob[x]), None
                )
                if bad is not None:
                    return (
                        f"execution orders diverge on key {key!r} at "
                        f"index {bad}: p{pa}={oa[bad]} p{pb}={ob[bad]}"
                    )
                if len(oa) != len(ob):
                    return (
                        f"key {key!r}: execution counts diverge "
                        f"(p{pa}={len(oa)} p{pb}={len(ob)})"
                    )
    if expected_total is not None:
        for pid, od in sorted(orders.items()):
            total = sum(len(v) for v in od.values())
            if total != expected_total:
                return (
                    f"process {pid} executed {total} != "
                    f"{expected_total} commands"
                )
    return None


def host_run(
    spec: FuzzSpec,
    plan: Optional[FaultPlan],
    *,
    planet: Optional[Planet] = None,
    regions: Optional[Sequence[str]] = None,
):
    """One perturbed schedule of ``spec`` through the host oracle:
    ``(metrics, monitors, latencies, the plan the runner ran)``. A
    lossless plan gets :data:`REPLAY_HORIZON_MS`; a
    :class:`RecordingPlan` keeps its events."""
    planet = planet or spec.planet()
    regions = list(regions or spec.regions or planet.regions()[: spec.n])
    oracle_cls = _oracle(spec)
    config = Config(
        **dev_config_kwargs(spec.protocol, spec.n, spec.f)
    ).with_(executor_monitor_execution_order=True)
    run_plan = plan
    if run_plan is not None and run_plan.horizon_ms is None:
        # deadlock guard for buggy protocols; inert past the natural end
        # (a RecordingPlan stays one: replace keeps the class)
        run_plan = replace(run_plan, horizon_ms=REPLAY_HORIZON_MS)
    workload = Workload(
        shard_count=1,
        key_gen=DeviceStream(
            conflict_rate=spec.conflict,
            pool_size=spec.pool_size,
            seed=spec.seed,
        ),
        keys_per_command=1,
        commands_per_client=spec.commands_per_client,
        payload_size=0,
    )
    runner = Runner(
        oracle_cls,
        planet,
        config,
        workload,
        spec.clients_per_region,
        regions,
        regions,
        fault_plan=run_plan,
    )
    metrics, monitors, latencies = runner.run(
        extra_sim_time_ms=spec.extra_ms
    )
    return metrics, monitors, latencies, run_plan


def host_check(
    spec: FuzzSpec,
    plan: Optional[FaultPlan],
    *,
    planet: Optional[Planet] = None,
    regions: Optional[Sequence[str]] = None,
    record: bool = False,
) -> Tuple[Optional[str], Optional[list]]:
    """Replay one perturbed schedule through the host oracle and check
    its execution monitors. Returns (violation | None, the recorded wire
    events when ``record``)."""
    planet = planet or spec.planet()
    regions = list(regions or spec.regions or planet.regions()[: spec.n])
    clients = spec.clients_per_region * len(regions)
    run_plan = plan
    if record and plan is not None:
        run_plan = RecordingPlan.of(plan)
    _metrics, monitors, latencies, run_plan = host_run(
        spec, run_plan, planet=planet, regions=regions)
    lossy = plan is not None and (
        plan.drop_bp > 0
        or plan.drop_list
        or any(
            w.delay is not None and w.delay >= INF for w in plan.windows
        )
    )
    crashed = plan is not None and bool(plan.crashes)
    completed = sum(h.count() for _iss, h in latencies.values())
    expected = (
        spec.commands_per_client * clients
        if not lossy and not crashed and completed
        == spec.commands_per_client * clients
        else None
    )
    violation = check_host_monitors(
        monitors,
        _live_pids(plan, spec.n),
        expected,
        lossless=not lossy,
    )
    events = (
        list(run_plan.events)
        if record and isinstance(run_plan, RecordingPlan)
        else None
    )
    return violation, events


# ----------------------------------------------------------------------
# results
# ----------------------------------------------------------------------


@dataclass
class LaneFinding:
    """One device-flagged lane and what became of it."""

    lane: int
    plan: Optional[FaultPlan]
    violation: int
    violation_step: int
    host_violation: Optional[str] = None
    shrunk: Optional[ShrinkResult] = None
    artifact: Optional[dict] = None
    # where the artifact was written (run_fuzz_point(artifact_dir=..)
    # writes each one the moment it exists)
    artifact_path: Optional[str] = None

    @property
    def violation_cause(self) -> str:
        return viol_names(self.violation)

    @property
    def confirmed(self) -> bool:
        return self.host_violation is not None


@dataclass
class FuzzPointResult:
    spec: FuzzSpec
    schedules: int
    elapsed_s: float
    schedules_per_sec: float
    findings: List[LaneFinding] = field(default_factory=list)
    engine_errors: Dict[str, int] = field(default_factory=dict)
    flagged: int = 0
    confirmed: int = 0
    unprocessed: int = 0  # flagged lanes past max_confirmations
    # per-lane coverage digests in plan order (LaneResults.coverage)
    digests: List[int] = field(default_factory=list)
    # every lane's LaneResults, in plan order
    lane_results: list = field(default_factory=list, repr=False)
    # host seconds spent confirming and shrinking (not in the summary,
    # as the reference's: its timings are the device fan-out's)
    confirm_s: float = 0.0

    def summary(self) -> dict:
        """The reference's summary keys."""
        return {
            "protocol": self.spec.protocol,
            "n": self.spec.n,
            "f": self.spec.f,
            "conflict": self.spec.conflict,
            "schedules": self.schedules,
            # device fan-out time only
            "fuzz_elapsed_s": round(self.elapsed_s, 2),
            "schedules_per_sec": round(self.schedules_per_sec, 2),
            "flagged": self.flagged,
            "confirmed": self.confirmed,
            "unprocessed": self.unprocessed,
            "engine_errors": self.engine_errors,
            "violations": [
                {
                    "lane": f.lane,
                    "device": f.violation_cause,
                    "step": f.violation_step,
                    "host": f.host_violation,
                    **(
                        {
                            "shrunk_to": f.shrunk.size,
                            "shrink_runs": f.shrunk.runs,
                        }
                        if f.shrunk
                        else {}
                    ),
                }
                for f in self.findings
            ],
        }


def run_fuzz_point(
    spec: FuzzSpec,
    *,
    planet: Optional[Planet] = None,
    confirm: bool = True,
    do_shrink: bool = True,
    shrink_budget: int = 150,
    max_confirmations: int = 8,
    strict_missing: bool = False,
    plans: Optional[Sequence[FaultPlan]] = None,
    lane_offset: int = 0,
    artifact_dir: Optional[str] = None,
    device=None,
) -> FuzzPointResult:
    """Fuzz one (protocol, config) point on ``device`` (default: the
    CUDA card): fan the schedule batch out with the monitors on, then
    host-confirm and shrink the flagged lanes.

    At most ``max_confirmations`` flagged lanes go through the host
    pipeline (the rest are counted as unprocessed) and each shrink spends
    at most ``shrink_budget`` host runs. ``strict_missing`` promotes the
    advisory missing-execution bit to a finding. ``plans`` overrides the
    draw, ``lane_offset`` shifts reported lane indices and
    ``artifact_dir`` writes every shrunk repro artifact the moment it
    exists.

    ``confirm=True`` (the default) on a protocol without a host oracle
    raises ``ValueError`` naming it, before any lane runs."""
    if confirm:
        _oracle(spec)
    planet = planet or spec.planet()
    regions = list(spec.regions or planet.regions()[: spec.n])
    dev, dims, lane_specs, plans, monitor_keys = point_lanes(
        spec, planet, plans)
    t0 = time.perf_counter()
    results = run_sweep(dev, dims, lane_specs, device=device,
                        monitor_keys=monitor_keys)
    elapsed = time.perf_counter() - t0

    out = FuzzPointResult(
        spec=spec,
        schedules=len(lane_specs),
        elapsed_s=elapsed,
        schedules_per_sec=len(lane_specs) / max(elapsed, 1e-9),
        digests=[int(r.coverage) for r in results],
        lane_results=results,
    )
    for r in results:
        if r.err:
            out.engine_errors[r.err_cause] = (
                out.engine_errors.get(r.err_cause, 0) + 1
            )
    mask = ~0 if strict_missing else ~VIOL_MISSING
    flagged = [
        (i, r) for i, r in enumerate(results) if (r.violation & mask)
    ]
    out.flagged = len(flagged)
    t1 = time.perf_counter()
    for i, r in flagged:
        if len(out.findings) >= max_confirmations:
            out.unprocessed += 1
            continue
        finding = LaneFinding(
            lane=lane_offset + i,
            plan=plans[i],
            violation=r.violation,
            violation_step=r.violation_step,
        )
        if confirm:
            _confirm(spec, finding, planet, regions, do_shrink,
                     shrink_budget, artifact_dir)
            out.confirmed += finding.confirmed
        out.findings.append(finding)
    out.confirm_s = time.perf_counter() - t1
    return out


def _confirm(spec: FuzzSpec, finding: LaneFinding, planet: Planet,
             regions: List[str], do_shrink: bool, shrink_budget: int,
             artifact_dir: Optional[str]) -> None:
    """Replay one flagged lane through the host oracle; shrink a
    confirmed violation to a repro artifact (written to ``artifact_dir``
    when given)."""
    plan = finding.plan
    violation, events = host_check(
        spec, plan, planet=planet, regions=regions, record=True)
    finding.host_violation = violation
    if violation is None or not do_shrink:
        return
    run_plan = plan
    if run_plan.horizon_ms is None:
        run_plan = replace(run_plan, horizon_ms=REPLAY_HORIZON_MS)

    def check(p):
        return host_check(spec, p, planet=planet, regions=regions)[0]

    finding.shrunk = shrink_plan(run_plan, events or [], check,
                                 budget=shrink_budget)
    if finding.shrunk is None:
        return
    finding.artifact = make_artifact(
        finding.shrunk,
        protocol=spec.protocol,
        n=spec.n,
        f=spec.f,
        conflict=spec.conflict,
        pool_size=spec.pool_size,
        clients_per_region=spec.clients_per_region,
        commands_per_client=spec.commands_per_client,
        regions=regions,
        workload_seed=spec.seed,
        extra_time_ms=spec.extra_ms,
        inject_bug=spec.inject_bug,
        aws=spec.aws,
        device={
            "lane": finding.lane,
            "violation": finding.violation,
            "violation_step": finding.violation_step,
        },
    )
    if artifact_dir is not None:
        finding.artifact_path = _persist_artifact(artifact_dir, spec,
                                                  finding)


def _persist_artifact(artifact_dir: str, spec: FuzzSpec,
                      finding: LaneFinding) -> str:
    """Write one repro artifact durably (atomic rename), in the
    canonical bytes every artifact is written in."""
    from ..engine.checkpoint import atomic_write, canonical_json

    os.makedirs(artifact_dir, exist_ok=True)
    path = os.path.join(
        artifact_dir,
        f"repro_{spec.protocol}_n{spec.n}_lane{finding.lane}.json",
    )
    atomic_write(path, canonical_json(finding.artifact, indent=2))
    return path


# ----------------------------------------------------------------------
# repro-artifact replay (cli.py mc --replay)
# ----------------------------------------------------------------------


def artifact_spec(obj: dict) -> FuzzSpec:
    """The fuzz point a repro artifact was shrunk on."""
    assert obj.get("kind") == ARTIFACT_KIND, "not a fuzz repro artifact"
    return FuzzSpec(
        protocol=obj["protocol"],
        n=int(obj["n"]),
        f=int(obj["f"]),
        conflict=int(obj["conflict"]),
        pool_size=int(obj["pool_size"]),
        clients_per_region=int(obj["clients_per_region"]),
        commands_per_client=int(obj["commands_per_client"]),
        seed=int(obj["workload_seed"]),
        extra_time_ms=int(obj["extra_time_ms"]),
        regions=tuple(obj["regions"]),
        aws=bool(obj.get("aws", False)),
        inject_bug=bool(obj.get("inject_bug", False)),
    )


def replay_artifact(obj: dict, planet: Optional[Planet] = None) -> dict:
    """Re-execute a shrunk repro artifact through the host oracle and
    report whether its violation reproduces. An artifact of a protocol
    without a host oracle raises ``ValueError`` naming it."""
    spec = artifact_spec(obj)
    _oracle(spec)
    plan = FaultPlan.from_json(obj["perturbations"])
    violation, _ = host_check(
        spec, plan, planet=planet, regions=spec.regions
    )
    return {
        # shrinking keeps "some violation", not a given one: reproduced
        # means a violation occurred, matches_expected whether it is the
        # recorded string
        "reproduced": violation is not None,
        "matches_expected": violation == obj.get("violation"),
        "violation": violation,
        "expected": obj.get("violation"),
        "perturbation_count": obj.get("perturbation_count"),
    }


def load_artifact(path: str) -> dict:
    """Read a repro artifact; one whose protocol has no host oracle
    raises ``ValueError`` naming it, before any replay."""
    with open(path) as fh:
        obj = json.load(fh)
    _oracle(artifact_spec(obj))
    return obj
