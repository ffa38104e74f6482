"""Device-scale schedule fuzzing: the device half of the reference's
``fantoch_tpu/mc/fuzz.py``.

Per (protocol, config) point:

1. a :class:`FuzzSpec` draws one :class:`FaultPlan` per schedule from a
   root PRNG (numpy's PCG64, as the reference's, so the plans are the
   reference's): always a seeded jitter plan (each wire hop's delay x a
   threefry draw in [1, jitter_max], keyed on (src, dst, channel
   index)), plus threefry drop masks on a share of the lanes and crash
   plans within the protocol's ``min_live`` on another;
2. the whole batch runs through ``run_sweep(monitor_keys=...)``: every
   lane returns its violation word, first violating step and coverage
   digest (:class:`FuzzPointResult`).

The reference goes on to replay every flagged lane through its host
oracle (confirmation), shrink a confirmed violation to a minimal
perturbation set and write a replayable repro artifact. The port has no
host oracle yet (ROADMAP Queue A item 17), so :func:`run_fuzz_point`
runs only with ``confirm=False`` and :func:`replay_artifact` /
:func:`load_artifact` raise; each refusal names the item before any
lane runs.

``TempoStabilityBugDev`` is the reference's deliberately broken Tempo
(stability threshold off by one), the self-check that the monitors catch
an ordering bug.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.config import Config
from ..core.planet import Planet
from ..engine.dims import EngineDims
from ..engine.faults import FaultPlan, unavailable
from ..engine.monitor import VIOL_MISSING, viol_names
from ..engine.protocols import dev_config_kwargs, dev_protocol
from ..engine.protocols.tempo import TempoDev
from ..engine.spec import make_lane
from ..parallel.sweep import run_sweep

# the ROADMAP Queue A item that ports the host oracle (sim/, protocol/,
# executor/, the client's Workload/DeviceStream, mc/checker.py and
# mc/shrink.py), which confirmation, shrinking and replay need
HOST_ORACLE_ITEM = "17"


def host_oracle_missing(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} needs the host oracle, which is not ported yet "
        f"(ROADMAP Queue A item {HOST_ORACLE_ITEM})"
    )


# ----------------------------------------------------------------------
# the deliberately broken twin (--inject-bug)
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
# results
# ----------------------------------------------------------------------


@dataclass
class LaneFinding:
    """One device-flagged lane. ``host_violation`` stays None: host
    confirmation needs the host oracle."""

    lane: int
    plan: Optional[FaultPlan]
    violation: int
    violation_step: int
    host_violation: Optional[str] = None

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

    def summary(self) -> dict:
        """The reference's summary keys (confirmation fields stay at
        their unconfirmed values)."""
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
                }
                for f in self.findings
            ],
        }


def run_fuzz_point(
    spec: FuzzSpec,
    *,
    planet: Optional[Planet] = None,
    confirm: bool = True,
    max_confirmations: int = 8,
    strict_missing: bool = False,
    plans: Optional[Sequence[FaultPlan]] = None,
    lane_offset: int = 0,
    device=None,
) -> FuzzPointResult:
    """Fuzz one (protocol, config) point on ``device`` (default: the
    CUDA card): fan the schedule batch out with the monitors on and
    collect the flagged lanes (at most ``max_confirmations`` findings,
    the rest counted as unprocessed). ``strict_missing`` promotes the
    advisory missing-execution bit to a finding. ``plans`` overrides the
    draw, ``lane_offset`` shifts reported lane indices.

    ``confirm=True`` (the reference's default) needs the host oracle and
    raises before any lane runs."""
    if confirm:
        raise host_oracle_missing(
            "run_fuzz_point(confirm=True) (host confirmation and shrink)"
        )
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
    for i, r in flagged:
        if len(out.findings) >= max_confirmations:
            out.unprocessed += 1
            continue
        out.findings.append(LaneFinding(
            lane=lane_offset + i,
            plan=plans[i],
            violation=r.violation,
            violation_step=r.violation_step,
        ))
    return out


def replay_artifact(obj: dict, planet: Optional[Planet] = None) -> dict:
    """Re-executing a repro artifact needs the host oracle."""
    raise host_oracle_missing("replay_artifact (mc --replay)")


def load_artifact(path: str) -> dict:
    """Repro artifacts are written and replayed by the host pipeline."""
    raise host_oracle_missing("load_artifact (mc --replay)")
