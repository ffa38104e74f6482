"""Time-varying traffic schedules and open-loop arrival schedules: the
port's own copy of the reference's ``fantoch_tpu/traffic/schedule.py``
and of its presets (``fantoch_tpu/registry.py`` ``TRAFFIC_PRESETS``,
``traffic_preset``, ``ARRIVAL_PRESETS``, ``arrival_preset``).

A :class:`TrafficSchedule` is piecewise over the per-client command
sequence axis (1-based seqs, the SUBMIT payload's seq): each
:class:`TrafficPhase` pins the ConflictPool knobs (conflict rate, pool
size, a rotated ``pool_base`` for hot-key churn), a ``think_ms`` delay
before the next SUBMIT, a read share and an optional Zipf coefficient.
:meth:`TrafficSchedule.compile` lowers it to the ``traffic_*`` ctx tables
the ``key_table`` kernel (K3) and the ``emit_rewrite`` kernel (K6) read:
a ``[T]`` seq → epoch index (``T = budget + 2``) and one ``[E]`` array per
knob. A flat schedule compiles to no tables: ``make_lane`` collapses it
onto the static path.

An :class:`ArrivalSchedule` timestamps every command of an open-loop
client by a seeded arrival process independent of completion
(exponential gaps whose mean is piecewise over the seq axis);
:meth:`ArrivalSchedule.arrival_table` draws the whole ``[C, T]`` table
on the host with numpy, the reference's stream exactly.

Plain numpy; no kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np

from ..client.key_gen import zipf_weights


@dataclass(frozen=True)
class TrafficPhase:
    """One epoch of the schedule, covering ``commands`` command seqs.

    ``zipf_coef`` is the per-epoch Zipf skew for lanes running the
    ``KeyGen::Zipf`` workload: 0.0 (the default) means "the lane's base
    coefficient", a nonzero value overrides it for this epoch — so a
    schedule can move the key-popularity skew over time the same way it
    moves the conflict pool. Pool-only lanes ignore it entirely."""

    commands: int
    conflict_rate: int
    pool_size: int = 1
    pool_base: int = 0
    think_ms: int = 0
    read_pct: int = 0
    zipf_coef: float = 0.0

    def __post_init__(self) -> None:
        assert self.commands >= 1, "a phase must cover >= 1 command"
        assert 0 <= self.conflict_rate <= 100, self.conflict_rate
        assert self.pool_size >= 1, self.pool_size
        assert self.pool_base >= 0, self.pool_base
        assert self.think_ms >= 0, self.think_ms
        assert 0 <= self.read_pct <= 100, self.read_pct
        assert self.zipf_coef >= 0.0, self.zipf_coef

    def knobs(self) -> Tuple[int, int, int, int, float]:
        """The parameters whose variation makes a schedule non-flat
        (read_pct rides along in the tables but never reaches the
        engine's arithmetic, so a read-mix-only schedule is still
        flat for the device)."""
        return (
            self.conflict_rate, self.pool_size, self.pool_base,
            self.think_ms, self.zipf_coef,
        )


@dataclass(frozen=True)
class TrafficSchedule:
    """A named piecewise schedule. ``cycle=True`` repeats the phase
    pattern over the whole command budget (a diurnal day repeating);
    ``cycle=False`` extends the last phase forever (a one-shot ramp).

    Hashable by value."""

    name: str
    phases: Tuple[TrafficPhase, ...]
    cycle: bool = False

    def __post_init__(self) -> None:
        assert self.phases, "a schedule needs at least one phase"

    # -- host helpers (the oracle mirror uses exactly these) -----------

    @property
    def pattern_len(self) -> int:
        return sum(p.commands for p in self.phases)

    def epoch_of(self, seq: int) -> int:
        """Phase index of 1-based command ``seq`` (unbounded axis:
        cycling or last-phase-extends past the pattern)."""
        assert seq >= 1, "command seqs are 1-based"
        idx = (seq - 1) % self.pattern_len if self.cycle else min(
            seq - 1, self.pattern_len - 1
        )
        for e, p in enumerate(self.phases):
            if idx < p.commands:
                return e
            idx -= p.commands
        return len(self.phases) - 1  # unreachable

    def phase_at(self, seq: int) -> TrafficPhase:
        return self.phases[self.epoch_of(seq)]

    def think_ms(self, seq: int) -> int:
        """The submit delay the oracle runner adds for command ``seq``
        — the bit-exact mirror of the engine's per-epoch think gather
        (engine/core.py ``_lane_step`` step 5)."""
        return self.phase_at(seq).think_ms

    def pool_span(self) -> int:
        """First key above every epoch's shared pool: private client
        keys are ``pool_span + client`` (the static path's
        ``pool_size + client`` generalized over rotation)."""
        return max(p.pool_base + p.pool_size for p in self.phases)

    def is_flat(self) -> bool:
        """True when the schedule is indistinguishable from the static
        ConflictPool path: one effective knob tuple, no think delay, no
        pool rotation, no zipf override. Flat schedules compile to NO
        ctx tables."""
        knobs = {p.knobs() for p in self.phases}
        if len(knobs) != 1:
            return False
        (conflict, _size, base, think, zcoef) = next(iter(knobs))
        del conflict
        return base == 0 and think == 0 and zcoef == 0.0

    # -- device lowering ----------------------------------------------

    def compile(self, commands_per_client: int) -> Dict[str, np.ndarray]:
        """Lower to the engine's ctx tables. ``traffic_seq_epoch`` is
        indexed by command seq (1-based; entry 0 mirrors seq 1, like
        the key table's unused column); length ``budget + 2`` matches
        the key table so the engine's index clamp never binds for a
        real command."""
        E = len(self.phases)
        T = commands_per_client + 2
        seq_epoch = np.zeros((T,), np.int32)
        seq_epoch[0] = self.epoch_of(1)
        for s in range(1, T):
            seq_epoch[s] = self.epoch_of(s)
        return {
            "traffic_seq_epoch": seq_epoch,
            "traffic_conflict": np.asarray(
                [p.conflict_rate for p in self.phases], np.int32
            ),
            "traffic_pool_base": np.asarray(
                [p.pool_base for p in self.phases], np.int32
            ),
            "traffic_pool_size": np.asarray(
                [p.pool_size for p in self.phases], np.int32
            ),
            "traffic_think": np.asarray(
                [p.think_ms for p in self.phases], np.int32
            ),
            "traffic_read_pct": np.asarray(
                [p.read_pct for p in self.phases], np.int32
            ),
            "traffic_pool_span": np.int32(self.pool_span()),
        }

    def zipf_tables(
        self, base_coefficient: float, total_keys: int
    ) -> Dict[str, np.ndarray]:
        """The epoch-varying ``KeyGen::Zipf`` extension: one cumulative
        weight row per phase, ``[E, K]``, row ``e`` built from phase
        e's ``zipf_coef`` (0.0 = the lane's base coefficient). The
        engine's ``gen_key`` gathers the row for the command's epoch
        before the searchsorted draw; the host oracle mirror
        (client/key_gen.py) builds the identical table from the same
        schedule, so the two sides agree bit-exactly."""
        rows = []
        for p in self.phases:
            coef = p.zipf_coef if p.zipf_coef > 0.0 else base_coefficient
            rows.append(
                np.cumsum(zipf_weights(total_keys, coef)).astype(
                    np.float32
                )
            )
        return {"traffic_zipf_cum": np.stack(rows, axis=0)}

    def has_zipf_override(self) -> bool:
        return any(p.zipf_coef > 0.0 for p in self.phases)

    def meta(self) -> dict:
        """Compact JSON-able lane metadata (LaneSpec.traffic_meta)."""
        return {
            "name": self.name,
            "epochs": len(self.phases),
            "cycle": bool(self.cycle),
            "pattern_commands": self.pattern_len,
            "pool_span": self.pool_span(),
        }

    # -- JSON round-trip (campaign grids, repro artifacts) ------------

    def to_json(self) -> dict:
        # zipf_coef is emitted only when set so every pre-zipf schedule
        # round-trips byte-identically (repro artifacts, campaign
        # journals, checkpoint meta all compare canonical JSON)
        return {
            "name": self.name,
            "cycle": bool(self.cycle),
            "phases": [
                {
                    "commands": p.commands,
                    "conflict_rate": p.conflict_rate,
                    "pool_size": p.pool_size,
                    "pool_base": p.pool_base,
                    "think_ms": p.think_ms,
                    "read_pct": p.read_pct,
                    **(
                        {"zipf_coef": p.zipf_coef}
                        if p.zipf_coef > 0.0
                        else {}
                    ),
                }
                for p in self.phases
            ],
        }

    @staticmethod
    def from_json(obj: dict) -> "TrafficSchedule":
        return TrafficSchedule(
            name=str(obj["name"]),
            cycle=bool(obj.get("cycle", False)),
            phases=tuple(
                TrafficPhase(**phase) for phase in obj["phases"]
            ),
        )


TrafficLike = Union[None, str, dict, TrafficSchedule]


def resolve_traffic(
    spec: TrafficLike,
    *,
    conflict: int,
    pool_size: int = 1,
    commands: int,
) -> Optional[TrafficSchedule]:
    """Resolve a traffic spec to a schedule (or None = static path).

    ``spec`` may be a preset name from :data:`TRAFFIC_PRESETS` (parameterized by the lane's base conflict rate /
    pool size / command budget, so the sweep's conflict axis composes
    with the traffic axis), a JSON schedule dict, an already-built
    :class:`TrafficSchedule`, or None. ``"flat"`` resolves to None —
    the static path, by construction."""
    if spec is None or isinstance(spec, TrafficSchedule):
        return spec
    if isinstance(spec, dict):
        return TrafficSchedule.from_json(spec)
    obj = traffic_preset(
        str(spec), conflict=conflict, pool_size=pool_size,
        commands=commands,
    )
    return None if obj is None else TrafficSchedule.from_json(obj)


def traffic_key_capacity(
    specs,
    *,
    conflict: int,
    pool_size: int,
    commands: int,
    clients: int,
) -> Optional[int]:
    """Protocol key capacity covering every schedule in ``specs`` (an
    iterable of preset names / schedules / None): private keys sit at
    ``pool_span + client``, so a rotated pool needs
    ``max(pool_span) + clients`` keys — the single source of the
    invariant ``make_lane`` asserts (``span + live_clients <= K``),
    shared by the CLI sweep and the campaign manager so the two can
    never drift.

    Returns None when every spec resolves flat: callers then keep
    their legacy default capacity (``dev_protocol``'s ``1 + clients``),
    preserving the pre-traffic lane shapes bit-for-bit so old campaign
    journals and checkpoints resume unchanged."""
    span: Optional[int] = None
    for spec in specs:
        sched = resolve_traffic(
            spec, conflict=conflict, pool_size=pool_size,
            commands=commands,
        )
        if sched is not None:
            span = max(span if span is not None else pool_size,
                       sched.pool_span())
    return None if span is None else span + clients


# ----------------------------------------------------------------------
# Open-loop arrival schedules.
#
# A closed-loop client arms command s+1 only when command s completes —
# the one workload shape planet-scale services never have (Schroeder et
# al., NSDI'06: closed-loop load generation hides saturation and
# suffers coordinated omission). An ArrivalSchedule instead timestamps
# every command by a seeded arrival process *independent of
# completion*: per-client exponential inter-arrival gaps whose mean is
# piecewise over the command-seq axis, exactly like the traffic knobs.
# The whole arrival table is drawn host-side once per lane
# (``arrival_table``) and shipped verbatim to both the device engine
# and the host oracle, so the two mirror bit-exactly by construction.
# ----------------------------------------------------------------------

# salt for the per-client arrival PRNG streams, so arrival draws never
# collide with any other seeded stream derived from the lane seed
ARRIVAL_STREAM_SALT = 0x0A21


@dataclass(frozen=True)
class ArrivalPhase:
    """One epoch of an arrival schedule: ``commands`` command seqs
    arriving with exponential gaps of mean ``mean_gap_ms`` (>= 1; the
    engine clock is integer ms and a 0-mean phase would collapse every
    arrival onto one tick)."""

    commands: int
    mean_gap_ms: int

    def __post_init__(self) -> None:
        assert self.commands >= 1, "a phase must cover >= 1 command"
        assert self.mean_gap_ms >= 1, self.mean_gap_ms


@dataclass(frozen=True)
class ArrivalSchedule:
    """A named piecewise arrival-rate schedule over the per-client
    command-seq axis. ``cycle=True`` repeats the pattern over the whole
    budget; ``cycle=False`` extends the last phase forever."""

    name: str
    phases: Tuple[ArrivalPhase, ...]
    cycle: bool = False

    def __post_init__(self) -> None:
        assert self.phases, "a schedule needs at least one phase"

    @property
    def pattern_len(self) -> int:
        return sum(p.commands for p in self.phases)

    def epoch_of(self, seq: int) -> int:
        """Phase index of 1-based command ``seq`` (same axis semantics
        as :meth:`TrafficSchedule.epoch_of`)."""
        assert seq >= 1, "command seqs are 1-based"
        idx = (seq - 1) % self.pattern_len if self.cycle else min(
            seq - 1, self.pattern_len - 1
        )
        for e, p in enumerate(self.phases):
            if idx < p.commands:
                return e
            idx -= p.commands
        return len(self.phases) - 1  # unreachable

    def mean_gap_ms(self, seq: int) -> int:
        return self.phases[self.epoch_of(seq)].mean_gap_ms

    def scale(self, load_pct: int) -> "ArrivalSchedule":
        """The offered-load axis: scale every phase's mean gap so the
        arrival *rate* becomes ``load_pct`` percent of this schedule's
        (gap 100/load times the base, floored at the 1 ms tick). A
        scaled schedule is renamed ``name@load`` so checkpoint and
        campaign meta refuse a resumed sweep whose load drifted — by
        name, before any bit compare."""
        assert load_pct >= 1, load_pct
        if load_pct == 100:
            return self
        return ArrivalSchedule(
            name=f"{self.name}@{load_pct}",
            cycle=self.cycle,
            phases=tuple(
                ArrivalPhase(
                    commands=p.commands,
                    mean_gap_ms=max(
                        1, round(p.mean_gap_ms * 100 / load_pct)
                    ),
                )
                for p in self.phases
            ),
        )

    def arrival_table(
        self, *, seed: int, clients: int, commands: int
    ) -> np.ndarray:
        """The per-lane arrival-time table: ``[C, T]`` i32 cumulative
        arrival times (ms), ``T = commands + 2`` with column 0 unused
        so 1-based command seqs index directly (the key-table layout).
        Client c's gaps come from its own counter-salted stream
        ``default_rng([seed, SALT, c])`` — insertion-ordered and
        independent of draw interleaving — with
        the gap before command s drawn exponential with the mean of
        s's epoch, floored at 1 ms. ``A[c, 1]`` is the first command's
        arrival (the first gap after t=0); the engine and the host
        oracle both consume THIS array verbatim, which is the whole
        bit-exactness argument."""
        T = commands + 2
        table = np.zeros((clients, T), np.int64)
        for c in range(clients):
            rng = np.random.default_rng(
                [int(seed), ARRIVAL_STREAM_SALT, int(c)]
            )
            t = 0
            for s in range(1, T):
                gap = max(
                    1,
                    int(round(rng.exponential(
                        self.mean_gap_ms(s)
                    ))),
                )
                t += gap
                table[c, s] = t
        table[:, 0] = table[:, 1]  # unused column mirrors seq 1
        assert int(table.max()) < np.iinfo(np.int32).max
        return table.astype(np.int32)

    def meta(self) -> dict:
        """Compact JSON-able lane metadata (LaneSpec.arrival_meta)."""
        return {
            "name": self.name,
            "epochs": len(self.phases),
            "cycle": bool(self.cycle),
            "pattern_commands": self.pattern_len,
            "mean_gaps_ms": [p.mean_gap_ms for p in self.phases],
        }

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "cycle": bool(self.cycle),
            "phases": [
                {
                    "commands": p.commands,
                    "mean_gap_ms": p.mean_gap_ms,
                }
                for p in self.phases
            ],
        }

    @staticmethod
    def from_json(obj: dict) -> "ArrivalSchedule":
        return ArrivalSchedule(
            name=str(obj["name"]),
            cycle=bool(obj.get("cycle", False)),
            phases=tuple(
                ArrivalPhase(**phase) for phase in obj["phases"]
            ),
        )


ArrivalLike = Union[None, str, dict, "ArrivalSchedule"]


def resolve_arrivals(
    spec: ArrivalLike,
    *,
    mean_gap_ms: int,
    commands: int,
    load_pct: int = 100,
) -> Optional[ArrivalSchedule]:
    """Resolve an arrival spec to a schedule (or None = closed loop).

    ``spec`` may be a preset name from :data:`ARRIVAL_PRESETS` (parameterized by the lane's base mean gap and
    command budget), a JSON schedule dict, an already-built
    :class:`ArrivalSchedule`, or None. ``"closed"`` resolves to None —
    the closed-loop static path, by construction. ``load_pct`` applies
    the offered-load scaling (:meth:`ArrivalSchedule.scale`) after
    resolution."""
    if spec is None:
        return None
    if isinstance(spec, ArrivalSchedule):
        return spec.scale(load_pct)
    if isinstance(spec, dict):
        return ArrivalSchedule.from_json(spec).scale(load_pct)
    obj = arrival_preset(
        str(spec), mean_gap_ms=mean_gap_ms, commands=commands
    )
    if obj is None:
        return None
    return ArrivalSchedule.from_json(obj).scale(load_pct)


# named time-varying traffic presets: `sweep --traffic` accepts exactly
# these. Presets are parameterized by the lane's base conflict rate, pool
# size and command budget so they compose with the sweep's conflict axis
# instead of overriding it.
TRAFFIC_PRESETS = ("flat", "diurnal", "flash", "churn")


def traffic_preset(name, *, conflict, pool_size=1, commands):
    """Resolve a preset name to a plain schedule dict (the JSON form
    :meth:`TrafficSchedule.from_json` consumes), or
    None for ``"flat"`` — the static path by construction.

    * ``flat`` — no schedule; the lane runs the static path (the
      traffic axis's control point).
    * ``diurnal`` — one "day" over the command budget in four quarters:
      off-peak issue delays (think 4 → 1 → 0 → 2 ms) and a shifting
      read mix (70 → 50 → 30 → 50 %); conflict stays at the base rate.
    * ``flash`` — a flash crowd: base traffic, then a short
      100%-conflict zero-think spike over ~a fifth of the budget, then
      recovery at the base rate.
    * ``churn`` — hot-key churn: the shared pool's base rotates by
      ``pool_size`` each quarter of the budget, moving the hot key set
      four times; conflict/think stay at the base.
    """
    if name == "flat":
        return None
    assert commands >= 1, "presets scale to the per-client budget"
    q = max(1, commands // 4)
    if name == "diurnal":
        phases = [
            dict(commands=q, conflict_rate=conflict, pool_size=pool_size,
                 think_ms=4, read_pct=70),
            dict(commands=q, conflict_rate=conflict, pool_size=pool_size,
                 think_ms=1, read_pct=50),
            dict(commands=q, conflict_rate=conflict, pool_size=pool_size,
                 think_ms=0, read_pct=30),
            dict(commands=q, conflict_rate=conflict, pool_size=pool_size,
                 think_ms=2, read_pct=50),
        ]
        return {"name": "diurnal", "cycle": True, "phases": phases}
    if name == "flash":
        spike = max(1, commands // 5)
        pre = max(1, (commands - spike) // 2)
        phases = [
            dict(commands=pre, conflict_rate=conflict,
                 pool_size=pool_size, think_ms=2, read_pct=50),
            dict(commands=spike, conflict_rate=100, pool_size=pool_size,
                 think_ms=0, read_pct=10),
            dict(commands=max(1, commands - pre - spike),
                 conflict_rate=conflict, pool_size=pool_size, think_ms=2,
                 read_pct=50),
        ]
        return {"name": "flash", "cycle": False, "phases": phases}
    if name == "churn":
        phases = [
            dict(commands=q, conflict_rate=conflict, pool_size=pool_size,
                 pool_base=i * pool_size, read_pct=30)
            for i in range(4)
        ]
        return {"name": "churn", "cycle": False, "phases": phases}
    raise ValueError(
        f"unknown traffic preset {name!r}; choose from "
        f"{','.join(TRAFFIC_PRESETS)}"
    )


# named open-loop arrival presets (ArrivalSchedule): `sweep --arrivals`
# accepts exactly these. Presets are
# parameterized by the lane's base mean inter-arrival gap and command
# budget so they compose with the offered-load axis (which scales the
# gaps) instead of overriding it.
ARRIVAL_PRESETS = ("closed", "poisson", "burst", "ramp")


def arrival_preset(name, *, mean_gap_ms, commands):
    """Resolve an arrival preset name to a plain schedule dict (the
    JSON form :meth:`ArrivalSchedule.from_json`
    consumes), or None for ``"closed"`` — the closed-loop static path
    by construction.

    * ``closed`` — no arrival process; the lane runs the closed loop
      (the arrivals axis's control point).
    * ``poisson`` — a stationary Poisson process: one phase,
      exponential gaps of mean ``mean_gap_ms`` over the whole budget.
    * ``burst`` — base Poisson traffic, then a burst at ~8x the rate
      over ~a fifth of the budget, then recovery at the base rate.
    * ``ramp`` — offered load doubling in four steps: gaps 4x -> 2x ->
      1x -> 0.5x the base mean, a quarter of the budget each.
    """
    if name == "closed":
        return None
    assert commands >= 1, "presets scale to the per-client budget"
    assert mean_gap_ms >= 1, "the engine clock is integer ms"
    if name == "poisson":
        return {
            "name": "poisson",
            "cycle": False,
            "phases": [
                dict(commands=commands, mean_gap_ms=mean_gap_ms)
            ],
        }
    if name == "burst":
        spike = max(1, commands // 5)
        pre = max(1, (commands - spike) // 2)
        phases = [
            dict(commands=pre, mean_gap_ms=mean_gap_ms),
            dict(commands=spike,
                 mean_gap_ms=max(1, mean_gap_ms // 8)),
            dict(commands=max(1, commands - pre - spike),
                 mean_gap_ms=mean_gap_ms),
        ]
        return {"name": "burst", "cycle": False, "phases": phases}
    if name == "ramp":
        q = max(1, commands // 4)
        phases = [
            dict(commands=q, mean_gap_ms=mean_gap_ms * 4),
            dict(commands=q, mean_gap_ms=mean_gap_ms * 2),
            dict(commands=q, mean_gap_ms=mean_gap_ms),
            dict(commands=q, mean_gap_ms=max(1, mean_gap_ms // 2)),
        ]
        return {"name": "ramp", "cycle": False, "phases": phases}
    raise ValueError(
        f"unknown arrival preset {name!r}; choose from "
        f"{','.join(ARRIVAL_PRESETS)}"
    )
