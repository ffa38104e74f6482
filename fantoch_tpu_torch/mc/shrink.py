"""Counterexample shrinking for fuzz-flagged schedules.

A violating fuzz lane is described by a *seeded* :class:`FaultPlan`
(jitter multipliers, threefry drop masks, crash plans) — compact, but
opaque: nothing says *which* of the hundreds of perturbed messages
matter. Shrinking rewrites the plan into an explicit per-message form
and then delta-debugs it down to a minimal set:

1. **record** — replay the plan through the host oracle once with a
   recording wrapper around ``FaultPlan.wire``; every message whose
   delay was actually multiplied (and every message actually dropped)
   becomes one *perturbation component*, as do the plan's crash
   entries;
2. **explicify** — rebuild the plan from the recorded components using
   ``jitter_overrides``/``drop_list`` (host-only explicit fields). The
   wire behavior of every recorded message is identical, so the replay
   reproduces the violation bit-for-bit;
3. **ddmin** — classic delta debugging (Zeller/Hildebrandt) over the
   component list with the host oracle as the test oracle, bounded by
   a run budget. Removing a component reverts that message to its base
   delay (or un-drops it / un-crashes the process), which perturbs the
   downstream schedule — standard shrinking semantics: the check only
   asks "does *some* violation persist", not "the same violation";
4. **artifact** — the surviving components serialize into a JSON repro
   (``artifact()``) that ``python -m fantoch_tpu_torch mc --replay <file>``
   re-executes deterministically through the host oracle.

Everything here is host-side: the device engine never sees explicit
per-message overrides (``FaultPlan.host_only``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from ..engine.faults import FaultPlan

# a perturbation component: ("jit", (src, dst, k), mult) |
# ("drop", (src, dst, k), None) | ("crash", row, crash_ms)
Component = Tuple[str, object, Optional[int]]

ARTIFACT_KIND = "fantoch-fuzz-repro"
ARTIFACT_VERSION = 1


class RecordingPlan(FaultPlan):
    """A :class:`FaultPlan` whose wire model logs every message it
    actually perturbed. Frozen-dataclass subclass: the event list is
    attached via ``object.__setattr__``."""

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "events", [])

    @staticmethod
    def of(plan: FaultPlan) -> "RecordingPlan":
        return RecordingPlan(
            crashes=plan.crashes,
            windows=plan.windows,
            drop_bp=plan.drop_bp,
            drop_seed=plan.drop_seed,
            horizon_ms=plan.horizon_ms,
            jitter_max=plan.jitter_max,
            jitter_seed=plan.jitter_seed,
            jitter_overrides=plan.jitter_overrides,
            drop_list=plan.drop_list,
        )

    def wire(self, src, dst, send_ms, base_delay, kcnt, drop_table=None,
             jitter_table=None):
        delay, lost = FaultPlan.wire(
            self, src, dst, send_ms, base_delay, kcnt, drop_table,
            jitter_table,
        )
        # the same resolution wire() itself uses (FaultPlan.jitter_mult
        # is the single source of truth), so recorded components always
        # describe the multiplier that was actually applied
        mult = self.jitter_mult(src, dst, kcnt, jitter_table)
        if mult is not None and mult > 1:
            self.events.append(("jit", (src, dst, kcnt), int(mult)))
        if lost:
            self.events.append(("drop", (src, dst, kcnt), None))
        return delay, lost


def plan_components(plan: FaultPlan, events) -> List[Component]:
    """Recorded wire events + the plan's crashes as one component list
    (deduplicated, deterministic order)."""
    out: List[Component] = [
        ("crash", row, ms) for row, ms in sorted(plan.crashes.items())
    ]
    seen = set()
    for kind, key, arg in events:
        if (kind, key) in seen:
            continue
        seen.add((kind, key))
        out.append((kind, key, arg))
    return out


def components_plan(
    components: List[Component], horizon_ms: Optional[int]
) -> FaultPlan:
    """The explicit plan that applies exactly ``components``."""
    crashes = {}
    overrides = {}
    drops = []
    for kind, key, arg in components:
        if kind == "crash":
            crashes[key] = arg
        elif kind == "jit":
            overrides[key] = arg
        elif kind == "drop":
            drops.append(key)
        else:  # pragma: no cover - construction is local to this module
            raise ValueError(kind)
    return FaultPlan(
        crashes=crashes,
        jitter_overrides=overrides,
        drop_list=tuple(drops),
        # keep the horizon whenever the original plan had one: an
        # un-dropped subset can still stall (a removed drop changes the
        # schedule), and lossy subsets require it
        horizon_ms=horizon_ms,
    )


@dataclass
class ShrinkResult:
    plan: FaultPlan             # minimal explicit plan
    components: List[Component]
    violation: str              # the violation the minimal plan shows
    runs: int                   # host-oracle executions spent
    initial_components: int

    @property
    def size(self) -> int:
        return len(self.components)


def ddmin(
    components: List[Component],
    test: Callable[[List[Component]], Optional[str]],
    budget: int = 150,
) -> Tuple[List[Component], Optional[str], int]:
    """Delta debugging to a (budget-bounded) 1-minimal component list.
    ``test`` returns the violation string a subset still produces, or
    None. Returns (minimal components, its violation, runs used)."""
    cur = list(components)
    cur_viol = None
    runs = 0
    gran = 2
    while len(cur) > 1 and runs < budget:
        size = max(len(cur) // gran, 1)
        chunks = [cur[i:i + size] for i in range(0, len(cur), size)]
        reduced = False
        for i in range(len(chunks)):
            cand = [c for j, ch in enumerate(chunks) for c in ch if j != i]
            runs += 1
            v = test(cand)
            if v is not None:
                cur, cur_viol = cand, v
                gran = max(gran - 1, 2)
                reduced = True
                break
            if runs >= budget:
                break
        if not reduced:
            if gran >= len(cur):
                break
            gran = min(len(cur), gran * 2)
    return cur, cur_viol, runs


def shrink(
    plan: FaultPlan,
    events,
    check: Callable[[FaultPlan], Optional[str]],
    budget: int = 150,
) -> Optional[ShrinkResult]:
    """Shrink a confirmed violating plan to a minimal explicit one.

    ``events`` is the recorded wire-event list from the confirming
    replay (``RecordingPlan.events``); ``check`` replays a candidate
    plan through the host oracle and returns its violation string (or
    None). Returns None if even the full explicit plan fails to
    reproduce — a caller bug (the explicit plan is wire-identical to
    the recorded replay) surfaced loudly instead of a bogus artifact."""
    assert not plan.windows, (
        "window-carrying plans are not explicifiable yet: "
        "RecordingPlan.wire does not record window delay effects, so "
        "the rebuilt explicit plan would silently drop them (fuzz "
        "plans never carry windows)"
    )
    components = plan_components(plan, events)
    horizon = plan.horizon_ms

    def test(cand: List[Component]) -> Optional[str]:
        return check(components_plan(cand, horizon))

    runs = 1
    full_viol = test(components)
    if full_viol is None:
        return None
    # a bug that fires on the unperturbed schedule needs no repro
    # perturbations at all — report that honestly before delta-debugging
    runs += 1
    empty_viol = test([])
    if empty_viol is not None:
        return ShrinkResult(
            plan=components_plan([], horizon),
            components=[],
            violation=empty_viol,
            runs=runs,
            initial_components=len(components),
        )
    minimal, viol, dd_runs = ddmin(components, test, budget=budget - runs)
    return ShrinkResult(
        plan=components_plan(minimal, horizon),
        components=minimal,
        violation=viol or full_viol,
        runs=runs + dd_runs,
        initial_components=len(components),
    )


def artifact(shrunk: ShrinkResult, *, protocol: str, n: int, f: int,
             conflict: int, pool_size: int, clients_per_region: int,
             commands_per_client: int, regions, workload_seed: int,
             extra_time_ms: int, inject_bug: bool = False,
             aws: bool = False, device: Optional[dict] = None) -> dict:
    """The JSON repro artifact ``cli.py mc --replay`` re-executes."""
    return {
        "kind": ARTIFACT_KIND,
        "version": ARTIFACT_VERSION,
        "protocol": protocol,
        "n": n,
        "f": f,
        "conflict": conflict,
        "pool_size": pool_size,
        "clients_per_region": clients_per_region,
        "commands_per_client": commands_per_client,
        # region names alone can't rebuild the latency matrix — the
        # planet dataset must ride along for --replay
        "aws": bool(aws),
        "regions": list(regions),
        "workload_seed": workload_seed,
        "extra_time_ms": extra_time_ms,
        "inject_bug": bool(inject_bug),
        "violation": shrunk.violation,
        "perturbations": shrunk.plan.meta(),
        "perturbation_count": shrunk.size,
        "shrink": {
            "initial_components": shrunk.initial_components,
            "host_runs": shrunk.runs,
        },
        **({"device": device} if device else {}),
    }
