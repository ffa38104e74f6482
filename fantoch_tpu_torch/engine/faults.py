"""Per-lane fault plans for the batched engine: the port's own copy of the
reference's ``fantoch_tpu/engine/faults.py``.

A :class:`FaultPlan` encodes one lane's adversity:

* **crash-stop faults** — process ``p`` dies at local time ``t``: messages
  addressed to it at or past ``t`` are lost and its timers stop. With no
  recovery modelled, doomed processes are suspected from the start: they
  rank last in every discovery order (so they join no quorum) and the
  clients attached to them are halted (budget zeroed). Under a leader
  protocol a leader crash halts every client;
* **link-degradation windows** — during ``[t0, t1)`` of the send time the
  ``(src, dst)`` delay is multiplied or overridden; an effective delay at
  or past ``INF`` is a partition and the message is lost;
* **probabilistic drops** — each process→process emission is lost with
  probability ``drop_bp / 10_000``, a threefry verdict keyed on ``(src,
  dst, channel emission index)``;
* **schedule jitter** — each such emission's delay is multiplied by a
  threefry draw in ``[1, jitter_max]`` under the same key.

Drops, windows and jitter touch process→process wire hops only. Lossy
plans need ``horizon_ms``, which ends the lane at a fixed instant. A plan
whose crashes exceed what the protocol tolerates (more than ``f``, or
fewer survivors than ``protocol.min_live``) makes the lane end at once
with ``ERR_UNAVAIL``. Fault plans are single-shard.

The device side (the crash cut-off and the horizon in ``qualify_pop``,
the wire faults and the horizon in ``emit_rewrite``, the horizon in the
run predicate every kernel of the step reads, ``kernels/lane_freeze.py``)
reads :func:`fault_ctx`'s arrays under the batch's
:class:`FaultFlags`, which the step receives as one integer
(:func:`flag_bits`). The draws here take ``u32`` values held in int64
arrays — numpy or torch alike — so the host tables and the kernels'
plain twins share one implementation.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np

from .. import random as rnd
from .dims import INF

# window slots of every lane (fixed shapes across a batch)
MAX_WINDOWS = 8

# drop probabilities are basis points out of this denominator
DROP_DENOM = 10_000

# the bits of the step's flag word (flag_bits): one per FaultFlags field,
# then the reorder perturbation, the safety monitors' step fold
# (engine/monitor.py step_viol, in K6), the open-loop client and the
# traffic schedule's think delay (both in K6)
FLAG_CRASH = 1
FLAG_WINDOWS = 2
FLAG_DROPS = 4
FLAG_HORIZON = 8
FLAG_JITTER = 16
FLAG_REORDER = 32
FLAG_MONITOR = 64
FLAG_OPEN_LOOP = 128
FLAG_THINK = 256


class FaultFlags(NamedTuple):
    """Fault capabilities of a batch: the union of its lanes' flags.
    Fault-free lanes' ctx arrays are inert under any flags."""

    crash: bool = False
    windows: bool = False
    drops: bool = False
    horizon: bool = False
    jitter: bool = False

    def __or__(self, other: "FaultFlags") -> "FaultFlags":
        return FaultFlags(*(bool(a or b) for a, b in zip(self, other)))


NO_FAULTS = FaultFlags()


def flag_bits(faults: FaultFlags = NO_FAULTS, reorder: bool = False,
              monitor: bool = False, open_loop: bool = False,
              think: bool = False) -> int:
    """The step's flag word: :data:`FLAG_CRASH` ... :data:`FLAG_THINK`.
    ``open_loop`` and ``think`` follow the batch's structure (its ctx
    holds ``ol_arrival``, or a traffic schedule's ``traffic_think``)."""
    bits = 0
    for bit, on in zip((FLAG_CRASH, FLAG_WINDOWS, FLAG_DROPS, FLAG_HORIZON,
                        FLAG_JITTER), faults):
        bits |= bit if on else 0
    return (bits | (FLAG_REORDER if reorder else 0)
            | (FLAG_MONITOR if monitor else 0)
            | (FLAG_OPEN_LOOP if open_loop else 0)
            | (FLAG_THINK if think else 0))


@dataclass(frozen=True)
class LinkWindow:
    """One ``(src, dst)`` degradation interval, by send time."""

    src: int
    dst: int
    t0: int
    t1: int
    mult: int = 1              # delay multiplier (>= 1)
    delay: Optional[int] = None  # absolute override; >= INF partitions

    def __post_init__(self):
        assert self.src != self.dst, "self-links never cross the wire"
        assert 0 <= self.t0 < self.t1, "empty or negative window"
        assert self.mult >= 1, "degradation cannot speed a link up"
        assert self.delay is None or self.delay >= 1, (
            "override must be >= 1 ms (0-delay links create same-instant "
            "ties the exact-match contract excludes) or INF to partition"
        )

    def effective(self, base_delay: int) -> int:
        if self.delay is not None:
            return min(self.delay, INF)
        return min(base_delay * self.mult, INF)


@dataclass(frozen=True)
class FaultPlan:
    """One lane's fault schedule (see the module docstring)."""

    crashes: Mapping[int, int] = field(default_factory=dict)
    windows: Tuple[LinkWindow, ...] = ()
    drop_bp: int = 0
    drop_seed: int = 0
    horizon_ms: Optional[int] = None
    # seeded schedule jitter: every wire hop's delay × U{1..jitter_max};
    # <= 1 disables
    jitter_max: int = 0
    jitter_seed: int = 0
    # explicit per-message perturbations by (src, dst, channel index):
    # shrunk repro artifacts, replayed by the host oracle only
    # (sim/runner.py), refused by make_lane
    jitter_overrides: Mapping[Tuple[int, int, int], int] = field(
        default_factory=dict
    )
    drop_list: Tuple[Tuple[int, int, int], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "crashes", dict(self.crashes))
        object.__setattr__(self, "windows", tuple(self.windows))
        object.__setattr__(
            self, "jitter_overrides", dict(self.jitter_overrides)
        )
        object.__setattr__(
            self, "drop_list", tuple(sorted(set(self.drop_list)))
        )
        assert len(self.windows) <= MAX_WINDOWS, (
            f"{len(self.windows)} windows > MAX_WINDOWS={MAX_WINDOWS}"
        )
        assert 0 <= self.drop_bp <= DROP_DENOM
        assert self.jitter_max >= 0
        assert all(
            m >= 1 for m in self.jitter_overrides.values()
        ), "jitter overrides only slow messages down (mult >= 1)"
        for row, t in self.crashes.items():
            assert row >= 0 and t >= 0, f"bad crash ({row}, {t})"
        # the kernels select the active window of a pair with a masked
        # sum, which is a selection only while windows of one pair never
        # overlap
        by_pair: Dict[Tuple[int, int], List[LinkWindow]] = {}
        for w in self.windows:
            by_pair.setdefault((w.src, w.dst), []).append(w)
        for pair, ws in by_pair.items():
            ws = sorted(ws, key=lambda w: w.t0)
            for a, b in zip(ws, ws[1:]):
                assert a.t1 <= b.t0, f"overlapping windows on {pair}"
        lossy = self.drop_bp > 0 or bool(self.drop_list) or any(
            w.delay is not None and w.delay >= INF for w in self.windows
        )
        if lossy:
            assert self.horizon_ms is not None, (
                "lossy plans (drops or partition windows) need "
                "horizon_ms: closed-loop clients have no "
                "retransmission, so a lost message can stall the lane "
                "forever"
            )

    @property
    def flags(self) -> FaultFlags:
        return FaultFlags(
            crash=bool(self.crashes),
            windows=bool(self.windows),
            drops=self.drop_bp > 0,
            horizon=self.horizon_ms is not None,
            jitter=self.jitter_max > 1,
        )

    def is_noop(self) -> bool:
        return (
            self.flags == NO_FAULTS
            and not self.jitter_overrides
            and not self.drop_list
        )

    def host_only(self) -> bool:
        """Plans carrying explicit per-message perturbations replay
        through the host oracle only."""
        return bool(self.jitter_overrides) or bool(self.drop_list)

    def window_at(self, src: int, dst: int, send_ms: int
                  ) -> Optional[LinkWindow]:
        for w in self.windows:
            if w.src == src and w.dst == dst and w.t0 <= send_ms < w.t1:
                return w
        return None

    def wire(self, src: int, dst: int, send_ms: int, base_delay: int,
             kcnt: int, drop_table: "np.ndarray | None" = None,
             jitter_table: "np.ndarray | None" = None,
             ) -> Tuple[int, bool]:
        """One message's ``(effective delay, lost?)``: the window by send
        time, then the jitter multiplier, then the drop verdict, all by
        channel emission index ``kcnt``. The host oracle calls it once a
        process-to-process message (sim/runner.py); explicit
        ``jitter_overrides``/``drop_list`` entries take the seeded tables'
        place per message."""
        delay, lost = base_delay, False
        w = self.window_at(src, dst, send_ms)
        if w is not None:
            delay = w.effective(base_delay)
            if delay >= INF:
                return delay, True
        mult = self.jitter_mult(src, dst, kcnt, jitter_table)
        if mult is not None and mult > 1:
            delay = min(delay * mult, INF)
            if delay >= INF:
                return delay, True
        if (src, dst, kcnt) in self._drop_set:
            lost = True
        elif drop_table is not None:
            assert kcnt < drop_table.shape[2], (
                "drop table too small; raise kmax"
            )
            lost = bool(drop_table[src, dst, kcnt])
        return delay, lost

    def jitter_mult(self, src: int, dst: int, kcnt: int,
                    jitter_table: "np.ndarray | None" = None
                    ) -> Optional[int]:
        """The jitter multiplier of one message: an explicit override
        first, else the seeded table."""
        mult = self.jitter_overrides.get((src, dst, kcnt))
        if mult is None and jitter_table is not None:
            assert kcnt < jitter_table.shape[2], (
                "jitter table too small; raise kmax"
            )
            mult = int(jitter_table[src, dst, kcnt])
        return mult

    @property
    def _drop_set(self):
        s = self.__dict__.get("_drop_set_cache")
        if s is None:
            s = frozenset(self.drop_list)
            object.__setattr__(self, "_drop_set_cache", s)
        return s

    def drop_table(self, n: int, kmax: int = 1 << 14) -> np.ndarray:
        """``[n, n, kmax]`` drop verdicts: ``table[src, dst, k]`` is the
        device's draw for channel emission ``k`` (:func:`drop_draw`)."""
        k0, k1 = _key_words(self.drop_key())
        s, d, k = _grid(n, kmax)
        return drop_draw(k0, k1, s, d, k) < self.drop_bp

    def drop_key(self) -> np.ndarray:
        return rnd.fold_in(rnd.PRNGKey(self.drop_seed), 0xFA17)

    def jitter_table(self, n: int, kmax: int = 1 << 14) -> np.ndarray:
        """``[n, n, kmax]`` delay multipliers: ``table[src, dst, k]`` is
        the device's draw for channel emission ``k``
        (:func:`jitter_draw`)."""
        k0, k1 = _key_words(self.jitter_key())
        s, d, k = _grid(n, kmax)
        return jitter_draw(k0, k1, s, d, k,
                           np.int64(self.jitter_max)).astype(np.int32)

    def jitter_key(self) -> np.ndarray:
        return rnd.fold_in(rnd.PRNGKey(self.jitter_seed), 0x717E)

    @staticmethod
    def from_json(obj: dict) -> "FaultPlan":
        """``{"crash": {"1": 200}, "windows": [{"src": 0, "dst": 1,
        "t0": 100, "t1": 400, "mult": 5}], "drop_bp": 50, "seed": 1,
        "horizon": 5000}``; a window's ``"delay": "inf"`` partitions.
        Accepts :meth:`meta` output too (``horizon_ms``/``drop_seed``)."""
        windows = []
        for w in obj.get("windows", ()):
            delay = w.get("delay")
            if isinstance(delay, str):
                assert delay.lower() == "inf", delay
                delay = INF
            windows.append(
                LinkWindow(
                    src=int(w["src"]), dst=int(w["dst"]),
                    t0=int(w["t0"]), t1=int(w["t1"]),
                    mult=int(w.get("mult", 1)), delay=delay,
                )
            )
        return FaultPlan(
            crashes={
                int(k): int(v) for k, v in obj.get("crash", {}).items()
            },
            windows=tuple(windows),
            drop_bp=int(obj.get("drop_bp", 0)),
            drop_seed=int(obj.get("seed", obj.get("drop_seed", 0))),
            horizon_ms=obj.get("horizon", obj.get("horizon_ms")),
            jitter_max=int(obj.get("jitter_max", 0)),
            jitter_seed=int(obj.get("jitter_seed", 0)),
            jitter_overrides={
                (int(o["src"]), int(o["dst"]), int(o["k"])): int(o["mult"])
                for o in obj.get("jitter_overrides", ())
            },
            drop_list=tuple(
                (int(o["src"]), int(o["dst"]), int(o["k"]))
                for o in obj.get("drop_list", ())
            ),
        )

    def meta(self, **extra) -> dict:
        """Compact per-lane metadata for ``LaneResults.faults``."""
        out: dict = {}
        if self.crashes:
            out["crash"] = {str(k): int(v) for k, v in
                            sorted(self.crashes.items())}
        if self.windows:
            out["windows"] = [
                {
                    "src": w.src, "dst": w.dst, "t0": w.t0, "t1": w.t1,
                    "mult": w.mult,
                    **(
                        {"delay": "inf" if w.delay >= INF else w.delay}
                        if w.delay is not None else {}
                    ),
                }
                for w in self.windows
            ]
        if self.drop_bp:
            out["drop_bp"] = self.drop_bp
            out["drop_seed"] = self.drop_seed
        if self.horizon_ms is not None:
            out["horizon_ms"] = int(self.horizon_ms)
        if self.jitter_max > 1:
            out["jitter_max"] = self.jitter_max
            out["jitter_seed"] = self.jitter_seed
        if self.jitter_overrides:
            out["jitter_overrides"] = [
                {"src": s, "dst": d, "k": k, "mult": m}
                for (s, d, k), m in sorted(self.jitter_overrides.items())
            ]
        if self.drop_list:
            out["drop_list"] = [
                {"src": s, "dst": d, "k": k} for s, d, k in self.drop_list
            ]
        out.update(extra)
        return out


def parse_fault_specs(text: str) -> List[Optional[FaultPlan]]:
    """A CLI ``--faults`` spec: a JSON object (one plan), a JSON list of
    objects (``{}``/``null`` = fault-free), or ``@path`` to a file holding
    either. Each sweep point runs once per plan."""
    if text.startswith("@"):
        with open(text[1:]) as fh:
            text = fh.read()
    obj = json.loads(text)
    if isinstance(obj, dict):
        obj = [obj]
    out: List[Optional[FaultPlan]] = []
    for entry in obj:
        if not entry:
            out.append(None)
            continue
        plan = FaultPlan.from_json(entry)
        out.append(None if plan.is_noop() else plan)
    return out


def _key_words(key: np.ndarray):
    k = np.asarray(key, np.uint32).astype(np.int64)
    return k[0], k[1]


def _grid(n: int, kmax: int):
    s, d, k = np.meshgrid(np.arange(n), np.arange(n), np.arange(kmax),
                          indexing="ij")
    return s.astype(np.int64), d.astype(np.int64), k.astype(np.int64)


def _wire_key(k0, k1, src, dst, kcnt):
    """``fold_in(fold_in(fold_in(key, src), dst), kcnt)``."""
    k0, k1 = rnd.fold_in2(k0, k1, src)
    k0, k1 = rnd.fold_in2(k0, k1, dst)
    return rnd.fold_in2(k0, k1, kcnt)


def drop_draw(k0, k1, src, dst, kcnt):
    """The drop verdict's draw in ``[0, DROP_DENOM)`` for key words
    ``(k0, k1)``: a pure function of (src, dst, channel emission index),
    ``randint(fold_in(fold_in(fold_in(key, src), dst), kcnt))``."""
    w0, w1 = _wire_key(k0, k1, src, dst, kcnt)
    return rnd.randint2(w0, w1, w0 * 0 + DROP_DENOM)


def jitter_draw(k0, k1, src, dst, kcnt, jmax):
    """The jitter multiplier's draw in ``[1, max(jmax, 1)]``, keyed as
    :func:`drop_draw`."""
    w0, w1 = _wire_key(k0, k1, src, dst, kcnt)
    span = jmax * (jmax > 1) + (jmax <= 1) * 1
    return rnd.randint2(w0, w1, w0 * 0 + span) + 1


# ----------------------------------------------------------------------
# lane construction helpers (engine/spec.py)
# ----------------------------------------------------------------------


def batch_fault_flags(plans_or_specs) -> FaultFlags:
    """Union of fault capabilities across a batch. Accepts FaultPlans,
    LaneSpecs, or None entries."""
    flags = NO_FAULTS
    for item in plans_or_specs:
        if item is None:
            continue
        f = getattr(item, "fault_flags", None)
        if f is None:
            f = item.flags
        flags = flags | f
    return flags


def min_live(protocol, config) -> int:
    """Smallest membership the protocol can make progress with: its own
    bound when it declares one, else n - f."""
    fn = getattr(protocol, "min_live", None)
    if fn is None:
        return config.n - config.f
    return int(fn(config))


def unavailable(plan: FaultPlan, protocol, config) -> bool:
    """True when the plan's crashes exceed what the recovery-free
    protocol tolerates: more than f crashes, or fewer survivors than its
    largest quorum or threshold. A leader crash is not unavailability:
    it halts every client."""
    k = len(plan.crashes)
    if k == 0:
        return False
    if k > config.f:
        return True
    doomed = set(plan.crashes)
    if config.leader is not None and (config.leader - 1) in doomed:
        return False
    return config.n - k < min_live(protocol, config)


def reorder_doomed_last(sorted_idx: np.ndarray, doomed) -> np.ndarray:
    """Each process's discovery order with the processes that are going
    to crash moved last (a stable partition), so no quorum (the first k
    of a row) includes them."""
    doomed = set(doomed)
    out = sorted_idx.copy()
    for p in range(out.shape[0]):
        row = list(sorted_idx[p])
        out[p] = [q for q in row if q not in doomed] + [
            q for q in row if q in doomed
        ]
    return out


def halted_client_mask(plan: FaultPlan, config,
                       attach_rows: np.ndarray) -> np.ndarray:
    """Clients halted by the plan: attached to a doomed process, or every
    client under a doomed leader."""
    doomed = set(plan.crashes)
    halted = np.asarray(
        [int(a) in doomed for a in attach_rows], dtype=bool
    )
    if config.leader is not None and (config.leader - 1) in doomed:
        halted[:] = True
    return halted


def min_link_delays(plan: FaultPlan, delay_pp: np.ndarray,
                    total: int) -> np.ndarray:
    """Per-pair lower bound of the wire delay over the whole run (a
    window override may undercut the base delay), for the lookahead
    matrix. Returns a ``[total, total]`` copy."""
    out = delay_pp[:total, :total].astype(np.int64).copy()
    for w in plan.windows:
        if w.src >= total or w.dst >= total:
            continue
        eff = w.effective(int(out[w.src, w.dst]))
        if eff < out[w.src, w.dst]:
            out[w.src, w.dst] = eff
    return out


def fault_ctx(plan: Optional[FaultPlan], dims) -> Dict[str, np.ndarray]:
    """The plan's fixed-shape ctx arrays, present in every lane (inert
    defaults when ``plan`` is None), equal key for key and bit for bit to
    the reference's."""
    N = dims.N
    crash_t = np.full((N,), INF, np.int32)
    win_src = np.full((MAX_WINDOWS,), -1, np.int32)
    win_dst = np.full((MAX_WINDOWS,), -1, np.int32)
    win_t0 = np.zeros((MAX_WINDOWS,), np.int32)
    win_t1 = np.zeros((MAX_WINDOWS,), np.int32)
    win_mul = np.ones((MAX_WINDOWS,), np.int32)
    win_ovr = np.full((MAX_WINDOWS,), -1, np.int32)
    drop_bp = 0
    jitter_num = 1
    horizon = INF
    if plan is not None:
        assert not plan.host_only(), (
            "explicit per-message perturbations (jitter_overrides/"
            "drop_list) replay through the host oracle only"
        )
        for row, t in plan.crashes.items():
            assert row < N, f"crash row {row} out of range"
            crash_t[row] = min(t, INF)
        for i, w in enumerate(plan.windows):
            win_src[i] = w.src
            win_dst[i] = w.dst
            win_t0[i] = w.t0
            win_t1[i] = min(w.t1, INF)
            win_mul[i] = w.mult
            win_ovr[i] = -1 if w.delay is None else min(w.delay, INF)
        drop_bp = plan.drop_bp
        jitter_num = max(plan.jitter_max, 1)
        if plan.horizon_ms is not None:
            horizon = min(plan.horizon_ms, INF)
    drop_key = (
        plan.drop_key() if plan is not None and plan.drop_bp
        else FaultPlan().drop_key()
    )
    jitter_key = (
        plan.jitter_key() if plan is not None and plan.jitter_max > 1
        else FaultPlan().jitter_key()
    )
    return {
        "fault_crash_t": crash_t,
        "fault_win_src": win_src,
        "fault_win_dst": win_dst,
        "fault_win_t0": win_t0,
        "fault_win_t1": win_t1,
        "fault_win_mul": win_mul,
        "fault_win_ovr": win_ovr,
        "fault_drop_num": np.int32(drop_bp),
        "fault_drop_key": drop_key,
        "fault_jitter_num": np.int32(jitter_num),
        "fault_jitter_key": jitter_key,
        "fault_horizon": np.int32(horizon),
        # set by make_lane after the availability check
        "fault_unavail": np.int32(0),
    }
