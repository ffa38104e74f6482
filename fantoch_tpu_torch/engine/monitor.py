"""On-device safety monitors of the batched engine (the port's copy of
the reference's ``fantoch_tpu/engine/monitor.py``).

A monitored run keeps, per lane, O(N x K) integers that the protocols'
executor choke points update inside the step, and reduces them to two
scalars and a coverage digest per lane:

* ``mon_hash [N, K]`` — per process and key, a rolling order-sensitive
  hash of the commands executed on that key (``mon_exec``). Two live
  processes with the same per-key count but different hashes executed
  different orders (the reference's ``check_monitors``);
* ``mon_cnt [N, K]`` — exactly-once counters: at clean quiescence every
  live process executed every completed command once;
* ``mon_flags [N]`` — in-run guard bits: execute-before-commit
  (``premature``) and a key outside the monitor's key capacity.

``monitor_keys`` (``core.build_runner``/``init_lane_state``) gates the
whole thing: at 0 the planes are never created, every kernel gets null
monitor pointers and runs no monitor branch, and the state tree and the
results are those of an unmonitored run.

Where the reference relies on int32 multiplication wrapping under XLA,
the plain twins here compute in int64 and reduce mod 2^32 back to int32
(signed overflow is undefined in the C++ under torch); the kernels use
``uint32_t``. The twins are batched over a leading lane axis: ``step_viol``
is the fold K6 ``emit_rewrite`` runs under ``FLAG_MONITOR``,
``finalize_lane`` the plain twin of K13 ``mon_finalize``.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from .dims import INF, SEQ_BOUND

I32 = torch.int32
I64 = torch.int64
MASK32 = 0xFFFFFFFF

# rolling-hash multiplier (a prime); the hash wraps mod 2^32
HASH_MUL = 1_000_003

# per-process in-run guard bits (``mon_flags``)
MON_F_PREMATURE = 1  # executed a dot absent from the committed record
MON_F_KEYRANGE = 2   # executed key >= monitor_keys (monitor misconfig)

# per-lane violation bitmask (LaneResults.violation)
VIOL_ORDER = 1      # per-key execution orders diverge across live
                    # processes (equal counts, different hashes)
VIOL_DUP = 2        # a process executed more commands than completed
                    # (clean quiescent lanes only)
VIOL_MISSING = 4    # a process executed fewer (clean quiescent lanes;
                    # advisory: an undersized extra_time tail can leave
                    # a correct protocol's executors undrained)
VIOL_PREMATURE = 8  # execute-before-commit guard tripped
VIOL_KEYRANGE = 16  # monitor key capacity too small (setup error)

VIOL_NAMES = {
    VIOL_ORDER: "order-divergence",
    VIOL_DUP: "duplicate-execution",
    VIOL_MISSING: "missing-execution",
    VIOL_PREMATURE: "execute-before-commit",
    VIOL_KEYRANGE: "monitor-key-range",
}

# monitor keys carried inside the per-process protocol state during a
# step (merged before the handlers, stripped after)
MON_PS_KEYS = ("_mon_hash", "_mon_cnt", "_mon_flags")


def viol_names(code: int) -> str:
    if not code:
        return "ok"
    return "+".join(
        name for bit, name in sorted(VIOL_NAMES.items()) if code & bit
    ) or f"unknown({code})"


def mon_init(dims, monitor_keys: int) -> Dict[str, np.ndarray]:
    """Host-side monitor state of one lane (top-level lane-state keys)."""
    N = dims.N
    return {
        "mon_hash": np.zeros((N, monitor_keys), np.int32),
        "mon_cnt": np.zeros((N, monitor_keys), np.int32),
        "mon_flags": np.zeros((N,), np.int32),
        "viol": np.int32(0),
        "viol_step": np.int32(INF),
        # the lane's coverage digest (cov_digest at the run's end)
        "cov": np.int32(0),
    }


@functools.lru_cache(maxsize=None)
def _digest_weights(length: int) -> np.ndarray:
    """``[length + 1]`` position weights of :func:`cov_digest`: the
    closed form of the rolling fold ``h <- h*HASH_MUL + x`` started from
    1 — ``MUL^L + sum x_i * MUL^(L-1-i)`` mod 2^32 — in exact integers,
    as wrapping int32 (``weights[0] = MUL^L``, ``weights[1 + i] =
    MUL^(L-1-i)``)."""
    powers = [1]
    for _ in range(length):
        powers.append((powers[-1] * HASH_MUL) & MASK32)
    w = np.asarray([powers[length]] + powers[length - 1 :: -1], np.uint32)
    return w.astype(np.int32)


def to_u32(x):
    """int32 → int64 in [0, 2^32) (the same bits, read unsigned)."""
    return x.to(I64) & MASK32


def to_i32(x):
    """int64 → int32 of its low 32 bits (two's complement)."""
    x = x & MASK32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(I32)


def mul_u32(a, b):
    """``a * b mod 2^32`` for int64 ``a``, ``b`` in [0, 2^32): ``b`` in
    16-bit halves, so no product leaves int64."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def cov_digest(hashes, cnts):
    """``[L]`` coverage digests of ``[L, N, K]`` final hash and count
    planes: the rolling hash ``1 -> fold(h*MUL + x)`` over each lane's
    row-major concatenation of hashes then counts, mod 2^32, as int32
    (the reference's ``cov_digest``, batched). Sums mod 2^32 do not
    depend on the order of addition."""
    L = hashes.shape[0]
    flat = torch.cat([hashes.reshape(L, -1), cnts.reshape(L, -1)], 1)
    w = torch.as_tensor(_digest_weights(int(flat.shape[1])),
                        device=flat.device)
    terms = mul_u32(to_u32(flat), to_u32(w[1:])[None, :])
    return to_i32(to_u32(w[0]) + terms.sum(1))


def mon_exec(ps, key, src, seq, enable, premature=None):
    """Record one execution per (lane, process) at the calling
    protocol's executor choke point: ``(src, seq)`` executed on ``key``
    where ``enable`` holds (all ``[L, N]``). A no-op when ``ps`` carries
    no monitor planes. ``premature`` is the protocol's
    execute-before-commit guard (True: the dot is not in this process's
    committed record)."""
    if "_mon_hash" not in ps:
        return ps
    h = ps["_mon_hash"]
    km = h.shape[2]

    def lead(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=h.device).expand(
            h.shape[:2])

    key, src, seq = (lead(x, I32) for x in (key, src, seq))
    do = lead(enable, torch.bool)
    in_range = (key >= 0) & (key < km)
    cmd = (to_u32(src) * SEQ_BOUND + to_u32(seq) + 1) & MASK32
    iota = torch.arange(km, dtype=I32, device=h.device)
    hit = (iota == key[..., None]) & (do & in_range)[..., None]
    rolled = to_i32(to_u32(h) * HASH_MUL + cmd[..., None])
    flags = ps["_mon_flags"] | MON_F_KEYRANGE * (do & ~in_range).to(I32)
    if premature is not None:
        flags = flags | MON_F_PREMATURE * (
            do & lead(premature, torch.bool)).to(I32)
    return dict(
        ps,
        _mon_hash=torch.where(hit, rolled, h),
        _mon_cnt=ps["_mon_cnt"] + hit.to(I32),
        _mon_flags=flags,
    )


def merge_mon(st):
    """Lane-state monitor planes → per-process ``ps`` keys."""
    return dict(st["ps"], _mon_hash=st["mon_hash"], _mon_cnt=st["mon_cnt"],
                _mon_flags=st["mon_flags"])


def strip_mon(ps):
    """Inverse of :func:`merge_mon` after the handlers: ``(ps, mon)``."""
    ps = dict(ps)
    mon = {k.lstrip("_"): ps.pop(k) for k in MON_PS_KEYS}
    return ps, mon


def step_viol(st, mon_flags):
    """Per-step violation tracking, batched: fold each lane's guard bits
    into its bitmask and pin the first violating step (``steps + 1`` of
    the state the step started from). Returns ``(viol, viol_step)``."""
    flags = torch.zeros_like(st["viol"])
    for p in range(mon_flags.shape[1]):
        flags = flags | mon_flags[:, p]
    viol = (
        st["viol"]
        | VIOL_PREMATURE * ((flags & MON_F_PREMATURE) != 0).to(I32)
        | VIOL_KEYRANGE * ((flags & MON_F_KEYRANGE) != 0).to(I32)
    )
    viol_step = torch.where(
        (viol != 0) & (st["viol_step"] >= INF), st["steps"] + 1,
        st["viol_step"],
    )
    return viol, viol_step


def finalize_lane(st, ctx, flags: int, order: bool):
    """The run's-end monitor reduction of every lane (the plain twin of
    K13 ``mon_finalize``): ``(viol, viol_step, cov)``.

    * order (``order``, the protocol's ``MONITOR_ORDER``): a pair of live
      processes with equal per-key counts but different hashes, on
      lossless lanes only (``fault_dropped == 0``);
    * exactly-once: at clean quiescence (budget done, no error, nothing
      lost, no crash plan under ``FLAG_CRASH``, and under
      ``FLAG_HORIZON`` the drain tail inside the horizon) every live
      process executed exactly the completed-command total;
    * ``viol_step``: the step count where a violation first shows;
    * ``cov``: :func:`cov_digest` of the final planes.

    The reference's ``running`` guard belongs to its segmented runner,
    which is not ported: the run loop ends every lane before this runs.
    """
    from .faults import FLAG_CRASH, FLAG_HORIZON

    hashes, cnts = st["mon_hash"], st["mon_cnt"]
    L, N = hashes.shape[:2]
    procs = torch.arange(N, dtype=I32, device=hashes.device)
    live = procs[None, :] < ctx["rows"][:, None]
    if flags & FLAG_CRASH:
        live = live & (ctx["fault_crash_t"] >= INF)
    viol = st["viol"]
    if order:
        pair = live[:, :, None] & live[:, None, :]
        same_cnt = cnts[:, :, None, :] == cnts[:, None, :, :]
        diff_hash = hashes[:, :, None, :] != hashes[:, None, :, :]
        bad = (pair[..., None] & same_cnt & diff_hash).flatten(1).any(1)
        viol = viol | VIOL_ORDER * (bad & (st["fault_dropped"] == 0)).to(I32)
    clean = ((st["done_time"] < INF) & (st["err"] == 0)
             & (st["fault_dropped"] == 0))
    if flags & FLAG_CRASH:
        clean = clean & (ctx["fault_crash_t"] >= INF).all(1)
    if flags & FLAG_HORIZON:
        # in int64: no signed overflow whatever the words hold
        clean = clean & (st["done_time"].to(I64) + ctx["extra_time"].to(I64)
                         <= ctx["fault_horizon"].to(I64))
    total = st["clients"]["completed"].sum(1, dtype=I32)
    per_proc = cnts.sum(2, dtype=I32)
    dup = (live & (per_proc > total[:, None])).any(1)
    missing = (live & (per_proc < total[:, None])).any(1)
    viol = (viol | VIOL_DUP * (clean & dup).to(I32)
            | VIOL_MISSING * (clean & missing).to(I32))
    viol_step = torch.where((viol != 0) & (st["viol_step"] >= INF),
                            st["steps"], st["viol_step"])
    return viol, viol_step, cov_digest(hashes, cnts)
