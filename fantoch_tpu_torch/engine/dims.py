"""Static shape bounds and error codes of the engine.

Per-lane *values* (n, f, delays, conflict rate, ...) vary freely inside a
batch; the *bounds* below are shared by every lane of one batch.
Overflow of a bound is detected at run time and surfaced as a per-lane
error bit — results of flagged lanes are never silently wrong.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

# simulated time / sequence sentinel: far enough from i32 overflow that
# `INF + delay` cannot wrap
INF = 1 << 30

# dot sequences must stay below this bound so (source, sequence) packs
# into one i32 for lexicographic argmin scans
SEQ_BOUND = 1 << 20

# per-lane error taxonomy (bits OR'd into i32 error words)
ERR_POOL = 1        # message-pool overflow — raise EngineDims.M
ERR_TRUNCATED = 2   # max_steps exhausted before the lane finished
ERR_SEQ = 4         # sequence/clock packing bound exceeded (SEQ_BOUND)
ERR_DOT = 8         # dot-slot window collision — raise EngineDims.D
ERR_CAPACITY = 16   # fixed-width table/buffer overflow (rows, slots)
ERR_PROTO = 32      # protocol invariant violated (missing/dup entries)
ERR_STUCK = 64      # one message requeued > REQUEUE_LIMIT times
ERR_UNAVAIL = 128   # fault plan exceeds what the protocol tolerates

# readiness-gate bounces per message before the lane is declared stuck
REQUEUE_LIMIT = 1 << 13

# message pool layout: one packed [M, 8 + P] i32 row per message, so a
# pop gathers a whole row and a step's emissions land in one row scatter
PA = 0    # arrival time (INF = free slot)
PKS = 1   # tie-break key: emitting src
PKC = 2   # tie-break key: per-(src, dst) channel emission index
PSRC = 3  # sender
PDST = 4  # destination process
PMT = 5   # message type
PRQ = 6   # readiness-gate bounce count
PPR = 7   # priority (inline self-message) flag
PPAY = 8  # payload words start here
POOL_FIELDS = 8

ERR_NAMES = {
    ERR_POOL: "pool-overflow",
    ERR_TRUNCATED: "truncated",
    ERR_SEQ: "seq-overflow",
    ERR_DOT: "dot-collision",
    ERR_CAPACITY: "capacity-overflow",
    ERR_PROTO: "protocol-invariant",
    ERR_STUCK: "requeue-livelock",
    ERR_UNAVAIL: "quorum-unavailable",
}


def dot_slot(seq, D: int):
    """Recycled dot-slot index of a 1-based sequence: ``(seq - 1) mod D``
    with floor modulo, as jnp's ``%`` (sequence 0 maps to slot D - 1)."""
    return torch.remainder(seq - 1, D)


def err_names(code: int) -> str:
    """Decode an error word into a readable cause list."""
    if not code:
        return "ok"
    return "+".join(
        name for bit, name in sorted(ERR_NAMES.items()) if code & bit
    ) or f"unknown({code})"


@dataclass(frozen=True)
class EngineDims:
    """Static bounds shared by all lanes of one batch.

    N: max processes per lane (lanes with n < N mask the tail)
    C: max clients per lane (padded clients have a 0-command budget)
    M: message-pool capacity (in-flight messages per lane)
    D: per-source dot-slot capacity (slots recycle modulo D after GC)
    F: max messages a single handler invocation may emit
    R: periodic-event rows per process (protocol-specific timers)
    P: payload words per message
    H: latency-histogram buckets (1 ms each; last bucket catches the tail)
    RR: client-region rows for latency aggregation
    """

    N: int
    C: int
    M: int
    D: int
    F: int
    R: int
    P: int
    H: int = 512
    RR: int = 8

    @staticmethod
    def for_protocol(protocol, n: int, clients: int, payload: int,
                     dot_slots: int = 64, pool: int | None = None,
                     total_commands: int | None = None,
                     regions: int = 8,
                     hist_buckets: int = 512) -> "EngineDims":
        """Bounds for a (protocol, n, client-count) sweep — the same
        formulas as the reference's ``EngineDims.for_protocol``.

        Pass ``total_commands`` to size the pool for the degenerate
        closed loop (a client at 0 latency from its whole quorum issues
        its whole budget in one instant): ``total_commands × 2(n-1)``.
        """
        fanout = getattr(protocol, "MAX_FANOUT", n + 1)
        extra = getattr(protocol, "EXTRA_SLOTS", 0)
        if pool is None:
            pool = clients * (n + 2) + 4 * n * n + 64
            if total_commands is not None:
                pool = max(pool, total_commands * 2 * (n - 1) + clients + 64)
        return EngineDims(
            N=n,
            C=clients,
            M=pool,
            D=dot_slots,
            F=max(fanout, n + 1) + extra,
            R=getattr(protocol, "PERIODIC_ROWS", 1),
            P=max(payload, 3),
            H=hist_buckets,
            RR=regions,
        )

    @staticmethod
    def for_partial(protocol, n: int, clients: int, total_commands: int,
                    dot_slots: int | None = None,
                    regions: int | None = None) -> "EngineDims":
        """Bounds for a partial-replication (multi-shard) lane, the
        reference's ``EngineDims.for_partial``: the process axis spans
        every shard's rows (N = S·n), the pool covers the cross-shard
        fan-out (forwards, shard commits, StableAtShard) and the
        histogram is 2,048 buckets wide."""
        S = protocol.S
        return EngineDims(
            N=S * n,
            C=clients,
            M=total_commands * 4 * S * n + 64,
            D=dot_slots if dot_slots is not None else total_commands + 1,
            F=protocol.fanout(n),
            R=protocol.PERIODIC_ROWS,
            P=protocol.payload_width(n),
            H=2048,
            RR=regions if regions is not None else n,
        )
