"""Discrete-event schedule (min-heap on milliseconds).

Capability parity with ``fantoch/src/sim/schedule.rs``: schedule actions at
``now + delay`` and pop them in time order, advancing the simulated clock.
The reference's BinaryHeap breaks same-time ties arbitrarily
(schedule.rs:109-119); here ties break by an explicit, schedule-independent
key — ``(kind_rank, src_key, chan_seq)``, then insertion order — so that
the device engine (which processes events out of global order under its
conservative-lookahead rule) resolves every tie identically without having
to reproduce the oracle's global insertion sequence. Periodic events rank
before message deliveries at the same instant; messages order by source,
then by the source's per-(src, dst)-channel emission counter — src-major,
so counter values are only ever compared within one FIFO channel, which
both sides enumerate identically.
"""

from __future__ import annotations

import heapq
from typing import Generic, List, Optional, Tuple, TypeVar

from ..core.timing import SimTime

A = TypeVar("A")

# kind ranks for the tie-break key
KIND_PERIODIC = 0
KIND_MESSAGE = 1


class Schedule(Generic[A]):
    def __init__(self) -> None:
        self._heap: List[Tuple[int, int, int, int, int, A]] = []
        self._seq = 0

    def schedule(
        self,
        time: SimTime,
        delay_ms: int,
        action: A,
        key: Tuple[int, int, int] = (KIND_PERIODIC, 0, 0),
    ) -> None:
        """``key`` = (kind_rank, src_key, chan_seq) for messages;
        insertion order is the final tie-break (and the only one
        periodic events rely on)."""
        self._seq += 1
        k1, k2, k3 = key
        heapq.heappush(
            self._heap,
            (time.millis() + delay_ms, k1, k2, k3, self._seq, action),
        )

    def next_action(self, time: SimTime) -> Optional[A]:
        if not self._heap:
            return None
        entry = heapq.heappop(self._heap)
        time.set_millis(entry[0])
        return entry[-1]

    def peek_millis(self) -> Optional[int]:
        """Arrival time of the next action without popping it — the
        fault-plan horizon check stops the loop *before* handling any
        event at or past the horizon, matching the device engine's
        qualification mask exactly."""
        if not self._heap:
            return None
        return self._heap[0][0]

    def __len__(self) -> int:
        return len(self._heap)
