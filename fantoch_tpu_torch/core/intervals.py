"""Interval-based event sets.

Host-side equivalent of the ``threshold`` crate's event sets used by the
reference (AboveExSet / ARClock): a set of positive integers stored as a
contiguous frontier plus disjoint intervals above it. Supports single-event
and range insertion; ``frontier`` is the highest ``n`` such that all of
``1..=n`` are present.

The device engine encodes the same thing as a frontier scalar plus a small
fixed-size gap buffer per (key, voter); this class is the exact host
reference for it.
"""

from __future__ import annotations

import bisect
from typing import List, Tuple


class IntervalSet:
    """Set of u64 events: frontier + sorted disjoint intervals above it."""

    __slots__ = ("frontier", "_intervals")

    def __init__(self) -> None:
        self.frontier = 0
        self._intervals: List[Tuple[int, int]] = []  # sorted, disjoint

    def add(self, event: int) -> bool:
        return self.add_range(event, event)

    def add_range(self, start: int, end: int) -> bool:
        """Add ``start..=end``; returns True iff at least one new event was
        added."""
        assert start <= end
        # clip below frontier
        if end <= self.frontier:
            return False
        start = max(start, self.frontier + 1)

        # find insertion window among intervals overlapping/adjacent to
        # [start-1, end+1]
        iv = self._intervals
        # locate first interval with iv_end >= start - 1
        lo = bisect.bisect_left(iv, (start,)) if iv else 0
        # step back one in case the previous interval is adjacent/overlapping
        if lo > 0 and iv[lo - 1][1] >= start - 1:
            lo -= 1
        hi = lo
        new_start, new_end = start, end
        added_new = True
        while hi < len(iv) and iv[hi][0] <= end + 1:
            s, e = iv[hi]
            if s <= start and e >= end:
                added_new = False  # fully covered
            new_start = min(new_start, s)
            new_end = max(new_end, e)
            hi += 1
        # a covering interval is necessarily the only one in the merge
        # window, so full coverage is exactly `not added_new`
        covered = not added_new
        iv[lo:hi] = [(new_start, new_end)]

        # advance frontier
        if iv and iv[0][0] == self.frontier + 1:
            self.frontier = iv[0][1]
            iv.pop(0)
        return not covered

    def contains(self, event: int) -> bool:
        if event <= self.frontier:
            return True
        i = bisect.bisect_right(self._intervals, (event, float("inf")))
        if i > 0:
            s, e = self._intervals[i - 1]
            if s <= event <= e:
                return True
        return False

    def count(self) -> int:
        return self.frontier + sum(e - s + 1 for s, e in self._intervals)

    def events(self) -> List[int]:
        out = list(range(1, self.frontier + 1))
        for s, e in self._intervals:
            out.extend(range(s, e + 1))
        return out

    def __repr__(self) -> str:
        return f"IntervalSet(frontier={self.frontier}, above={self._intervals})"
