"""Exact host histogram (fantoch/src/metrics/histogram.rs:15-130).

A value→count map with mean/stddev/cov/mdtm/percentile; the device
engine's 1 ms bucket arrays convert into it with :meth:`from_buckets`.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import List

import numpy as np

class Histogram:
    """Exact histogram: value -> count (histogram.rs:15-21)."""

    def __init__(self) -> None:
        self.counts: Counter = Counter()

    @classmethod
    def from_values(cls, values) -> "Histogram":
        h = cls()
        for v in values:
            h.increment(v)
        return h

    @classmethod
    def from_buckets(cls, buckets: np.ndarray) -> "Histogram":
        """Ingest a dense bucket-count array (bucket index == value)."""
        h = cls()
        for value, count in enumerate(np.asarray(buckets).tolist()):
            if count:
                h.counts[value] = int(count)
        return h

    def increment(self, value: int, count: int = 1) -> None:
        self.counts[value] += count

    def merge(self, other: "Histogram") -> None:
        self.counts.update(other.counts)

    def all_values(self) -> List[int]:
        out: List[int] = []
        for value in sorted(self.counts):
            out.extend([value] * self.counts[value])
        return out

    def count(self) -> int:
        return sum(self.counts.values())

    def mean(self) -> float:
        n = self.count()
        if n == 0:
            return 0.0
        total = sum(v * c for v, c in self.counts.items())
        return total / n

    def stddev(self) -> float:
        n = self.count()
        if n == 0:
            return 0.0
        mean = self.mean()
        var = sum(c * (v - mean) ** 2 for v, c in self.counts.items()) / n
        return math.sqrt(var)

    def cov(self) -> float:
        """Coefficient of variation (histogram.rs:77-81)."""
        mean = self.mean()
        return self.stddev() / mean if mean else 0.0

    def mdtm(self) -> float:
        """Mean distance to mean (histogram.rs:83-92)."""
        n = self.count()
        if n == 0:
            return 0.0
        mean = self.mean()
        return sum(c * abs(v - mean) for v, c in self.counts.items()) / n

    def min(self) -> float:
        return float(min(self.counts)) if self.counts else math.nan

    def max(self) -> float:
        return float(max(self.counts)) if self.counts else math.nan

    def percentile(self, pct: float) -> float:
        """Exact percentile with the reference's semantics
        (histogram.rs:110-168): index = round(pct·count); when pct·count is
        a whole number the result is the midpoint of the value at the index
        and the next distinct value, otherwise the left value.
        """
        assert 0.0 <= pct <= 1.0
        if not self.counts:
            return 0.0
        index_f = pct * self.count()
        index = int(math.floor(index_f + 0.5))  # round half away from zero
        is_whole = abs(index_f - index) == 0.0
        items = iter(sorted(self.counts.items()))
        left = right = 0.0
        for value, cnt in items:
            if index == cnt:
                left = float(value)
                nxt = next(items, None)
                # unlike the reference (which panics), pct==1.0 falls back
                # to the max value
                right = float(nxt[0]) if nxt is not None else left
                break
            if index < cnt:
                left = right = float(value)
                break
            index -= cnt
        if is_whole:
            return (left + right) / 2.0
        return left

    def __repr__(self) -> str:
        avg = self.mean()
        p95 = self.percentile(0.95)
        p99 = self.percentile(0.99)
        return f"avg={avg:.1f} p95={p95:.0f} p99={p99:.0f} count={self.count()}"
