"""Workload key distributions needed by lane construction."""

from __future__ import annotations

import numpy as np


def zipf_weights(key_count: int, coefficient: float) -> np.ndarray:
    """P(k) ∝ 1 / k^coefficient for k in 1..=key_count, matching the zipf
    crate used by the reference (client/key_gen.rs:62-77)."""
    ranks = np.arange(1, key_count + 1, dtype=np.float64)
    weights = 1.0 / np.power(ranks, coefficient)
    return weights / weights.sum()
