"""Closed-form latency modeling and region-set search ("bote").

Capability parity with ``fantoch_bote``: client-perceived latency sums
for leaderless/leader protocols over a planet (lib.rs:38-120) and an
exhaustive ranked search over candidate region sets
(search.rs:42-520). The search's per-config work — sorting distances,
quorum latencies, per-client sums, mean/COV — is pure array math, so the
batched path evaluates *all* C(R, n) configurations as one [B, n]
tensor program (the reference parallelizes with rayon; search.rs:321-327):
one launch of K15 (``kernels/bote_stats.py``) per n on the CUDA card.
``validate.py`` runs the top candidates through measured campaigns.

The port's copy of the JAX package's ``bote/``.
"""

from .model import Bote, batched_config_stats
from .search import (
    FTMetric,
    ProtocolModel,
    RankingParams,
    Search,
    compute_stats,
)

__all__ = [
    "Bote",
    "batched_config_stats",
    "FTMetric",
    "ProtocolModel",
    "RankingParams",
    "Search",
    "compute_stats",
]
