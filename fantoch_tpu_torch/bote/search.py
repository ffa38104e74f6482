"""Exhaustive ranked region-set search (the port's copy of the JAX
package's ``bote/search.py``).

Capability parity with ``fantoch_bote/src/search.rs``: for every
candidate server subset, model Atlas/FPaxos/EPaxos client latencies
(compute_stats, search.rs:262-319; the FPaxos leader is the best-COV
leader for f=1, reused for f=2), score each config by Atlas's mean
improvement over FPaxos plus a 30x-weighted improvement over EPaxos,
and filter by minimum mean/fairness improvements (compute_score,
search.rs:421-472). ``FTMetric`` picks which f values count
(search.rs:652-666).

The reference evaluates configs with rayon (search.rs:321-327); here the
whole subset batch of each n is one launch of K15 on the CUDA card
(``batched_config_stats``, ``kernels/bote_stats.py``), or its plain twin
with ``device="cpu"``; the rankings reduce its latencies on the host in
f64, as the JAX package's search does, so scores and means are its bits.

The result cache holds pickles. It is read through an unpickler that
admits only this module's :class:`RankedConfig`: a file that names any
other class (the JAX package's search writes the same file names, since
its ``RankingParams`` has the same repr) is taken for a corrupt cache and
recomputed, never imported.
"""

from __future__ import annotations

import itertools
import pickle
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..core.metrics import Histogram
from ..core.planet import Planet, Region
from .model import Bote, batched_config_stats


class ProtocolModel:
    """Quorum-size formulas (fantoch_bote/src/protocol.rs:20-35)."""

    @staticmethod
    def minority(n: int) -> int:
        return n // 2

    @staticmethod
    def fpaxos(n: int, f: int) -> int:
        return f + 1

    @staticmethod
    def epaxos(n: int, _f: int = 0) -> int:
        f = ProtocolModel.minority(n)
        return f + (f + 1) // 2

    @staticmethod
    def atlas(n: int, f: int) -> int:
        return ProtocolModel.minority(n) + f


class FTMetric:
    """Which f values count for scoring (search.rs:652-666)."""

    F1 = "f1"
    F1F2 = "f1f2"

    @staticmethod
    def fs(metric: str, n: int) -> List[int]:
        max_f = 1 if metric == FTMetric.F1 else 2
        return list(range(1, min(ProtocolModel.minority(n), max_f) + 1))


@dataclass
class RankingParams:
    """search.rs RankingParams."""

    min_mean_fpaxos_improv: float
    min_fairness_fpaxos_improv: float
    min_mean_epaxos_improv: float = float("-inf")
    min_n: int = 3
    max_n: int = 13
    ft_metric: str = FTMetric.F1F2


def _max_f(n: int) -> int:
    return min(ProtocolModel.minority(n), 2)  # search.rs:474-477


def compute_stats(
    config: Sequence[Region], all_clients: Sequence[Region], bote: Bote
) -> Dict[str, Histogram]:
    """Host reference for one config (search.rs:262-319): keys like the
    reference's ProtocolStats — ``af1``/``ff1``/``e`` (+``C`` when
    clients are colocated with the servers)."""
    n = len(config)
    stats: Dict[str, Histogram] = {}
    leader, _ = bote.best_leader(
        config, all_clients, ProtocolModel.fpaxos(n, 1), sort_by="cov"
    )
    for placement, clients in (("", all_clients), ("C", config)):
        for f in range(1, _max_f(n) + 1):
            atlas = bote.leaderless(
                config, clients, ProtocolModel.atlas(n, f)
            )
            stats[f"af{f}{placement}"] = Histogram.from_values(
                lat for _c, lat in atlas
            )
            fpaxos = bote.leader(
                leader, config, clients, ProtocolModel.fpaxos(n, f)
            )
            stats[f"ff{f}{placement}"] = Histogram.from_values(
                lat for _c, lat in fpaxos
            )
        epaxos = bote.leaderless(config, clients, ProtocolModel.epaxos(n))
        stats[f"e{placement}"] = Histogram.from_values(
            lat for _c, lat in epaxos
        )
    return stats


@dataclass
class RankedConfig:
    score: float
    config: Tuple[Region, ...]
    means: Dict[str, float]


class Search:
    """Exhaustive search over all C(len(servers), n) subsets for each n
    in [min_n, max_n] (odd n only, like the reference's configs)."""

    def __init__(
        self,
        planet: Planet | None = None,
        servers: Sequence[Region] | None = None,
        clients: Sequence[Region] | None = None,
    ):
        self.planet = planet if planet is not None else Planet.new()
        regions = sorted(self.planet.regions())  # name order == index order
        self.servers = list(servers) if servers is not None else regions
        self.clients = list(clients) if clients is not None else regions
        self.region_index = {r: i for i, r in enumerate(regions)}
        self.lat = self.planet.latency_matrix(regions).astype(np.float32)

    def rank(
        self,
        params: RankingParams,
        device=None,
        cache_path: "str | None" = None,
    ) -> Dict[int, List[RankedConfig]]:
        """Rank all configs per n, each n's subset batch on ``device``
        (default the CUDA card, which raises without a GPU; ``"cpu"``
        runs K15's plain twin). ``cache_path`` persists results keyed by
        (servers, clients, params) — the reference's bincode search
        cache (search.rs:47-96)."""
        from .. import resolve_device

        device = resolve_device(device)
        if cache_path is not None:
            cached = self._cache_load(cache_path, params)
            if cached is not None:
                return cached
        out: Dict[int, List[RankedConfig]] = {}
        for n in range(params.min_n, params.max_n + 1, 2):
            subsets = list(
                itertools.combinations(
                    sorted(self.region_index[r] for r in self.servers), n
                )
            )
            if not subsets:
                continue
            out[n] = self._rank_n(n, np.asarray(subsets), params, device)
        if cache_path is not None:
            self._cache_store(cache_path, params, out)
        return out

    # -- result cache (search.rs:47-96, pickle instead of bincode) -----

    def _cache_key(self, params: RankingParams) -> str:
        import hashlib

        h = hashlib.sha256(
            repr((sorted(self.servers), sorted(self.clients), params)).encode()
        )
        # the latency data is part of the key: same region names over a
        # different planet must not collide
        h.update(self.lat.tobytes())
        return h.hexdigest()[:24]

    def _cache_load(self, path: str, params: RankingParams):
        import os

        f = os.path.join(path, f"search_{self._cache_key(params)}.pkl")
        if not os.path.exists(f):
            return None
        try:
            with open(f, "rb") as fh:
                return _CacheUnpickler(fh).load()
        except Exception:
            # corrupt/truncated cache, or one that names a class other
            # than this module's RankedConfig: recompute
            return None

    def _cache_store(self, path: str, params: RankingParams, out) -> None:
        import os

        from ..engine.checkpoint import atomic_write

        os.makedirs(path, exist_ok=True)
        f = os.path.join(path, f"search_{self._cache_key(params)}.pkl")
        atomic_write(f, pickle.dumps(out))

    def _rank_n(self, n, subsets, params: RankingParams, device):
        client_idx = np.asarray(
            [self.region_index[r] for r in self.clients]
        )
        fs = FTMetric.fs(params.ft_metric, n)
        quorums = sorted(
            {ProtocolModel.atlas(n, f) for f in fs}
            | {ProtocolModel.epaxos(n)}
        )
        # one launch: the leaderless latencies, the f=1 best-COV leader
        # and its FPaxos latencies for every f (the leader reused for
        # f=2, search.rs:271-276); each a C-ordered [B, C] f32 array, the
        # layout the reference's reductions read
        dev = batched_config_stats(
            self.lat,
            subsets,
            client_idx,
            quorums,
            leader_quorum_size=ProtocolModel.fpaxos(n, 1),
            leader_quorum_sizes=[ProtocolModel.fpaxos(n, f) for f in fs],
            device=device,
        )
        res = {k: v.cpu().numpy() for k, v in dev.items()}

        def stats(latencies):
            # latencies are integer milliseconds (exactly representable in
            # float32), so reducing them in float64 on the host reproduces
            # the reference's Histogram-of-u64 mean/COV bit-for-bit — the
            # device only does the heavy [B, C] latency evaluation
            latencies = np.asarray(latencies, np.float64)
            mean = latencies.mean(axis=1)
            std = latencies.std(axis=1)
            return mean, std / np.maximum(mean, 1e-9)

        valid = np.ones((subsets.shape[0],), bool)
        score = np.zeros((subsets.shape[0],), np.float64)
        means: Dict[str, np.ndarray] = {}
        e_mean, _ = stats(res[f"lat_{ProtocolModel.epaxos(n)}"])
        means["e"] = np.asarray(e_mean)
        for f in fs:
            a_mean, a_cov = stats(res[f"lat_{ProtocolModel.atlas(n, f)}"])
            f_mean, f_cov = stats(
                res[f"leader_lat_{ProtocolModel.fpaxos(n, f)}"]
            )
            a_mean, a_cov = np.asarray(a_mean), np.asarray(a_cov)
            f_mean, f_cov = np.asarray(f_mean), np.asarray(f_cov)
            means[f"af{f}"] = a_mean
            means[f"ff{f}"] = f_mean
            mean_improv = f_mean - a_mean
            fairness_improv = f_cov - a_cov
            valid &= mean_improv >= params.min_mean_fpaxos_improv
            valid &= fairness_improv >= params.min_fairness_fpaxos_improv
            e_improv = means["e"] - a_mean
            if n in (11, 13):  # search.rs:460-464
                valid &= e_improv >= params.min_mean_epaxos_improv
            score += mean_improv + 30.0 * e_improv  # search.rs:467-468

        region_names = sorted(self.region_index, key=self.region_index.get)
        ranked = [
            RankedConfig(
                score=float(score[b]),
                config=tuple(region_names[i] for i in subsets[b]),
                means={k: float(v[b]) for k, v in means.items()},
            )
            for b in np.nonzero(valid)[0]
        ]
        ranked.sort(key=lambda rc: -rc.score)
        return ranked


class _CacheUnpickler(pickle.Unpickler):
    """Loads a search cache, refusing every class but this module's
    :class:`RankedConfig` (the cache's dicts, lists, tuples, strings and
    floats need none)."""

    def find_class(self, module, name):
        if (module, name) == (__name__, "RankedConfig"):
            return RankedConfig
        raise pickle.UnpicklingError(
            f"search cache names {module}.{name}, not this port's "
            "RankedConfig"
        )
