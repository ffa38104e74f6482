"""The closed-form latency model (the port's copy of the JAX package's
``bote/model.py``).

Host API mirrors ``fantoch_bote/src/lib.rs``: ``leaderless`` = client →
closest server → that server's closest quorum (lib.rs:38-58);
``leader`` = client → leader → leader's closest quorum (lib.rs:60-89);
``best_leader`` picks by a Histogram statistic (lib.rs:91-120). The
``nth_closest`` helper counts the source itself when it is a server
(distance 0), exactly like filtering the planet's sorted list
(lib.rs:160-180).

``batched_config_stats`` is the batched path: given the full latency
matrix, evaluate a [B, n] batch of server subsets for all clients at
once — the unit of work the search fans out over. On the CUDA card it
is one launch of K15 (``kernels/bote_stats.py``); on the CPU the
kernel's plain twin.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..core.metrics import Histogram
from ..core.planet import Planet, Region


class Bote:
    def __init__(self, planet: Planet | None = None):
        self.planet = planet if planet is not None else Planet.new()

    def leaderless(
        self,
        servers: Sequence[Region],
        clients: Sequence[Region],
        quorum_size: int,
    ) -> List[Tuple[Region, int]]:
        """lib.rs:38-58."""
        out = []
        for client in clients:
            client_to_closest, closest = self._nth_closest(1, client, servers)
            closest_to_quorum, _ = self._nth_closest(
                quorum_size, closest, servers
            )
            out.append((client, client_to_closest + closest_to_quorum))
        return out

    def leader(
        self,
        leader: Region,
        servers: Sequence[Region],
        clients: Sequence[Region],
        quorum_size: int,
    ) -> List[Tuple[Region, int]]:
        """lib.rs:60-89."""
        leader_to_quorum, _ = self._nth_closest(quorum_size, leader, servers)
        return [
            (
                client,
                self.planet.ping_latency(client, leader) + leader_to_quorum,
            )
            for client in clients
        ]

    def best_leader(
        self,
        servers: Sequence[Region],
        clients: Sequence[Region],
        quorum_size: int,
        sort_by: str = "cov",
    ) -> Tuple[Region, Histogram]:
        """lib.rs:91-120; ``sort_by`` in {mean, cov, mdtm}."""
        stats = []
        for leader in servers:
            latencies = self.leader(leader, servers, clients, quorum_size)
            hist = Histogram.from_values(lat for _c, lat in latencies)
            stats.append((leader, hist))
        stats.sort(key=lambda pair: getattr(pair[1], sort_by)())
        return stats[0]

    def _nth_closest(
        self, nth: int, from_: Region, servers: Sequence[Region]
    ) -> Tuple[int, Region]:
        ranked = [
            (lat, to)
            for lat, to in self.planet.sorted(from_)
            if to in set(servers)
        ]
        lat, to = ranked[nth - 1]
        return lat, to


def batched_config_stats(
    lat,
    subsets,
    client_idx,
    quorum_sizes: Sequence[int],
    leader_quorum_size: int | None = None,
    *,
    leader_quorum_sizes: Sequence[int] = (),
    device=None,
):
    """Evaluate many server subsets at once, on ``device`` (default the
    CUDA card, which raises without a GPU; ``"cpu"`` runs K15's plain
    twin).

    lat:          [R, R] ping matrix over alphabetically-ordered regions
                  (index order == the host model's name tie-break)
    subsets:      [B, n] region indices per configuration
    client_idx:   [C] region indices of clients
    quorum_sizes: leaderless quorum sizes to evaluate (one output each)
    leader_quorum_size: when set, also compute the best-COV-leader stats
                  (FPaxos model, compute_stats: search.rs:271-276)
    leader_quorum_sizes: with a leader, the quorum sizes of its FPaxos
                  latencies (one output each)

    Returns a dict of tensors on ``device`` with, per quorum size q:
    ``lat_q`` [B, C] leaderless client latencies; and when requested:
    ``leader`` [B] best leader subset position, ``leader_lat`` [B, C]
    its client latencies, ``cov`` [B, n] every candidate leader's COV
    and, per leader quorum size q, ``leader_lat_q`` [B, C].

    The latencies are integer-valued and exact in float32; the COV is
    float32 in the reference's order of summation (sequential in client
    order: ``kernels/bote_stats.py``), so the leader is the reference's
    bit for bit. Rankings consume the latencies and re-reduce them in
    f64 on the host (see search.py)."""
    import torch

    from .. import resolve_device
    from ..kernels import bote_stats

    device = resolve_device(device)
    lat_t = torch.as_tensor(np.asarray(lat, np.float32), device=device)
    sub_t = torch.as_tensor(np.asarray(subsets, np.int32), device=device)
    cli_t = torch.as_tensor(np.asarray(client_idx, np.int32), device=device)
    # the leader's own latencies are its quorum size's FPaxos plane
    fq = list(leader_quorum_sizes)
    if leader_quorum_size is not None and leader_quorum_size not in fq:
        fq.append(leader_quorum_size)
    lat_q, leader, leader_lat, cov = bote_stats(
        lat_t, sub_t, cli_t, list(quorum_sizes), leader_quorum_size, fq
    )
    out = {f"lat_{q}": lat_q[i] for i, q in enumerate(quorum_sizes)}
    if leader_quorum_size is not None:
        out["leader"] = leader
        out["cov"] = cov
        out["leader_lat"] = leader_lat[fq.index(leader_quorum_size)]
        for q in leader_quorum_sizes:
            out[f"leader_lat_{q}"] = leader_lat[fq.index(q)]
    return out
