"""Region-to-region latency data ("planet").

The reference's ``fantoch/src/planet/`` as lane construction needs it: a
latency matrix between named regions with sorted-by-distance lists
(planet/mod.rs:30-140).

The datasets are the JSON matrices shipped in ``fantoch_tpu_torch/data/``
(avg ping truncated to ms, intra-region latency 0), a copy of the JAX
package's own so this package stands alone.
"""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Optional, Tuple

Region = str

DATA_DIR = Path(__file__).resolve().parent.parent / "data"


@lru_cache(maxsize=None)
def _load_dataset_cached(name: str) -> str:
    return (DATA_DIR / f"{name}.json").read_text()


def _load_dataset(name: str) -> Dict[Region, Dict[Region, int]]:
    # re-parse per call so each Planet owns its (mutable) dict
    return json.loads(_load_dataset_cached(name))


class Planet:
    """Latency matrix between regions, with per-region sorted distance
    lists (planet/mod.rs:21-28)."""

    def __init__(self, latencies: Dict[Region, Dict[Region, int]]):
        self.latencies = latencies
        # regions sorted by (latency, name) from each region; the name
        # tie-break matches the reference's sort of (u64, Region) tuples
        # (planet/mod.rs:122-140)
        self.sorted_: Dict[Region, List[Tuple[int, Region]]] = {
            from_: sorted((lat, to) for to, lat in entries.items())
            for from_, entries in latencies.items()
        }

    # -- constructors ---------------------------------------------------

    @classmethod
    def new(cls) -> "Planet":
        """The default GCP planet (planet/mod.rs:33-35): 20 regions."""
        return cls.from_dataset("latency_gcp")

    @classmethod
    def from_dataset(cls, name: str) -> "Planet":
        """Load a shipped dataset: ``latency_gcp``,
        ``latency_aws_2020_06_05`` or ``latency_aws_2021_02_13``."""
        return cls(_load_dataset(name))

    # -- queries --------------------------------------------------------

    def regions(self) -> List[Region]:
        return list(self.latencies)

    def ping_latency(self, from_: Region, to: Region) -> Optional[int]:
        """Ping latency in ms between two regions (planet/mod.rs:107-113)."""
        entries = self.latencies.get(from_)
        if entries is None:
            return None
        return entries.get(to)

    def sorted(self, from_: Region) -> Optional[List[Tuple[int, Region]]]:
        """Regions sorted by distance (ASC) from ``from_``
        (planet/mod.rs:117-119)."""
        return self.sorted_.get(from_)
