"""Topology helpers (the reference's ``fantoch/src/util.rs``): key
hashing for shard routing (util.rs:118-123), distance-based process
sorting (util.rs:153-186) and closest-process-per-shard discovery
(util.rs:188-230).

The reference hashes with ahash; any stable hash works, and this one is
the port's own copy of the simulator's choice: blake2b with an 8-byte
digest, read little-endian (Python's ``hash`` is salted per run)."""

from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence, Tuple

from .ids import ProcessId, ShardId
from .planet import Planet, Region


def key_hash(key: str) -> int:
    """Stable hash of a key's string form."""
    return int.from_bytes(
        hashlib.blake2b(key.encode(), digest_size=8).digest(), "little"
    )


def sort_processes_by_distance(
    region: Region,
    planet: Planet,
    processes: Sequence[Tuple[ProcessId, ShardId, Region]],
) -> List[Tuple[ProcessId, ShardId]]:
    """Sort processes by the distance of their region from ``region``; ties
    within the same region break by process id (util.rs:153-186)."""
    sorted_regions = planet.sorted(region)
    assert sorted_regions is not None, "region should be part of planet"
    index = {r: i for i, (_lat, r) in enumerate(sorted_regions)}
    ordered = sorted(processes, key=lambda p: (index[p[2]], p[0]))
    return [(pid, shard_id) for pid, shard_id, _ in ordered]


def closest_process_per_shard(
    region: Region,
    planet: Planet,
    processes: Sequence[Tuple[ProcessId, ShardId, Region]],
) -> Dict[ShardId, ProcessId]:
    """Mapping from shard id to the closest process of that shard
    (util.rs:188-230)."""
    closest: Dict[ShardId, ProcessId] = {}
    for process_id, shard_id in sort_processes_by_distance(
        region, planet, processes
    ):
        closest.setdefault(shard_id, process_id)
    return closest
