"""Key hashing for shard routing (the reference's ``util.rs:118-123``).

The reference hashes with ahash; any stable hash works, and this one is
the port's own copy of the simulator's choice: blake2b with an 8-byte
digest, read little-endian (Python's ``hash`` is salted per run)."""

from __future__ import annotations

import hashlib


def key_hash(key: str) -> int:
    """Stable hash of a key's string form."""
    return int.from_bytes(
        hashlib.blake2b(key.encode(), digest_size=8).digest(), "little"
    )
