"""Compact binary coverage maps (the standing farm's on-disk format; the
port's copy of the JAX package's ``mc/covmap.py``, byte for byte the same
files).

A standing fuzz farm (docs/MC.md "Standing farm") accumulates
million-bucket coverage maps per (protocol, n, fault class) point;
re-serializing those as indented JSON inside every journal entry is
what capped the JSON-map campaigns at hours. This module is the byte-exact
binary replacement:

* **canonical bytes by construction** — a fixed little-endian header,
  the point signature embedded as canonical JSON
  (``engine.checkpoint.canonical_json``) with its SHA-256 in the
  header, then ``(digest, count)`` pairs in ascending digest order.
  Two equal maps serialize to identical bytes on any host, so the
  fleet-merge and SIGKILL-resume identity pins ``cmp`` binary maps
  exactly like they ``cmp`` ``summary.json``;
* **atomic, versioned persistence** — maps land via the repo's single
  ``atomic_write`` choke point (GL404) under
  ``covmaps/<point>.t<tried>.covmap``; a chunk's map is written
  *before* its journal entry, so the journal never references bytes a
  crash could have lost. ``compact_point_maps`` keeps the newest two
  versions per point (the current chunk's and its predecessor — the
  predecessor survives so a reader racing the writer's prune can
  retry) instead of rewriting history;
* **refusal by name** — a foreign format version
  (:class:`CovmapVersionError`), a tampered/truncated file
  (:class:`CovmapError`) or a signature from a different fuzz point
  (:class:`~fantoch_tpu_torch.mc.coverage.CoverageMismatchError`, same key
  diff as the JSON loader) refuses loudly; nothing is ever silently
  rebuilt from zero;
* **lossless JSON migration** — ``migrate_point_states`` converts the
  ``mc --coverage-dir`` JSON state files in place (binary sibling per
  state file) and *proves* each conversion lossless by round-tripping
  the binary back to canonical map JSON and comparing bytes.

The format deliberately stores only what the identity pins compare:
the signature and the bucket table. Seed pools and generator positions
stay in the journal — they are per-chunk-small, and the journal is
already the resume source of truth.
"""

from __future__ import annotations

import hashlib
import os
import struct
from typing import Dict, List, Optional, Tuple

from ..engine.checkpoint import atomic_write, canonical_json
from .coverage import (
    COVERAGE_VERSION,
    CoverageError,
    CoverageMap,
    CoverageMismatchError,
)

#: the 8-byte magic every binary coverage map starts with
COVMAP_MAGIC = b"FCOVMAP\x00"
#: binary container version — independent of the digest-scheme
#: version (COVERAGE_VERSION), which rides inside the signature
COVMAP_FORMAT_VERSION = 1

# header: magic, container version, signature length, bucket count,
# sha256 of the embedded signature bytes
_HEADER = struct.Struct("<8sIIQ32s")
# one bucket: digest (i64 — digests are i32 but journals carry plain
# ints), hit count (u64)
_PAIR = struct.Struct("<qQ")

COVMAP_SUFFIX = ".covmap"


class CovmapError(CoverageError):
    """A binary coverage map is structurally damaged (bad magic,
    truncated pairs, header/signature hash mismatch) — refused loudly,
    never silently rebuilt."""


class CovmapVersionError(CoverageMismatchError):
    """The binary container version is foreign — maps across format
    versions are not comparable bytes; migrate explicitly."""


def signature_sha256(signature: dict) -> str:
    """Hex SHA-256 of a point signature's canonical JSON — the short
    identity the header carries and refusal messages print."""
    return hashlib.sha256(
        canonical_json(signature).encode("utf-8")
    ).hexdigest()


def covmap_bytes(cmap: CoverageMap) -> bytes:
    """Serialize a map to its canonical binary form (see module
    docstring): equal maps → identical bytes, on any host."""
    sig_bytes = canonical_json(cmap.signature).encode("utf-8")
    pairs = sorted(
        (int(d), int(c)) for d, c in cmap.buckets.items()
    )
    head = _HEADER.pack(
        COVMAP_MAGIC,
        COVMAP_FORMAT_VERSION,
        len(sig_bytes),
        len(pairs),
        hashlib.sha256(sig_bytes).digest(),
    )
    body = b"".join(_PAIR.pack(d, c) for d, c in pairs)
    return head + sig_bytes + body


def covmap_from_bytes(data: bytes, signature: Optional[dict] = None,
                      name: str = "<bytes>") -> CoverageMap:
    """Inverse of :func:`covmap_bytes`. ``signature`` (the requesting
    point's ``point_signature``) makes the load refuse a map built for
    a different fuzz point by name, exactly like
    ``CoverageMap.from_json``; structural damage and foreign container
    versions refuse by their own names."""
    if len(data) < _HEADER.size:
        raise CovmapError(
            f"binary coverage map {name} truncated before header "
            f"({len(data)} bytes)"
        )
    magic, version, sig_len, count, sig_sha = _HEADER.unpack_from(data)
    if magic != COVMAP_MAGIC:
        raise CovmapError(
            f"{name} is not a binary coverage map "
            f"(magic={magic!r})"
        )
    if version != COVMAP_FORMAT_VERSION:
        raise CovmapVersionError(
            f"binary coverage map {name} has container version "
            f"{version} != {COVMAP_FORMAT_VERSION} — bytes across "
            "container versions are incomparable; migrate explicitly"
        )
    sig_end = _HEADER.size + sig_len
    body_end = sig_end + count * _PAIR.size
    if len(data) != body_end:
        raise CovmapError(
            f"binary coverage map {name} truncated or padded: "
            f"{len(data)} bytes != {body_end} expected"
        )
    sig_bytes = data[_HEADER.size:sig_end]
    if hashlib.sha256(sig_bytes).digest() != sig_sha:
        raise CovmapError(
            f"binary coverage map {name}: embedded signature does "
            "not match its header hash — damaged or tampered"
        )
    import json

    try:
        stored = json.loads(sig_bytes.decode("utf-8"))
    except ValueError as e:
        raise CovmapError(
            f"binary coverage map {name}: unreadable embedded "
            f"signature: {e}"
        ) from e
    if int(stored.get("version", -1)) != COVERAGE_VERSION:
        raise CoverageMismatchError(
            f"coverage map version {stored.get('version')!r} != "
            f"{COVERAGE_VERSION} — digests across versions are "
            "incomparable; start a fresh map"
        )
    if signature is not None and stored != signature:
        diff = sorted(
            k
            for k in set(stored) | set(signature)
            if stored.get(k) != signature.get(k)
        )
        raise CoverageMismatchError(
            f"binary coverage map {name} was built for a different "
            f"fuzz point (mismatched: {diff}); refusing to mix "
            "digest spaces"
        )
    buckets: Dict[int, int] = {}
    prev = None
    for i in range(count):
        d, c = _PAIR.unpack_from(data, sig_end + i * _PAIR.size)
        if prev is not None and d <= prev:
            raise CovmapError(
                f"binary coverage map {name}: bucket digests not "
                "strictly ascending — not canonical bytes"
            )
        prev = d
        buckets[int(d)] = int(c)
    return CoverageMap(signature=stored, buckets=buckets)


def save_covmap(path: str, cmap: CoverageMap) -> str:
    """Atomically persist one map in binary form (crash-safe via the
    repo-wide ``atomic_write`` choke point)."""
    atomic_write(path, covmap_bytes(cmap))
    return path


def load_covmap(path: str, signature: Optional[dict] = None
                ) -> CoverageMap:
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except OSError as e:
        raise CovmapError(
            f"unreadable binary coverage map {path}: {e}"
        ) from e
    return covmap_from_bytes(
        data, signature=signature, name=os.path.basename(path)
    )


# ----------------------------------------------------------------------
# farm-mode point files: covmaps/<point>.t<tried>.covmap
# ----------------------------------------------------------------------

COVMAP_DIRNAME = "covmaps"


def flat_point(key: str) -> str:
    """Filesystem-safe form of a fuzz point key — ``tempo/n3/crash``
    → ``tempo_n3_crash`` (protocol names and fault classes are
    ``[a-z0-9]`` by construction, so the mapping is invertible)."""
    return key.replace("/", "_")


def point_map_path(directory: str, key: str, tried: int) -> str:
    """The versioned on-disk home of one point's map after ``tried``
    schedules. The version rides the filename (zero-padded so
    lexicographic order is numeric order) instead of rewriting one
    file's history."""
    return os.path.join(
        directory, COVMAP_DIRNAME,
        f"{flat_point(key)}.t{int(tried):08d}{COVMAP_SUFFIX}",
    )


def final_map_path(directory: str, key: str) -> str:
    """The canonical unversioned name merge/summary materialize once a
    point completes or retires — what CI ``cmp``s across farms."""
    return os.path.join(
        directory, COVMAP_DIRNAME, f"{flat_point(key)}{COVMAP_SUFFIX}"
    )


def save_point_map(directory: str, key: str, tried: int,
                   cmap: CoverageMap) -> str:
    path = point_map_path(directory, key, tried)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return save_covmap(path, cmap)


def load_point_map(directory: str, key: str, tried: int,
                   signature: Optional[dict] = None) -> CoverageMap:
    return load_covmap(
        point_map_path(directory, key, tried), signature=signature
    )


def _point_versions(covdir: str, key: str) -> List[Tuple[int, str]]:
    """(tried, filename) of every versioned map of ``key``, ascending
    — deterministic enumeration (sorted listdir) like every other
    directory walk the determinism lint audits."""
    prefix = f"{flat_point(key)}.t"
    out: List[Tuple[int, str]] = []
    if not os.path.isdir(covdir):
        return out
    for fname in sorted(os.listdir(covdir)):
        if not fname.startswith(prefix):
            continue
        if not fname.endswith(COVMAP_SUFFIX):
            continue
        stamp = fname[len(prefix):-len(COVMAP_SUFFIX)]
        if stamp.isdigit():
            out.append((int(stamp), fname))
    return out


def compact_point_maps(directory: str, key: str, keep: int = 2
                       ) -> List[str]:
    """Drop all but the newest ``keep`` versioned maps of one point.
    ``keep=2`` is the farm's cadence: the current chunk's map plus its
    predecessor, so a fleet reader that raced the writer still finds
    the version its journal snapshot references one generation back.
    Returns the removed paths (for logging/tests)."""
    covdir = os.path.join(directory, COVMAP_DIRNAME)
    versions = _point_versions(covdir, key)
    removed: List[str] = []
    for _tried, fname in versions[:-keep] if keep > 0 else versions:
        path = os.path.join(covdir, fname)
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass  # a concurrent compactor won the race — same outcome
        removed.append(path)
    return removed


def latest_point_map(directory: str, key: str,
                     signature: Optional[dict] = None
                     ) -> Optional[Tuple[int, CoverageMap]]:
    """(tried, map) of the newest persisted version of one point, or
    None before first touch."""
    covdir = os.path.join(directory, COVMAP_DIRNAME)
    versions = _point_versions(covdir, key)
    if not versions:
        return None
    tried, fname = versions[-1]
    cmap = load_covmap(
        os.path.join(covdir, fname), signature=signature
    )
    return tried, cmap


# ----------------------------------------------------------------------
# one-shot JSON → binary migration (cli.py mc --migrate-covmaps)
# ----------------------------------------------------------------------


def migrate_point_states(directory: str) -> List[str]:
    """Convert every ``mc --coverage-dir`` JSON state file
    (``cov_*.json``) in ``directory`` to a binary sibling
    (``cov_*.covmap``) and PROVE each conversion lossless: the binary
    is loaded back and its canonical map JSON must equal the source's
    byte-for-byte, else the migration refuses by name (and the
    atomic write means a refused/killed migration leaves no partial
    binary behind). The JSON state files are left untouched — they
    still carry the seed pool and generator positions the binary
    format deliberately excludes. Returns the written paths in
    deterministic (sorted) order."""
    import json

    written: List[str] = []
    if not os.path.isdir(directory):
        raise CovmapError(
            f"--migrate-covmaps: {directory} is not a directory"
        )
    for fname in sorted(os.listdir(directory)):
        if not (fname.startswith("cov_") and fname.endswith(".json")):
            continue
        src = os.path.join(directory, fname)
        try:
            with open(src) as fh:
                state = json.load(fh)
        except (OSError, ValueError) as e:
            raise CovmapError(
                f"unreadable coverage state {src}: {e}"
            ) from e
        if "coverage" not in state:
            raise CovmapError(
                f"{src} is not a coverage point state (no map)"
            )
        cmap = CoverageMap.from_json(state["coverage"])
        dst = src[:-len(".json")] + COVMAP_SUFFIX
        save_covmap(dst, cmap)
        # the golden round-trip: binary → map → canonical JSON bytes
        # must equal the source map's canonical JSON bytes
        back = load_covmap(dst)
        if canonical_json(back.to_json()) != canonical_json(
            cmap.to_json()
        ):
            raise CovmapError(
                f"migration of {src} is NOT lossless — binary "
                "round-trip diverged; refusing"
            )
        written.append(dst)
    return written
