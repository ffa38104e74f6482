"""Work leasing over a shared campaign directory (the port's copy of the
JAX package's ``fleet/leases.py``, with its own copy of the worker-id
rules).

Workers coordinate through the filesystem only, so the protocol must be
correct under concurrent claims, SIGKILL at any instant, and clock skew
between nothing (all mtimes come from the shared filesystem). For a
unit ``U`` in campaign dir ``D``::

    D/leases/<uid>.<worker>   # the worker's lease RECORD (JSON)
    D/leases/<uid>.lock       # the exclusive claim: a HARD LINK to
                              # exactly one record
    D/leases/<uid>.stale.*    # tombstone of a reclaimed expired lock

where ``uid`` is the unit id with every ``/`` and ``.`` flattened to
``_`` (unit ids are campaign batch keys like ``tempo/n3/b0``).

Claim protocol (``claim_unit``):

1. write the worker's lease record to a temp file and atomically
   rename it into ``<uid>.<worker>`` — crash-safe, never half-written;
2. atomically **hard-link** it to ``<uid>.lock``. ``os.link`` fails
   with ``EEXIST`` when any live claim exists, so exactly one worker
   ever wins a race — the loser removes its record and moves on. (A
   rename cannot express this: it overwrites; the link is the one
   filesystem primitive that is create-exclusive *and* atomic.)
3. the lock and the winner's record are the **same inode**, so
   heartbeats (``Lease.heartbeat`` → ``os.utime``) refresh both at
   once, and expiry checks read one mtime.

Expiry + reclaim: a lock whose mtime is older than ``ttl_s`` belongs
to a dead (or wedged) worker. Reclaim renames the expired lock to a
per-reclaimer tombstone — again atomic, so of N concurrent reclaimers
exactly one's rename succeeds (the rest see ENOENT and retry the claim
normally) — then claims as usual. Reclaim **never** fires before the
TTL: a live worker heartbeats at ``ttl_s / 4``, so only a worker dead
for at least ``3·ttl_s/4`` of heartbeats can lose its lease (the CI
``fleet-smoke`` stale-lease self-check pins the gate).

A worker that finishes (or abandons) a unit releases the lease:
record first, lock last, so a half-released lease still names its
holder. Completion itself is recorded in the worker's journal, not in
the lease — leases are purely advisory throughput hints; the merge
step trusts only journals (fleet/merge.py).
"""

from __future__ import annotations

import errno
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Optional, Tuple

LEASES_DIR = "leases"

#: default lease TTL: long enough that a heartbeat every TTL/4 rides
#: out filesystem hiccups, short enough that a SIGKILLed worker's unit
#: is back in the pool within a segment or two
DEFAULT_TTL_S = 30.0


# Fleet worker ids become lease and journal file names:
# `leases/<unit>.<worker>` and `journals/<worker>.jsonl`. The rules keep
# the filenames parseable and collision-free — alphanumerics plus `_`/`-`
# only (the first `.` in a lease name splits unit from worker, so dots
# are out), length-bounded, and never the reserved lease suffixes.
WORKER_ID_MAX = 64
_WORKER_ID_RESERVED = ("lock", "stale", "tmp")


def worker_id_ok(worker) -> bool:
    if not isinstance(worker, str) or not worker:
        return False
    if len(worker) > WORKER_ID_MAX:
        return False
    if worker in _WORKER_ID_RESERVED:
        return False
    # ascii-only on purpose: isalnum() alone admits non-ASCII letters
    # and digits, which would leak into lease/journal filenames
    return all(
        (c.isascii() and c.isalnum()) or c in "_-" for c in worker
    )


def check_worker_id(worker) -> str:
    """Validate a fleet worker id, raising ``ValueError`` naming the
    rule it breaks."""
    if not worker_id_ok(worker):
        raise ValueError(
            f"bad fleet worker id {worker!r}: ids are 1-"
            f"{WORKER_ID_MAX} chars of [A-Za-z0-9_-], and not one of "
            f"the reserved lease suffixes {_WORKER_ID_RESERVED} "
            "(docs/FLEET.md)"
        )
    return worker


class FleetError(RuntimeError):
    """A fleet invariant was violated (bad worker id, conflicting
    journal entries for one unit) — refused loudly, never papered
    over."""


def _unit_id(unit: str) -> str:
    """Flatten a campaign unit key to a lease-safe file stem: no path
    separators, no dots (the first ``.`` splits uid from worker)."""
    return unit.replace("/", "_").replace(".", "_")


def _leases_dir(path: str) -> str:
    return os.path.join(path, LEASES_DIR)


@dataclass
class Lease:
    """A held claim on one unit. ``heartbeat()`` while working,
    ``release()`` when the unit is journaled or abandoned."""

    path: str       # campaign dir
    unit: str       # the unit key (unsanitized)
    worker: str
    ttl_s: float

    @property
    def record_path(self) -> str:
        return os.path.join(
            _leases_dir(self.path), f"{_unit_id(self.unit)}.{self.worker}"
        )

    @property
    def lock_path(self) -> str:
        return os.path.join(
            _leases_dir(self.path), f"{_unit_id(self.unit)}.lock"
        )

    def heartbeat(self) -> None:
        """Refresh the lease mtime (lock + record share one inode)."""
        try:
            os.utime(self.lock_path)
        except OSError:
            # lock reclaimed from under us (we outlived our TTL, e.g.
            # a paused VM): keep going — our completion journals
            # deterministically-identical results either way, and the
            # next claim scan sees the new holder
            pass

    def release(self) -> None:
        """Drop the claim: record first, lock last, so a crash mid-
        release leaves a lock that still names its holder (and expires
        normally)."""
        for p in (self.record_path, self.lock_path):
            try:
                os.remove(p)
            except OSError:
                pass

    def heartbeater(self) -> "_Heartbeat":
        """Context manager running a daemon thread that heartbeats at
        ``ttl_s / 4`` while a (blocking) unit runs."""
        return _Heartbeat(self)


class _Heartbeat:
    def __init__(self, lease: Lease):
        self._lease = lease
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def __enter__(self):
        period = max(self._lease.ttl_s / 4.0, 0.05)

        def run():
            while not self._stop.wait(period):
                self._lease.heartbeat()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        return False


def lease_holder(path: str, unit: str) -> "Optional[Tuple[str, float]]":
    """``(worker_id, age_s)`` of the live lock on ``unit``, or None.
    Age is mtime-based — compare against the TTL yourself; this
    function never reclaims."""
    lock = os.path.join(_leases_dir(path), f"{_unit_id(unit)}.lock")
    try:
        mtime = os.stat(lock).st_mtime
        with open(lock) as fh:
            worker = json.load(fh).get("worker", "?")
    except (OSError, ValueError):
        return None
    return worker, max(time.time() - mtime, 0.0)


def _reclaim_expired(leases: str, uid: str, worker: str,
                     ttl_s: float) -> None:
    """Remove an expired lock (and orphaned records) for ``uid``.
    Atomic: the rename-to-tombstone succeeds for exactly one
    reclaimer; everyone else sees ENOENT and simply proceeds to a
    normal claim attempt."""
    lock = os.path.join(leases, f"{uid}.lock")
    try:
        age = time.time() - os.stat(lock).st_mtime
    except OSError:
        age = None
    if age is not None and age > ttl_s:
        tomb = os.path.join(leases, f"{uid}.stale.{worker}")
        try:
            os.rename(lock, tomb)
        except OSError:
            return  # someone else won the reclaim
        try:
            os.remove(tomb)
        except OSError:
            pass
    # sweep orphaned files (a loser SIGKILLed between link-fail and
    # remove, a reclaimed holder's record, or a `.{uid}.{w}.tmp` claim
    # temp whose writer died before the rename) once they are older
    # than the TTL — records are only load-bearing while hard-linked
    # as the lock, so an expired unlinked record is pure litter
    try:
        names = os.listdir(leases)
    except OSError:
        return
    for name in names:
        if name.endswith(".lock") or not (
            name.startswith(uid + ".")
            or name.startswith("." + uid + ".")
        ):
            continue
        p = os.path.join(leases, name)
        try:
            st = os.stat(p)
            if st.st_nlink < 2 and time.time() - st.st_mtime > ttl_s:
                os.remove(p)
        except OSError:
            pass


def claim_unit(path: str, unit: str, worker: str,
               ttl_s: float = DEFAULT_TTL_S) -> Optional[Lease]:
    """Try to claim ``unit`` for ``worker``. Returns a held
    :class:`Lease` or None when another live worker holds it (or won
    the race). Expired locks are reclaimed first — and ONLY expired
    ones (mtime older than ``ttl_s``)."""
    check_worker_id(worker)
    leases = _leases_dir(path)
    os.makedirs(leases, exist_ok=True)
    uid = _unit_id(unit)
    _reclaim_expired(leases, uid, worker, ttl_s)

    lease = Lease(path=path, unit=unit, worker=worker, ttl_s=ttl_s)
    # 1. the worker's lease record, atomically renamed into place
    tmp = os.path.join(leases, f".{uid}.{worker}.tmp")
    with open(tmp, "w") as fh:
        json.dump(
            {"worker": worker, "unit": unit, "claimed_at": time.time()},
            fh,
            sort_keys=True,
        )
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, lease.record_path)
    # 2. the exclusive claim: hard-link the record to the lock. EEXIST
    # = a live claim already holds the unit — exactly one racer wins.
    try:
        os.link(lease.record_path, lease.lock_path)
    except OSError as e:
        if e.errno not in (errno.EEXIST,):
            try:
                os.remove(lease.record_path)
            except OSError:
                pass
            raise
        try:
            os.remove(lease.record_path)
        except OSError:
            pass
        return None
    # claim time = link time: stamp the shared inode so the TTL clock
    # starts now, not at record-write time
    os.utime(lease.lock_path)
    return lease
