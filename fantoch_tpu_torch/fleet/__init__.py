"""Fleet campaigns: lease-sharded multi-worker campaign execution (the
port's copy of the JAX package's ``fleet/``; workers run their units on
the CUDA card unless given ``device="cpu"``, ``--device cpu`` before the
subcommand on the CLI).

PR 5's campaign manager made one grid survive one process's death; a
fleet makes it survive *any* worker's death while many workers drain
the same grid concurrently. The shared campaign directory is the only
coordination medium — no coordinator process, no network protocol —
which is exactly the posture preemptible workers need: any worker
can claim any unit, any worker can resume any other worker's
checkpointed unit (the signed checkpoints already refuse cross-version
resumes), and a SIGKILLed worker costs at most its in-flight segment
window, reclaimed after a lease TTL.

    python -m fantoch_tpu_torch fleet --dir D --grid '{...}' --workers 3 --merge
    python -m fantoch_tpu_torch fleet --dir D --worker-id w7 --budget-s 3600
    python -m fantoch_tpu_torch fleet --dir D --merge

Three pieces (docs/FLEET.md):

* ``leases.py`` — per-unit claims via atomic-rename lease records plus
  an atomic hard-link lock, heartbeat mtimes, TTL-gated reclaim;
* ``worker.py`` — the worker loop: claim a unit, run it through the
  existing checkpointed ``run_sweep`` / fuzz-point machinery, journal
  it into a worker-scoped journal, release;
* ``merge.py`` — the deterministic merge: completed units from every
  worker journal, ordered canonically, written as a ``results.jsonl``
  that is **byte-identical** between a 1-worker control and any
  N-worker, any-interleaving fleet run.
"""

from .leases import (
    DEFAULT_TTL_S,
    WORKER_ID_MAX,
    FleetError,
    Lease,
    check_worker_id,
    claim_unit,
    lease_holder,
    worker_id_ok,
)
from .merge import merge_campaign
from .worker import run_fleet_worker

__all__ = [
    "DEFAULT_TTL_S",
    "WORKER_ID_MAX",
    "FleetError",
    "Lease",
    "check_worker_id",
    "claim_unit",
    "lease_holder",
    "worker_id_ok",
    "merge_campaign",
    "run_fleet_worker",
]
