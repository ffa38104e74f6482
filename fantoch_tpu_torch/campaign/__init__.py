"""Durable, resumable evaluation campaigns (the port's copy of the JAX
package's ``campaign/``; the units run on the CUDA card unless
``run_campaign`` is given ``device="cpu"``).

The reference survives machine churn through its ``fantoch_exp``
orchestrator by re-running whole experiments; the device engine packs
thousands of lanes into one process, so anything that kills that
process used to lose the entire run. A *campaign* makes the work
larger than one process lifetime: a journal-backed manager chunks a
(protocol × n × conflict × fault-plan) sweep grid — or a schedule-fuzz
grid — into batches, checkpoints the in-flight batch at
``segment_steps`` boundaries (engine/checkpoint.py through
``run_sweep(checkpoint=...)``), journals every completed unit, and
resumes exactly where it stopped across process restarts:

    python -m fantoch_tpu_torch campaign --dir D --grid '{"kind": "sweep", ...}'
    python -m fantoch_tpu_torch campaign --dir D --resume

Resume is **bit-exact** for sweep campaigns: an interrupted-and-resumed
campaign writes a ``results.jsonl`` byte-identical to an uninterrupted
control run (pinned against the reference's bytes by
``tests/test_torch_campaign.py``, and on the card by ``chip_smoke.py``,
which SIGKILLs a campaign once its journal holds a line). Fuzz campaigns accumulate coverage
instead of resetting: the plan generator's position, schedules-tried
counters and confirmed-violation artifacts all persist. The
reference's docs/CAMPAIGN.md gives the artifact format and the refusal
rules.
"""

from .manager import (
    CampaignError,
    FuzzCampaign,
    SweepCampaign,
    campaign_from_json,
    run_campaign,
)

__all__ = [
    "CampaignError",
    "FuzzCampaign",
    "SweepCampaign",
    "campaign_from_json",
    "run_campaign",
]
