"""Open-loop serving workloads: the throughput–latency knee (the port's
copy of the JAX package's ``serving/``).

Closed-loop clients (one command in flight, the next armed by the
previous completion) hide saturation behavior and suffer coordinated
omission ("Open Versus Closed: A Cautionary Tale", Schroeder et al.,
NSDI'06). The engine's open-loop client mode (engine/core.py,
docs/TRAFFIC.md "Open-loop arrivals") timestamps commands by seeded
arrival draws independent of completion, bounds the in-flight window,
and counts arrival-queue delay into latency — so sweeping an
offered-load axis exposes the *knee*: the first load where tail
latency leaves the unloaded baseline.

:mod:`fantoch_tpu_torch.serving.knee` drives that sweep per (protocol,
planet, traffic) point through the campaign manager (journaled,
checkpointed, SIGKILL+resume byte-identical) and writes the measured
latency-vs-offered-load curves plus the located knee as a canonical
atomic artifact (docs/CAMPAIGN.md "Knee artifacts").
"""

from .knee import (
    KNEE_ARTIFACT,
    KNEE_KIND,
    KNEE_VERSION,
    build_knee_artifact,
    check_knee_artifact,
    collect_curves,
    knee_campaign,
    locate_knee,
    run_knee_sweep,
)

__all__ = [
    "KNEE_ARTIFACT",
    "KNEE_KIND",
    "KNEE_VERSION",
    "build_knee_artifact",
    "check_knee_artifact",
    "collect_curves",
    "knee_campaign",
    "locate_knee",
    "run_knee_sweep",
]
