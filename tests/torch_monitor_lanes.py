"""Monitored golden batches for the port's monitor tests: one batch of
lanes per protocol, built the same way on the reference's engine and on
the port's, with every monitor check given a lane that trips it."""

import json

from fantoch_tpu.core import Config as RConfig
from fantoch_tpu.core import Planet as RPlanet
from fantoch_tpu.engine import EngineDims as RDims
from fantoch_tpu.engine import faults as rfaults
from fantoch_tpu.engine import make_lane as r_make_lane
from fantoch_tpu.engine import run_lanes as r_run_lanes
from fantoch_tpu.engine.protocols import dev_config_kwargs as r_cfg_kwargs
from fantoch_tpu.engine.protocols import dev_protocol as r_dev_protocol
from fantoch_tpu_torch.core import Config, Planet
from fantoch_tpu_torch.engine import EngineDims, make_lane, run_lanes
from fantoch_tpu_torch.engine import faults
from fantoch_tpu_torch.engine.protocols import (
    dev_config_kwargs, dev_protocol,
)

N, COMMANDS = 3, 4
# monitor keys: the shared key and client 0's private key, so the
# conflict-0 lane's other clients execute keys out of range
MONITOR_KEYS = 2
# (plan, conflict, extra time ms): fault-free; jittered; private keys
# (monitor-key-range); a 1 ms drain tail (missing-execution); a crash;
# drops under a horizon
LANES = [
    (None, 100, 1000),
    ({"jitter_max": 8, "jitter_seed": 3}, 100, 5000),
    (None, 0, 1000),
    ({"jitter_max": 8, "jitter_seed": 1}, 100, 1),
    ({"crash": {"2": 300}, "jitter_max": 4, "jitter_seed": 2}, 100, 1000),
    ({"drop_bp": 400, "seed": 7, "horizon": 3000}, 100, 1000),
]
KEYRANGE_LANE, MISSING_LANE = 2, 3


def lanes(ref: bool, name: str):
    """``(protocol, dims, specs)`` of ``name``'s batch on one engine."""
    planet = (RPlanet if ref else Planet).new()
    regions = planet.regions()[:N]
    proto = (r_dev_protocol if ref else dev_protocol)(name, N)
    total = COMMANDS * N
    dims = (RDims if ref else EngineDims).for_protocol(
        proto, n=N, clients=N, payload=proto.payload_width(N),
        total_commands=total, dot_slots=total + 1, regions=N,
    )
    cfg = (RConfig if ref else Config)(
        **(r_cfg_kwargs if ref else dev_config_kwargs)(name, N, 1))
    plan_cls = (rfaults if ref else faults).FaultPlan
    specs = [
        (r_make_lane if ref else make_lane)(
            proto, planet, cfg, conflict_rate=conflict, pool_size=1,
            commands_per_client=COMMANDS, clients_per_region=1,
            process_regions=regions, client_regions=regions, dims=dims,
            extra_time_ms=extra, seed=i,
            faults=plan_cls.from_json(plan) if plan else None,
        )
        for i, (plan, conflict, extra) in enumerate(LANES)
    ]
    return proto, dims, specs


def run_both(name: str):
    """Both engines' ``to_json`` lines of ``name``'s monitored batch, and
    the port's results."""
    ref = r_run_lanes(*lanes(True, name), monitor_keys=MONITOR_KEYS)
    got = run_lanes(*lanes(False, name), device="cpu",
                    monitor_keys=MONITOR_KEYS)
    dump = [[json.dumps(r.to_json(), sort_keys=True) for r in rs]
            for rs in (ref, got)]
    return dump[0], dump[1], got
