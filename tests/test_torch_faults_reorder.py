"""The reorder perturbation through the port on the CPU: every hop's
delay scaled by a per-step uniform [0, 10) draw (runner.rs:520-524,
``make_lane(reorder=True)``). The quick shapes of
``tests/test_engine_reorder.py`` (n = 3, f = 1, conflict 100, 20
commands, seed 0) for Atlas and EPaxos here; FPaxos's and Caesar's in
``tests/test_torch_faults_reorder_fpaxos_caesar.py``, Tempo's in
``tests/test_torch_faults.py``'s golden reorder batch, and the Tempo
partial reorder lane of ``tests/test_engine_partial.py`` in
``tests/test_torch_faults_reorder_partial.py``. Each lane's
``LaneResults.to_json()`` must equal the reference's ``run_lanes`` byte
for byte, with the invariants those tests assert. Tolerance: none
(integer state)."""

import json

import pytest

from fantoch_tpu.core import Config as RConfig
from fantoch_tpu.core import Planet as RPlanet
from fantoch_tpu.engine import EngineDims as RDims
from fantoch_tpu.engine import make_lane as r_make_lane
from fantoch_tpu.engine import run_lanes as r_run_lanes
from fantoch_tpu.engine.protocols import TempoPartialDev as RTempoPartial
from fantoch_tpu.engine.protocols import dev_config_kwargs as r_cfg_kwargs
from fantoch_tpu.engine.protocols import dev_protocol as r_dev_protocol
from fantoch_tpu_torch.core import Config, Planet
from fantoch_tpu_torch.engine import EngineDims, make_lane, run_lanes
from fantoch_tpu_torch.engine.protocols import (
    TempoPartialDev, dev_config_kwargs, dev_protocol,
)
from torch_threads import one_torch_thread  # noqa: F401

COMMANDS = 20


def quick_lane(ref: bool, name: str):
    """test_engine_reorder.py's ``run_reordered`` lane: ``(protocol,
    dims, [spec])``."""
    planet = (RPlanet if ref else Planet).new()
    regions = planet.regions()[:3]
    proto = (r_dev_protocol if ref else dev_protocol)(name, 3)
    total = COMMANDS * 3
    dims = (RDims if ref else EngineDims).for_protocol(
        proto, n=3, clients=3, payload=proto.payload_width(3),
        total_commands=total, dot_slots=total + 1, regions=3,
    )
    spec = (r_make_lane if ref else make_lane)(
        proto, planet,
        (RConfig if ref else Config)(
            **(r_cfg_kwargs if ref else dev_config_kwargs)(name, 3, 1)),
        conflict_rate=100, pool_size=1, commands_per_client=COMMANDS,
        clients_per_region=1, process_regions=regions,
        client_regions=regions, dims=dims, extra_time_ms=30_000, seed=0,
        reorder=True,
    )
    return proto, dims, [spec]


def partial_lane(ref: bool):
    """test_engine_tempo_partial_reorder_invariants's lane: n = 3, 2
    shards, conflict 100, a pool of 4, 2 keys per command, 10 commands,
    seed 5."""
    planet = (RPlanet if ref else Planet).new()
    regions = planet.regions()[:3]
    proto = (RTempoPartial if ref else TempoPartialDev)(
        keys=4 + 3 + 1, shards=2, keys_per_cmd=2)
    dims = (RDims if ref else EngineDims).for_partial(proto, 3, 3, 30)
    config = (RConfig if ref else Config)(
        n=3, f=1, shard_count=2, gc_interval_ms=100,
        executor_executed_notification_interval_ms=100,
        executor_cleanup_interval_ms=100,
        tempo_detached_send_interval_ms=100,
    )
    spec = (r_make_lane if ref else make_lane)(
        proto, planet, config, conflict_rate=100, pool_size=4,
        commands_per_client=10, clients_per_region=1,
        process_regions=regions, client_regions=regions, dims=dims,
        extra_time_ms=30_000, seed=5, reorder=True,
    )
    return proto, dims, [spec]


def check(lanes):
    """Both engines on one lane; returns the port's result."""
    (want,) = r_run_lanes(*lanes(True))
    (got,) = run_lanes(*lanes(False), device="cpu")
    assert json.dumps(got.to_json(), sort_keys=True) == json.dumps(
        want.to_json(), sort_keys=True)
    assert got.err == 0, got.err_cause
    return got


def check_quick(name: str):
    """One quick shape on both engines, with test_engine_reorder.py's
    ``check_invariants``."""
    res = check(lambda ref: quick_lane(ref, name))
    total = 3 * COMMANDS
    assert res.completed == total
    m = {k: int(v.sum()) for k, v in res.protocol_metrics.items()}
    if name == "fpaxos":
        # leader-based: the f + 1 write-quorum acceptors GC each slot
        assert m["stable"] == 2 * total
    else:
        assert m["fast_path"] + m["slow_path"] == total
        assert m["stable"] == 3 * total
    return res


@pytest.mark.parametrize("name", ["atlas", "epaxos"])
def test_reorder_quick_shape_matches_reference(name):
    res = check_quick(name)
    assert res.requeues > 0  # messages overtook their prerequisites
