"""Tempo end to end through the port on the CPU: the configurations of
``tests/test_engine_tempo.py`` — the four exact ones that are not slow,
the concurrent one, a skip-capable batch, and a lane with the real-time
clock bump (every 50 ms) — whose ``LaneResults.to_json()`` must equal
the reference's ``run_lanes`` byte for byte; the committed fixture the
card's run is held to; the protocol invariants the reference test
asserts; and the lane ctx the port builds for Tempo."""

import json
from pathlib import Path

import numpy as np
import pytest

from fantoch_tpu.core import Config as RConfig
from fantoch_tpu.core import Planet as RPlanet
from fantoch_tpu.engine import EngineDims as RDims
from fantoch_tpu.engine import make_lane as r_make_lane
from fantoch_tpu.engine import run_lanes as r_run_lanes
from fantoch_tpu.engine.protocols import TempoDev as RTempo
from fantoch_tpu_torch.core import Config, Planet
from fantoch_tpu_torch.engine import EngineDims, make_lane, run_lanes
from fantoch_tpu_torch.engine.protocols import TempoDev
from torch_threads import one_torch_thread  # noqa: F401

FIXTURE = Path(__file__).parent / "fixtures" / "torch_tempo_golden.json"

# (n, f, conflict, commands, clients per region, clock bump ms): the
# four exact configurations of test_engine_tempo.py that are not slow,
# its concurrent one, and the first again with the clock bump. One
# batch (chip_smoke.py builds the identical batches on the card), so
# the dims fit the largest: N = 5, C = 10, 300 commands.
MAIN = [
    (3, 1, 100, 30, 2, None),
    (3, 1, 0, 30, 2, None),
    (5, 1, 100, 10, 1, None),
    (5, 2, 100, 20, 1, None),
    (5, 1, 100, 30, 2, None),
    (3, 1, 100, 30, 2, 50),
]
# test_engine_tempo.py's skip_fast_ack configuration, with the knob on
# and off in one skip-capable batch
SKIP = [(3, 1, 100, 20, 1, True), (3, 1, 100, 20, 1, False)]


def _config(cfg, n, f, bump=None, skip=False):
    return cfg(n=n, f=f, gc_interval_ms=100,
               tempo_detached_send_interval_ms=100,
               tempo_clock_bump_interval_ms=bump, skip_fast_ack=skip)


def golden_batches(cfg, planet, dims_cls, make, proto_cls):
    """``[(protocol, dims, specs), ...]``: the main batch and the
    skip-capable batch."""
    regions = planet.regions()
    out = []
    for points, skip_capable in ((MAIN, False), (SKIP, True)):
        clients = max(n * cpr for n, _f, _c, _k, cpr, _x in points)
        total = max(k * n * cpr for n, _f, _c, k, cpr, _x in points)
        n_max = max(p[0] for p in points)
        proto = proto_cls(keys=1 + clients, skip_capable=skip_capable)
        dims = dims_cls.for_protocol(
            proto, n=n_max, clients=clients,
            payload=proto.payload_width(n_max), total_commands=total,
            dot_slots=total + 1, regions=n_max,
        )
        specs = []
        for i, (n, f, conflict, commands, cpr, x) in enumerate(points):
            config = (_config(cfg, n, f, skip=x) if skip_capable
                      else _config(cfg, n, f, bump=x))
            specs.append(make(
                proto, planet, config, conflict_rate=conflict, pool_size=1,
                commands_per_client=commands, clients_per_region=cpr,
                process_regions=regions[:n], client_regions=regions[:n],
                dims=dims, seed=i,
            ))
        out.append((proto, dims, specs))
    return out


def dumps(results):
    return json.dumps([r.to_json() for r in results], sort_keys=True) + "\n"


@pytest.fixture(scope="module")
def reference_json():
    batches = golden_batches(RConfig, RPlanet.new(), RDims, r_make_lane,
                             RTempo)
    return dumps([r for p, d, s in batches for r in r_run_lanes(p, d, s)])


@pytest.fixture(scope="module")
def port_results():
    batches = golden_batches(Config, Planet.new(), EngineDims, make_lane,
                             TempoDev)
    return [r for p, d, s in batches
            for r in run_lanes(p, d, s, device="cpu")]


def test_to_json_byte_identical_to_reference(port_results, reference_json):
    assert dumps(port_results) == reference_json


def test_fixture_is_the_reference_output(reference_json):
    """The committed fixture (what chip_smoke.py holds the card's run
    to) is regenerated from the reference and must not have changed."""
    assert FIXTURE.read_text() == reference_json


def test_invariants(port_results):
    """As test_engine_tempo.py asserts: no error; every command issued
    and completed; every command committed once, on the fast or the slow
    path (with f = 1 always the fast one) — or, on the skip path, on
    neither; every process GCs every command."""
    points = [p[:5] + (False,) for p in MAIN] + [p[:5] + (p[5],)
                                                 for p in SKIP]
    for (n, f, _c, commands, cpr, skip), res in zip(points, port_results):
        assert not res.err, res.err_cause
        total = commands * cpr * n
        assert res.completed == total
        assert int(res.lat_count.sum()) == total
        fast = int(res.protocol_metrics["fast_path"].sum())
        slow = int(res.protocol_metrics["slow_path"].sum())
        if skip:
            assert fast == slow == 0
        else:
            assert fast + slow == total
        if f == 1:
            assert slow == 0
        assert int(res.protocol_metrics["stable"].sum()) == n * total
    # the slow path is taken somewhere (f = 2), and the skip path is
    # faster than the ack round
    assert int(port_results[3].protocol_metrics["slow_path"].sum()) > 0
    skip_on, skip_off = port_results[len(MAIN):]
    assert skip_on.lat_sum.sum() < skip_off.lat_sum.sum()


def test_lane_ctx_and_state_match_reference():
    """The Tempo lane ctx (quorum matrices, sizes, the np.bool_ modes)
    and initial state equal the reference's key for key and dtype for
    dtype, with the clock bump and skip_fast_ack on and off."""
    from fantoch_tpu.engine.core import init_lane_state as r_init
    from fantoch_tpu_torch.engine.core import init_lane_state

    for cfg_kw in (dict(bump=None, skip=False), dict(bump=50, skip=True)):
        for proto_cls, cfg, planet, make, dims_cls, init in (
            (RTempo, RConfig, RPlanet.new(), r_make_lane, RDims, r_init),
            (TempoDev, Config, Planet.new(), make_lane, EngineDims,
             init_lane_state),
        ):
            proto = proto_cls(keys=4, skip_capable=True)
            dims = dims_cls.for_protocol(proto, n=3, clients=3,
                                         payload=proto.payload_width(3))
            spec = make(proto, planet, _config(cfg, 3, 1, **cfg_kw),
                        commands_per_client=2, clients_per_region=1,
                        process_regions=planet.regions()[:3],
                        client_regions=planet.regions()[:3], dims=dims)
            first = np.zeros((dims.C,), np.int32)
            if proto_cls is RTempo:
                want = (spec.ctx, init(proto, dims, spec.ctx, first))
            else:
                got = (spec.ctx, init(proto, dims, spec.ctx, first))
        for w, g in zip(want, got):
            _assert_tree_equal(w, g)
        assert got[0]["skip_fast_ack"] == cfg_kw["skip"]
        assert isinstance(got[0]["clock_bump_mode"], np.bool_)


def _assert_tree_equal(want, got, path=""):
    assert sorted(want) == sorted(got), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_equal(want[k], got[k], f"{path}/{k}")
            continue
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (path, k)
        np.testing.assert_array_equal(a, b, err_msg=f"{path}/{k}")


@pytest.mark.parametrize("clients, keys", [(5, None), (10, None), (3, 7)])
def test_dev_protocol_sizes_tempo_as_the_reference(clients, keys):
    """``dev_protocol("tempo", clients, keys)`` sizes the tables by load
    (keys default to one per client plus the shared conflict key), and
    ``dev_config_kwargs`` sends detached votes every 100 ms, as the
    reference's do."""
    from fantoch_tpu.engine.protocols import dev_config_kwargs as r_kwargs
    from fantoch_tpu.engine.protocols import dev_protocol as r_dev
    from fantoch_tpu_torch.engine.protocols import (
        dev_config_kwargs, dev_protocol,
    )

    want = r_dev("tempo", clients, keys=keys)
    got = dev_protocol("tempo", clients, keys=keys)
    assert vars(got) == vars(want)
    assert dev_config_kwargs("tempo", 5, 2) == r_kwargs("tempo", 5, 2)
