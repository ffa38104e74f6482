"""Atlas under partial replication end to end through the port on the
CPU: the configuration of ``tests/test_engine_partial.py``'s
``test_engine_atlas_partial_matches_oracle`` that is not slow, and one
more lane at conflict 10, in one batch, whose ``LaneResults.to_json()``
must equal the reference's ``run_lanes`` byte for byte, with the oracle
checks that test makes; the committed fixture the card's run is held
to; the protocol's sizing against the reference's; the main path's
sizes; and (slow) a lane on which the reference overflows its tables,
whose error the port must reproduce exactly."""

import json
from pathlib import Path

import pytest

from fantoch_tpu.client import DeviceStream, Workload
from fantoch_tpu.core import Config as RConfig
from fantoch_tpu.core import Planet as RPlanet
from fantoch_tpu.engine import EngineDims as RDims
from fantoch_tpu.engine import make_lane as r_make_lane
from fantoch_tpu.engine import run_lanes as r_run_lanes
from fantoch_tpu.engine.protocols import AtlasPartialDev as RAtlasPartial
from fantoch_tpu.protocol import Atlas
from fantoch_tpu.protocol.base import ProtocolMetricsKind
from fantoch_tpu.sim import Runner
from fantoch_tpu_torch.core import Config, Planet
from fantoch_tpu_torch.engine import EngineDims, make_lane, run_lanes
from fantoch_tpu_torch.engine.protocols import (
    AtlasPartialDev, partial_dev_protocol,
)
from torch_threads import one_torch_thread  # noqa: F401

FIXTURE = (Path(__file__).parent / "fixtures"
           / "torch_atlas_partial_golden.json")

COMMANDS = 10
# (n, f, shards, conflict, pool, keys per command): the configuration of
# test_engine_atlas_partial_matches_oracle that is not slow and one at
# conflict 10, in one batch (chip_smoke.py builds the identical batch on
# the card)
POINTS = [(3, 1, 2, 100, 4, 2), (3, 1, 2, 10, 4, 2)]


def _config(cfg, n, f, shards):
    return cfg(n=n, f=f, shard_count=shards, gc_interval_ms=100,
               executor_executed_notification_interval_ms=100,
               executor_cleanup_interval_ms=100)


def golden_batch(cfg, planet, dims_cls, make, proto_cls, points=POINTS,
                 commands=COMMANDS):
    """``(protocol, dims, [spec])``, as test_engine_partial.py's
    ``run_engine`` builds each lane (one n, shard count, pool and key
    count for the whole batch)."""
    n, _f, shards, _c, pool, kpc = points[0]
    regions = planet.regions()[:n]
    proto = proto_cls(keys=pool + n + 1, shards=shards, keys_per_cmd=kpc)
    dims = dims_cls.for_partial(proto, n, n, commands * n, regions=n)
    specs = [make(proto, planet, _config(cfg, n, f, shards),
                  conflict_rate=conflict, pool_size=pool,
                  commands_per_client=commands, clients_per_region=1,
                  process_regions=regions, client_regions=regions,
                  dims=dims)
             for n, f, shards, conflict, pool, kpc in points]
    return proto, dims, specs


def dumps(results):
    return json.dumps([r.to_json() for r in results], sort_keys=True) + "\n"


@pytest.fixture(scope="module")
def reference_json():
    return dumps(r_run_lanes(*golden_batch(RConfig, RPlanet.new(), RDims,
                                           r_make_lane, RAtlasPartial)))


@pytest.fixture(scope="module")
def port_results():
    return run_lanes(*golden_batch(Config, Planet.new(), EngineDims,
                                   make_lane, AtlasPartialDev),
                     device="cpu")


def test_to_json_byte_identical_to_reference(port_results, reference_json):
    assert dumps(port_results) == reference_json


def test_fixture_is_the_reference_output(reference_json):
    """The committed fixture (what chip_smoke.py holds the card's run
    to) is regenerated from the reference and must not have changed."""
    assert FIXTURE.read_text() == reference_json


def _oracle(n, f, shards, conflict, pool, kpc):
    """test_engine_partial.py's ``run_oracle`` with Atlas: the host
    simulator on the same key stream."""
    regions = RPlanet.new().regions()[:n]
    wl = Workload(
        shard_count=shards,
        key_gen=DeviceStream(conflict_rate=conflict, pool_size=pool),
        keys_per_command=kpc, commands_per_client=COMMANDS, payload_size=0,
    )
    runner = Runner(Atlas, RPlanet.new(), _config(RConfig, n, f, shards),
                    wl, 1, regions, list(regions))
    metrics, _, lat = runner.run(extra_sim_time_ms=1500)
    fast = slow = stable = 0
    for pm, _em in metrics.values():
        fast += pm.get_aggregated(ProtocolMetricsKind.FAST_PATH) or 0
        slow += pm.get_aggregated(ProtocolMetricsKind.SLOW_PATH) or 0
        stable += pm.get_aggregated(ProtocolMetricsKind.STABLE) or 0
    return regions, lat, fast, slow, stable


@pytest.mark.parametrize("i", range(len(POINTS)))
def test_oracle_checks(port_results, i):
    """As test_engine_atlas_partial_matches_oracle asserts: no error;
    every client issues its budget; fast + slow commits equal the
    oracle's, between one and one per shard per command; the n
    processes of the dot owner's shard GC every command (stable = n ×
    total, as the oracle's); the latency means equal the oracle's."""
    n, _f, shards = POINTS[i][:3]
    regions, lat, fast, slow, stable = _oracle(*POINTS[i])
    res = port_results[i]
    assert not res.err, res.err_cause
    total = COMMANDS * n
    for region in regions:
        assert res.issued(region) == COMMANDS
    dev_fast = int(res.protocol_metrics["fast_path"].sum())
    dev_slow = int(res.protocol_metrics["slow_path"].sum())
    assert total <= dev_fast + dev_slow <= total * shards
    assert dev_fast + dev_slow == fast + slow
    assert int(res.protocol_metrics["stable"].sum()) == stable == n * total
    for region in regions:
        _issued, hist = lat[region]
        assert res.latency_mean(region) == hist.mean(), region


def test_partial_dev_protocol_sizing_as_the_reference():
    """``partial_dev_protocol("atlas")`` sizes its tables as the
    reference's (keys = pool + clients + 1; Q = KPC·(n + 1) dep slots per
    shard, QS = S·Q in the union; the engine's P and F follow)."""
    from fantoch_tpu.engine.protocols import (
        partial_dev_protocol as r_partial,
    )

    for n, clients, shards, kpc, pool in ((5, 5, 2, 2, 4), (3, 3, 3, 2, 1),
                                          (3, 6, 2, 1, 4)):
        got = partial_dev_protocol("atlas", clients, shards,
                                   keys_per_cmd=kpc, pool_size=pool)
        want = r_partial("atlas", clients, shards, keys_per_cmd=kpc,
                         pool_size=pool)
        assert isinstance(got, AtlasPartialDev)
        assert (got.K, got.G, got.B, got.S, got.KPC) == (
            want.K, want.G, want.B, want.S, want.KPC)
        assert (got.q_shard(n), got.q_union(n), got.payload_width(n),
                got.fanout(n), got.PERIODIC_ROWS) == (
            want.q_shard(n), want.q_union(n), want.payload_width(n),
            want.fanout(n), want.PERIODIC_ROWS)
        dims = EngineDims.for_partial(got, n, clients, 10 * clients)
        rdims = RDims.for_partial(want, n, clients, 10 * clients)
        assert dims == EngineDims(**vars(rdims))
    got = partial_dev_protocol("atlas", 5, 2, keys_per_cmd=2, pool_size=4)
    assert (got.K, got.G, got.B, got.q_shard(5), got.q_union(5)) == (
        10, 8, 16, 12, 24)


def test_main_path_sizes():
    """The Atlas partial main path's shapes (EngineDims.for_partial of
    the CLI path at 9 commands per client, AtlasPartialDev's defaults):
    N = 10, C = 5, M = 1,864, D = 46, F = 28, R = 2, P = 77, H = 2,048;
    K = 10, G = 8, B = 16, Q = 12, QS = 24; 40 state planes, 255,234
    bytes per process, of which 132,480 the vertices' dep triples and
    88,320 the dep report tables."""
    from fantoch_tpu_torch import cli

    args = cli.parse_args(cli.MAIN_PATH_ATLAS_PARTIAL)
    proto, dims, specs = cli.sweep_setup(args)
    assert args.commands == 9
    assert (dims.N, dims.C, dims.M, dims.D, dims.F, dims.R, dims.P,
            dims.H) == (10, 5, 1864, 46, 28, 2, 77, 2048)
    assert (proto.K, proto.G, proto.B, proto.q_shard(5),
            proto.q_union(5)) == (10, 8, 16, 12, 24)
    assert len(specs) == 512
    ps = proto.init_state(dims, specs[0].ctx)
    per_process = sum(v.nbytes for v in ps.values()) // dims.N
    assert len(ps) == 40 and per_process == 255_234
    nbytes = lambda *ks: sum(ps[k].nbytes for k in ks) // dims.N  # noqa: E731
    assert nbytes("vx_dep_src", "vx_dep_seq", "vx_dep_km") == 132_480
    assert nbytes("qd_src", "qd_seq", "qd_km", "qd_cnt") == 88_320


# the first five GCP regions at f = 2, conflict 10 and 50 commands per
# client: the reference overflows a fixed-width table here
OVERFLOW = [(5, 2, 2, 10, 4, 2)]


@pytest.mark.slow
def test_capacity_overflow_reproduced_exactly():
    """A lane on which the reference ends in ERR_CAPACITY: the port's
    ``to_json()`` (the error word, the counters, the latencies) equals
    the reference's byte for byte."""
    want = r_run_lanes(*golden_batch(RConfig, RPlanet.new(), RDims,
                                     r_make_lane, RAtlasPartial,
                                     OVERFLOW, 50))
    got = run_lanes(*golden_batch(Config, Planet.new(), EngineDims,
                                  make_lane, AtlasPartialDev, OVERFLOW, 50),
                    device="cpu")
    assert want[0].err & 16, want[0].err_cause
    assert dumps(got) == dumps(want)
