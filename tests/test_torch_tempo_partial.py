"""Tempo under partial replication end to end through the port on the
CPU: the two configurations of ``tests/test_engine_partial.py``'s
``test_engine_partial_matches_oracle`` that are not slow, whose
``LaneResults.to_json()`` must equal the reference's ``run_lanes`` byte
for byte, with the oracle checks that test makes; the committed fixture
the card's run is held to; the per-command shard/key tables, shard rows
and initial state the port builds, against the reference's
``make_lane``/``init_lane_state``; the port's ``key_hash``; and the main
path's sizes."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from fantoch_tpu.client import DeviceStream, Workload
from fantoch_tpu.core import Config as RConfig
from fantoch_tpu.core import Planet as RPlanet
from fantoch_tpu.core.util import key_hash as r_key_hash
from fantoch_tpu.engine import EngineDims as RDims
from fantoch_tpu.engine import make_lane as r_make_lane
from fantoch_tpu.engine import run_lanes as r_run_lanes
from fantoch_tpu.engine import stack_lanes as r_stack_lanes
from fantoch_tpu.engine.driver import stack_states as r_stack_states
from fantoch_tpu.engine.protocols import TempoPartialDev as RTempoPartial
from fantoch_tpu.protocol import Tempo
from fantoch_tpu.protocol.base import ProtocolMetricsKind
from fantoch_tpu.sim import Runner
from fantoch_tpu_torch import carry
from fantoch_tpu_torch.core import Config, Planet
from fantoch_tpu_torch.core.util import key_hash
from fantoch_tpu_torch.engine import (
    EngineDims, make_lane, prepare_batch, run_lanes,
)
from fantoch_tpu_torch.engine.protocols import (
    TempoPartialDev, partial_dev_protocol,
)
from torch_threads import one_torch_thread  # noqa: F401

FIXTURE = Path(__file__).parent / "fixtures" / "torch_tempo_partial_golden.json"

COMMANDS = 10
# (n, f, shards, conflict, pool, keys per command): the configurations
# of test_engine_partial_matches_oracle that are not slow, one batch each
# (chip_smoke.py builds the identical batches on the card)
POINTS = [(3, 1, 2, 0, 1, 1), (3, 1, 2, 100, 4, 2)]


def _config(cfg, n, f, shards, **kw):
    return cfg(n=n, f=f, shard_count=shards, gc_interval_ms=100,
               executor_executed_notification_interval_ms=100,
               executor_cleanup_interval_ms=100,
               tempo_detached_send_interval_ms=100, **kw)


def golden_batches(cfg, planet, dims_cls, make, proto_cls):
    """``[(protocol, dims, [spec]), ...]``, as test_engine_partial.py's
    ``run_engine`` builds them."""
    out = []
    for n, f, shards, conflict, pool, kpc in POINTS:
        regions = planet.regions()[:n]
        proto = proto_cls(keys=pool + n + 1, shards=shards, keys_per_cmd=kpc)
        dims = dims_cls.for_partial(proto, n, n, COMMANDS * n, regions=n)
        spec = make(proto, planet, _config(cfg, n, f, shards),
                    conflict_rate=conflict, pool_size=pool,
                    commands_per_client=COMMANDS, clients_per_region=1,
                    process_regions=regions, client_regions=regions,
                    dims=dims)
        out.append((proto, dims, [spec]))
    return out


def dumps(results):
    return json.dumps([r.to_json() for r in results], sort_keys=True) + "\n"


@pytest.fixture(scope="module")
def reference_json():
    batches = golden_batches(RConfig, RPlanet.new(), RDims, r_make_lane,
                             RTempoPartial)
    return dumps([r for p, d, s in batches for r in r_run_lanes(p, d, s)])


@pytest.fixture(scope="module")
def port_results():
    batches = golden_batches(Config, Planet.new(), EngineDims, make_lane,
                             TempoPartialDev)
    return [r for p, d, s in batches
            for r in run_lanes(p, d, s, device="cpu")]


def test_to_json_byte_identical_to_reference(port_results, reference_json):
    assert dumps(port_results) == reference_json


def test_fixture_is_the_reference_output(reference_json):
    """The committed fixture (what chip_smoke.py holds the card's run
    to) is regenerated from the reference and must not have changed."""
    assert FIXTURE.read_text() == reference_json


def _oracle(n, f, shards, conflict, pool, kpc):
    """test_engine_partial.py's ``run_oracle``: the host simulator on the
    same key stream."""
    config = _config(RConfig, n, f, shards)
    regions = RPlanet.new().regions()[:n]
    wl = Workload(
        shard_count=shards,
        key_gen=DeviceStream(conflict_rate=conflict, pool_size=pool),
        keys_per_command=kpc, commands_per_client=COMMANDS, payload_size=0,
    )
    runner = Runner(Tempo, RPlanet.new(), config, wl, 1, regions,
                    list(regions))
    metrics, _, lat = runner.run(extra_sim_time_ms=1500)
    fast = slow = stable = 0
    for pm, _em in metrics.values():
        fast += pm.get_aggregated(ProtocolMetricsKind.FAST_PATH) or 0
        slow += pm.get_aggregated(ProtocolMetricsKind.SLOW_PATH) or 0
        stable += pm.get_aggregated(ProtocolMetricsKind.STABLE) or 0
    return regions, lat, fast, slow, stable


@pytest.mark.parametrize("i", range(len(POINTS)))
def test_oracle_checks(port_results, i):
    """As test_engine_partial_matches_oracle asserts: no error; every
    client issues its budget; fast + slow commits equal the oracle's,
    between one and one per shard per command; every process of the
    command's shards GCs it (stable = n × total, as the oracle's); the
    latency means equal the oracle's."""
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


def test_key_hash_matches_reference():
    keys = [str(k) for k in range(-5, 2000)] + ["", "key", "ümlaut"]
    assert [key_hash(k) for k in keys] == [r_key_hash(k) for k in keys]


# lanes of the table check: (n, shards, keys per command, conflict,
# pool, commands); conflict 1 and 10 redraw often enough that the
# stream outgrows its first width, and 3 shards route keys three ways
TABLE_POINTS = [
    (3, 2, 2, 100, 4, 6),
    (3, 2, 2, 1, 4, 6),
    (5, 2, 2, 10, 4, 4),
    (3, 3, 2, 50, 4, 5),
    (3, 2, 1, 0, 1, 5),
]


@pytest.mark.parametrize("point", TABLE_POINTS)
def test_partial_tables_and_state_match_reference(point):
    """The port's lane (make_lane's shard rows, zeroed lookahead and
    per-shard attachment, prepare_batch's per-command tables drawn from
    the key_table stream) equals the reference's ctx key for key, and
    its initial state (first SUBMITs at the target shard) equals the
    reference's ``init_lane_state``."""
    n, shards, kpc, conflict, pool, commands = point
    regions = RPlanet.new().regions()[3:3 + n]
    ref_p = RTempoPartial(keys=pool + n + 1, shards=shards, keys_per_cmd=kpc)
    port_p = TempoPartialDev(keys=pool + n + 1, shards=shards,
                             keys_per_cmd=kpc)
    rdims = RDims.for_partial(ref_p, n, n, commands * n)
    dims = EngineDims.for_partial(port_p, n, n, commands * n)
    assert dims == EngineDims(**vars(rdims))
    kw = dict(conflict_rate=conflict, pool_size=pool,
              commands_per_client=commands, clients_per_region=1,
              process_regions=regions, client_regions=regions, seed=7)
    ref = [r_make_lane(ref_p, RPlanet.new(), _config(RConfig, n, 1, shards),
                       dims=rdims, **kw)]
    port = [make_lane(port_p, Planet.new(), _config(Config, n, 1, shards),
                      dims=dims, **kw)]
    ref_ctx = r_stack_lanes(ref)
    state, ctx = prepare_batch(port_p, dims, port, torch.device("cpu"))
    ctx = carry.to_numpy(ctx)
    assert sorted(ref_ctx) == sorted(set(ctx) - {"key_table"})
    for k in ref_ctx:
        a, b = np.asarray(ref_ctx[k]), ctx[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    total = n * shards
    la = ctx["lookahead"][0]
    assert (la[:total, :total] == np.where(np.eye(total), 1 << 30, 0)).all()
    assert (ctx["shard_of"][0, total:] == shards).all()
    want = r_stack_states(ref_p, rdims, ref)
    got = carry.to_numpy(state)
    _assert_tree_equal(want, got)


def _assert_tree_equal(want, got, path=""):
    assert sorted(want) == sorted(got), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_equal(want[k], got[k], f"{path}/{k}")
            continue
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (path, k)
        np.testing.assert_array_equal(a, b, err_msg=f"{path}/{k}")


def test_partial_dev_protocol_as_the_reference():
    """Tempo's twin is sized as the reference's (keys = pool + clients +
    1); Atlas's twin is not ported yet and raises naming its ROADMAP
    item; a protocol without partial.rs paths raises ValueError, as the
    reference's switch does."""
    from fantoch_tpu.engine.protocols import (
        partial_dev_protocol as r_partial,
    )

    got = partial_dev_protocol("tempo", 5, 2, keys_per_cmd=2, pool_size=4)
    want = r_partial("tempo", 5, 2, keys_per_cmd=2, pool_size=4)
    assert (got.K, got.PK, got.R, got.G, got.S, got.KPC) == (
        want.K, want.PK, want.R, want.G, want.S, want.KPC) == (
        10, 32, 16, 8, 2, 2)
    with pytest.raises(NotImplementedError, match="item 8"):
        partial_dev_protocol("atlas", 5, 2)
    for name in ("basic", "caesar"):
        with pytest.raises(ValueError, match="partial replication"):
            partial_dev_protocol(name, 5, 2)
        with pytest.raises(ValueError, match="partial replication"):
            r_partial(name, 5, 2)


def test_main_path_sizes():
    """The partial main path's shapes (EngineDims.for_partial of the CLI
    path, TempoPartialDev's defaults): N = 10, C = 5, M = 10,064,
    D = 251, F = 14, P = 56, H = 2,048; 41 state planes, 614,322 bytes
    per process, two thirds of them the vote ranges."""
    from fantoch_tpu_torch import cli

    args = cli.parse_args(cli.MAIN_PATH_TEMPO_PARTIAL)
    proto, dims, specs = cli.sweep_setup(args)
    assert (dims.N, dims.C, dims.M, dims.D, dims.F, dims.R, dims.P,
            dims.H) == (10, 5, 10064, 251, 14, 3, 56, 2048)
    assert (proto.K, proto.PK, proto.R, proto.G) == (10, 32, 16, 8)
    assert len(specs) == 512
    ps = proto.init_state(dims, specs[0].ctx)
    per_process = sum(v.nbytes for v in ps.values()) // dims.N
    assert len(ps) == 41 and per_process == 614_322
    votes = (ps["votes_s"].nbytes + ps["votes_e"].nbytes) // dims.N
    assert votes == 401_600
