"""Caesar end to end through the port on the CPU: the five configurations
of ``tests/test_engine_caesar.py`` that are not slow (the wait condition
on and off) in one batch, whose ``LaneResults.to_json()`` must equal the
reference's ``run_lanes`` byte for byte; the committed fixture the
card's run is held to; the invariants the reference test asserts; and
the lane ctx, initial state and sizing the port builds, down to the main
path's shapes."""

import json
from pathlib import Path

import numpy as np
import pytest

from fantoch_tpu.core import Config as RConfig
from fantoch_tpu.core import Planet as RPlanet
from fantoch_tpu.engine import EngineDims as RDims
from fantoch_tpu.engine import make_lane as r_make_lane
from fantoch_tpu.engine import run_lanes as r_run_lanes
from fantoch_tpu.engine.protocols import CaesarDev as RCaesar
from fantoch_tpu_torch.core import Config, Planet
from fantoch_tpu_torch.engine import EngineDims, make_lane, run_lanes
from fantoch_tpu_torch.engine.protocols import CaesarDev
from torch_threads import one_torch_thread  # noqa: F401

FIXTURE = Path(__file__).parent / "fixtures" / "torch_caesar_golden.json"

# (n, f, wait condition, conflict, commands, clients per region): the
# configurations of test_engine_caesar.py that are not slow, in one batch
# (chip_smoke.py builds the identical batch on the card), so the dims fit
# the largest: N = 5, C = 6, 180 commands
POINTS = [
    (3, 1, True, 100, 30, 1),
    (3, 1, False, 100, 30, 1),
    (3, 1, True, 0, 30, 2),
    (5, 2, True, 100, 10, 1),
    (5, 2, False, 100, 10, 1),
]


def golden_batch(cfg, planet, dims_cls, make, proto_cls):
    """``(protocol, dims, specs)`` of the batch."""
    regions = planet.regions()
    clients = max(n * cpr for n, _f, _w, _c, _k, cpr in POINTS)
    total = max(k * n * cpr for n, _f, _w, _c, k, cpr in POINTS)
    n_max = max(p[0] for p in POINTS)
    proto = proto_cls.for_load(keys=1 + clients, clients=clients)
    dims = dims_cls.for_protocol(
        proto, n=n_max, clients=clients,
        payload=proto.payload_width(n_max), total_commands=total,
        dot_slots=total + 1, regions=n_max,
    )
    specs = [
        make(proto, planet,
             cfg(n=n, f=f, gc_interval_ms=100, caesar_wait_condition=wait),
             conflict_rate=conflict, pool_size=1,
             commands_per_client=commands, clients_per_region=cpr,
             process_regions=regions[:n], client_regions=regions[:n],
             dims=dims, seed=i)
        for i, (n, f, wait, conflict, commands, cpr) in enumerate(POINTS)
    ]
    return proto, dims, specs


def dumps(results):
    return json.dumps([r.to_json() for r in results], sort_keys=True) + "\n"


@pytest.fixture(scope="module")
def reference_json():
    return dumps(r_run_lanes(*golden_batch(RConfig, RPlanet.new(), RDims,
                                           r_make_lane, RCaesar)))


@pytest.fixture(scope="module")
def port_results():
    return run_lanes(*golden_batch(Config, Planet.new(), EngineDims,
                                   make_lane, CaesarDev), device="cpu")


def test_to_json_byte_identical_to_reference(port_results, reference_json):
    assert dumps(port_results) == reference_json


def test_fixture_is_the_reference_output(reference_json):
    """The committed fixture (what chip_smoke.py holds the card's run
    to) is regenerated from the reference and must not have changed."""
    assert FIXTURE.read_text() == reference_json


def test_invariants(port_results):
    """As test_engine_caesar.py asserts: no error; every command issued
    and completed; every command committed once, on the fast or the
    slow path; every process GCs every command. Without the wait
    condition a blocked proposal is rejected at once, so the lanes with
    it off take the slow path."""
    for (n, _f, wait, _c, commands, cpr), res in zip(POINTS, port_results):
        assert not res.err, res.err_cause
        total = commands * cpr * n
        assert res.completed == total
        assert int(res.lat_count.sum()) == total
        fast = int(res.protocol_metrics["fast_path"].sum())
        slow = int(res.protocol_metrics["slow_path"].sum())
        assert fast + slow == total
        assert int(res.protocol_metrics["stable"].sum()) == n * total
    for i in (1, 4):
        assert int(port_results[i].protocol_metrics["slow_path"].sum()) > 0


@pytest.mark.parametrize("wait", [True, False])
def test_lane_ctx_and_state_match_reference(wait):
    """The lane ctx (quorum sizes and the np.bool_ wait flag) and the
    initial state equal the reference's key for key and dtype for dtype,
    at n = 3 and n = 5."""
    from fantoch_tpu.engine.core import init_lane_state as r_init
    from fantoch_tpu_torch.engine.core import init_lane_state

    for n, f in ((3, 1), (5, 2)):
        trees = []
        for proto_cls, cfg, planet, make, dims_cls, init in (
            (RCaesar, RConfig, RPlanet.new(), r_make_lane, RDims, r_init),
            (CaesarDev, Config, Planet.new(), make_lane, EngineDims,
             init_lane_state),
        ):
            proto = proto_cls.for_load(keys=4, clients=n)
            dims = dims_cls.for_protocol(proto, n=n, clients=n,
                                         payload=proto.payload_width(n))
            spec = make(proto, planet,
                        cfg(n=n, f=f, gc_interval_ms=100,
                            caesar_wait_condition=wait),
                        commands_per_client=2, clients_per_region=1,
                        process_regions=planet.regions()[:n],
                        client_regions=planet.regions()[:n], dims=dims)
            first = np.zeros((dims.C,), np.int32)
            trees.append((spec.ctx, init(proto, dims, spec.ctx, first)))
            assert proto.min_live(spec.config) == max(
                spec.config.caesar_quorum_sizes())
        for w, g in zip(*trees):
            _assert_tree_equal(w, g)
        ctx = trees[1][0]
        assert isinstance(ctx["wait_condition"], np.bool_)
        assert ctx["wait_condition"] == wait


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
def test_dev_protocol_sizes_as_the_reference(clients, keys):
    """``dev_protocol("caesar", clients, keys)`` sizes by load (DEP =
    max(64, 8 × clients), BB = max(16, DEP / 4), one key per client plus
    the shared conflict key unless given), the engine dims follow (four
    extra outbox slots for the scans, two timer rows), and
    ``dev_config_kwargs`` is the reference's."""
    from fantoch_tpu.engine.protocols import dev_config_kwargs as r_kwargs
    from fantoch_tpu.engine.protocols import dev_protocol as r_dev
    from fantoch_tpu_torch.engine.protocols import (
        dev_config_kwargs, dev_protocol,
    )

    want = r_dev("caesar", clients, keys=keys)
    got = dev_protocol("caesar", clients, keys=keys)
    assert type(got).__name__ == type(want).__name__
    assert vars(got) == vars(want)
    for n in (3, 5):
        kw = dict(n=n, clients=clients, payload=want.payload_width(n),
                  total_commands=50 * clients, dot_slots=50 * clients + 1)
        assert got.payload_width(n) == want.payload_width(n)
        assert vars(EngineDims.for_protocol(got, **kw)) == vars(
            RDims.for_protocol(want, **kw))
        dims = EngineDims.for_protocol(got, **kw)
        assert got.gc_per_msg(dims) == want.gc_per_msg(RDims(**vars(dims)))
    assert dev_config_kwargs("caesar", 5, 2) == r_kwargs("caesar", 5, 2)


def test_main_path_shapes_are_the_reference_sizing():
    """The Caesar main path (``cli.MAIN_PATH_CAESAR``: the reference
    bench's grid with the wait condition on) at the reference's sizing:
    K = 6, S = 32, DEP = 64, BB = 16, G = 8, EB = 128, P = 133 (W =
    141), F = n + 1 + 4 = 10, two timer rows (GC every 100 ms, executed
    notification every 50 ms), D = 251, M = 2,069, quorums (4, 3); the
    state is 38 planes, 976,866 bytes per process (2.50 GB per 512-lane
    batch), the same as the reference's ``init_state``."""
    from fantoch_tpu.engine.protocols import dev_protocol as r_dev
    from fantoch_tpu_torch import cli

    args = cli.parse_args(cli.MAIN_PATH_CAESAR)
    protocol, dims, specs = cli.sweep_setup(args)
    assert len(specs) == 2048
    assert vars(protocol) == dict(K=6, S=32, DEP=64, BB=16, G=8, EB=128)
    assert (dims.N, dims.C, dims.M, dims.D, dims.F, dims.R, dims.P) == (
        5, 5, 2069, 251, 10, 2, 133
    )
    assert protocol.periodic_intervals(specs[0].config, dims) == [100, 50]
    assert {(int(s.ctx["fq_size"]), int(s.ctx["wq_size"]))
            for s in specs} == {(4, 3)}
    assert all(bool(s.ctx["wait_condition"]) for s in specs)
    state = protocol.init_state(dims, specs[0].ctx)
    want = r_dev("caesar", 5).init_state(RDims(**vars(dims)), specs[0].ctx)
    _assert_tree_equal(want, state)
    assert len(state) == 38
    per_proc = sum(v.nbytes for v in state.values()) // dims.N
    assert per_proc == 976866
    assert round(512 * dims.N * per_proc / 1e9, 2) == 2.50
