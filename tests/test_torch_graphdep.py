"""Atlas and EPaxos end to end through the port on the CPU: the
configurations of ``tests/test_engine_graphdep.py`` — the three exact
ones of each protocol that are not slow and the concurrent one — whose
``LaneResults.to_json()`` must equal the reference's ``run_lanes`` byte
for byte; the committed fixture the card's run is held to; the protocol
invariants the reference test asserts; and the lane ctx, initial state
and sizing the port builds for both protocols."""

import json
from pathlib import Path

import numpy as np
import pytest

from fantoch_tpu.core import Config as RConfig
from fantoch_tpu.core import Planet as RPlanet
from fantoch_tpu.engine import EngineDims as RDims
from fantoch_tpu.engine import make_lane as r_make_lane
from fantoch_tpu.engine import run_lanes as r_run_lanes
from fantoch_tpu.engine.protocols import AtlasDev as RAtlas
from fantoch_tpu.engine.protocols import EPaxosDev as REPaxos
from fantoch_tpu_torch.core import Config, Planet
from fantoch_tpu_torch.engine import EngineDims, make_lane, run_lanes
from fantoch_tpu_torch.engine.protocols import AtlasDev, EPaxosDev
from torch_threads import one_torch_thread  # noqa: F401

FIXTURE = Path(__file__).parent / "fixtures" / "torch_graphdep_golden.json"

# (n, f, conflict, commands, clients per region): the three exact
# configurations of test_engine_graphdep.py that are not slow, and its
# concurrent one. One batch per protocol (chip_smoke.py builds the
# identical batches on the card), so the dims fit the largest: N = 5,
# C = 10, 200 commands.
POINTS = [
    (3, 1, 100, 30, 1),
    (3, 1, 0, 30, 2),
    (5, 2, 100, 10, 1),
    (5, 2, 100, 20, 2),
]
PROTOCOLS = ("atlas", "epaxos")
REF = {"atlas": RAtlas, "epaxos": REPaxos}
PORT = {"atlas": AtlasDev, "epaxos": EPaxosDev}


def golden_batch(cfg, planet, dims_cls, make, proto_cls):
    """``(protocol, dims, specs)`` of one protocol's batch."""
    regions = planet.regions()
    clients = max(n * cpr for n, _f, _c, _k, cpr in POINTS)
    total = max(k * n * cpr for n, _f, _c, k, cpr in POINTS)
    n_max = max(p[0] for p in POINTS)
    proto = proto_cls(keys=1 + clients)
    dims = dims_cls.for_protocol(
        proto, n=n_max, clients=clients,
        payload=proto.payload_width(n_max), total_commands=total,
        dot_slots=total + 1, regions=n_max,
    )
    specs = [
        make(proto, planet, cfg(n=n, f=f, gc_interval_ms=100),
             conflict_rate=conflict, pool_size=1,
             commands_per_client=commands, clients_per_region=cpr,
             process_regions=regions[:n], client_regions=regions[:n],
             dims=dims, seed=i)
        for i, (n, f, conflict, commands, cpr) in enumerate(POINTS)
    ]
    return proto, dims, specs


def dumps(results):
    return json.dumps([r.to_json() for r in results], sort_keys=True) + "\n"


@pytest.fixture(scope="module")
def reference_json():
    results = []
    for name in PROTOCOLS:
        results += r_run_lanes(*golden_batch(RConfig, RPlanet.new(), RDims,
                                             r_make_lane, REF[name]))
    return dumps(results)


@pytest.fixture(scope="module")
def port_results():
    results = []
    for name in PROTOCOLS:
        results += run_lanes(*golden_batch(Config, Planet.new(), EngineDims,
                                           make_lane, PORT[name]),
                             device="cpu")
    return results


def test_to_json_byte_identical_to_reference(port_results, reference_json):
    assert dumps(port_results) == reference_json


def test_fixture_is_the_reference_output(reference_json):
    """The committed fixture (what chip_smoke.py holds the card's run
    to) is regenerated from the reference and must not have changed."""
    assert FIXTURE.read_text() == reference_json


def test_invariants(port_results):
    """As test_engine_graphdep.py asserts: no error; every command
    issued and completed; every command committed once, on the fast or
    the slow path; every process GCs every command; with n = 3, f = 1
    the fast path always (threshold union with f = 1 for Atlas, a
    single reporter for EPaxos)."""
    for (n, f, _c, commands, cpr), res in zip(POINTS * 2, port_results):
        assert not res.err, res.err_cause
        total = commands * cpr * n
        assert res.completed == total
        assert int(res.lat_count.sum()) == total
        fast = int(res.protocol_metrics["fast_path"].sum())
        slow = int(res.protocol_metrics["slow_path"].sum())
        assert fast + slow == total
        assert int(res.protocol_metrics["stable"].sum()) == n * total
        if (n, f) == (3, 1):
            assert slow == 0
    # both protocols take the slow path at n = 5, f = 2 with conflicts
    for i in (2, 3, 6, 7):
        assert int(port_results[i].protocol_metrics["slow_path"].sum()) > 0


@pytest.mark.parametrize("name", PROTOCOLS)
def test_lane_ctx_and_state_match_reference(name):
    """The lane ctx (quorum matrices, the expected ack count, the
    fast-path mode and the np.bool_ ack_self flag) and the initial state
    equal the reference's key for key and dtype for dtype, at n = 3 and
    n = 5."""
    from fantoch_tpu.engine.core import init_lane_state as r_init
    from fantoch_tpu_torch.engine.core import init_lane_state

    for n, f in ((3, 1), (5, 2)):
        trees = []
        for proto_cls, cfg, planet, make, dims_cls, init in (
            (REF[name], RConfig, RPlanet.new(), r_make_lane, RDims, r_init),
            (PORT[name], Config, Planet.new(), make_lane, EngineDims,
             init_lane_state),
        ):
            proto = proto_cls(keys=4)
            dims = dims_cls.for_protocol(proto, n=n, clients=n,
                                         payload=proto.payload_width(n))
            spec = make(proto, planet, cfg(n=n, f=f, gc_interval_ms=100),
                        commands_per_client=2, clients_per_region=1,
                        process_regions=planet.regions()[:n],
                        client_regions=planet.regions()[:n], dims=dims)
            first = np.zeros((dims.C,), np.int32)
            trees.append((spec.ctx, init(proto, dims, spec.ctx, first)))
            assert proto.min_live(spec.config) == max(
                spec.config.atlas_quorum_sizes() if name == "atlas"
                else spec.config.epaxos_quorum_sizes())
        for w, g in zip(*trees):
            _assert_tree_equal(w, g)
        ctx = trees[1][0]
        assert isinstance(ctx["ack_self"], np.bool_)
        assert ctx["ack_self"] == (name == "atlas")
        assert ctx["fp_mode"] == (name == "epaxos")


def _assert_tree_equal(want, got, path=""):
    assert sorted(want) == sorted(got), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_equal(want[k], got[k], f"{path}/{k}")
            continue
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (path, k)
        np.testing.assert_array_equal(a, b, err_msg=f"{path}/{k}")


@pytest.mark.parametrize("name", PROTOCOLS)
@pytest.mark.parametrize("clients, keys", [(5, None), (10, None), (3, 7)])
def test_dev_protocol_sizes_as_the_reference(name, clients, keys):
    """``dev_protocol(name, clients, keys)`` sizes the key table by load
    (one key per client plus the shared conflict key unless given), the
    engine dims follow (Q = n + 1 dep slots, payload 5 + 2Q, two extra
    outbox slots for the drain), and ``dev_config_kwargs`` is the
    reference's."""
    from fantoch_tpu.engine.protocols import dev_config_kwargs as r_kwargs
    from fantoch_tpu.engine.protocols import dev_protocol as r_dev
    from fantoch_tpu_torch.engine.protocols import (
        dev_config_kwargs, dev_protocol,
    )

    want = r_dev(name, clients, keys=keys)
    got = dev_protocol(name, clients, keys=keys)
    assert type(got).__name__ == type(want).__name__
    assert vars(got) == vars(want)
    for n in (3, 5):
        kw = dict(n=n, clients=clients, payload=want.payload_width(n),
                  total_commands=50 * clients, dot_slots=50 * clients + 1)
        assert got.payload_width(n) == want.payload_width(n)
        assert vars(EngineDims.for_protocol(got, **kw)) == vars(
            RDims.for_protocol(want, **kw))
    assert dev_config_kwargs(name, 5, 2) == r_kwargs(name, 5, 2)
