"""The port's lane construction equals the reference's ctx key for key,
dtype for dtype, value for value; what the reference refuses (fault,
traffic and arrival options, mixed batches) the port refuses by the same
error and message."""

import itertools

import numpy as np
import pytest

from fantoch_tpu.core import Config as RConfig
from fantoch_tpu.core import Planet as RPlanet
from fantoch_tpu.engine import EngineDims as RDims
from fantoch_tpu.engine import make_lane as r_make_lane
from fantoch_tpu.engine import stack_lanes as r_stack_lanes
from fantoch_tpu.engine.protocols import BasicDev as RBasic
from fantoch_tpu_torch.core import Config, Planet
from fantoch_tpu_torch.engine import EngineDims, make_lane, stack_lanes
from fantoch_tpu_torch.engine.protocols import (
    BasicDev, FPaxosDev, dev_protocol,
)
from fantoch_tpu_torch.parallel import make_sweep_specs


def _pair(planet_name, regions, clients_per_region, **kw):
    n = len(regions)
    f = kw.pop("f", 1)
    clients = n * clients_per_region
    rd = RDims.for_protocol(RBasic, n=n, clients=clients, payload=max(n, 3),
                            regions=n)
    pd = EngineDims.for_protocol(BasicDev, n=n, clients=clients,
                                 payload=max(n, 3), regions=n)
    assert rd.__dict__ == pd.__dict__
    rplanet = (RPlanet.from_dataset(planet_name) if planet_name
               else RPlanet.new())
    planet = Planet.from_dataset(planet_name) if planet_name else Planet.new()
    common = dict(
        commands_per_client=7, clients_per_region=clients_per_region,
        process_regions=regions, client_regions=regions, **kw,
    )
    ref = r_make_lane(RBasic, rplanet, RConfig(n=n, f=f, gc_interval_ms=100),
                      dims=rd, **common)
    port = make_lane(BasicDev, planet, Config(n=n, f=f, gc_interval_ms=100),
                     dims=pd, **common)
    return ref, port


def _assert_ctx_equal(ref_ctx, port_ctx):
    assert list(ref_ctx) == list(port_ctx)
    for k in ref_ctx:
        a, b = np.asarray(ref_ctx[k]), np.asarray(port_ctx[k])
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        assert a.shape == b.shape, (k, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=k)


GCP = RPlanet.new().regions()
CASES = [
    (None, GCP[:3], 1, dict(f=0, conflict_rate=100, seed=0)),
    (None, GCP[:3], 2, dict(f=1, conflict_rate=0, seed=5)),
    (None, GCP[3:8], 1, dict(f=2, conflict_rate=10, seed=9)),
    (None, [GCP[i] for i in (0, 4, 9, 13, 19)], 1,
     dict(f=1, conflict_rate=50, pool_size=4, seed=1)),
    (None, GCP[5:8], 1, dict(f=1, zipf=(1.0, 32), seed=2)),
    ("latency_aws_2021_02_13", None, 1, dict(f=1, conflict_rate=50)),
    (None, ["us-west1", "us-west1", "europe-west2"], 1,
     dict(f=1, conflict_rate=100)),  # colocated: serialized lookahead
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_make_lane_ctx_matches_reference(case):
    planet_name, regions, cpr, kw = CASES[case]
    if regions is None:
        regions = RPlanet.from_dataset(planet_name).regions()[:3]
    ref, port = _pair(planet_name, list(regions), cpr, **dict(kw))
    _assert_ctx_equal(ref.ctx, port.ctx)
    assert ref.region_rows == port.region_rows
    assert ref.process_regions == port.process_regions
    assert ref.fault_meta is None and port.fault_meta is None


def test_sweep_specs_and_stack_match_reference():
    from fantoch_tpu.parallel.sweep import (
        make_sweep_specs as r_make_sweep_specs,
    )

    region_sets = [list(c) for c in itertools.islice(
        itertools.combinations(GCP, 5), 3)]
    kw = dict(region_sets=region_sets, fs=[1, 2], conflicts=[0, 100],
              commands_per_client=4, clients_per_region=1)
    rd = RDims.for_protocol(RBasic, n=5, clients=5, payload=5, regions=5)
    pd = EngineDims.for_protocol(BasicDev, n=5, clients=5, payload=5,
                                 regions=5)
    ref = r_make_sweep_specs(RBasic, RPlanet.new(), dims=rd, **kw)
    port = make_sweep_specs(BasicDev, Planet.new(), dims=pd, **kw)
    assert len(ref) == len(port) == 12
    _assert_ctx_equal(r_stack_lanes(ref), stack_lanes(port))


def _lane_refusal(kw, shards=1):
    """A make_lane call the reference refuses, on both sides: Tempo at
    n = 3 (under ``shards`` > 1 its partial twin) with ``kw``."""
    from fantoch_tpu.engine.protocols import dev_protocol as r_dev
    from fantoch_tpu.engine.protocols import (
        partial_dev_protocol as r_partial,
    )
    from fantoch_tpu_torch.engine.protocols import partial_dev_protocol

    def build(make, cfg, planet, dims_cls, dev, partial):
        if shards > 1:
            proto = partial("tempo", 3, shards)
            dims = dims_cls.for_partial(proto, 3, 3, 6)
        else:
            proto = dev("tempo", 3)
            dims = dims_cls.for_protocol(proto, n=3, clients=3,
                                         payload=proto.payload_width(3))
        make(proto, planet, cfg(n=3, f=1, shard_count=shards), dims=dims,
             conflict_rate=100, pool_size=4 if shards > 1 else 1,
             commands_per_client=4, clients_per_region=1,
             process_regions=GCP[:3], client_regions=GCP[:3], **kw)

    return (
        lambda: build(r_make_lane, RConfig, RPlanet.new(), RDims, r_dev,
                      r_partial),
        lambda: build(make_lane, Config, Planet.new(), EngineDims,
                      dev_protocol, partial_dev_protocol),
    )


def _mixed_batch():
    """A static lane and a churn lane in one batch: their ctx fields
    differ, so ``stack_lanes`` refuses."""
    kw = dict(commands_per_client=4, clients_per_region=1,
              process_regions=GCP[:3], client_regions=GCP[:3])
    rd = RDims.for_protocol(RBasic, n=3, clients=3, payload=3)
    pd = EngineDims.for_protocol(BasicDev, n=3, clients=3, payload=3)
    ref = [r_make_lane(RBasic, RPlanet.new(), RConfig(n=3, f=1), dims=rd,
                       traffic=t, **kw) for t in (None, "churn")]
    port = [make_lane(BasicDev, Planet.new(), Config(n=3, f=1), dims=pd,
                      traffic=t, **kw) for t in (None, "churn")]
    return lambda: r_stack_lanes(ref), lambda: stack_lanes(port)


def _cli(extra):
    """A ``sweep`` command line the reference CLI refuses."""
    from fantoch_tpu.cli import main as r_main
    from fantoch_tpu_torch.cli import main

    grid = ["sweep", "--protocol", "tempo", "--n", "3", "--subsets", "1",
            "--commands", "2", "--conflicts", "100", *extra]
    return (lambda: r_main(["--platform", "cpu", *grid]),
            lambda: main(["--device", "cpu", *grid]))


@pytest.mark.parametrize(
    "case, error, match",
    [
        (lambda: _lane_refusal(dict(traffic="churn"), shards=2),
         AssertionError, "traffic schedules are single-shard"),
        (lambda: _lane_refusal(dict(arrivals="poisson"), shards=2),
         AssertionError, "open-loop arrivals are single-shard"),
        (lambda: _lane_refusal(dict(arrivals="poisson", reorder=True)),
         AssertionError, "reorder lanes are closed-loop only"),
        (lambda: _lane_refusal(dict(arrivals="poisson", traffic="diurnal")),
         AssertionError, "think delays model"),
        (lambda: _lane_refusal(dict(arrivals="burst", open_window=0)),
         AssertionError, "0"),
        (_mixed_batch, AssertionError, "cannot share a batch"),
        (lambda: _cli(["--arrivals", "poisson", "--offered-load", "0"]),
         SystemExit, "--offered-load and --open-window must be >= 1"),
        (lambda: _cli(["--arrivals", "poisson", "--traffic", "flash"]),
         SystemExit, "--traffic flash carries think delays"),
        (lambda: _cli(["--arrivals", "closed"]),
         SystemExit, "unknown arrival preset 'closed'"),
        (lambda: _cli(["--traffic", "rush"]),
         SystemExit, "unknown traffic preset 'rush'"),
    ],
    ids=["traffic-with-shards", "arrivals-with-shards",
         "arrivals-with-reorder", "diurnal-with-arrivals", "window-0",
         "mixed-batch", "cli-offered-load-0", "cli-flash-with-arrivals",
         "cli-closed-arrivals", "cli-unknown-traffic"],
)
def test_out_of_slice_options_raise_by_name(case, error, match):
    """The traffic and arrival options (ported in slice 10) are refused
    where the reference refuses them, by the same error and message."""
    ref, port = case()
    with pytest.raises(error, match=match) as want:
        ref()
    with pytest.raises(error, match=match) as got:
        port()
    assert str(got.value) == str(want.value)


def _shard_plan():
    """A crash plan on a two-shard lane: fault plans are single-shard."""
    from fantoch_tpu.engine import FaultPlan as RFaultPlan
    from fantoch_tpu.engine.protocols import (
        partial_dev_protocol as r_partial,
    )
    from fantoch_tpu_torch.engine.faults import FaultPlan
    from fantoch_tpu_torch.engine.protocols import partial_dev_protocol

    def build(make, cfg, planet, dims_cls, partial, plan):
        proto = partial("tempo", 3, 2)
        dims = dims_cls.for_partial(proto, 3, 3, 6)
        make(proto, planet, cfg(n=3, f=1, shard_count=2), dims=dims,
             conflict_rate=100, pool_size=4, commands_per_client=2,
             clients_per_region=1, process_regions=GCP[:3],
             client_regions=GCP[:3], faults=plan)

    return (
        lambda: build(r_make_lane, RConfig, RPlanet.new(), RDims, r_partial,
                      RFaultPlan(crashes={1: 100})),
        lambda: build(make_lane, Config, Planet.new(), EngineDims,
                      partial_dev_protocol, FaultPlan(crashes={1: 100})),
        "single-shard",
    )


def _host_only_plan():
    """An explicit per-message drop list: the reference's host oracle
    replays it, the device engine refuses it."""
    from fantoch_tpu.engine import FaultPlan as RFaultPlan
    from fantoch_tpu_torch.engine.faults import FaultPlan

    def build(make, cfg, planet, dims, plan):
        make(BasicDev if make is make_lane else RBasic, planet,
             cfg(n=3, f=1, gc_interval_ms=100), dims=dims,
             commands_per_client=1, clients_per_region=1,
             process_regions=GCP[:3], client_regions=GCP[:3], faults=plan)

    kw = dict(drop_list=((0, 1, 1),), horizon_ms=1000)
    return (
        lambda: build(r_make_lane, RConfig, RPlanet.new(),
                      RDims.for_protocol(RBasic, n=3, clients=3, payload=3),
                      RFaultPlan(**kw)),
        lambda: build(make_lane, Config, Planet.new(),
                      EngineDims.for_protocol(BasicDev, n=3, clients=3,
                                              payload=3),
                      FaultPlan(**kw)),
        "host oracle only",
    )


def _mixed_reorder_batch():
    """A batch of one reorder lane and one FIFO lane: one step runs a
    batch, so its lanes must agree."""
    from fantoch_tpu.engine.driver import batch_reorder_flag as r_flag
    from fantoch_tpu_torch.engine.driver import batch_reorder_flag

    kw = dict(commands_per_client=1, clients_per_region=1,
              process_regions=GCP[:3], client_regions=GCP[:3])
    rd = RDims.for_protocol(RBasic, n=3, clients=3, payload=3)
    pd = EngineDims.for_protocol(BasicDev, n=3, clients=3, payload=3)
    ref = [r_make_lane(RBasic, RPlanet.new(), RConfig(n=3, f=1), dims=rd,
                       reorder=r, **kw) for r in (True, False)]
    port = [make_lane(BasicDev, Planet.new(), Config(n=3, f=1), dims=pd,
                      reorder=r, **kw) for r in (True, False)]
    return (lambda: r_flag(ref), lambda: batch_reorder_flag(port),
            "cannot mix reorder and FIFO")


@pytest.mark.parametrize(
    "case", [_shard_plan, _host_only_plan, _mixed_reorder_batch],
    ids=["faults-with-shards", "host-only-plan", "mixed-reorder-batch"],
)
def test_fault_refusals_as_the_reference(case):
    """What the reference refuses of fault plans and reordering, the port
    refuses by the same assertion."""
    ref, port, match = case()
    with pytest.raises(AssertionError, match=match):
        ref()
    with pytest.raises(AssertionError, match=match):
        port()


def test_partial_replication_and_other_protocols_raise_by_name():
    # partial replication is ported for Tempo and Atlas: a protocol
    # without a partial twin fails the reference's own assertion (its
    # shard count must match the config's), and Atlas's twin is sized as
    # the reference's
    from fantoch_tpu.engine.protocols import (
        partial_dev_protocol as r_partial,
    )
    from fantoch_tpu_torch.engine.protocols import partial_dev_protocol

    kw = dict(commands_per_client=1, clients_per_region=1,
              process_regions=GCP[:3], client_regions=GCP[:3])
    rd = RDims.for_protocol(RBasic, n=6, clients=3, payload=3)
    pd = EngineDims.for_protocol(BasicDev, n=6, clients=3, payload=3)
    with pytest.raises(AssertionError, match="protocol shards must match"):
        r_make_lane(RBasic, RPlanet.new(),
                    RConfig(n=3, f=1, shard_count=2), dims=rd, **kw)
    with pytest.raises(AssertionError, match="protocol shards must match"):
        make_lane(BasicDev, Planet.new(), Config(n=3, f=1, shard_count=2),
                  dims=pd, **kw)
    assert type(r_partial("atlas", 5, 2)).__name__ == "AtlasPartialDev"
    got, want = partial_dev_protocol("atlas", 5, 2), r_partial("atlas", 5, 2)
    assert type(got).__name__ == "AtlasPartialDev"
    assert (got.K, got.G, got.B, got.S, got.KPC, got.q_shard(5),
            got.q_union(5)) == (want.K, want.G, want.B, want.S, want.KPC,
                                want.q_shard(5), want.q_union(5))
    # Atlas and EPaxos are ported: their key tables are sized as the
    # reference's (one key per client plus the shared conflict key)
    from fantoch_tpu.engine.protocols import dev_protocol as r_dev

    # Caesar is ported: sized by load as the reference's (K = 1 + clients,
    # DEP = max(64, 8 × clients), BB = max(16, DEP / 4))
    caesar = dev_protocol("caesar", 5)
    assert (caesar.K, caesar.DEP, caesar.BB) == (6, 64, 16)
    assert vars(caesar) == vars(r_dev("caesar", 5))

    for name in ("atlas", "epaxos"):
        got, want = dev_protocol(name, 5), r_dev(name, 5)
        assert type(got).__name__ == type(want).__name__
        assert got.K == want.K == 6 and got.G == want.G
    with pytest.raises(ValueError, match="unknown protocol"):
        dev_protocol("paxos")
    assert dev_protocol("basic") is BasicDev
    assert dev_protocol("fpaxos") is FPaxosDev
