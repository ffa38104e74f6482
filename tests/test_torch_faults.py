"""Fault plans and reordering through the port on the CPU, against the
reference's ``fantoch_tpu/engine/faults.py`` and engine.

- the host side: plan validation, ``parse_fault_specs`` and ``meta``,
  ``unavailable``/``min_live`` for every protocol, ``fault_ctx`` key for
  key and bit for bit, the drop and jitter tables, the lanes
  ``make_lane`` builds with a plan or ``reorder=True``;
- the golden batches: the Tempo configurations of
  ``tests/test_engine_faults.py`` that are not slow (the crash diffs, the
  window diff, the overflow-multiplier partition, the Tempo liveness
  shapes, the unavailable lane) in one batch, and the quick Tempo shape
  of ``tests/test_engine_reorder.py`` (20 commands, seeds 0 and 1) in a
  reorder batch, whose ``LaneResults.to_json()`` must equal the
  reference's ``run_lanes`` byte for byte; the committed fixture the
  card's run is held to; the reference tests' invariants.

Tolerance: none (integer state)."""

import json
from pathlib import Path

import numpy as np
import pytest

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
from fantoch_tpu_torch.engine.dims import ERR_UNAVAIL, INF
from fantoch_tpu_torch.engine.protocols import (
    dev_config_kwargs, dev_protocol,
)
from torch_threads import one_torch_thread  # noqa: F401

FIXTURE = Path(__file__).parent / "fixtures" / "torch_faults_golden.json"
GCP = RPlanet.new().regions()

# the golden Tempo fault batch (n = 3, f = 1, 15 commands, one client per
# region): test_engine_faults.py's crash diffs (rows 0 and 2 at 150 ms),
# its 6x window diff, its overflow-multiplier partition, its two Tempo
# liveness shapes and its unavailable lane, as plans in from_json form
FAULT_PLANS = [
    {"crash": {"0": 150}},
    {"crash": {"2": 150}},
    {"windows": [{"src": 0, "dst": 1, "t0": 50, "t1": 400, "mult": 6},
                 {"src": 1, "dst": 0, "t0": 50, "t1": 400, "mult": 6}]},
    {"windows": [{"src": 0, "dst": 1, "t0": 0, "t1": 800,
                  "mult": 1 << 29}], "horizon": 5000},
    {"crash": {"2": 200}},
    {"crash": {"1": 0}},
    {"crash": {"1": 100, "2": 400}},
]
FAULT_COMMANDS = 15
# the reorder batch: test_engine_reorder.py's quick Tempo shape, seeds 0
# and 1, 20 commands, 30 s of extra time
REORDER_SEEDS = [0, 1]
REORDER_COMMANDS = 20


class Side:
    """One engine's lane-building entry points."""

    def __init__(self, ref: bool):
        self.config = RConfig if ref else Config
        self.planet = RPlanet if ref else Planet
        self.dims = RDims if ref else EngineDims
        self.make_lane = r_make_lane if ref else make_lane
        self.dev_protocol = r_dev_protocol if ref else dev_protocol
        self.cfg_kwargs = r_cfg_kwargs if ref else dev_config_kwargs
        self.faults = rfaults if ref else faults
        self.run = r_run_lanes if ref else (
            lambda p, d, s: run_lanes(p, d, s, device="cpu"))


def golden_batches(side: Side, n: int = 3):
    """``[(protocol, dims, specs), ...]``: the Tempo fault batch and the
    Tempo reorder batch."""
    regions = side.planet.new().regions()[:n]
    proto = side.dev_protocol("tempo", n)
    out = []
    for commands, plans, seeds, reorder, extra in (
        (FAULT_COMMANDS, FAULT_PLANS, [0] * len(FAULT_PLANS), False, 1000),
        (REORDER_COMMANDS, [None] * len(REORDER_SEEDS), REORDER_SEEDS, True,
         30_000),
    ):
        total = commands * n
        dims = side.dims.for_protocol(
            proto, n=n, clients=n, payload=proto.payload_width(n),
            total_commands=total, dot_slots=total + 1, regions=n,
        )
        specs = [
            side.make_lane(
                proto, side.planet.new(),
                side.config(**side.cfg_kwargs("tempo", n, 1)),
                conflict_rate=100, pool_size=1,
                commands_per_client=commands, clients_per_region=1,
                process_regions=regions, client_regions=regions, dims=dims,
                extra_time_ms=extra, seed=seed, reorder=reorder,
                faults=(side.faults.FaultPlan.from_json(plan) if plan
                        else None),
            )
            for plan, seed in zip(plans, seeds)
        ]
        out.append((proto, dims, specs))
    return out


def dumps(results):
    return json.dumps([r.to_json() for r in results], sort_keys=True) + "\n"


@pytest.fixture(scope="module")
def reference_json():
    return dumps([r for p, d, s in golden_batches(Side(True))
                  for r in Side(True).run(p, d, s)])


@pytest.fixture(scope="module")
def port_results():
    return [r for p, d, s in golden_batches(Side(False))
            for r in Side(False).run(p, d, s)]


def test_to_json_byte_identical_to_reference(port_results, reference_json):
    assert dumps(port_results) == reference_json


def test_fixture_is_the_reference_output(reference_json):
    """The committed fixture (what chip_smoke.py holds the card's run
    to) is regenerated from the reference and must not have changed."""
    assert FIXTURE.read_text() == reference_json


def test_invariants(port_results):
    """As test_engine_faults.py and test_engine_reorder.py assert: the
    crash lanes finish clean with every surviving client's budget, the
    window lane is slower for the region behind the degraded link than
    the clean crash-free runs, the overflowing multiplier partitions, the
    unavailable lane ends at once with ERR_UNAVAIL; the reorder lanes
    commit every command once and GC it everywhere."""
    n, total = 3, 3 * FAULT_COMMANDS
    crash0, crash2, window, overflow, live2, live1, unavail = port_results[
        :len(FAULT_PLANS)]
    for res in (crash0, crash2, live2, live1):
        assert res.err == 0, res.err_cause
        assert res.completed == (n - 1) * FAULT_COMMANDS
        assert res.faults["halted_clients"] == 1
    assert window.err == 0 and window.completed == total
    assert overflow.err == 0 and overflow.dropped > 0
    assert unavail.err & ERR_UNAVAIL and unavail.steps <= 2
    assert unavail.faults["unavail"] is True
    assert unavail.err_cause == "quorum-unavailable"
    for res in port_results[len(FAULT_PLANS):]:
        assert res.err == 0, res.err_cause
        assert res.completed == 3 * REORDER_COMMANDS
        m = {k: int(v.sum()) for k, v in res.protocol_metrics.items()}
        assert m["fast_path"] + m["slow_path"] == 3 * REORDER_COMMANDS
        assert m["stable"] == n * 3 * REORDER_COMMANDS
        assert res.requeues > 0  # the reordering overtook prerequisites


# ----------------------------------------------------------------------
# the host side
# ----------------------------------------------------------------------

def _raises_alike(build):
    """``build(mod)`` raises AssertionError under both modules."""
    for mod in (rfaults, faults):
        with pytest.raises(AssertionError):
            build(mod)


@pytest.mark.parametrize("case", [
    lambda m: m.LinkWindow(src=0, dst=0, t0=0, t1=10),
    lambda m: m.LinkWindow(src=0, dst=1, t0=10, t1=10),
    lambda m: m.LinkWindow(src=0, dst=1, t0=0, t1=10, mult=0),
    lambda m: m.LinkWindow(src=0, dst=1, t0=0, t1=10, delay=0),
    lambda m: m.FaultPlan(windows=(
        m.LinkWindow(src=0, dst=1, t0=0, t1=100),
        m.LinkWindow(src=0, dst=1, t0=50, t1=150))),
    lambda m: m.FaultPlan(drop_bp=100),
    lambda m: m.FaultPlan(windows=(
        m.LinkWindow(src=0, dst=1, t0=0, t1=10, delay=INF),)),
    lambda m: m.FaultPlan(windows=tuple(
        m.LinkWindow(src=0, dst=1, t0=2 * i, t1=2 * i + 1)
        for i in range(9))),
])
def test_fault_plan_validation_as_the_reference(case):
    _raises_alike(case)


SPEC = (
    '[{}, null, {"crash": {"1": 200}}, '
    '{"windows": [{"src": 0, "dst": 1, "t0": 0, "t1": 500, '
    '"delay": "inf"}], "horizon": 5000}, '
    '{"drop_bp": 50, "horizon": 3000, "seed": 3}, '
    '{"jitter_max": 8, "jitter_seed": 1, "windows": [{"src": 1, "dst": 0, '
    '"t0": 50, "t1": 400, "mult": 6}]}, {"jitter_max": 1}]'
)


def test_parse_fault_specs_and_meta_as_the_reference(tmp_path):
    want = rfaults.parse_fault_specs(SPEC)
    spec_file = tmp_path / "plans.json"
    spec_file.write_text(SPEC)
    for got in (faults.parse_fault_specs(SPEC),
                faults.parse_fault_specs(f"@{spec_file}")):
        assert len(got) == len(want) == 7
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if w is None:
                continue
            assert g.meta(halted_clients=1) == w.meta(halted_clients=1)
            assert tuple(g.flags) == tuple(w.flags)
            assert g.host_only() == w.host_only()
            # meta round-trips through from_json
            assert faults.FaultPlan.from_json(g.meta()) == g
    assert got[0] is None and got[1] is None and got[6] is None
    one = faults.parse_fault_specs('{"crash": {"0": 5}}')
    assert len(one) == 1 and one[0].crashes == {0: 5}


PROTOCOLS = ["basic", "fpaxos", "tempo", "atlas", "epaxos", "caesar"]


@pytest.mark.parametrize("name", PROTOCOLS)
def test_min_live_and_unavailable_for_every_protocol(name):
    """``min_live`` and ``unavailable`` as the reference's, over n, f and
    crash sets (leader crashes included)."""
    from fantoch_tpu.engine.protocols import BasicDev as RBasic
    from fantoch_tpu.engine.protocols import FPaxosDev as RFPaxos
    from fantoch_tpu_torch.engine.protocols import BasicDev, FPaxosDev

    def protos(clients):
        if name == "basic":
            return RBasic, BasicDev
        if name == "fpaxos":
            return RFPaxos, FPaxosDev
        return (r_dev_protocol(name, clients), dev_protocol(name, clients))

    for n, f in ((3, 1), (5, 1), (5, 2), (7, 3)):
        rp, pp = protos(n)
        rcfg = RConfig(**r_cfg_kwargs(name, n, f))
        pcfg = Config(**dev_config_kwargs(name, n, f))
        assert faults.min_live(pp, pcfg) == rfaults.min_live(rp, rcfg)
        for crashed in ((), (0,), (n - 1,), (0, 1), (1, 2, 3)[:f + 1]):
            plan = {r: 10 * (r + 1) for r in crashed}
            assert faults.unavailable(
                faults.FaultPlan(crashes=plan), pp, pcfg
            ) == rfaults.unavailable(rfaults.FaultPlan(crashes=plan), rp,
                                     rcfg), (n, f, crashed)


@pytest.mark.parametrize("plan", [
    None,
    {"crash": {"1": 200, "0": 7}},
    {"windows": [{"src": 0, "dst": 1, "t0": 0, "t1": 500, "delay": "inf"},
                 {"src": 2, "dst": 1, "t0": 5, "t1": 9, "delay": 3},
                 {"src": 1, "dst": 0, "t0": 50, "t1": 400, "mult": 6}],
     "horizon": 5000},
    {"drop_bp": 400, "seed": 7, "jitter_max": 8, "jitter_seed": 1,
     "horizon": 1 << 31},
])
def test_fault_ctx_matches_reference(plan):
    rd = RDims(N=5, C=5, M=8, D=4, F=5, R=1, P=3, H=8, RR=5)
    pd = EngineDims(N=5, C=5, M=8, D=4, F=5, R=1, P=3, H=8, RR=5)
    want = rfaults.fault_ctx(
        rfaults.FaultPlan.from_json(plan) if plan else None, rd)
    got = faults.fault_ctx(
        faults.FaultPlan.from_json(plan) if plan else None, pd)
    assert list(got) == list(want)
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("seeds", [(7, 1), (0, 0), (123, 99)])
def test_wire_tables_match_reference(seeds):
    """The drop and jitter tables at n = 3, kmax = 64: the host form of
    the draws K6 makes per wire row."""
    kw = dict(drop_bp=400, drop_seed=seeds[0], jitter_max=8,
              jitter_seed=seeds[1], horizon_ms=1000)
    want, got = rfaults.FaultPlan(**kw), faults.FaultPlan(**kw)
    for table in ("drop_table", "jitter_table"):
        a, b = getattr(want, table)(3, 64), getattr(got, table)(3, 64)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b, err_msg=table)
    drops = got.drop_table(3, 64)
    assert 0 < drops.sum() < drops.size
    # the wire model's verdicts as the reference's, message by message
    tables = dict(drop_table=drops, jitter_table=got.jitter_table(3, 64))
    rtables = dict(drop_table=want.drop_table(3, 64),
                   jitter_table=want.jitter_table(3, 64))
    for s in range(3):
        for d in range(3):
            for k in range(0, 64, 7):
                assert got.wire(s, d, 100, 40, k, **tables) == want.wire(
                    s, d, 100, 40, k, **rtables)


@pytest.mark.parametrize("plan, reorder", [
    ({"crash": {"1": 200}}, False),
    ({"crash": {"0": 100}}, False),
    ({"crash": {"1": 100, "2": 400}}, False),
    ({"windows": [{"src": 0, "dst": 1, "t0": 0, "t1": 500, "delay": 2}],
      "drop_bp": 400, "seed": 7, "horizon": 5000}, False),
    (None, True),
    ({"jitter_max": 8, "jitter_seed": 1}, True),
])
@pytest.mark.parametrize("name", ["fpaxos", "tempo"])
def test_lane_with_faults_matches_reference(name, plan, reorder):
    """``make_lane(faults=, reorder=)``: the ctx (doomed processes ranked
    last in quorums, halted clients' budgets, the lookahead under a
    window override and under reorder, the fault planes, the
    unavailability word) and the lane's flags and metadata."""
    sides = (Side(True), Side(False))
    lanes = []
    for side in sides:
        proto = side.dev_protocol(name, 3)
        dims = side.dims.for_protocol(proto, n=3, clients=3,
                                      payload=proto.payload_width(3))
        lanes.append(side.make_lane(
            proto, side.planet.new(),
            side.config(**side.cfg_kwargs(name, 3, 1)),
            commands_per_client=4, clients_per_region=1,
            process_regions=GCP[:3], client_regions=GCP[:3], dims=dims,
            reorder=reorder,
            faults=side.faults.FaultPlan.from_json(plan) if plan else None,
        ))
    want, got = lanes
    assert list(got.ctx) == list(want.ctx)
    for k in want.ctx:
        a, b = np.asarray(want.ctx[k]), np.asarray(got.ctx[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert got.fault_meta == want.fault_meta
    assert tuple(got.fault_flags) == tuple(want.fault_flags)
