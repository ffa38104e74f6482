"""Fault plans on the other protocols through the port on the CPU: the
Atlas, EPaxos, FPaxos and Basic configurations of
``tests/test_engine_faults.py`` that are not slow, one batch per
protocol, whose ``LaneResults.to_json()`` must equal the reference's
``run_lanes`` byte for byte, with the reference tests' invariants; its
mixed fault sweep through ``make_sweep_specs``/``run_sweep``; and the
``sweep --faults`` summary against the reference CLI's.

The Basic drop diff (drops at 4 % with seed 7) runs here to a horizon
of 400 ms: its lane at the reference's 4,000 ms takes 45,450 steps, most
of them a commit requeued every millisecond behind a dropped
prerequisite, some 15 minutes on the host twins; that lane is the slow
test below. Tolerance: none (integer state)."""

import json

import pytest

from fantoch_tpu.core import Config as RConfig
from fantoch_tpu.core import Planet as RPlanet
from fantoch_tpu.engine import EngineDims as RDims
from fantoch_tpu.engine import faults as rfaults
from fantoch_tpu.engine import make_lane as r_make_lane
from fantoch_tpu.engine import run_lanes as r_run_lanes
from fantoch_tpu.engine.protocols import BasicDev as RBasic
from fantoch_tpu.engine.protocols import FPaxosDev as RFPaxos
from fantoch_tpu.engine.protocols import dev_config_kwargs as r_cfg_kwargs
from fantoch_tpu.engine.protocols import dev_protocol as r_dev_protocol
from fantoch_tpu_torch.core import Config, Planet
from fantoch_tpu_torch.engine import EngineDims, make_lane, run_lanes
from fantoch_tpu_torch.engine import faults
from fantoch_tpu_torch.engine.dims import ERR_STUCK, ERR_TRUNCATED
from fantoch_tpu_torch.engine.protocols import (
    BasicDev, FPaxosDev, dev_config_kwargs, dev_protocol,
)
from torch_threads import one_torch_thread  # noqa: F401

COMMANDS = 15
DROP = {"drop_bp": 400, "seed": 7}

# protocol → plans (from_json form), n = 3, f = 1, 15 commands, one
# client per region: the crash diffs, the liveness shapes, the FPaxos
# leader crash and the Basic drop diff of test_engine_faults.py
BATCHES = {
    "atlas": [{"crash": {"1": 100}}, {"crash": {"1": 150}}],
    "epaxos": [{"crash": {"2": 250}}],
    "fpaxos": [{"crash": {"1": 200}}, {"crash": {"2": 200}},
               {"crash": {"0": 100}}],
    "basic": [dict(DROP, horizon=400), {"crash": {"0": 200}}],
}


def _lanes(ref: bool, name: str, plans, commands=COMMANDS):
    """``(protocol, dims, specs)`` of one batch on one engine."""
    planet = (RPlanet if ref else Planet).new()
    regions = planet.regions()[:3]
    if name in ("basic", "fpaxos"):
        proto = {("basic", True): RBasic, ("basic", False): BasicDev,
                 ("fpaxos", True): RFPaxos,
                 ("fpaxos", False): FPaxosDev}[(name, ref)]
    else:
        proto = (r_dev_protocol if ref else dev_protocol)(name, 3)
    total = commands * 3
    dims = (RDims if ref else EngineDims).for_protocol(
        proto, n=3, clients=3, payload=proto.payload_width(3),
        total_commands=total, dot_slots=total + 1, regions=3,
    )
    cfg = (RConfig if ref else Config)(
        **(r_cfg_kwargs if ref else dev_config_kwargs)(name, 3, 1))
    plan_cls = (rfaults if ref else faults).FaultPlan
    specs = [
        (r_make_lane if ref else make_lane)(
            proto, planet, cfg, conflict_rate=100, pool_size=1,
            commands_per_client=commands, clients_per_region=1,
            process_regions=regions, client_regions=regions, dims=dims,
            faults=plan_cls.from_json(plan),
        )
        for plan in plans
    ]
    return proto, dims, specs


def _both(name, plans, commands=COMMANDS):
    """The reference's and the port's results on one batch."""
    want = r_run_lanes(*_lanes(True, name, plans, commands))
    got = run_lanes(*_lanes(False, name, plans, commands), device="cpu")
    return want, got


def _assert_same(want, got):
    for i, (w, g) in enumerate(zip(want, got)):
        assert json.dumps(g.to_json(), sort_keys=True) == json.dumps(
            w.to_json(), sort_keys=True), f"lane {i}"
    assert len(want) == len(got)


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_fault_batch_to_json_matches_reference(name):
    want, got = _both(name, BATCHES[name])
    _assert_same(want, got)
    # test_engine_faults.py's invariants
    if name == "basic":
        drop, live = got
        assert not drop.err & (ERR_STUCK | ERR_TRUNCATED), drop.err_cause
        assert drop.err == 0 and drop.dropped > 0
        assert 0 < drop.completed < 3 * COMMANDS
        assert live.err == 0 and live.completed == 2 * COMMANDS
        return
    if name == "fpaxos":
        *crashes, leader = got
        assert leader.err == 0 and leader.completed == 0
        assert leader.faults["halted_clients"] == 3
    else:
        crashes = got
    for res in crashes:
        assert res.err == 0, res.err_cause
        assert res.completed == 2 * COMMANDS


@pytest.mark.slow
def test_basic_drop_diff_at_the_reference_horizon():
    """test_drop_diff_exact_basic's lane as the reference runs it: drops
    at 4 %, seed 7, horizon 4,000 ms (45,450 steps)."""
    want, got = _both("basic", [dict(DROP, horizon=4000)])
    _assert_same(want, got)
    assert got[0].err == 0 and got[0].dropped > 0
    assert 0 < got[0].completed < 3 * COMMANDS


def test_mixed_fault_sweep_matches_reference():
    """test_mixed_fault_sweep: a fault-free, a crash and a partition
    lane of one point in one sweep, each point's lanes on one workload;
    the port's ``run_sweep`` equals the reference's byte for byte."""
    from fantoch_tpu.parallel.sweep import make_sweep_specs as r_specs
    from fantoch_tpu.parallel.sweep import run_sweep as r_sweep
    from fantoch_tpu_torch.parallel import make_sweep_specs, run_sweep

    out = []
    for ref in (True, False):
        fm = rfaults if ref else faults
        planet = (RPlanet if ref else Planet).new()
        proto = (r_dev_protocol if ref else dev_protocol)("tempo", 3)
        dims = (RDims if ref else EngineDims).for_protocol(
            proto, n=3, clients=3, payload=proto.payload_width(3),
            total_commands=30, dot_slots=31, regions=3,
        )
        plans = [
            None,
            fm.FaultPlan(crashes={2: 150}),
            fm.FaultPlan(windows=(fm.LinkWindow(src=0, dst=1, t0=0, t1=600,
                                                delay=1 << 30),),
                         horizon_ms=5000),
        ]
        specs = (r_specs if ref else make_sweep_specs)(
            proto, planet, region_sets=[planet.regions()[:3]], fs=[1],
            conflicts=[100], commands_per_client=10, clients_per_region=1,
            dims=dims,
            config_base=(RConfig if ref else Config)(
                **(r_cfg_kwargs if ref else dev_config_kwargs)(
                    "tempo", 3, 1)),
            faults=plans,
        )
        assert len(specs) == 3
        out.append(r_sweep(proto, dims, specs) if ref
                   else run_sweep(proto, dims, specs, device="cpu"))
    want, got = out
    _assert_same(want, got)
    clean, crash, part = got
    assert clean.faults is None and clean.err == 0 and clean.completed == 30
    assert crash.faults["crash"] == {"2": 150} and crash.completed == 20
    assert part.faults["windows"][0]["delay"] == "inf"
    assert part.dropped > 0 and part.completed <= clean.completed


def test_cli_faults_summary_matches_reference(capsys):
    """``sweep --faults`` (the reference CLI's help example) on a small
    Tempo grid: the summary JSON, fault keys included, as the reference
    CLI's; ``--shards > 1`` is refused as it is there."""
    from fantoch_tpu.cli import main as r_main
    from fantoch_tpu_torch.cli import main

    grid = ["sweep", "--protocol", "tempo", "--n", "3", "--subsets", "2",
            "--fs", "1", "--commands", "3", "--conflicts", "100",
            "--faults", '[{}, {"crash": {"1": 200}}, {"windows": [{"src": '
            '0, "dst": 1, "t0": 0, "t1": 500, "delay": "inf"}], '
            '"horizon": 5000}]']
    r_main(["--platform", "cpu", *grid])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    main(["--device", "cpu", *grid])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want
    assert got["points"] == 6 and got["fault_lanes"] == 4
    with pytest.raises(SystemExit, match="single-shard"):
        main(["--device", "cpu", "sweep", "--protocol", "tempo", "--n", "3",
              "--shards", "2", "--subsets", "1", "--commands", "1",
              "--conflicts", "100", "--faults", '{"crash": {"1": 200}}'])
