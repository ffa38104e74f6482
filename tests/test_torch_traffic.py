"""Time-varying traffic schedules through the port on the CPU, against the
reference's ``fantoch_tpu/traffic`` and engine.

- the host side: ``TrafficSchedule.compile``/``meta``/``zipf_tables``
  and ``ArrivalSchedule.arrival_table``/``meta`` of every preset and a
  few seeds and bases, equal to the reference's value for value;
- the key table (K3's plain twin) against the reference's
  ``key_table_fn`` under churn (the epoch boundary), flash, diurnal and
  an epoch-Zipf schedule;
- a flat schedule collapses onto the static lane: the same ctx keys and
  bytes, the same ``to_json``;
- ``LaneResults.to_json()`` byte-identical to the reference's
  ``run_lanes`` for Tempo under each preset and under the reference
  tests' time-varying schedule with a crash and a window (their
  ``test_engine_oracle_bitexact_traffic_faults_*`` lanes), and for FPaxos
  under churn and diurnal with their FPaxos lane's fault plan.

Tolerance: none (integer state and float32 tables compared exactly)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fantoch_tpu import registry as rreg
from fantoch_tpu.core import Config as RConfig
from fantoch_tpu.core import Planet as RPlanet
from fantoch_tpu.engine import EngineDims as RDims
from fantoch_tpu.engine import make_lane as r_make_lane
from fantoch_tpu.engine import run_lanes as r_run_lanes
from fantoch_tpu.engine import stack_lanes as r_stack_lanes
from fantoch_tpu.engine.core import key_table_fn, keygen_ctx_fields
from fantoch_tpu.engine.faults import FaultPlan as RFaultPlan
from fantoch_tpu.engine.protocols import dev_config_kwargs as r_cfg_kwargs
from fantoch_tpu.engine.protocols import dev_protocol as r_dev_protocol
from fantoch_tpu.traffic import schedule as rsched
from fantoch_tpu_torch import carry
from fantoch_tpu_torch.core import Config, Planet
from fantoch_tpu_torch.engine import EngineDims, make_lane, run_lanes
from fantoch_tpu_torch.engine.faults import FaultPlan
from fantoch_tpu_torch.engine.protocols import (
    dev_config_kwargs, dev_protocol,
)
from fantoch_tpu_torch.engine.spec import stack_lanes
from fantoch_tpu_torch.kernels.key_table import key_table, traffic_tables
from fantoch_tpu_torch.traffic import schedule as psched
from torch_threads import one_torch_thread  # noqa: F401

COMMANDS = 8
N = 3
# the reference tests' time-varying schedule: conflict shift, pool churn,
# think curve, read mix (tests/test_traffic.py _tv_schedule)
TV = {"name": "tv", "cycle": False, "phases": [
    {"commands": 3, "conflict_rate": 100, "pool_size": 1, "pool_base": 0,
     "think_ms": 4, "read_pct": 60},
    {"commands": 2, "conflict_rate": 50, "pool_size": 2, "pool_base": 1,
     "think_ms": 0, "read_pct": 20},
    {"commands": 3, "conflict_rate": 100, "pool_size": 1, "pool_base": 3,
     "think_ms": 1, "read_pct": 40},
]}
# an epoch-Zipf schedule: the coefficient changes per epoch (0.0 = the
# lane's base coefficient)
ZIPF = {"name": "zipf", "cycle": True, "phases": [
    {"commands": 2, "conflict_rate": 50, "zipf_coef": 0.5},
    {"commands": 3, "conflict_rate": 50},
    {"commands": 2, "conflict_rate": 50, "zipf_coef": 2.0},
]}
# the fault plans of the reference tests' Tempo and FPaxos lanes
TEMPO_PLAN = {"crash": {"2": 260},
              "windows": [{"src": 0, "dst": 1, "t0": 40, "t1": 220,
                           "mult": 3}]}
FPAXOS_PLAN = {"crash": {"2": 300},
               "windows": [{"src": 1, "dst": 0, "t0": 0, "t1": 150,
                            "mult": 2}]}


class Side:
    """One engine's lane-building entry points."""

    def __init__(self, ref: bool):
        self.ref = ref
        self.config = RConfig if ref else Config
        self.planet = RPlanet if ref else Planet
        self.dims = RDims if ref else EngineDims
        self.make_lane = r_make_lane if ref else make_lane
        self.dev_protocol = r_dev_protocol if ref else dev_protocol
        self.cfg_kwargs = r_cfg_kwargs if ref else dev_config_kwargs
        self.plan = RFaultPlan if ref else FaultPlan
        self.sched = rsched if ref else psched
        self.run = r_run_lanes if ref else (
            lambda p, d, s: run_lanes(p, d, s, device="cpu"))

    def schedule(self, obj):
        return (self.sched.TrafficSchedule.from_json(obj)
                if isinstance(obj, dict) else obj)


def _batch(side: Side, name: str, lanes, zipf=None, keys=16):
    """``(protocol, dims, specs)``: one lane per ``(traffic, conflict,
    seed, plan)`` of ``lanes``, n = 3, one client a region."""
    regions = side.planet.new().regions()[:N]
    proto = side.dev_protocol(name, N, keys=keys)
    total = COMMANDS * N
    dims = side.dims.for_protocol(
        proto, n=N, clients=N, payload=proto.payload_width(N),
        total_commands=total, dot_slots=total + 1, regions=N,
    )
    specs = [
        side.make_lane(
            proto, side.planet.new(),
            side.config(**side.cfg_kwargs(name, N, 1)),
            conflict_rate=conflict, pool_size=2 if zipf is None else 1,
            zipf=zipf, commands_per_client=COMMANDS, clients_per_region=1,
            process_regions=regions, client_regions=regions, dims=dims,
            seed=seed, traffic=side.schedule(traffic),
            faults=side.plan.from_json(plan) if plan else None,
        )
        for traffic, conflict, seed, plan in lanes
    ]
    return proto, dims, specs


# every preset over conflict rates and seeds; the reference tests' lanes
TEMPO_BATCHES = [
    [("diurnal", 50, 0, None), ("churn", 10, 1, None),
     ("diurnal", 100, 2, None), ("churn", 100, 3, None)],
    [("flash", 0, 0, None), ("flash", 50, 1, None), (TV, 100, 0, TEMPO_PLAN)],
]
FPAXOS_BATCHES = [
    [("churn", 100, 1, FPAXOS_PLAN), ("diurnal", 100, 1, FPAXOS_PLAN),
     ("churn", 50, 2, None)],
]


def dumps(results):
    return json.dumps([r.to_json() for r in results], sort_keys=True) + "\n"


def _run_all(side: Side):
    out = []
    for name, batches in (("tempo", TEMPO_BATCHES),
                          ("fpaxos", FPAXOS_BATCHES)):
        for lanes in batches:
            out.extend(side.run(*_batch(side, name, lanes)))
    return out


# ----------------------------------------------------------------------
# the host side
# ----------------------------------------------------------------------

def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and np.array_equal(x, y), k


@pytest.mark.parametrize("conflict,pool_size,commands",
                         [(0, 1, 8), (50, 2, 20), (100, 3, 50)])
def test_traffic_presets_compile_as_the_reference(conflict, pool_size,
                                                  commands):
    assert psched.TRAFFIC_PRESETS == rreg.TRAFFIC_PRESETS
    for name in psched.TRAFFIC_PRESETS:
        kw = dict(conflict=conflict, pool_size=pool_size, commands=commands)
        assert psched.traffic_preset(name, **kw) == rreg.traffic_preset(
            name, **kw)
        mine = psched.resolve_traffic(name, **kw)
        ref = rsched.resolve_traffic(name, **kw)
        if ref is None:
            assert mine is None
            continue
        assert mine.meta() == ref.meta()
        assert mine.is_flat() == ref.is_flat()
        assert mine.to_json() == ref.to_json()
        _same(mine.compile(commands), ref.compile(commands))
        _same(mine.zipf_tables(1.0, 12), ref.zipf_tables(1.0, 12))
    for obj in (TV, ZIPF):
        mine = psched.TrafficSchedule.from_json(obj)
        ref = rsched.TrafficSchedule.from_json(obj)
        assert mine.meta() == ref.meta()
        _same(mine.compile(commands), ref.compile(commands))
        _same(mine.zipf_tables(0.8, 20), ref.zipf_tables(0.8, 20))
    kw = dict(conflict=conflict, pool_size=pool_size, commands=commands)
    assert (psched.traffic_key_capacity(list(psched.TRAFFIC_PRESETS),
                                        clients=5, **kw)
            == rsched.traffic_key_capacity(list(rreg.TRAFFIC_PRESETS),
                                           clients=5, **kw))
    with pytest.raises(ValueError):
        psched.traffic_preset("rush_hour", **kw)


@pytest.mark.parametrize("seed,load,gap", [(0, 100, 4), (3, 200, 4),
                                           (7, 400, 8), (11, 50, 1)])
def test_arrival_presets_draw_as_the_reference(seed, load, gap):
    assert psched.ARRIVAL_PRESETS == rreg.ARRIVAL_PRESETS
    for name in psched.ARRIVAL_PRESETS:
        mine = psched.resolve_arrivals(name, mean_gap_ms=gap, commands=20,
                                       load_pct=load)
        ref = rsched.resolve_arrivals(name, mean_gap_ms=gap, commands=20,
                                      load_pct=load)
        if ref is None:
            assert mine is None
            continue
        assert mine.meta() == ref.meta() and mine.to_json() == ref.to_json()
        a = mine.arrival_table(seed=seed, clients=4, commands=20)
        b = ref.arrival_table(seed=seed, clients=4, commands=20)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError):
        psched.arrival_preset("rush_hour", mean_gap_ms=gap, commands=5)


# ----------------------------------------------------------------------
# the key table (K3's twin) under a schedule
# ----------------------------------------------------------------------

@pytest.mark.parametrize("traffic", ["churn", "flash", "diurnal", "zipf"])
def test_key_table_matches_reference_under_schedules(traffic):
    """Every lane's [C, T] key table, the columns past the budget (the
    epoch clamp) included, equals the reference's ``key_table_fn``; on
    churn the keys move with the pool base at the epoch boundary."""
    zipf = (1.0, 12) if traffic == "zipf" else None
    sched = ZIPF if traffic == "zipf" else traffic
    lanes = [(sched, c, s, None) for s, c in enumerate((0, 10, 50, 100))]
    r_proto, r_dims, r_specs = _batch(Side(True), "tempo", lanes, zipf)
    _p, dims, specs = _batch(Side(False), "tempo", lanes, zipf)
    rctx, ctx = r_stack_lanes(r_specs), stack_lanes(specs)
    _same(rctx, ctx)
    T = COMMANDS + 4
    kctx = {k: jnp.asarray(rctx[k]) for k in keygen_ctx_fields(rctx)}
    want = np.asarray(jax.vmap(key_table_fn(r_dims.C, T))(kctx))
    c = carry.to_torch(ctx, "cpu")
    got = key_table(c["rng_key"], c["conflict_rate"], c["pool_size"],
                    c["key_gen_kind"], c["zipf_cum"], dims.C, T,
                    traffic_tables(c)).numpy()
    assert np.array_equal(want, got)
    if traffic == "churn":
        # conflict 100: every key is in the epoch's pool [base, base + 2)
        base = ctx["traffic_pool_base"][3][ctx["traffic_seq_epoch"][3]]
        keys = got[3, :N, 1:COMMANDS + 1]
        assert ((keys >= base[1:COMMANDS + 1])
                & (keys < base[1:COMMANDS + 1] + 2)).all()
        assert len(set(base[1:COMMANDS + 1].tolist())) == 4


# ----------------------------------------------------------------------
# flat collapse
# ----------------------------------------------------------------------

def test_flat_schedule_is_the_static_lane():
    """``traffic="flat"`` and a one-phase schedule without think,
    rotation or Zipf coefficient give the static lane: the same ctx keys
    and bytes, no traffic metadata and the same results."""
    side = Side(False)
    one = {"name": "one", "phases": [
        {"commands": COMMANDS, "conflict_rate": 50, "pool_size": 2}]}
    _p, _d, static = _batch(side, "tempo", [(None, 50, 0, None)])
    proto, dims, flat = _batch(side, "tempo", [("flat", 50, 0, None),
                                               (one, 10, 0, None)])
    for spec in flat:
        assert spec.traffic_meta is None and spec.arrival_meta is None
        _same(spec.ctx, static[0].ctx)
    assert dumps(side.run(proto, dims, flat)) == dumps(
        side.run(proto, dims, static * 2))


# ----------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_json():
    return dumps(_run_all(Side(True)))


def test_to_json_byte_identical_to_reference(reference_json):
    assert dumps(_run_all(Side(False))) == reference_json


def test_lanes_carry_the_reference_metadata():
    for name, batches in (("tempo", TEMPO_BATCHES),
                          ("fpaxos", FPAXOS_BATCHES)):
        for lanes in batches:
            _p, _d, mine = _batch(Side(False), name, lanes)
            _p, _d, ref = _batch(Side(True), name, lanes)
            for a, b in zip(mine, ref):
                assert a.traffic_meta == b.traffic_meta is not None
                assert a.fault_meta == b.fault_meta
                _same(a.ctx, b.ctx)


def test_cli_traffic_summary_matches_reference(capsys):
    """``sweep --traffic churn`` on a small Tempo grid: the summary JSON,
    its ``traffic`` field included, as the reference CLI's (the protocol's
    key table sized by ``traffic_key_capacity``)."""
    from fantoch_tpu.cli import main as r_main
    from fantoch_tpu_torch.cli import main

    grid = ["sweep", "--protocol", "tempo", "--n", "3", "--subsets", "2",
            "--fs", "1", "--commands", "4", "--conflicts", "0,100",
            "--traffic", "churn"]
    r_main(["--platform", "cpu", *grid])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    main(["--device", "cpu", *grid])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want
    assert got["traffic"] == "churn" and got["errors"] == 0
