"""Open-loop arrivals through the port on the CPU, against the reference's
engine (``fantoch_tpu.engine.run_lanes``):

- ``LaneResults.to_json()`` byte-identical to the reference's for the
  lanes of the reference's ``tests/test_serving.py``: Tempo under burst
  arrivals with a crash and a link window at a window of 3, Tempo under
  Poisson arrivals at load 200 with drops, FPaxos under burst arrivals
  with a crash and a window, FPaxos under ramp arrivals at load 150 with
  drops (its horizon cut from 5,000 to 250 ms: a lost FPaxos message
  stalls the lane, which then steps to its horizon, some 5.7 steps a
  millisecond, and the plain twins take 12 ms a step on the CPU; at 250
  ms four messages are lost and ten commands complete);
- the six protocols' open-loop lanes are in
  ``test_torch_serving_protocols.py``;
- the window saturation of the reference's
  ``test_open_window_saturation_counts_queue_delay``: at load 400 a
  window of 1 shows a larger mean latency than a window of the budget
  on the same arrivals (the queue delay counts), and both complete
  every command;
- a flat, closed-loop lane (``arrivals="closed"``) is today's static
  lane, byte for byte;
- the committed fixture ``tests/fixtures/torch_open_loop_golden.json``
  (the reference's bytes of the four serving lanes, which
  ``chip_smoke.py`` holds the card's run to).

Tolerance: none (integer state)."""

import json
from pathlib import Path

import pytest

from fantoch_tpu.core import Config as RConfig
from fantoch_tpu.core import Planet as RPlanet
from fantoch_tpu.engine import EngineDims as RDims
from fantoch_tpu.engine import make_lane as r_make_lane
from fantoch_tpu.engine import run_lanes as r_run_lanes
from fantoch_tpu.engine.faults import FaultPlan as RFaultPlan
from fantoch_tpu.engine.protocols import dev_config_kwargs as r_cfg_kwargs
from fantoch_tpu.engine.protocols import dev_protocol as r_dev_protocol
from fantoch_tpu_torch.core import Config, Planet
from fantoch_tpu_torch.engine import EngineDims, make_lane, run_lanes
from fantoch_tpu_torch.engine.faults import FaultPlan
from fantoch_tpu_torch.engine.protocols import (
    dev_config_kwargs, dev_protocol,
)
from torch_threads import one_torch_thread  # noqa: F401

FIXTURE = Path(__file__).parent / "fixtures" / "torch_open_loop_golden.json"
N = 3
# the reference's tests/test_serving.py lanes: (protocol, commands,
# arrivals, load, window, seed, plan)
SERVING_LANES = {
    "tempo_faults": ("tempo", 8, "burst", 100, 3, 0, {
        "crash": {"2": 260},
        "windows": [{"src": 0, "dst": 1, "t0": 40, "t1": 220, "mult": 3}]}),
    "tempo_drops": ("tempo", 8, "poisson", 200, 2, 2, {
        "drop_bp": 500, "seed": 9, "horizon": 5000}),
    "fpaxos_faults": ("fpaxos", 8, "burst", 100, 3, 1, {
        "crash": {"2": 300},
        "windows": [{"src": 1, "dst": 0, "t0": 0, "t1": 150, "mult": 2}]}),
    "fpaxos_drops": ("fpaxos", 8, "ramp", 150, 4, 4, {
        "drop_bp": 400, "seed": 5, "horizon": 250}),
}


class Side:
    """One engine's lane-building entry points."""

    def __init__(self, ref: bool):
        self.config = RConfig if ref else Config
        self.planet = RPlanet if ref else Planet
        self.dims = RDims if ref else EngineDims
        self.make_lane = r_make_lane if ref else make_lane
        self.dev_protocol = r_dev_protocol if ref else dev_protocol
        self.cfg_kwargs = r_cfg_kwargs if ref else dev_config_kwargs
        self.plan = RFaultPlan if ref else FaultPlan
        self.run = r_run_lanes if ref else (
            lambda p, d, s: run_lanes(p, d, s, device="cpu"))


def _lanes(side: Side, name, commands, arrivals, loads_windows, seed=0,
           plan=None):
    """``(protocol, dims, specs)``: one lane per ``(load, window)``."""
    regions = side.planet.new().regions()[:N]
    proto = side.dev_protocol(name, N)
    total = commands * N
    dims = side.dims.for_protocol(
        proto, n=N, clients=N, payload=proto.payload_width(N),
        total_commands=total, dot_slots=total + 1, regions=N,
    )
    specs = [
        side.make_lane(
            proto, side.planet.new(),
            side.config(**side.cfg_kwargs(name, N, 1)),
            conflict_rate=100, pool_size=1, commands_per_client=commands,
            clients_per_region=1, process_regions=regions,
            client_regions=regions, dims=dims, seed=seed,
            faults=side.plan.from_json(plan) if plan else None,
            arrivals=arrivals, arrival_load=load, open_window=window,
        )
        for load, window in loads_windows
    ]
    return proto, dims, specs


def dumps(results):
    return json.dumps([r.to_json() for r in results], sort_keys=True) + "\n"


def _both(*args, **kw):
    """The reference's and the port's ``to_json`` bytes of one batch,
    and the port's results."""
    ref = Side(True).run(*_lanes(Side(True), *args, **kw))
    port = Side(False).run(*_lanes(Side(False), *args, **kw))
    return dumps(ref), dumps(port), port


def _serving(side: Side, lane: str):
    name, commands, arrivals, load, window, seed, plan = SERVING_LANES[lane]
    return side.run(*_lanes(side, name, commands, arrivals,
                            [(load, window)], seed=seed, plan=plan))


@pytest.fixture(scope="module")
def reference_serving():
    return {lane: dumps(_serving(Side(True), lane))
            for lane in sorted(SERVING_LANES)}


@pytest.mark.parametrize("lane", sorted(SERVING_LANES))
def test_reference_serving_lanes_byte_identical(lane, reference_serving):
    results = _serving(Side(False), lane)
    assert dumps(results) == reference_serving[lane]
    assert results[0].faults is not None
    assert results[0].completed > 0


def test_fixture_is_the_reference_output(reference_serving):
    """The committed fixture (what chip_smoke.py holds the card's run
    to) is the reference's bytes of the serving lanes, in lane order."""
    assert FIXTURE.read_text() == "".join(
        reference_serving[lane] for lane in sorted(SERVING_LANES))


def test_open_window_saturation_counts_queue_delay():
    """At a saturating load, a window of 1 measures a larger mean latency
    than a window of the whole budget on the same arrivals: the
    arrival-queue wait is in the latency."""
    commands = 8
    proto, dims, specs = _lanes(Side(False), "tempo", commands, "poisson",
                                [(400, 1)])
    _p, dims2, wide = _lanes(Side(False), "tempo", commands, "poisson",
                             [(400, commands)])
    capped = run_lanes(proto, dims, specs, device="cpu")[0]
    uncapped = run_lanes(proto, dims2, wide, device="cpu")[0]
    means = []
    for res in (capped, uncapped):
        assert not res.err
        total = count = 0.0
        for region in res.region_rows:
            h = res.histogram(region)
            total += h.mean() * h.count()
            count += h.count()
        assert count == commands * N
        means.append(total / count)
    assert means[0] > means[1], means


def test_closed_arrivals_are_the_static_lane():
    side = Side(False)
    proto, dims, closed = _lanes(side, "tempo", 3, "closed", [(100, 4)])
    _p, _d, static = _lanes(side, "tempo", 3, None, [(100, 4)])
    assert closed[0].arrival_meta is None
    assert sorted(closed[0].ctx) == sorted(static[0].ctx)
    assert not any(k.startswith("ol_") for k in closed[0].ctx)
    assert dumps(side.run(proto, dims, closed)) == dumps(
        side.run(proto, dims, static))


def test_cli_arrivals_summary_matches_reference(capsys):
    """``sweep --arrivals poisson`` on a small Tempo grid at load 200 and
    a window of 2: the summary JSON, its ``arrivals`` field included, as
    the reference CLI's."""
    from fantoch_tpu.cli import main as r_main
    from fantoch_tpu_torch.cli import main

    grid = ["sweep", "--protocol", "tempo", "--n", "3", "--subsets", "2",
            "--fs", "1", "--commands", "3", "--conflicts", "0,100",
            "--arrivals", "poisson", "--offered-load", "200",
            "--open-window", "2"]
    r_main(["--platform", "cpu", *grid])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    main(["--device", "cpu", *grid])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want
    assert got["arrivals"] == "poisson" and got["errors"] == 0
