"""Basic end to end through the port on the CPU: the reference's golden
numbers (tests/test_engine_basic.py), ``LaneResults.to_json()`` byte for
byte against the reference's ``run_lanes``, the committed fixture the
card's run is held to, and the CLI summary."""

import json
from pathlib import Path

import pytest

from fantoch_tpu.core import Config as RConfig
from fantoch_tpu.core import Planet as RPlanet
from fantoch_tpu.engine import EngineDims as RDims
from fantoch_tpu.engine import make_lane as r_make_lane
from fantoch_tpu.engine import run_lanes as r_run_lanes
from fantoch_tpu.engine.protocols import BasicDev as RBasic
from fantoch_tpu_torch.core import Config, Planet
from fantoch_tpu_torch.engine import EngineDims, make_lane, run_lanes
from fantoch_tpu_torch.engine.protocols import BasicDev
from torch_threads import one_torch_thread  # noqa: F401

FIXTURE = Path(__file__).parent / "fixtures" / "torch_basic_golden.json"
COMMANDS = 100
PROCESS_REGIONS = ["asia-east1", "us-central1", "us-west1"]
CLIENT_REGIONS = ["us-west1", "us-west2"]
# the golden batch: f ∈ {0, 1, 2} × conflict ∈ {0, 100}, seeded by index
# (chip_smoke.py builds the identical batch on the card)
POINTS = [(f, cf) for f in (0, 1, 2) for cf in (0, 100)]


def _golden(cfg, planet, dims_cls, make, proto):
    dims = dims_cls.for_protocol(
        proto, n=3, clients=2, payload=3, total_commands=2 * COMMANDS,
        dot_slots=2 * COMMANDS + 1, regions=2,
    )
    specs = [
        make(proto, planet, cfg(n=3, f=f, gc_interval_ms=100),
             conflict_rate=cf, pool_size=1, commands_per_client=COMMANDS,
             clients_per_region=1, process_regions=PROCESS_REGIONS,
             client_regions=CLIENT_REGIONS, dims=dims, extra_time_ms=1000,
             seed=i)
        for i, (f, cf) in enumerate(POINTS)
    ]
    return dims, specs


def _dumps(results):
    return json.dumps([r.to_json() for r in results], sort_keys=True) + "\n"


@pytest.fixture(scope="module")
def reference_json():
    dims, specs = _golden(RConfig, RPlanet.new(), RDims, r_make_lane, RBasic)
    return _dumps(r_run_lanes(RBasic, dims, specs))


@pytest.fixture(scope="module")
def port_results():
    dims, specs = _golden(Config, Planet.new(), EngineDims, make_lane,
                          BasicDev)
    return run_lanes(BasicDev, dims, specs, device="cpu")


def test_golden_numbers(port_results):
    expected = {0: (0.0, 24.0), 1: (34.0, 58.0), 2: (118.0, 142.0)}
    for (f, cf), res in zip(POINTS, port_results):
        assert not res.err
        assert res.issued("us-west1") == res.issued("us-west2") == COMMANDS
        assert list(res.protocol_metrics["stable"]) == [2 * COMMANDS] * 3
        if cf == 100:
            assert (res.latency_mean("us-west1"),
                    res.latency_mean("us-west2")) == expected[f]


def test_to_json_byte_identical_to_reference(port_results, reference_json):
    assert _dumps(port_results) == reference_json


def test_fixture_is_the_reference_output(reference_json):
    """The committed fixture (what chip_smoke.py holds the card's run
    to) is regenerated from the reference and must not have changed."""
    assert FIXTURE.read_text() == reference_json


def test_cli_summary_matches_reference(capsys):
    from fantoch_tpu.cli import main as r_main
    from fantoch_tpu_torch.cli import main

    grid = ["sweep", "--protocol", "basic", "--n", "3", "--subsets", "2",
            "--fs", "1,2", "--commands", "3", "--conflicts", "0,100"]
    r_main(["--platform", "cpu", *grid])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    main(["--device", "cpu", *grid])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want
    assert got["points"] == 8 and got["errors"] == 0
