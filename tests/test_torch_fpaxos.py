"""FPaxos end to end through the port on the CPU: the three
configurations of ``tests/test_engine_fpaxos.py`` ((f, leader) ∈ {(1, 1),
(1, 3), (2, 2)}, n = 3, 50 commands per client) in one batch, whose
``LaneResults.to_json()`` must equal the reference's ``run_lanes`` byte
for byte; the committed fixture the card's run is held to; and the CLI
summary of a small FPaxos sweep."""

import json
from pathlib import Path

import pytest
import torch

from fantoch_tpu.core import Config as RConfig
from fantoch_tpu.core import Planet as RPlanet
from fantoch_tpu.engine import EngineDims as RDims
from fantoch_tpu.engine import make_lane as r_make_lane
from fantoch_tpu.engine import run_lanes as r_run_lanes
from fantoch_tpu.engine.protocols import FPaxosDev as RFPaxos
from fantoch_tpu_torch.core import Config, Planet
from fantoch_tpu_torch.engine import EngineDims, make_lane, run_lanes
from fantoch_tpu_torch.engine.protocols import FPaxosDev
from torch_threads import one_torch_thread  # noqa: F401

FIXTURE = Path(__file__).parent / "fixtures" / "torch_fpaxos_golden.json"
COMMANDS = 50
PROCESS_REGIONS = ["asia-east1", "us-central1", "us-west1"]
CLIENT_REGIONS = ["us-west1", "us-west2"]
# the golden batch, seeded by index (chip_smoke.py builds the identical
# batch on the card)
POINTS = [(1, 1), (1, 3), (2, 2)]


def _golden(cfg, planet, dims_cls, make, proto):
    total = COMMANDS * len(CLIENT_REGIONS)
    dims = dims_cls.for_protocol(
        proto, n=3, clients=2, payload=proto.payload_width(3),
        total_commands=total, dot_slots=total + 1, regions=2,
    )
    specs = [
        make(proto, planet, cfg(n=3, f=f, leader=leader, gc_interval_ms=100),
             conflict_rate=100, pool_size=1, commands_per_client=COMMANDS,
             clients_per_region=1, process_regions=PROCESS_REGIONS,
             client_regions=CLIENT_REGIONS, dims=dims, extra_time_ms=1000,
             seed=i)
        for i, (f, leader) in enumerate(POINTS)
    ]
    return dims, specs


def _dumps(results):
    return json.dumps([r.to_json() for r in results], sort_keys=True) + "\n"


@pytest.fixture(scope="module")
def reference_json():
    dims, specs = _golden(RConfig, RPlanet.new(), RDims, r_make_lane,
                          RFPaxos)
    return _dumps(r_run_lanes(RFPaxos, dims, specs))


@pytest.fixture(scope="module")
def port_results():
    dims, specs = _golden(Config, Planet.new(), EngineDims, make_lane,
                          FPaxosDev)
    return run_lanes(FPaxosDev, dims, specs, device="cpu")


def test_golden_batch_is_clean(port_results):
    """Every command completes, and the f+1 write-quorum acceptors GC
    every slot (the reference test's stable total, 2 x commands each)."""
    for (f, _leader), res in zip(POINTS, port_results):
        assert not res.err
        for region in CLIENT_REGIONS:
            assert res.issued(region) == COMMANDS
        stable = res.protocol_metrics["stable"]
        assert int(stable.sum()) == (f + 1) * 2 * COMMANDS
        assert set(stable.tolist()) <= {0, 2 * COMMANDS}


def test_to_json_byte_identical_to_reference(port_results, reference_json):
    assert _dumps(port_results) == reference_json


def test_fixture_is_the_reference_output(reference_json):
    """The committed fixture (what chip_smoke.py holds the card's run
    to) is regenerated from the reference and must not have changed."""
    assert FIXTURE.read_text() == reference_json


def test_cli_summary_matches_reference(capsys):
    from fantoch_tpu.cli import main as r_main
    from fantoch_tpu_torch.cli import main

    grid = ["sweep", "--protocol", "fpaxos", "--n", "3", "--subsets", "2",
            "--fs", "1,2", "--commands", "3", "--conflicts", "0,100"]
    r_main(["--platform", "cpu", *grid])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    main(["--device", "cpu", *grid])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want
    assert got["points"] == 8 and got["errors"] == 0


def test_sweep_without_a_gpu_raises(monkeypatch):
    """The FPaxos sweep runs on the card unless ``--device cpu``."""
    from fantoch_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["sweep", "--protocol", "fpaxos", "--n", "3", "--subsets", "1",
              "--commands", "1", "--conflicts", "0"])
