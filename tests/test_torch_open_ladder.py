"""The open-loop Tempo offered-load ladder's ERR_CAPACITY ends against the
reference's engine (``fantoch_tpu.engine.run_lanes``): about half of the
ladder's lanes end in ERR_CAPACITY on the card, since Tempo's tables are
sized for one command in flight a client; this holds one such lane at
conflict 10, built by each side's CLI from the ladder's command line, to
the reference's ``to_json`` bytes. Tolerance: none (integer state)."""

import json

import pytest

from fantoch_tpu.engine import run_lanes as r_run_lanes
from fantoch_tpu_torch.engine import run_lanes
from torch_threads import one_torch_thread  # noqa: F401


# a lane of the open-loop Tempo ladder's load-100 rung
# (cli.MAIN_PATH_TEMPO_OPEN: n = 5, the first 64 GCP subsets, Poisson
# arrivals of mean gap 4 ms, a window of 4): subset 39, f = 2, conflict
# 10, one of the rung's four conflict-10 lanes that end in ERR_CAPACITY
# (at step 434); chip_smoke.py holds the card's run of it to the host's
LADDER_LANE = 317


def test_ladder_capacity_lane_matches_reference(monkeypatch):
    """The ladder's ERR_CAPACITY ends are the reference's own: one
    conflict-10 lane that ends so, built by each side's CLI from the same
    command line, gives the same ``to_json`` bytes on the port (CPU) as
    on the reference's engine."""
    from fantoch_tpu import cli as r_cli
    from fantoch_tpu.parallel import sweep as r_sweep
    from fantoch_tpu_torch import cli

    argv = list(cli.MAIN_PATH_TEMPO_OPEN)
    proto, dims, specs = cli.sweep_setup(cli.parse_args(argv))
    spec = specs[LADDER_LANE]
    assert int(spec.ctx["conflict_rate"]) == 10
    (port,) = run_lanes(proto, dims, [spec], device="cpu")
    assert port.err_cause == "capacity-overflow"

    captured = {}

    def capture(dev, rdims, rspecs, **_kw):
        captured["lane"] = (dev, rdims, rspecs)
        raise SystemExit(0)

    # the reference CLI sizes its batches itself (no --batch-lanes)
    i = argv.index("--batch-lanes")
    monkeypatch.setattr(r_sweep, "run_sweep", capture)
    with pytest.raises(SystemExit):
        r_cli.main(["--platform", "cpu", *argv[:i], *argv[i + 2:]])
    rproto, rdims, rspecs = captured["lane"]
    assert len(rspecs) == len(specs)
    (ref,) = r_run_lanes(rproto, rdims, [rspecs[LADDER_LANE]])
    assert json.dumps(port.to_json(), sort_keys=True) == json.dumps(
        ref.to_json(), sort_keys=True)
