"""The knee sweep (``fantoch_tpu_torch/serving/knee.py``) against the
reference's ``fantoch_tpu/serving/knee.py`` on the CPU.

``locate_knee`` and ``check_knee_artifact`` take and refuse what the
reference's do (``tests/test_serving.py``'s cases); the dry run writes
the reference's ``knee.json`` bytes; a two-load Basic open-loop grid
(Poisson arrivals, loads 50 and 200) writes the reference's
``knee.json``, also when a zero budget stops it mid-grid and it resumes,
and through ``python -m fantoch_tpu_torch knee`` (exit 75, then 0). The
reference's own Tempo knee runs are in the slow tier. Tolerance:
none."""

import contextlib
import io
import json

import pytest

from fantoch_tpu import serving as rserving
from fantoch_tpu_torch import serving
from fantoch_tpu_torch.serving import (
    check_knee_artifact, locate_knee, run_knee_sweep,
)
from torch_threads import one_torch_thread  # noqa: F401

# a Basic grid of two offered loads: one lane a load, two units
KW = dict(protocols=("basic",), ns=(3,), arrival="poisson", loads=(50, 200),
          commands_per_client=6, open_window=2, segment_steps=512)


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_exports_match_the_reference():
    assert serving.__all__ == rserving.__all__
    for name in ("KNEE_ARTIFACT", "KNEE_KIND", "KNEE_VERSION"):
        assert getattr(serving, name) == getattr(rserving, name)


@pytest.mark.parametrize("curve,mult", [
    ({"50": {"p99": 100.0}, "100": {"p99": 150.0}, "200": {"p99": 350.0},
      "400": {"p99": 900.0}}, 3.0),
    ({"50": {"p99": 100.0}, "100": {"p99": 150.0}, "200": {"p99": 350.0},
      "400": {"p99": 900.0}}, 2.0),
    ({"50": {"p99": 100.0}, "100": {"p99": 150.0}, "200": {"p99": 350.0},
      "400": {"p99": 900.0}}, 10.0),
    ({"50": {"p99": None}, "100": {"p99": 9.0}}, 3.0),
    ({"50": {"p99": 10.0}, "100": {"p99": None}, "200": {"p99": 99.0}}, 3.0),
    ({"25": {"p99": 0.0}, "400": {"p99": 1.0}}, 3.0),
])
def test_locate_knee_matches_the_reference(curve, mult):
    assert locate_knee(curve, mult) == rserving.locate_knee(curve, mult)


def _gate(check, obj):
    try:
        check(obj)
    except AssertionError as e:
        return str(e)
    return None


def test_knee_artifact_gate_matches_the_reference(tmp_path):
    artifact, summary = run_knee_sweep(
        str(tmp_path / "dry"), protocols=("tempo", "fpaxos"),
        loads=(50, 200), dryrun=True)
    want, _ = rserving.run_knee_sweep(
        str(tmp_path / "rdry"), protocols=("tempo", "fpaxos"),
        loads=(50, 200), dryrun=True)
    assert artifact == want and summary["done"] and summary["dryrun"]
    assert _read(tmp_path / "dry" / "knee.json") == _read(
        tmp_path / "rdry" / "knee.json")
    base = json.loads(json.dumps(artifact))
    base["dryrun"] = False
    stats = {"mean": 1.0, "p50": 1.0, "p99": 1.0, "count": 4,
             "goodput_cps": 10.0, "lanes": 1, "errors": 0}
    err_stats = {"mean": None, "p50": None, "p99": None, "count": 0,
                 "goodput_cps": None, "lanes": 1, "errors": 1,
                 "error_cause": "pool-overflow"}

    def point(proto, curve, knee):
        return {"regions": ["a", "b", "c"], "protocol": proto,
                "curve": curve, "knee": knee}

    good = dict(base, points=[
        point(p, {"50": dict(stats), "200": dict(stats)}, None)
        for p in ("tempo", "fpaxos")])
    cases = [
        artifact, good,
        dict(base, points=[point(p, {"50": dict(stats),
                                     "200": dict(err_stats)}, None)
                           for p in ("tempo", "fpaxos")]),
        dict(base, points=[point(p, {"50": dict(stats), "200": dict(
            err_stats, p99=0.0, error_cause=None)}, None)
            for p in ("tempo", "fpaxos")]),
        dict(good, points=[dict(good["points"][0], knee=75),
                           good["points"][1]]),
        dict(good, points=good["points"][:1]),
        dict(base, points=[point(p, {"50": dict(stats)}, None)
                           for p in ("tempo", "fpaxos")]),
        dict(good, kind="nope"),
        dict(good, arrival="closed"),
        dict(artifact, points=[]),
        {k: v for k, v in good.items() if k != "loads"},
    ]
    got = [_gate(check_knee_artifact, c) for c in cases]
    assert got == [_gate(rserving.check_knee_artifact, c) for c in cases]
    assert got[:3] == [None, None, None]
    assert all(g is not None for g in got[3:])


@pytest.fixture(scope="module")
def ref_knee(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref")
    artifact, summary = rserving.run_knee_sweep(str(path), **KW)
    assert summary["done"]
    return path, artifact


def test_knee_sweep_matches_the_reference(tmp_path, ref_knee):
    ref, want = ref_knee
    artifact, summary = run_knee_sweep(str(tmp_path), device="cpu", **KW)
    assert summary["done"] and artifact == want
    check_knee_artifact(artifact)
    assert [p["protocol"] for p in artifact["points"]] == ["basic"]
    for name in ("knee.json", "campaign.json", "results.jsonl"):
        assert _read(tmp_path / name) == _read(ref / name), name


def test_knee_sweep_interrupted_and_resumed(tmp_path, ref_knee):
    ref, _want = ref_knee
    art0, s0 = run_knee_sweep(str(tmp_path), budget_s=0.0, device="cpu",
                              **KW)
    assert art0 is None and not s0["done"]
    assert s0["interrupted"] == "budget exhausted"
    assert s0["batches_done"] == 1
    art1, s1 = run_knee_sweep(str(tmp_path), resume=True, device="cpu",
                              **KW)
    assert s1["done"] and s1["artifact"] == str(tmp_path / "knee.json")
    assert _read(tmp_path / "knee.json") == _read(ref / "knee.json")


def test_knee_cli_interrupted_and_resumed(tmp_path, ref_knee):
    from fantoch_tpu_torch.cli import main

    ref, _want = ref_knee
    argv = ["--device", "cpu", "knee", "--dir", str(tmp_path),
            "--protocols", "basic", "--loads", "50,200", "--commands", "6",
            "--open-window", "2", "--segment-steps", "512"]
    codes = []
    for extra in (["--budget-s", "0"], ["--resume"]):
        err = io.StringIO()
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(err):
            try:
                main(argv + extra)
                codes.append(0)
            except SystemExit as e:
                codes.append(e.code)
    assert codes == [75, 0]
    assert _read(tmp_path / "knee.json") == _read(ref / "knee.json")


def test_run_knee_sweep_needs_a_gpu_unless_given_the_cpu(tmp_path,
                                                          monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_knee_sweep(str(tmp_path / "k"), **KW)


@pytest.mark.slow
def test_tempo_knee_interrupted_and_resumed_as_the_reference(tmp_path):
    """The reference's own Tempo knee run (tests/test_serving.py)."""
    kw = dict(KW, protocols=("tempo",))
    _art, s = rserving.run_knee_sweep(str(tmp_path / "ref"), **kw)
    assert s["done"]
    run_knee_sweep(str(tmp_path / "c"), budget_s=0.0, device="cpu", **kw)
    _art, s = run_knee_sweep(str(tmp_path / "c"), resume=True,
                             device="cpu", **kw)
    assert s["done"]
    assert _read(tmp_path / "c" / "knee.json") == _read(
        tmp_path / "ref" / "knee.json")


@pytest.mark.slow
def test_knee_of_two_protocols_as_the_reference(tmp_path):
    """The reference's saturating grid (loads 25/400/3,200, 48 commands):
    both protocols' knees at load 400, the reference's bytes."""
    kw = dict(protocols=("tempo", "fpaxos"), ns=(3,), arrival="poisson",
              loads=(25, 400, 3200), commands_per_client=48,
              open_window=4, segment_steps=1024)
    want, s = rserving.run_knee_sweep(str(tmp_path / "ref"), **kw)
    assert s["done"]
    got, s = run_knee_sweep(str(tmp_path / "c"), device="cpu", **kw)
    assert s["done"] and got == want
    assert [p["knee"] for p in got["points"]] == [400, 400]
