"""The campaign manager (``fantoch_tpu_torch/campaign``) against the
reference's ``fantoch_tpu/campaign`` on the CPU.

``tests/test_campaign.py``'s ``SWEEP_GRID`` (Basic, n = 3, four lanes in
two units of two) runs through the reference once; the port's
``campaign.json``, ``journal.jsonl`` and ``results.jsonl`` (with
``device="cpu"``) equal its bytes uninterrupted, after
``stop_after_segments`` and resume, under a budget, with a torn final
journal line and after a SIGTERM in a subprocess. A campaign the
reference starts and stops at a unit boundary, the port finishes with
the same ``results.jsonl``. The spec round trip and its refusals give
the reference's messages; ``aot``, ``shard_lanes`` and ``mesh_shard``
are refused by name before anything is written; a ``hetero: true`` grid
(Basic and FPaxos in mixed units) gives the reference's homogeneous
bytes, as the reference's own mixed layout does. Tolerance: none."""

import glob
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from fantoch_tpu.campaign import campaign_from_json as r_from_json
from fantoch_tpu.campaign import manager as rmanager
from fantoch_tpu.campaign import run_campaign as r_run
from fantoch_tpu_torch.campaign import (
    CampaignError, campaign_from_json, run_campaign,
)
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent

# tests/test_campaign.py's grid: scan_window 1 pins the per-segment
# ladder the stop_after_segments interruptions count on
SWEEP_GRID = {
    "kind": "sweep",
    "protocols": ["basic"],
    "ns": [3],
    "conflicts": [0, 100],
    "subsets": 2,
    "commands_per_client": 2,
    "batch_lanes": 2,
    "segment_steps": 8,
    "scan_window": 1,
}
FILES = ("campaign.json", "journal.jsonl", "results.jsonl")


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _run(path, spec=None, **kw):
    return run_campaign(str(path), spec, device="cpu", **kw)


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    """The reference's uninterrupted run of ``SWEEP_GRID``."""
    path = tmp_path_factory.mktemp("ref")
    summary = r_run(str(path), r_from_json(SWEEP_GRID))
    assert summary["done"] and summary["errors"] == 0
    return path


def _same_results(path, ref_dir):
    assert _read(path / "results.jsonl") == _read(ref_dir / "results.jsonl")


def test_spec_round_trip_and_refusals_match_the_reference():
    spec = campaign_from_json(SWEEP_GRID)
    assert campaign_from_json(spec.to_json()) == spec
    assert spec.to_json() == r_from_json(SWEEP_GRID).to_json()
    fuzz = {"kind": "fuzz", "protocols": ["tempo"], "coverage": True,
            "classes": ["crash", "mixed"], "binary_maps": True}
    assert campaign_from_json(fuzz).to_json() == \
        r_from_json(fuzz).to_json()
    for bad in (
        {"kind": "nope"},
        dict(SWEEP_GRID, protocols=["nope"]),
        dict(SWEEP_GRID, bogus=1),
        dict(SWEEP_GRID, protocols=[]),
        dict(SWEEP_GRID, traffic=["nope"]),
        dict(SWEEP_GRID, arrivals=["nope"]),
        dict(SWEEP_GRID, offered_loads=[0]),
        dict(SWEEP_GRID, arrivals=["poisson"], traffic=["diurnal"]),
        dict(SWEEP_GRID, scan_window=0),
        dict(fuzz, classes=["nope"]),
        dict(fuzz, classes=[]),
        dict(fuzz, classes=["crash", "crash"]),
        dict(fuzz, retire_after=-1),
        dict(fuzz, coverage=False, retire_after=2, binary_maps=False),
        dict(fuzz, coverage=False),
    ):
        with pytest.raises(rmanager.CampaignError) as want:
            r_from_json(bad)
        with pytest.raises(CampaignError) as got:
            campaign_from_json(bad)
        assert str(got.value) == str(want.value)


def test_uninterrupted_campaign_matches_the_reference(tmp_path, ref_dir):
    summary = _run(tmp_path, campaign_from_json(SWEEP_GRID))
    assert summary["done"] and summary["lanes"] == 4
    assert summary["errors"] == 0 and summary["batches_done"] == 2
    for name in FILES:
        assert _read(tmp_path / name) == _read(ref_dir / name), name
    assert not (tmp_path / "ckpt").exists()


def test_stop_after_segments_then_resume(tmp_path, ref_dir):
    s1 = _run(tmp_path, campaign_from_json(SWEEP_GRID),
              stop_after_segments=1)
    assert not s1["done"] and s1["interrupted"] == "segment-limit"
    assert glob.glob(str(tmp_path / "ckpt" / "*" / "manifest.json"))
    s2 = _run(tmp_path, resume=True)
    assert s2["done"]
    _same_results(tmp_path, ref_dir)


def test_budget_makes_progress_and_converges(tmp_path, ref_dir):
    summary = _run(tmp_path, campaign_from_json(SWEEP_GRID), budget_s=0.0)
    calls = 1
    while not summary["done"]:
        summary = _run(tmp_path, resume=True, budget_s=0.0)
        calls += 1
        assert calls < 50, "budgeted campaign failed to converge"
    assert summary["batches_done"] == summary["batches_total"] == 2
    _same_results(tmp_path, ref_dir)


def test_torn_final_journal_line_reruns_its_unit(tmp_path, ref_dir):
    _run(tmp_path, campaign_from_json(SWEEP_GRID))
    jpath = tmp_path / "journal.jsonl"
    lines = jpath.read_text().splitlines(keepends=True)
    jpath.write_text("".join(lines[:-1]) + lines[-1][: len(lines[-1]) // 2])
    os.remove(tmp_path / "results.jsonl")
    assert _run(tmp_path, resume=True)["done"]
    _same_results(tmp_path, ref_dir)


def test_sigterm_in_a_subprocess_then_resume(tmp_path, ref_dir):
    """A SIGTERM once the journal holds its first unit stops the CLI at
    the next boundary (exit 75; 0 if the grid had finished); resuming
    gives the reference's bytes."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "fantoch_tpu_torch", "--device", "cpu",
         "campaign", "--dir", str(tmp_path), "--grid",
         json.dumps(SWEEP_GRID)],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
    )
    try:
        deadline = time.monotonic() + 120
        jpath = tmp_path / "journal.jsonl"
        while time.monotonic() < deadline and proc.poll() is None:
            if jpath.exists() and jpath.stat().st_size:
                break
            time.sleep(0.005)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode in (0, 75), err
    summary = json.loads(out.strip().splitlines()[-1])
    if proc.returncode == 75:
        assert summary["interrupted"].startswith("signal"), summary
        summary = _run(tmp_path, resume=True)
    assert summary["done"]
    _same_results(tmp_path, ref_dir)


def test_the_port_finishes_a_campaign_the_reference_started(
        tmp_path, ref_dir, monkeypatch):
    """The reference runs the first unit and stops at the unit boundary
    (a SIGTERM delivered as its journal line lands); the port resumes
    the directory and writes the reference's results."""
    append = rmanager._append_journal

    def append_then_term(path, entry):
        append(path, entry)
        os.kill(os.getpid(), signal.SIGTERM)

    monkeypatch.setattr(rmanager, "_append_journal", append_then_term)
    s1 = r_run(str(tmp_path), r_from_json(SWEEP_GRID))
    monkeypatch.undo()
    assert not s1["done"] and s1["batches_done"] == 1
    assert s1["interrupted"] == f"signal {int(signal.SIGTERM)}"
    s2 = _run(tmp_path, resume=True)
    assert s2["done"] and s2["batches_done"] == 2
    for name in FILES:
        assert _read(tmp_path / name) == _read(ref_dir / name), name


def test_directory_refusals(tmp_path):
    with pytest.raises(CampaignError, match="resume"):
        _run(tmp_path / "missing", resume=True)
    path = tmp_path / "c"
    _run(path, campaign_from_json(SWEEP_GRID), stop_after_segments=1)
    other = campaign_from_json(dict(SWEEP_GRID, conflicts=[0, 50]))
    with pytest.raises(CampaignError, match="different campaign"):
        _run(path, other)
    with pytest.raises(CampaignError, match="disagrees"):
        _run(path, other, resume=True)
    with pytest.raises(CampaignError, match="needs a --grid"):
        _run(tmp_path / "fresh")


@pytest.mark.parametrize("field", ["aot", "shard_lanes", "mesh_shard"])
def test_unported_fields_are_refused_by_name(tmp_path, field):
    spec = campaign_from_json(dict(SWEEP_GRID, **{field: True}))
    with pytest.raises(CampaignError, match=repr(field)):
        _run(tmp_path, spec)
    assert not os.listdir(tmp_path)
    # a stored campaign.json with the field (the reference's file) is
    # refused on resume too
    r_dir = tmp_path / "stored"
    rmanager._load_or_init_spec(
        str(r_dir), r_from_json(dict(SWEEP_GRID, **{field: True})), False)
    with pytest.raises(CampaignError, match=repr(field)):
        _run(r_dir, resume=True)
    assert sorted(os.listdir(r_dir)) == ["campaign.json"]


def test_cli_refuses_aot_with_exit_2(tmp_path, capsys):
    from fantoch_tpu_torch.cli import main

    with pytest.raises(SystemExit) as e:
        main(["--device", "cpu", "campaign", "--dir", str(tmp_path),
              "--grid", json.dumps(dict(SWEEP_GRID, aot=True))])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "campaign refused: CampaignError" in err and "'aot'" in err


def test_hetero_grid_gives_the_homogeneous_bytes(tmp_path):
    """Basic and FPaxos interleaved into always-full mixed units run
    through the port's mixed body; ``results.jsonl`` equals the
    reference's homogeneous layout byte for byte, and ``campaign.json``
    the reference's hetero spec file."""
    grid = dict(SWEEP_GRID, protocols=["basic", "fpaxos"], batch_lanes=3)
    ref = tmp_path / "ref"
    assert r_run(str(ref), r_from_json(grid))["done"]
    rmanager._load_or_init_spec(str(tmp_path / "rhet"),
                                r_from_json(dict(grid, hetero=True)), False)
    het = tmp_path / "het"
    summary = _run(het, campaign_from_json(dict(grid, hetero=True)))
    assert summary["done"] and summary["batches_total"] == 3
    assert _read(het / "results.jsonl") == _read(ref / "results.jsonl")
    assert _read(het / "campaign.json") == _read(
        tmp_path / "rhet" / "campaign.json")
    ids = [json.loads(x)["id"] for x in open(het / "journal.jsonl")]
    assert ids == ["hetero/b0", "hetero/b1", "hetero/b2"]


def test_run_campaign_needs_a_gpu_unless_given_the_cpu(tmp_path,
                                                        monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_campaign(str(tmp_path), campaign_from_json(SWEEP_GRID))
    assert not os.listdir(tmp_path)
