"""Fleet campaigns (``fantoch_tpu_torch/fleet``) against the reference's
``fantoch_tpu/fleet`` and ``fantoch_tpu/campaign`` on the CPU.

The reference's ``tests/test_fleet.py`` cases, held to the reference's
bytes: the port's own worker-id rules equal the reference's; eight
threads racing one lease leave exactly one winner; the worker-rotated
scan order and the claim backoff are the reference's functions; a lease
is reclaimed only after its TTL, a released unit at once; conflicting
duplicate completions are refused. ``tests/test_campaign.py``'s Basic
grid at one lane a unit (four units), merged from two workers, from an
abandoned-and-resumed unit and from a worker SIGKILLed mid-unit in a
subprocess, gives the reference ``campaign``'s ``results.jsonl`` byte for
byte; the merge refuses a missing directory and reports missing units.
The steered fuzz grid of ``tests/test_coverage.py:383`` merged from two
workers equals the reference's solo worker's ``summary.json`` (and in the
slow tier the port's solo worker's, every protocol's merge and the
two-worker Tempo fuzz fleet). A spec with ``aot``, ``shard_lanes`` or ``mesh_shard`` is
refused by name with nothing written (these replace the reference's own
mesh test, which fails on the reference). The CLI exits 0, 75 and 2 as
the reference's does, and ``--workers 2 --merge`` spawns two worker
processes whose merge equals the reference's bytes. Tolerance: none."""

import contextlib
import glob
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from fantoch_tpu.campaign import campaign_from_json as r_from_json
from fantoch_tpu.campaign import run_campaign as r_run
from fantoch_tpu.fleet import merge_campaign as r_merge
from fantoch_tpu.fleet import run_fleet_worker as r_worker
from fantoch_tpu.fleet import worker as rworker
from fantoch_tpu.registry import worker_id_ok as r_worker_id_ok
from fantoch_tpu_torch import cli
from fantoch_tpu_torch.campaign import CampaignError, campaign_from_json
from fantoch_tpu_torch.fleet import (
    FleetError, check_worker_id, claim_unit, lease_holder, merge_campaign,
    run_fleet_worker, worker_id_ok,
)
from fantoch_tpu_torch.fleet.worker import (
    append_worker_journal, claim_backoff_s, read_all_journals,
    sweep_done_units, worker_scan_order,
)
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent

# tests/test_fleet.py's grid: tests/test_campaign.py's Basic shapes at one
# lane a unit (4 units); scan_window 1 pins the per-segment ladder the
# stop_after_segments interruptions count on
SWEEP_GRID = {
    "kind": "sweep",
    "protocols": ["basic"],
    "ns": [3],
    "conflicts": [0, 100],
    "subsets": 2,
    "commands_per_client": 2,
    "batch_lanes": 1,
    "segment_steps": 8,
    "scan_window": 1,
}
# tests/test_coverage.py's steered fuzz grid
COV_GRID = {
    "kind": "fuzz",
    "protocols": ["basic"],
    "ns": [3],
    "schedules": 6,
    "chunk": 2,
    "commands_per_client": 3,
    "seed": 1,
    "confirm": False,
    "crash_share": 0.0,
    "drop_share": 0.0,
    "coverage": True,
}


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _worker(path, spec=None, **kw):
    return run_fleet_worker(str(path), spec, device="cpu", **kw)


@pytest.fixture(scope="module")
def ref_results(tmp_path_factory):
    """The reference ``campaign``'s ``results.jsonl`` for ``SWEEP_GRID``."""
    path = tmp_path_factory.mktemp("ref")
    summary = r_run(str(path), r_from_json(SWEEP_GRID))
    assert summary["done"] and summary["errors"] == 0
    return _read(path / "results.jsonl")


# ----------------------------------------------------------------------
# worker ids + lease protocol (device-free)
# ----------------------------------------------------------------------


def test_worker_id_rules_are_the_references():
    assert worker_id_ok("w0") and worker_id_ok("tpu-pod_3")
    ids = ("", "a.b", "a/b", "lock", "stale", "tmp", "x" * 64, "x" * 65,
           ".hidden", "wé", "٢", None, 7, "w0", "tpu-pod_3", "A-b_9")
    for w in ids:
        assert worker_id_ok(w) == r_worker_id_ok(w), w
    for bad in ("", "a.b", "lock", "x" * 65, "wé", None):
        assert not worker_id_ok(bad)
    with pytest.raises(ValueError, match="worker id") as e:
        check_worker_id("a.b")
    from fantoch_tpu.registry import check_worker_id as r_check

    with pytest.raises(ValueError) as r:
        r_check("a.b")
    assert str(e.value) == str(r.value)


def test_lease_contention_exactly_one_winner(tmp_path):
    d = str(tmp_path)
    for rnd in range(10):
        unit = f"proto/n3/b{rnd}"
        wins = []
        barrier = threading.Barrier(8)

        def race(i, unit=unit, wins=wins, barrier=barrier):
            barrier.wait()
            lease = claim_unit(d, unit, f"w{i}", ttl_s=30.0)
            if lease is not None:
                wins.append(lease)

        threads = [threading.Thread(target=race, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(wins) == 1, f"round {rnd}: {len(wins)} winners"
        holder = lease_holder(d, unit)
        assert holder is not None and holder[0] == wins[0].worker
        wins[0].release()
        assert lease_holder(d, unit) is None


def test_scan_order_and_backoff_are_the_references(tmp_path):
    units = [f"p/n3/b{i}" for i in range(8)]
    workers = [f"w{i}" for i in range(8)]
    for w in workers + ["long-worker-id_9"]:
        assert worker_scan_order(units, w) == rworker.worker_scan_order(
            units, w)
        seq = [claim_backoff_s(w, m) for m in range(0, 12)]
        assert seq == [rworker.claim_backoff_s(w, m) for m in range(0, 12)]
        assert seq[0] == 0.0 and all(0.0 < s <= 0.25 for s in seq[1:])
    assert claim_backoff_s("w0", 3) != claim_backoff_s("w1", 3)

    def drain(subdir, orders):
        d = str(tmp_path / subdir)
        misses, claimed = 0, []
        for w, order in zip(workers, orders):
            for u in order:
                lease = claim_unit(d, u, w, ttl_s=30.0)
                if lease is None:
                    misses += 1
                else:
                    claimed.append(u)
                    break
        assert sorted(claimed) == sorted(units)
        return misses

    assert drain("canon", [list(units)] * 8) == 28
    assert drain("rot", [worker_scan_order(units, w) for w in workers]) == 0


def test_lease_reclaim_only_after_ttl(tmp_path):
    d = str(tmp_path)
    a = claim_unit(d, "u/1", "a", ttl_s=0.6)
    assert a is not None
    assert claim_unit(d, "u/1", "b", ttl_s=0.6) is None
    for _ in range(4):
        time.sleep(0.25)
        a.heartbeat()
    assert claim_unit(d, "u/1", "b", ttl_s=0.6) is None, (
        "reclaim fired on a heartbeated lease")
    time.sleep(0.7)
    b = claim_unit(d, "u/1", "b", ttl_s=0.6)
    assert b is not None and lease_holder(d, "u/1")[0] == "b"
    b.release()
    # a released unit is claimable at once
    c = claim_unit(d, "u/2", "a", ttl_s=30.0)
    c.release()
    c = claim_unit(d, "u/2", "b", ttl_s=30.0)
    assert c is not None
    c.release()
    with pytest.raises(ValueError, match="worker id"):
        claim_unit(d, "u/3", "bad.id")


def test_conflicting_duplicate_unit_results_refused(tmp_path):
    d = str(tmp_path)
    append_worker_journal(
        d, "a", {"kind": "batch", "id": "x/b0", "results": [{"err": 0}]})
    append_worker_journal(
        d, "b", {"kind": "batch", "id": "x/b0", "results": [{"err": 1}]})
    with pytest.raises(FleetError, match="DIFFERING"):
        sweep_done_units(read_all_journals(d))


# ----------------------------------------------------------------------
# multi-worker merge determinism, held to the reference's bytes
# ----------------------------------------------------------------------


def test_two_worker_fleet_merge_matches_the_reference(tmp_path,
                                                      ref_results):
    spec = campaign_from_json(SWEEP_GRID)
    fleet = tmp_path / "fleet"
    s1 = _worker(fleet, spec, worker_id="w1", stop_after_units=2)
    assert s1["interrupted"] == "unit-limit"
    assert s1["units_completed_here"] == 2 and not s1["done"]
    s2 = _worker(fleet, None, worker_id="w2")
    assert s2["done"] and s2["units_completed_here"] == 2
    merged = merge_campaign(str(fleet))
    assert merged["merged"] and merged["errors"] == 0

    assert _read(fleet / "results.jsonl") == ref_results
    assert not (fleet / "journal.jsonl").exists()
    assert sorted(os.listdir(fleet / "journals")) == ["w1.jsonl",
                                                      "w2.jsonl"]


def test_abandoned_unit_resumed_by_other_worker_bit_exact(tmp_path,
                                                          ref_results):
    spec = campaign_from_json(SWEEP_GRID)
    fleet = tmp_path / "fleet"
    s1 = _worker(fleet, spec, worker_id="a", stop_after_segments=1)
    assert s1["interrupted"] == "segment-limit"
    assert s1["units_completed_here"] == 0
    assert glob.glob(str(fleet / "ckpt" / "*" / "manifest.json"))
    assert lease_holder(str(fleet), "basic/n3/b0") is None
    s2 = _worker(fleet, None, worker_id="b")
    assert s2["done"]
    assert merge_campaign(str(fleet))["merged"]
    assert _read(fleet / "results.jsonl") == ref_results


def test_merge_refuses_missing_units_and_empty_dir(tmp_path):
    with pytest.raises(CampaignError, match="nothing to merge"):
        merge_campaign(str(tmp_path / "missing"))
    spec = campaign_from_json(SWEEP_GRID)
    fleet = tmp_path / "fleet"
    _worker(fleet, spec, worker_id="w1", stop_after_units=1)
    merged = merge_campaign(str(fleet))
    assert not merged["merged"]
    assert merged["units_done"] == 1 and merged["missing_units"]
    assert not (fleet / "results.jsonl").exists()


def test_fleet_worker_killed_mid_unit_reclaimed_bit_exact(tmp_path,
                                                          ref_results):
    """A subprocess worker (the CLI) is SIGKILLed holding a lease; its
    lease expires (short TTL), a second worker reclaims the unit,
    resumes its checkpoint, and the merge equals the reference's
    bytes."""
    spec = campaign_from_json(SWEEP_GRID)
    fleet = tmp_path / "fleet"
    proc = subprocess.Popen(
        [sys.executable, "-m", "fantoch_tpu_torch", "--device", "cpu",
         "fleet", "--dir", str(fleet), "--grid", json.dumps(SWEEP_GRID),
         "--worker-id", "doomed", "--ttl-s", "1.5"],
        cwd=str(ROOT), stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and proc.poll() is None:
            if glob.glob(str(fleet / "ckpt" / "*" / "manifest.json")) or \
                    glob.glob(str(fleet / "leases" / "*.lock")):
                break
            time.sleep(0.02)
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    deadline = time.monotonic() + 120
    while True:
        s = _worker(fleet, spec, worker_id="reclaimer", ttl_s=1.5)
        if s["done"]:
            break
        assert time.monotonic() < deadline, s
        time.sleep(0.5)
    assert merge_campaign(str(fleet))["merged"]
    assert _read(fleet / "results.jsonl") == ref_results


def _ref_solo(path, grid):
    assert r_worker(str(path), r_from_json(grid), worker_id="solo")["done"]
    assert r_merge(str(path))["merged"]
    return _read(path / "summary.json")


def test_steered_fleet_two_workers_merge_equals_solo(tmp_path):
    """tests/test_coverage.py:383: two workers handing a steered point's
    chunks across the journaled map, pool and generator positions merge
    to the reference's solo worker's ``summary.json``."""
    want = _ref_solo(tmp_path / "ref", COV_GRID)
    grid = campaign_from_json(COV_GRID)
    fleet = tmp_path / "fleet"
    s1 = _worker(fleet, grid, worker_id="w1", budget_s=0.0)
    assert not s1["done"] and s1["interrupted"] == "budget exhausted"
    s2 = _worker(fleet, None, worker_id="w2")
    assert s2["done"]
    assert merge_campaign(str(fleet))["merged"]
    assert _read(fleet / "summary.json") == want
    merged = json.loads(_read(fleet / "summary.json"))
    assert merged["points"]["basic/n3"]["cov_buckets"] > 0
    assert merged["schedules_tried"] == grid.schedules


@pytest.mark.parametrize("field", ["aot", "shard_lanes", "mesh_shard"])
def test_unported_fields_refused_before_anything_is_written(tmp_path,
                                                            field):
    spec = campaign_from_json(dict(SWEEP_GRID, **{field: True}))
    d = tmp_path / "fleet"
    with pytest.raises(CampaignError, match=field):
        _worker(d, spec, worker_id="w1")
    assert not d.exists()
    code, _out, err = _cli(["fleet", "--dir", str(d), "--grid",
                            json.dumps(dict(SWEEP_GRID, **{field: True})),
                            "--worker-id", "w1"])
    assert code == 2 and field in err
    assert not d.exists()


def _cli(argv):
    out, err = io.StringIO(), io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            cli.main(["--device", "cpu", *argv])
        except SystemExit as e:
            code = 0 if e.code is None else (
                e.code if isinstance(e.code, int) else 1)
    return code, out.getvalue(), err.getvalue()


def test_cli_exits(tmp_path, ref_results):
    d = str(tmp_path / "f")
    grid = json.dumps(SWEEP_GRID)
    code, out, _ = _cli(["fleet", "--dir", d, "--grid", grid,
                         "--worker-id", "w1", "--stop-after-units", "1"])
    assert code == 75 and json.loads(out)["units_completed_here"] == 1
    code, out, _ = _cli(["fleet", "--dir", d, "--merge"])
    assert code == 75 and not json.loads(out)["merged"]
    code, out, _ = _cli(["fleet", "--dir", d, "--worker-id", "w2",
                         "--merge"])
    assert code == 0
    assert _read(os.path.join(d, "results.jsonl")) == ref_results
    # refusals, exit 2
    code, _o, err = _cli(["fleet", "--dir", d, "--worker-id", "bad.id"])
    assert code == 2 and "worker id" in err
    code, _o, err = _cli(["fleet", "--dir", d, "--worker-id", "w3",
                          "--farm"])
    assert code == 2 and "--farm" in err
    code, _o, err = _cli(["fleet", "--dir", d, "--worker-id", "w3",
                          "--grid", json.dumps(dict(SWEEP_GRID,
                                                    conflicts=[0]))])
    assert code == 2 and "CampaignError" in err
    code, _o, _e = _cli(["fleet", "--dir", d])
    assert code == 1
    code, _o, _e = _cli(["fleet", "--dir", d, "--workers", "2",
                         "--worker-id", "w1"])
    assert code == 1


def test_cli_workers_spawn_and_merge(tmp_path, ref_results):
    """``--workers 2 --merge``: two ``python -m fantoch_tpu_torch --device
    cpu fleet`` processes drain the grid; the merge is the reference's."""
    d = str(tmp_path / "f")
    code, out, err = _cli(["fleet", "--dir", d, "--grid",
                           json.dumps(SWEEP_GRID), "--workers", "2",
                           "--merge"])
    assert code == 0, err
    assert json.loads(out.strip().splitlines()[-1])["merged"]
    assert _read(os.path.join(d, "results.jsonl")) == ref_results
    names = sorted(os.listdir(os.path.join(d, "journals")))
    assert set(names) <= {"w0.jsonl", "w1.jsonl"} and names


def test_sweep_aot_dir_refused_by_name(tmp_path):
    """The reference's ``sweep --aot-dir`` has no counterpart: exit 2,
    naming the serialized executable, before anything runs or is
    written."""
    d = tmp_path / "aot"
    code, out, err = _cli(["sweep", "--protocol", "basic", "--n", "3",
                           "--subsets", "1", "--commands", "1",
                           "--conflicts", "0", "--aot-dir", str(d)])
    assert code == 2 and out == ""
    assert "--aot-dir" in err and "serialized sweep executable" in err
    assert not d.exists()


def test_no_gpu_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_fleet_worker(str(tmp_path / "f"),
                         campaign_from_json(SWEEP_GRID), worker_id="w1")
    assert not (tmp_path / "f").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["fleet", "--dir", str(tmp_path / "f"), "--grid",
                  json.dumps(SWEEP_GRID), "--worker-id", "w1"])


# ----------------------------------------------------------------------
# slow tier: all protocols + the two-worker fuzz fleet
# ----------------------------------------------------------------------


@pytest.mark.slow
def test_steered_solo_worker_matches_the_reference(tmp_path):
    want = _ref_solo(tmp_path / "ref", COV_GRID)
    solo = tmp_path / "solo"
    s = _worker(solo, campaign_from_json(COV_GRID), worker_id="solo")
    assert s["done"] and merge_campaign(str(solo))["merged"]
    assert _read(solo / "summary.json") == want


@pytest.mark.slow
def test_fleet_merge_identity_all_protocols(tmp_path):
    grid = {
        "kind": "sweep",
        "protocols": ["basic", "fpaxos", "tempo", "atlas", "epaxos",
                      "caesar"],
        "ns": [3],
        "conflicts": [100],
        "subsets": 1,
        "commands_per_client": 2,
        "batch_lanes": 1,
        "segment_steps": 64,
    }
    mgr = tmp_path / "mgr"
    assert r_run(str(mgr), r_from_json(grid))["done"]
    spec = campaign_from_json(grid)
    fleet = tmp_path / "fleet"
    _worker(fleet, spec, worker_id="w1", stop_after_units=3)
    assert _worker(fleet, None, worker_id="w2")["done"]
    assert merge_campaign(str(fleet))["merged"]
    assert _read(fleet / "results.jsonl") == _read(mgr / "results.jsonl")


@pytest.mark.slow
def test_fuzz_fleet_two_workers_summary_identical(tmp_path):
    grid = {
        "kind": "fuzz",
        "protocols": ["tempo"],
        "ns": [3],
        "schedules": 8,
        "chunk": 4,
        "commands_per_client": 5,
        "seed": 7,
        "confirm": False,
    }
    want = _ref_solo(tmp_path / "ref", grid)
    spec = campaign_from_json(grid)
    fleet = tmp_path / "fleet"
    s1 = _worker(fleet, spec, worker_id="w1", budget_s=0.0)
    assert not s1["done"] and s1["interrupted"] == "budget exhausted"
    assert _worker(fleet, None, worker_id="w2")["done"]
    assert merge_campaign(str(fleet))["merged"]
    assert _read(fleet / "summary.json") == want
