"""``mc --farm``, ``mc --coverage-dir`` and ``mc --migrate-covmaps`` of the
port's CLI against the reference CLI's on the CPU (the monitored Basic
runner, n = 3, a few schedules).

* ``--farm`` (two fault classes, one chunk each): a budget of 0 stops
  the port's farm after one chunk (exit 75); the same command again
  drains it (exit 0); its summary,
  ``summary.json`` and final binary maps equal the reference CLI's
  uninterrupted farm's;
* ``--coverage-dir``: two invocations accumulate one point's coverage
  (the second starts from the first's map, lanes offset by the first's
  schedules) and print and persist what the reference CLI's two
  invocations do;
* ``--migrate-covmaps``: the binary maps written from those states are
  the reference CLI's bytes and load back to the same buckets; the JSON
  states stay as they were; a damaged state is refused with exit 2.
Tolerance: none."""

import contextlib
import io
import json
import os
import shutil

import pytest

from fantoch_tpu.cli import main as r_main
from fantoch_tpu_torch.cli import main
from torch_threads import one_torch_thread  # noqa: F401

BASE = ["mc", "--protocols", "basic", "--ns", "3", "--commands", "3",
        "--seed", "1", "--no-confirm"]
FARM = BASE + ["--schedules", "2", "--chunk", "2", "--classes",
               "jitter,crash", "--crash-share", "0.3", "--drop-share",
               "0.2"]
COVERAGE = BASE + ["--schedules", "2", "--crash-share", "0",
                   "--drop-share", "0"]


def _call(fn, flag, argv):
    """(exit code, last stdout line as JSON, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            fn([flag, "cpu", *argv])
        except SystemExit as e:
            code = e.code
    lines = out.getvalue().strip().splitlines()
    return code, (json.loads(lines[-1]) if lines else None), err.getvalue()


def _port(argv):
    return _call(main, "--device", argv)


def _ref(argv):
    return _call(r_main, "--platform", argv)


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_mc_farm_drains_and_resumes_as_the_reference(tmp_path):
    ref = tmp_path / "ref"
    code, want, _ = _ref(FARM + ["--farm", str(ref)])
    assert code in (0, None) and want["done"]
    farm = tmp_path / "farm"
    code, first, err = _port(FARM + ["--farm", str(farm), "--budget-s", "0"])
    assert code == 75 and not first["done"], err
    assert "farm interrupted (budget exhausted)" in err
    assert first["schedules_tried"] == 2
    code, got, _ = _port(FARM + ["--farm", str(farm)])
    assert code in (0, None) and got["done"]
    for d in (got, want):
        d.pop("dir"), d.pop("summary")
    assert got == want
    assert _read(farm / "summary.json") == _read(ref / "summary.json")
    assert _read(farm / "campaign.json") == _read(ref / "campaign.json")
    names = sorted(os.listdir(farm / "covmaps"))
    assert names == ["basic_n3_crash.covmap", "basic_n3_jitter.covmap"]
    for name in names:
        assert _read(farm / "covmaps" / name) == _read(
            ref / "covmaps" / name), name
    # a drifted re-invocation is refused by name, exit 2
    code, _, err = _port(FARM[:-1] + ["0.5", "--farm", str(farm)])
    assert code == 2 and "mc refused: CampaignError" in err


def _untimed(line):
    line = dict(line, grid=[dict(p) for p in line["grid"]])
    for d in [line] + line["grid"]:
        for k in ("elapsed_s", "fuzz_elapsed_s", "schedules_per_sec"):
            d.pop(k, None)
    return line


@pytest.fixture(scope="module")
def coverage_dirs(tmp_path_factory):
    """``COVERAGE`` run twice with one ``--coverage-dir`` through the
    reference CLI and the port's: ({side: [line, line]}, {side: dir})."""
    lines, dirs = {}, {}
    for side, call in (("port", _port), ("ref", _ref)):
        d = tmp_path_factory.mktemp(side)
        lines[side] = []
        for _ in range(2):
            code, line, err = call(COVERAGE + ["--coverage-dir", str(d)])
            assert code in (0, None), err
            lines[side].append(_untimed(line))
        dirs[side] = d
    return lines, dirs


def test_mc_coverage_dir_accumulates_as_the_reference(coverage_dirs):
    lines, dirs = coverage_dirs
    assert lines["port"] == lines["ref"]
    first, second = (line["grid"][0] for line in lines["port"])
    assert first["tried_total"] == 2 and second["tried_total"] == 4
    assert second["coverage_buckets"] >= first["coverage_buckets"] > 0
    assert second["coverage_buckets"] == (first["coverage_buckets"]
                                          + second["new_buckets"])
    name = "cov_basic_n3.json"
    assert _read(dirs["port"] / name) == _read(dirs["ref"] / name)


def test_mc_migrate_covmaps_is_lossless_as_the_reference(coverage_dirs,
                                                         tmp_path):
    from fantoch_tpu_torch.mc import covmap as cvm

    _lines, dirs = coverage_dirs
    out = {}
    for side, call in (("port", _port), ("ref", _ref)):
        d = tmp_path / side
        shutil.copytree(dirs[side], d)
        before = _read(d / "cov_basic_n3.json")
        code, line, err = call(["mc", "--migrate-covmaps", str(d)])
        assert code in (0, None), err
        assert line == {"migrated": [str(d / "cov_basic_n3.covmap")],
                        "count": 1}
        assert _read(d / "cov_basic_n3.json") == before
        out[side] = _read(d / "cov_basic_n3.covmap")
    assert out["port"] == out["ref"]
    state = json.loads(_read(tmp_path / "port" / "cov_basic_n3.json"))
    back = cvm.load_covmap(str(tmp_path / "port" / "cov_basic_n3.covmap"))
    assert back.to_json() == state["coverage"]
    # a damaged state is refused with exit 2, naming the reason
    (tmp_path / "port" / "cov_bad_n3.json").write_text("{")
    code, _, err = _port(["mc", "--migrate-covmaps", str(tmp_path / "port")])
    assert code == 2 and "mc refused: CovmapError" in err
