"""``python -m fantoch_tpu_torch sweep --out f.jsonl`` against the
reference CLI's ``sweep --out`` (``fantoch_tpu/cli.py`` through
``plot/db.py save_results``) on the CPU: for the same argv the JSONL is
byte-identical, on a small Basic grid and on a Tempo point under a
crash plan (the fault metadata rides in each row's attributes), and the
summary lines are equal, ``out`` included. The port's ``load_results``
reads the rows back (by attribute match too), and saving them again
writes the same bytes."""

import json

import pytest

from fantoch_tpu.cli import main as r_main
from fantoch_tpu_torch.cli import main
from fantoch_tpu_torch.plot import load_results, save_results
from torch_threads import one_torch_thread  # noqa: F401

GRIDS = {
    "basic": ["sweep", "--protocol", "basic", "--n", "3", "--subsets", "2",
              "--fs", "1", "--commands", "2", "--conflicts", "0,100"],
    "tempo-faults": ["sweep", "--protocol", "tempo", "--n", "3",
                     "--subsets", "1", "--fs", "1", "--commands", "2",
                     "--conflicts", "100",
                     "--faults", '[{}, {"crash": {"1": 200}}]'],
}


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_sweep_out_is_the_references(tmp_path, capsys, grid):
    argv = GRIDS[grid]
    ref, port = tmp_path / "ref.jsonl", tmp_path / "port.jsonl"
    r_main(["--platform", "cpu", *argv, "--out", str(ref)])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    main(["--device", "cpu", *argv, "--out", str(port)])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert port.read_bytes() == ref.read_bytes()
    assert got == dict(want, out=str(port))
    rows = load_results(port)
    assert len(rows) == got["points"]
    again = tmp_path / "again.jsonl"
    save_results(again, rows)
    assert again.read_bytes() == port.read_bytes()
    attrs = [a for a, _ in rows]
    assert {a["protocol"] for a in attrs} == {argv[2]}
    assert all(a["shards"] == 1 and a["n"] == 3 for a in attrs)
    if grid == "tempo-faults":
        assert [a.get("faults") is not None for a in attrs] == [False, True]
        assert len(load_results(port, match={"conflict": 100})) == 2
        assert load_results(port, match={"conflict": 0}) == []
    else:
        assert len(load_results(port, match={"conflict": 0})) == 2
