"""The device half of the schedule fuzzer (``fantoch_tpu_torch/mc/fuzz.py``)
against the reference's ``fantoch_tpu/mc/fuzz.py`` on the CPU.

* the perturbation draw: ``plan_rng``, ``class_spec``, ``draw_plans``
  (one shot and in chunks, across ``rng_state``/``restore_rng``) give
  the reference's plans;
* ``run_fuzz_point(confirm=False)`` on the injected-bug spec and the
  Basic spec of ``tests/test_mc_fuzz.py``: the reference's ``flagged``,
  ``engine_errors``, flagged lanes with their violations and steps, and
  digests; the injected bug's per-lane results equal the committed
  fixture ``tests/fixtures/torch_fuzz_bug_golden.json``;
* ``mc --no-confirm``'s summary on a small grid equals the reference
  CLI's outside its timings (``--farm``, ``--coverage-dir`` and
  ``--migrate-covmaps`` are held to the reference CLI in
  ``tests/test_torch_mc_farm.py``);
* ``mc --protocols tempo --inject-bug`` with confirmation and ``--out`` on
  the injected-bug point prints the reference CLI's summary (timings and
  directories aside) and writes the reference's artifact bytes, whose
  ``mc --replay`` gives the reference's replay; ``run_fuzz_point``,
  ``load_artifact`` and ``replay_artifact`` take a Tempo spec and
  artifact as the reference's do, and refuse a protocol outside
  ``protocol.BY_NAME`` by name, before any lane runs.

The mixed crash/drop Tempo spec of ``test_mc_fuzz.py`` (lossy lanes to
a 20,000 ms horizon) is in the slow tier. Tolerance: none."""

import json
from pathlib import Path

import pytest

from fantoch_tpu.mc import fuzz as rfuzz
from fantoch_tpu_torch.engine.monitor import VIOL_ORDER
from fantoch_tpu_torch.mc import fuzz
from torch_threads import one_torch_thread  # noqa: F401

FIXTURE = Path(__file__).parent / "fixtures" / "torch_fuzz_bug_golden.json"

BUG = dict(protocol="tempo", n=3, f=1, schedules=8, commands_per_client=5,
           seed=3, inject_bug=True, crash_share=0.0, drop_share=0.0)
BASIC = dict(protocol="basic", n=3, f=1, schedules=6, commands_per_client=5,
             seed=1, crash_share=0.0, drop_share=0.0)
MIXED = dict(protocol="tempo", n=3, f=1, schedules=12,
             commands_per_client=5, seed=5, crash_share=0.25,
             drop_share=0.25)


def _plans(mod, kw, **draw):
    spec = mod.FuzzSpec(**kw)
    return [p.meta() for p in mod.draw_plans(
        spec, mod.point_config(spec), mod.point_protocol(spec), **draw)]


@pytest.mark.parametrize("kw", [
    dict(protocol="tempo", n=5, schedules=64),
    dict(protocol="fpaxos", n=3, schedules=64, seed=9),
    dict(protocol="atlas", n=5, f=2, schedules=40, seed=2,
         crash_share=0.5, drop_share=0.4),
    dict(protocol="caesar", n=5, f=2, schedules=30, seed=4),
])
@pytest.mark.parametrize("fault_class", ["mixed", "crash", "drop",
                                         "jitter"])
def test_draw_plans_match_the_reference(kw, fault_class):
    ref = rfuzz.class_spec(rfuzz.FuzzSpec(**kw), fault_class)
    got = fuzz.class_spec(fuzz.FuzzSpec(**kw), fault_class)
    fields = ("seed", "crash_share", "drop_share", "fault_class")
    assert [getattr(got, f) for f in fields] == [
        getattr(ref, f) for f in fields]
    ref_kw = {k: getattr(ref, k) for k in kw} | {
        f: getattr(ref, f) for f in fields}
    assert _plans(fuzz, ref_kw) == _plans(rfuzz, ref_kw)
    assert (fuzz.plan_rng(got).bit_generator.state
            == rfuzz.plan_rng(ref).bit_generator.state)


def test_chunked_draws_resume_as_the_reference():
    kw = dict(protocol="tempo", n=3, schedules=20)
    spec, rspec = fuzz.FuzzSpec(**kw), rfuzz.FuzzSpec(**kw)
    rng, rrng = fuzz.plan_rng(spec), rfuzz.plan_rng(rspec)
    first = _plans(fuzz, kw, count=7, rng=rng)
    rfuzz.draw_plans(rspec, rfuzz.point_config(rspec),
                     rfuzz.point_protocol(rspec), count=7, rng=rrng)
    state = json.loads(json.dumps(fuzz.rng_state(rng)))
    assert state == json.loads(json.dumps(rfuzz.rng_state(rrng)))
    rest = _plans(fuzz, kw, count=13, rng=fuzz.restore_rng(state))
    assert first + rest == _plans(rfuzz, kw)
    with pytest.raises(ValueError, match="unknown fault class"):
        fuzz.class_spec(spec, "bursty")


def _ref_point(kw):
    res = rfuzz.run_fuzz_point(rfuzz.FuzzSpec(**kw), confirm=False)
    return res, [(f.lane, f.violation, f.violation_step)
                 for f in res.findings]


def _port_point(kw):
    res = fuzz.run_fuzz_point(fuzz.FuzzSpec(**kw), confirm=False,
                              device="cpu")
    return res, [(f.lane, f.violation, f.violation_step)
                 for f in res.findings]


@pytest.mark.parametrize("kw", [BUG, BASIC], ids=["injected_bug", "basic"])
def test_run_fuzz_point_matches_the_reference(kw):
    ref, ref_found = _ref_point(kw)
    got, found = _port_point(kw)
    assert found == ref_found
    assert got.flagged == ref.flagged
    assert got.engine_errors == ref.engine_errors
    assert got.digests == ref.digests
    assert all(d != 0 for d in got.digests)
    summary, ref_summary = got.summary(), ref.summary()
    for k in ("fuzz_elapsed_s", "schedules_per_sec"):
        summary.pop(k)
        ref_summary.pop(k)
    assert summary == ref_summary
    if kw is BUG:
        assert got.flagged >= 1
        assert any(f.violation & VIOL_ORDER for f in got.findings)
        assert {f.violation_cause for f in got.findings} == {
            "order-divergence"}
        want = json.loads(FIXTURE.read_text())
        lanes = got.lane_results
        assert want == {
            "violation": [r.violation for r in lanes],
            "violation_step": [r.violation_step for r in lanes],
            "digests": [r.coverage for r in lanes],
            "engine_errors": sorted({r.err_cause for r in lanes if r.err}),
        }
    else:
        assert got.flagged == 0 and not got.engine_errors


@pytest.mark.slow
def test_mixed_crash_and_drop_point_matches_the_reference():
    ref, ref_found = _ref_point(MIXED)
    got, found = _port_point(MIXED)
    assert found == ref_found and got.flagged == 0
    assert got.engine_errors == ref.engine_errors
    assert got.digests == ref.digests


GRID = ["mc", "--no-confirm", "--protocols", "tempo,basic", "--ns", "3",
        "--schedules", "2", "--commands", "2", "--seed", "4"]


def _without_timings(out):
    line = json.loads(out.strip().splitlines()[-1])
    for d in [line] + line["grid"]:
        for k in ("elapsed_s", "fuzz_elapsed_s", "schedules_per_sec"):
            d.pop(k, None)
    return line


def test_mc_summary_matches_the_reference_cli(capsys):
    from fantoch_tpu.cli import main as r_main
    from fantoch_tpu_torch.cli import main

    r_main(["--platform", "cpu", *GRID])
    want = _without_timings(capsys.readouterr().out)
    main(["--device", "cpu", *GRID])
    got = _without_timings(capsys.readouterr().out)
    assert got == want
    assert got["points"] == 2 and got["schedules"] == 4


def _tempo_artifact():
    """A clean repro artifact of Tempo: no perturbations, a full drain
    tail."""
    return {"kind": "fantoch-fuzz-repro", "version": 1, "protocol": "tempo",
            "n": 3, "f": 1, "conflict": 100, "pool_size": 1,
            "clients_per_region": 1, "commands_per_client": 2,
            "regions": ["asia-east1", "asia-east2", "asia-northeast1"],
            "workload_seed": 0, "extra_time_ms": 0, "violation": "x",
            "perturbations": {}, "perturbation_count": 0}


# the injected-bug point (BUG, tests/test_mc_fuzz.py:291-319) through the
# CLI: every lane flags, lane 0 confirms and shrinks (the reference's
# device run is BUG's, compiled once)
BUG_GRID = ["mc", "--protocols", "tempo", "--ns", "3", "--schedules", "8",
            "--seed", "3", "--inject-bug", "--crash-share", "0",
            "--drop-share", "0", "--max-confirm", "1", "--shrink-budget",
            "80"]


@pytest.fixture(scope="module")
def bug_grid(tmp_path_factory):
    """``BUG_GRID`` with ``--out`` through the reference CLI and the
    port's: (port line, reference line, port dir, reference dir)."""
    import contextlib
    import io

    from fantoch_tpu.cli import main as r_main
    from fantoch_tpu_torch.cli import main

    dirs = tmp_path_factory.mktemp("port"), tmp_path_factory.mktemp("ref")
    lines = []
    for call, flag, out in ((main, "--device", dirs[0]),
                            (r_main, "--platform", dirs[1])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            call([flag, "cpu", *BUG_GRID, "--out", str(out)])
        lines.append(json.loads(buf.getvalue().strip().splitlines()[-1]))
    return (*lines, *dirs)


def _untimed_grid(line, out):
    line = dict(line, grid=[dict(p) for p in line["grid"]])
    for d in [line] + line["grid"]:
        for k in ("elapsed_s", "fuzz_elapsed_s", "schedules_per_sec"):
            d.pop(k, None)
    line["artifacts"] = [str(Path(p).relative_to(out))
                         for p in line["artifacts"]]
    return line


def test_mc_confirms_tempo_as_the_reference_cli(bug_grid):
    got, want, out, rout = bug_grid
    assert _untimed_grid(got, out) == _untimed_grid(want, rout)
    assert got["flagged"] >= 1 and got["confirmed"] == 1
    (viol,) = got["grid"][0]["violations"]
    assert viol["device"] == "order-divergence" and viol["host"]
    assert viol["shrunk_to"] <= 10
    (name,) = _untimed_grid(got, out)["artifacts"]
    assert (out / name).read_bytes() == (rout / name).read_bytes()


def test_mc_replays_a_tempo_artifact(bug_grid, capsys):
    from fantoch_tpu_torch.cli import main

    got, _want, _out, _rout = bug_grid
    path = got["artifacts"][0]
    main(["mc", "--replay", path])
    replay = json.loads(capsys.readouterr().out)
    assert replay == rfuzz.replay_artifact(rfuzz.load_artifact(path))
    assert replay["reproduced"] and replay["matches_expected"]


def test_host_oracle_entry_points_take_tempo(tmp_path):
    spec = fuzz.FuzzSpec(**dict(BASIC, protocol="tempo", schedules=2))
    res = fuzz.run_fuzz_point(spec, device="cpu")
    assert res.flagged == 0 and res.confirmed == 0 and not res.findings
    path = tmp_path / "repro_tempo.json"
    path.write_text(json.dumps(_tempo_artifact()))
    obj = fuzz.load_artifact(str(path))
    assert obj == rfuzz.load_artifact(str(path))
    replay = fuzz.replay_artifact(obj)
    assert replay == rfuzz.replay_artifact(obj)
    assert not replay["reproduced"] and replay["violation"] is None


def test_host_oracle_entry_points_refuse_by_name(tmp_path):
    unknown = dict(_tempo_artifact(), protocol="tempo_partial")
    path = tmp_path / "repro_tempo_partial.json"
    path.write_text(json.dumps(unknown))
    for call in (lambda: fuzz.load_artifact(str(path)),
                 lambda: fuzz.replay_artifact(unknown),
                 lambda: fuzz.run_fuzz_point(
                     fuzz.FuzzSpec(**dict(BASIC, protocol="paxos")),
                     device="cpu")):
        with pytest.raises(ValueError,
                           match="no host oracle for protocol '"):
            call()
