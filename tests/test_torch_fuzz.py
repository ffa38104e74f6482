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
  CLI's outside its timings; what needs a host oracle that is not
  ported (Tempo's, Atlas's, EPaxos's, Caesar's) or the campaign drivers
  is refused by name before any lane runs, and so is ``sim`` of those
  protocols.

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
    """A repro artifact of Tempo, whose host oracle is not ported."""
    return {"kind": "fantoch-fuzz-repro", "version": 1, "protocol": "tempo",
            "n": 3, "f": 1, "conflict": 100, "pool_size": 1,
            "clients_per_region": 1, "commands_per_client": 2,
            "regions": ["asia-east1", "asia-east2", "asia-northeast1"],
            "workload_seed": 0, "extra_time_ms": 0, "violation": "x",
            "perturbations": {}, "perturbation_count": 0}


@pytest.mark.parametrize("argv,item", [
    (["mc", "--protocols", "tempo"], "17"),
    (["mc", "--no-confirm", "--replay", "{tempo_artifact}"], "17"),
    (["mc", "--no-confirm", "--farm", "farm"], "14"),
    (["mc", "--no-confirm", "--coverage-dir", "cov"], "14"),
    (["mc", "--no-confirm", "--migrate-covmaps", "cov"], "14"),
])
def test_mc_refuses_what_is_not_ported_by_name(argv, item, capsys,
                                               tmp_path):
    from fantoch_tpu_torch.cli import main

    path = tmp_path / "repro_tempo.json"
    path.write_text(json.dumps(_tempo_artifact()))
    argv = [str(path) if a == "{tempo_artifact}" else a for a in argv]
    with pytest.raises(SystemExit) as e:
        main(["--device", "cpu", *argv])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert f"ROADMAP Queue A item {item}" in err and "mc refused" in err
    if item == "17":
        assert "tempo" in err


@pytest.mark.parametrize("protocol", ["tempo", "tempo_atomic", "atlas",
                                      "epaxos", "caesar"])
def test_sim_refuses_what_is_not_ported_by_name(protocol, capsys):
    from fantoch_tpu_torch.cli import main

    with pytest.raises(SystemExit) as e:
        main(["sim", "--protocol", protocol, "--commands", "2"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "sim refused" in err and "ROADMAP Queue A item 17" in err
    assert f"host oracle of {protocol} " in err


def test_host_oracle_entry_points_refuse_by_name(tmp_path):
    spec = fuzz.FuzzSpec(**dict(BASIC, protocol="tempo"))
    path = tmp_path / "repro_tempo.json"
    path.write_text(json.dumps(_tempo_artifact()))
    for call in (lambda: fuzz.run_fuzz_point(spec, device="cpu"),
                 lambda: fuzz.run_fuzz_point(fuzz.FuzzSpec(**BUG),
                                             device="cpu"),
                 lambda: fuzz.replay_artifact(_tempo_artifact()),
                 lambda: fuzz.load_artifact(str(path))):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP Queue A item 17"):
            call()
