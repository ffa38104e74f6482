"""Host confirmation of the schedule fuzzer on the oracles of Tempo, Atlas,
EPaxos and Caesar and on the injected bug's broken Tempo twin
(``fantoch_tpu_torch/mc/fuzz.py``) against the reference's
``fantoch_tpu/mc`` on the CPU.

* ``host_check`` (with the recorded wire events) on the first jitter,
  crash and drop lane of a drawn n = 3 plan set of each protocol (n = 5
  for Caesar's crash lane: at n = 3 it tolerates no crash): the port's
  verdict and events are the reference's;
* ``host_check`` through ``TempoStabilityBug`` on the injected-bug
  point's flagged plan (``tests/test_mc_fuzz.py:291-319``: Tempo n = 3,
  f = 1, 8 schedules, seed 3, no crashes, no drops): the reference's
  order divergence; ``oracle_protocol`` returns the broken twin only for
  ``inject_bug`` and refuses names outside ``BY_NAME``;
* ``run_fuzz_point(confirm=True)`` on that point with
  ``max_confirmations=1`` and ``shrink_budget=80``: its flagged lanes are
  the committed fixture's (the reference's, pinned by
  ``tests/test_torch_fuzz.py``), and its host verdict, shrunk
  components, shrink runs and artifact are what the reference's
  ``host_check``, ``shrink`` and ``artifact`` give for that lane; the
  artifact has at most 10 perturbations, round-trips through
  ``load_artifact`` and ``replay_artifact`` (reproduced, as the
  reference's replay) and ``mc --replay``;
* the slow tier runs the reference's own ``run_fuzz_point(confirm=True)``
  on the point (its device half is a cold XLA compile) and compares the
  whole summary and the artifacts.

Tolerance: none."""

import json
from dataclasses import replace
from pathlib import Path

import pytest

from fantoch_tpu.mc import fuzz as rfuzz
from fantoch_tpu.mc import shrink as rshrink
from fantoch_tpu_torch.engine.monitor import VIOL_ORDER
from fantoch_tpu_torch.mc import fuzz
from fantoch_tpu_torch.protocol import Tempo
from torch_threads import one_torch_thread  # noqa: F401

FIXTURE = Path(__file__).parent / "fixtures" / "torch_fuzz_bug_golden.json"

BUG = dict(protocol="tempo", n=3, f=1, schedules=8, commands_per_client=5,
           seed=3, inject_bug=True, crash_share=0.0, drop_share=0.0)
BUG_POINT = dict(max_confirmations=1, shrink_budget=80)


def _drawn(mod, name, n=3):
    spec = mod.FuzzSpec(protocol=name, n=n, f=1, schedules=8,
                        commands_per_client=3, seed=6, crash_share=0.3,
                        drop_share=0.3)
    return spec, mod.draw_plans(spec, mod.point_config(spec),
                                mod.point_protocol(spec))


def _kind(plan):
    if plan.crashes:
        return "crash"
    return "drop" if plan.drop_bp else "jitter"


@pytest.mark.parametrize("kind", ["jitter", "crash", "drop"])
@pytest.mark.parametrize("name", ["tempo", "atlas", "epaxos", "caesar"])
def test_host_check_matches_the_reference(name, kind):
    # Caesar's fast quorum is every process at n = 3, so its crash plans
    # fall back to jitter there: its crash lane is drawn at n = 5
    n = 5 if (name, kind) == ("caesar", "crash") else 3
    spec, plans = _drawn(fuzz, name, n)
    rspec, rplans = _drawn(rfuzz, name, n)
    lane = next(i for i, p in enumerate(plans) if _kind(p) == kind)
    assert plans[lane].meta() == rplans[lane].meta()
    got = fuzz.host_check(spec, plans[lane], record=True)
    assert got == rfuzz.host_check(rspec, rplans[lane], record=True)
    assert got[1], "a jittered replay records wire events"


def test_oracle_protocol_names():
    assert fuzz.oracle_protocol("tempo") is Tempo
    bug = fuzz.oracle_protocol("tempo", inject_bug=True)
    assert bug is fuzz.TempoStabilityBug and issubclass(bug, Tempo)
    assert bug.EXECUTOR.__name__ == rfuzz.TempoStabilityBug.EXECUTOR.__name__
    with pytest.raises(ValueError, match="Tempo-specific"):
        fuzz.oracle_protocol("atlas", inject_bug=True)
    for name in ("tempo_partial", "paxos"):
        with pytest.raises(ValueError, match=f"'{name}'"):
            fuzz.oracle_protocol(name)


def test_host_check_of_the_broken_twin_matches_the_reference():
    spec, rspec = fuzz.FuzzSpec(**BUG), rfuzz.FuzzSpec(**BUG)
    plan = fuzz.draw_plans(spec, fuzz.point_config(spec),
                           fuzz.point_protocol(spec))[0]
    rplan = rfuzz.draw_plans(rspec, rfuzz.point_config(rspec),
                             rfuzz.point_protocol(rspec))[0]
    got = fuzz.host_check(spec, plan, record=True)
    assert got == rfuzz.host_check(rspec, rplan, record=True)
    assert got[0].startswith("execution orders diverge")
    # the correct Tempo on the same plan: no violation
    assert fuzz.host_check(replace(spec, inject_bug=False), plan)[0] is None


@pytest.fixture(scope="module")
def bug_point(tmp_path_factory):
    out = tmp_path_factory.mktemp("bug")
    res = fuzz.run_fuzz_point(fuzz.FuzzSpec(**BUG), device="cpu",
                              artifact_dir=str(out), **BUG_POINT)
    return res, out


def _ref_confirm(lane):
    """The reference's confirmation of one flagged lane, step by step as
    its ``run_fuzz_point`` takes it: ``host_check`` with the events
    recorded, ``shrink`` under the replay horizon and ``artifact``."""
    spec = rfuzz.FuzzSpec(**BUG)
    planet = spec.planet()
    regions = planet.regions()[: spec.n]
    plan = rfuzz.draw_plans(spec, rfuzz.point_config(spec),
                            rfuzz.point_protocol(spec))[lane]
    violation, events = rfuzz.host_check(spec, plan, planet=planet,
                                         regions=regions, record=True)
    run_plan = replace(plan, horizon_ms=rfuzz.REPLAY_HORIZON_MS)
    shrunk = rshrink.shrink(
        run_plan, events or [],
        lambda p: rfuzz.host_check(spec, p, planet=planet,
                                   regions=regions)[0],
        budget=BUG_POINT["shrink_budget"])
    return violation, shrunk


def test_run_fuzz_point_confirms_the_injected_bug_as_the_reference(
        bug_point):
    res, out = bug_point
    golden = json.loads(FIXTURE.read_text())
    flagged = [i for i, v in enumerate(golden["violation"]) if v]
    assert res.flagged == len(flagged) >= 1
    assert res.confirmed == 1 and res.unprocessed == len(flagged) - 1
    assert res.confirm_s > 0
    (finding,) = res.findings
    assert finding.lane == flagged[0]
    assert finding.violation & VIOL_ORDER
    violation, shrunk = _ref_confirm(finding.lane)
    assert finding.host_violation == violation is not None
    assert finding.shrunk.components == shrunk.components
    assert (finding.shrunk.size, finding.shrunk.runs) == (
        shrunk.size, shrunk.runs)
    assert finding.shrunk.size <= 10
    want = rshrink.artifact(
        shrunk, protocol="tempo", n=3, f=1, conflict=100, pool_size=1,
        clients_per_region=1, commands_per_client=5,
        regions=list(res.spec.planet().regions()[:3]), workload_seed=3,
        extra_time_ms=res.spec.extra_ms, inject_bug=True, aws=False,
        device={"lane": finding.lane, "violation": finding.violation,
                "violation_step": finding.violation_step})
    assert finding.artifact == want
    assert json.loads(Path(finding.artifact_path).read_text()) == want
    assert finding.artifact_path == str(out / "repro_tempo_n3_lane0.json")


def test_the_injected_bug_artifact_replays(bug_point, capsys):
    from fantoch_tpu_torch.cli import main

    res, _out = bug_point
    path = res.findings[0].artifact_path
    obj = fuzz.load_artifact(path)
    assert obj == rfuzz.load_artifact(path)
    assert obj["inject_bug"] and obj["perturbation_count"] <= 10
    replay = fuzz.replay_artifact(obj)
    assert replay == rfuzz.replay_artifact(obj)
    assert replay["reproduced"] and replay["matches_expected"]
    main(["mc", "--replay", path])
    assert json.loads(capsys.readouterr().out) == replay


@pytest.mark.slow
def test_run_fuzz_point_with_confirmation_equals_the_reference(
        bug_point, tmp_path):
    res, _out = bug_point
    ref = rfuzz.run_fuzz_point(rfuzz.FuzzSpec(**BUG),
                               artifact_dir=str(tmp_path), **BUG_POINT)

    def untimed(summary):
        return {k: v for k, v in summary.items()
                if k not in ("fuzz_elapsed_s", "schedules_per_sec")}

    assert untimed(res.summary()) == untimed(ref.summary())
    assert [f.artifact for f in res.findings] == [
        f.artifact for f in ref.findings]
    for f, rf in zip(res.findings, ref.findings):
        assert (Path(f.artifact_path).read_bytes()
                == Path(rf.artifact_path).read_bytes())
