"""Host confirmation, shrinking and replay of the schedule fuzzer
(``fantoch_tpu_torch/mc/fuzz.py``, ``mc/shrink.py``) against the
reference's ``fantoch_tpu/mc`` on the CPU.

* ``host_check`` on every plan ``draw_plans`` gives a small FPaxos spec
  and a small Basic spec (jitter, crash and drop plans): the violation
  string and the recorded wire events equal;
* ``check_host_monitors`` on hand-made monitors with a duplicate,
  divergent orders, a count gap, a missing monitor, loss gating and an
  exactly-once total: the port's verdicts are the reference's;
* ``ddmin``, ``plan_components``/``components_plan`` and
  ``RecordingPlan`` as ``tests/test_mc_fuzz.py:226-283`` pins them, and
  equal to the reference's on the same inputs;
* ``run_fuzz_point(confirm=True)`` on an FPaxos point with a 1 ms drain
  tail under ``strict_missing`` (its lanes end before every follower has
  executed: the device flags missing executions, the oracle confirms a
  count divergence, the shrinker cuts the plan): the summary without
  timings, the host violations and the repro artifacts equal, each
  artifact also written to ``artifact_dir``;
* an artifact round trip: ``_persist_artifact`` writes the reference's
  bytes, ``load_artifact`` reads it back, ``replay_artifact`` gives the
  reference's dict (reproduced), and a clean plan replays with
  ``reproduced`` false on both sides; ``mc --replay`` exits 0 on the one
  and refuses the other;
* ``mc --protocols fpaxos`` without ``--no-confirm`` prints the
  reference CLI's summary outside its timings; on the ``TAIL`` point's
  1 ms drain tail its ``--out`` artifacts replay with ``--replay`` on
  the port and on the reference.

Tolerance: none."""

import json

import pytest

from fantoch_tpu.core import kvs as rkvs
from fantoch_tpu.core.ids import Rifl as RRifl
from fantoch_tpu.engine.faults import FaultPlan as RFaultPlan
from fantoch_tpu.mc import fuzz as rfuzz
from fantoch_tpu.mc import shrink as rshrink
from fantoch_tpu_torch.core import kvs
from fantoch_tpu_torch.core.ids import Rifl
from fantoch_tpu_torch.engine.faults import FaultPlan
from fantoch_tpu_torch.mc import fuzz, shrink
from torch_threads import one_torch_thread  # noqa: F401

# a point whose lanes end 1 ms after the last completion: followers have
# not executed everything yet, so with strict_missing every lane can
# flag, confirm and shrink
TAIL = dict(protocol="fpaxos", n=3, f=1, schedules=3, commands_per_client=2,
            seed=1, extra_time_ms=1, crash_share=0.0, drop_share=0.0)
POINT = dict(strict_missing=True, max_confirmations=2, shrink_budget=20)
# the drawn-plan specs: jitter, crash and drop plans
DRAWN = {
    "fpaxos": dict(protocol="fpaxos", n=3, f=1, schedules=4,
                   commands_per_client=3, seed=1, crash_share=0.34,
                   drop_share=0.33),
    "basic": dict(protocol="basic", n=3, f=1, schedules=3,
                  commands_per_client=3, seed=2, crash_share=0.34,
                  drop_share=0.33),
}


def _drawn(mod, name):
    spec = mod.FuzzSpec(**DRAWN[name])
    return spec, mod.draw_plans(spec, mod.point_config(spec),
                                mod.point_protocol(spec))


@pytest.mark.parametrize("name,lane", [
    (name, lane) for name, kw in DRAWN.items()
    for lane in range(kw["schedules"])])
def test_host_check_matches_the_reference_on_every_drawn_plan(name, lane):
    spec, plans = _drawn(fuzz, name)
    rspec, rplans = _drawn(rfuzz, name)
    assert plans[lane].meta() == rplans[lane].meta()
    got = fuzz.host_check(spec, plans[lane], record=True)
    want = rfuzz.host_check(rspec, rplans[lane], record=True)
    assert got == want
    assert got[1], "a jittered replay records wire events"


def test_drawn_specs_cover_every_plan_kind():
    for name in DRAWN:
        _, plans = _drawn(fuzz, name)
        kinds = {"crash" if p.crashes else "drop" if p.drop_bp else "jitter"
                 for p in plans}
        assert kinds == {"crash", "drop", "jitter"}, (name, kinds)


def _monitors(mod, rifl, orders):
    out = {}
    for pid, keys in orders.items():
        m = mod.ExecutionOrderMonitor()
        for key, seq in keys.items():
            for source, sequence in seq:
                m.add(key, rifl(source, sequence))
        out[pid] = m
    return out


A, B, C = (1, 1), (2, 1), (3, 1)
MONITOR_CASES = {
    "clean": ({1: {"0": [A, B]}, 2: {"0": [A, B]}}, [1, 2], 2, True, None),
    "duplicate": ({1: {"0": [A, A]}, 2: {"0": [A]}}, [1, 2], None, False,
                  "process 1 key '0': duplicate execution"),
    "divergent": ({1: {"0": [A, B]}, 2: {"0": [B, A]}}, [1, 2], None, True,
                  "execution orders diverge on key '0' at index 0: "
                  "p1=(1, 1) p2=(2, 1)"),
    "lossy_divergence_ignored": ({1: {"0": [A, B]}, 2: {"0": [B, A]}},
                                 [1, 2], None, False, None),
    "count_gap": ({1: {"0": [A, B, C]}, 2: {"0": [A, B]}}, [1, 2], None,
                  True, "key '0': execution counts diverge (p1=3 p2=2)"),
    "total": ({1: {"0": [A], "1": [B]}, 2: {"0": [A], "1": [B]}}, [1, 2],
              3, True, "process 1 executed 2 != 3 commands"),
    "no_monitor": ({1: {"0": [A]}}, [1, 2], None, True,
                   "process 2: no execution monitor"),
    "crashed_skipped": ({1: {"0": [A]}, 3: {"0": [B]}}, [1], 1, True, None),
}


@pytest.mark.parametrize("case", list(MONITOR_CASES))
def test_check_host_monitors_matches_the_reference(case):
    orders, live, expected, lossless, verdict = MONITOR_CASES[case]
    got = fuzz.check_host_monitors(
        _monitors(kvs, Rifl, orders), live, expected, lossless)
    want = rfuzz.check_host_monitors(
        _monitors(rkvs, RRifl, orders), live, expected, lossless)
    assert got == want == verdict


def test_ddmin_reduces_to_the_culprit_as_the_reference():
    comps = [("jit", (0, 1, k), 2) for k in range(40)]
    culprit = ("jit", (2, 0, 99), 7)
    comps.insert(17, culprit)
    calls = {"port": [], "ref": []}

    def oracle(side):
        def test_fn(cand):
            calls[side].append(list(cand))
            return "viol" if culprit in cand else None
        return test_fn

    got = shrink.ddmin(comps, oracle("port"), budget=100)
    want = rshrink.ddmin(comps, oracle("ref"), budget=100)
    assert got == want
    assert got[0] == [culprit] and got[1] == "viol"
    assert got[2] == len(calls["port"]) <= 100
    assert calls["port"] == calls["ref"]
    never = shrink.ddmin(comps[:32], lambda _c: None, budget=10)
    assert never == rshrink.ddmin(comps[:32], lambda _c: None, budget=10)
    assert never[2] <= 10 and never[0] == comps[:32] and never[1] is None


def test_components_round_trip_as_the_reference():
    kw = dict(crashes={1: 300}, drop_bp=100, drop_seed=3, horizon_ms=5000,
              jitter_max=4, jitter_seed=2)
    events = [("jit", (0, 1, 5), 3), ("drop", (2, 0, 9), None),
              ("jit", (0, 1, 5), 3)]
    comps = shrink.plan_components(FaultPlan(**kw), events)
    assert comps == rshrink.plan_components(RFaultPlan(**kw), events) == [
        ("crash", 1, 300), ("jit", (0, 1, 5), 3), ("drop", (2, 0, 9), None)]
    explicit = shrink.components_plan(comps, 5000)
    assert explicit.meta() == rshrink.components_plan(comps, 5000).meta()
    assert explicit.crashes == {1: 300}
    assert explicit.jitter_overrides == {(0, 1, 5): 3}
    assert explicit.drop_list == ((2, 0, 9),)
    assert explicit.host_only() and explicit.jitter_max == 0


def test_recording_plan_records_as_the_reference():
    events = []
    for mod, plan_cls in ((shrink, FaultPlan), (rshrink, RFaultPlan)):
        plan = mod.RecordingPlan.of(plan_cls(
            jitter_overrides={(0, 1, 3): 4}, drop_list=((0, 2, 1),),
            horizon_ms=1000))
        out = [plan.wire(0, 1, 10, 50, 3), plan.wire(0, 1, 10, 50, 4),
               plan.wire(0, 2, 10, 50, 1)]
        events.append((out, plan.events))
    assert events[0] == events[1]
    assert events[0][1] == [("jit", (0, 1, 3), 4), ("drop", (0, 2, 1), None)]


@pytest.fixture(scope="module")
def tail_points(tmp_path_factory):
    got = fuzz.run_fuzz_point(
        fuzz.FuzzSpec(**TAIL), device="cpu",
        artifact_dir=str(tmp_path_factory.mktemp("artifacts")), **POINT)
    want = rfuzz.run_fuzz_point(rfuzz.FuzzSpec(**TAIL), **POINT)
    return got, want


def _untimed(summary):
    return {k: v for k, v in summary.items()
            if k not in ("fuzz_elapsed_s", "schedules_per_sec")}


def test_run_fuzz_point_confirms_and_shrinks_as_the_reference(tail_points):
    got, want = tail_points
    assert _untimed(got.summary()) == _untimed(want.summary())
    assert got.confirmed >= 1 and got.confirm_s > 0
    assert [f.host_violation for f in got.findings] == [
        f.host_violation for f in want.findings]
    assert [f.artifact for f in got.findings] == [
        f.artifact for f in want.findings]
    assert any(f.shrunk is not None for f in got.findings)
    for f in got.findings:
        # artifact_dir: each artifact written the moment it exists
        assert (f.artifact_path is None) == (f.artifact is None)
        if f.artifact_path:
            assert json.load(open(f.artifact_path)) == f.artifact


def test_artifact_round_trip(tail_points, tmp_path, capsys):
    from fantoch_tpu_torch.cli import main

    got, want = tail_points
    finding = next(f for f in got.findings if f.artifact is not None)
    rfinding = next(f for f in want.findings if f.artifact is not None)
    spec, rspec = fuzz.FuzzSpec(**TAIL), rfuzz.FuzzSpec(**TAIL)
    path = fuzz._persist_artifact(str(tmp_path / "port"), spec, finding)
    rpath = rfuzz._persist_artifact(str(tmp_path / "ref"), rspec, rfinding)
    assert open(path).read() == open(rpath).read()
    obj = fuzz.load_artifact(path)
    assert obj == json.loads(json.dumps(finding.artifact))
    replay = fuzz.replay_artifact(obj)
    assert replay == rfuzz.replay_artifact(obj)
    assert replay["reproduced"] and replay["matches_expected"]
    main(["mc", "--replay", path])
    assert json.loads(capsys.readouterr().out) == replay

    # the same point with its drain tail: nothing to reproduce
    clean = dict(obj, extra_time_ms=5000, perturbations={})
    replay = fuzz.replay_artifact(clean)
    assert replay == rfuzz.replay_artifact(clean)
    assert not replay["reproduced"] and replay["violation"] is None
    (tmp_path / "clean.json").write_text(json.dumps(clean))
    with pytest.raises(SystemExit, match="did not reproduce"):
        main(["mc", "--replay", str(tmp_path / "clean.json")])


GRID = ["mc", "--protocols", "fpaxos", "--ns", "3", "--schedules",
        "2", "--commands", "2", "--seed", "1", "--crash-share", "0",
        "--drop-share", "0", "--strict-missing", "--max-confirm", "1",
        "--shrink-budget", "5"]


def test_mc_confirm_summary_matches_the_reference_cli(capsys, tmp_path):
    from fantoch_tpu.cli import main as r_main
    from fantoch_tpu_torch.cli import main

    def untimed(out):
        line = json.loads(out.strip().splitlines()[-1])
        for d in [line] + line["grid"]:
            for k in ("elapsed_s", "fuzz_elapsed_s", "schedules_per_sec"):
                d.pop(k, None)
        line["artifacts"] = [p.rsplit("/", 1)[1] for p in line["artifacts"]]
        return line

    r_main(["--platform", "cpu", *GRID, "--out", str(tmp_path / "ref")])
    want = untimed(capsys.readouterr().out)
    main(["--device", "cpu", *GRID, "--out", str(tmp_path / "port")])
    got = untimed(capsys.readouterr().out)
    assert got == want
    assert got["points"] == 1 and got["schedules"] == 2
    for name in got["artifacts"]:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "ref" / name).read_bytes())


def test_mc_out_writes_artifacts_that_replay(tmp_path, capsys,
                                             monkeypatch):
    """``mc --out`` writes the artifacts of the confirmed lanes, and
    ``--replay`` of one reproduces its violation, on the port as on the
    reference. The CLI has no drain-tail option (the reference's has
    none), so the grid's specs get the ``TAIL`` point's 1 ms tail here:
    its flagged lanes confirm and shrink."""
    from dataclasses import replace

    from fantoch_tpu_torch import cli

    specs = cli.mc_specs
    monkeypatch.setattr(cli, "mc_specs", lambda args: [
        replace(s, extra_time_ms=TAIL["extra_time_ms"]) for s in specs(args)])
    out = tmp_path / "repros"
    cli.main(["--device", "cpu", *GRID, "--out", str(out)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["confirmed"] >= 1 and line["artifacts"]
    assert sorted(line["artifacts"]) == sorted(
        str(p) for p in out.glob("repro_*.json"))
    path = line["artifacts"][0]
    cli.main(["mc", "--replay", path])
    replay = json.loads(capsys.readouterr().out)
    assert replay["reproduced"]
    assert replay == rfuzz.replay_artifact(rfuzz.load_artifact(path))
