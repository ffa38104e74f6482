"""The bounded model checker (``fantoch_tpu_torch/mc/checker.py``) against
the reference's ``fantoch_tpu/mc/checker.py`` on the CPU.

For each of ``tests/test_mc.py``'s five protocols, the port's
``CheckResult`` equals the reference's field for field (visited states,
quiescent leaves, truncation, violation): at ``max_states=1000`` here,
and at the reference test's own bounds (5,000; Caesar 2,000) in the slow
tier. ``test_detects_divergence``'s ``execute_at_commit`` twin is caught
with the reference's violation string. The explorer is host code: it
launches no kernel. Tolerance: none."""

import dataclasses

import pytest

from fantoch_tpu import protocol as rprotocol
from fantoch_tpu.core import Config as RConfig
from fantoch_tpu.mc import ModelChecker as RModelChecker
from fantoch_tpu_torch import protocol as pprotocol
from fantoch_tpu_torch.core import Config
from fantoch_tpu_torch.mc import CheckResult, ModelChecker

# tests/test_mc.py's parameters: protocol, config knobs, its own bound
CASES = [
    ("Tempo", dict(tempo_detached_send_interval_ms=1000), 5_000),
    ("Atlas", {}, 5_000),
    ("EPaxos", {}, 5_000),
    ("FPaxos", dict(leader=1), 5_000),
    ("Caesar", dict(caesar_wait_condition=True), 2_000),
]
# Tempo's result at its bound, which chip_smoke.py's phase 10 holds the
# card's host to
TEMPO_AT_BOUND = {"states": 5001, "quiescent": 1763, "truncated": True,
                  "violation": None}


def _pair(name, kw, max_states, **extra):
    ref = RModelChecker(getattr(rprotocol, name), RConfig(n=3, f=1, **kw),
                        clients=2, commands_per_client=1,
                        max_states=max_states, **extra).run()
    got = ModelChecker(getattr(pprotocol, name), Config(n=3, f=1, **kw),
                       clients=2, commands_per_client=1,
                       max_states=max_states, **extra).run()
    assert isinstance(got, CheckResult)
    return dataclasses.asdict(got), dataclasses.asdict(ref), got


@pytest.mark.parametrize("name,kw,_bound", CASES,
                         ids=[c[0] for c in CASES])
def test_check_result_matches_the_reference(name, kw, _bound):
    got, want, res = _pair(name, kw, 1000)
    assert got == want
    assert res.ok and res.truncated and res.quiescent > 100


@pytest.mark.slow
@pytest.mark.parametrize("name,kw,bound", CASES, ids=[c[0] for c in CASES])
def test_check_result_matches_the_reference_at_its_bounds(name, kw, bound):
    got, want, res = _pair(name, kw, bound)
    assert got == want
    assert res.ok and res.quiescent > 100
    if name == "Tempo":
        assert got == TEMPO_AT_BOUND


def test_detects_divergence_as_the_reference():
    """A Tempo that executes at commit (skipping the ordering layer)
    breaks agreement; the port finds it at the reference's state with the
    reference's violation string."""

    class RTempoUnordered(rprotocol.Tempo):
        pass

    class TempoUnordered(pprotocol.Tempo):
        pass

    ref = RModelChecker(RTempoUnordered,
                        RConfig(n=3, f=1, execute_at_commit=True),
                        clients=2, commands_per_client=1,
                        max_states=50_000).run()
    got = ModelChecker(TempoUnordered,
                       Config(n=3, f=1, execute_at_commit=True),
                       clients=2, commands_per_client=1,
                       max_states=50_000).run()
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert not got.ok and "diverge" in got.violation
