"""Tempo, TempoAtomic, the table executor and the native key clocks of the
host oracle (``fantoch_tpu_torch/protocol/tempo.py``, ``table.py``,
``executor/table.py``, ``native/``) against the reference on the CPU.

* the port's ``sim.Runner`` against the reference's for the cases of
  ``tests/test_sim_tempo.py`` ((3,1), (5,1), (5,2) at seed 3, real time
  (3,1) and (5,1) with a 50 ms clock bump, reorder seeds 1, 2 and 4), at
  3 clients a process x 10 commands: every region's latencies, every
  process's metrics and per-key execution orders equal, and the
  reference's own slow-path pins hold; the reference's scale (10 x 100)
  is in the slow tier;
* ``TempoAtomic`` equals ``Tempo`` and the reference's ``TempoAtomic``;
* the port's native ``AtomicKeyClocks`` gives the reference's clocks and
  vote triples on ``tests/test_native.py``'s cases and on 500 random
  proposals, and its votes stay gap-free under 2 and 8 threads;
* the library is built from the port's own source into
  ``fantoch_tpu_torch/_build/native/``, nothing is written beside the
  source, and a failed build raises with the compiler's message (no
  fallback to the sequential clocks).

Tolerance: none."""

import random

import pytest

from fantoch_tpu.native import AtomicKeyClocks as RAtomicKeyClocks
from fantoch_tpu_torch.core.ids import Rifl
from fantoch_tpu_torch.native import keyclocks
from fantoch_tpu_torch.native.keyclocks import AtomicKeyClocks
from fantoch_tpu_torch.protocol import TempoAtomic
from fantoch_tpu_torch.protocol.table import NativeAtomicKeyClocks
from torch_oracle import PORT, REF, sim_run, totals

# the cases of tests/test_sim_tempo.py: (n, f, seed, clock bump ms)
CASES = {
    "3_1": (3, 1, 0, None),
    "5_1": (5, 1, 0, None),
    "5_2": (5, 2, 3, None),
    "real_time_3_1": (3, 1, 0, 50),
    "real_time_5_1": (5, 1, 0, 50),
    "reorder_seed_1": (3, 1, 1, None),
    "reorder_seed_2": (3, 1, 2, None),
    "reorder_seed_4": (3, 1, 4, None),
}


def _tempo_kw(n, f, seed, bump):
    kw = dict(n=n, f=f, seed=seed, tempo_detached_send_interval_ms=100)
    if bump is not None:
        kw.update(tempo_tiny_quorums=True,
                  tempo_clock_bump_interval_ms=bump)
    return kw


def _check(case, got, commands, clients):
    n, f, _seed, _bump = CASES[case]
    t = totals(got)
    cmds = commands * clients * n
    assert t["fast_path"] + t["slow_path"] == cmds
    assert t["stable"] == n * cmds
    # the reference's pins: all fast but at (5, 2)
    assert (t["slow_path"] > 0) == (case == "5_2")
    orders = list(got["orders"].values())
    assert orders[0] and all(o == orders[0] for o in orders)


@pytest.mark.parametrize("case", list(CASES))
def test_tempo_matches_the_reference(case):
    kw = _tempo_kw(*CASES[case])
    got = sim_run(PORT, "tempo", **kw)
    assert got == sim_run(REF, "tempo", **kw)
    _check(case, got, 10, 3)


@pytest.mark.slow
@pytest.mark.parametrize("case", ["3_1", "5_2", "real_time_5_1"])
def test_tempo_matches_the_reference_at_its_scale(case):
    kw = _tempo_kw(*CASES[case])
    got = sim_run(PORT, "tempo", commands=100, clients=10, **kw)
    assert got == sim_run(REF, "tempo", commands=100, clients=10, **kw)
    _check(case, got, 100, 10)


@pytest.mark.parametrize("case", ["3_1", "5_2"])
def test_tempo_atomic_equals_tempo(case):
    kw = _tempo_kw(*CASES[case])
    got = sim_run(PORT, "tempo_atomic", **kw)
    assert got == sim_run(PORT, "tempo", **kw)
    assert got == sim_run(REF, "tempo_atomic", **kw)


def test_tempo_atomic_uses_the_native_clocks():
    assert TempoAtomic.KEY_CLOCKS is NativeAtomicKeyClocks
    clocks = NativeAtomicKeyClocks(1, 0, capacity=16)
    assert clocks.parallel()
    from fantoch_tpu_torch.core.command import Command

    cmd = Command(Rifl(1, 1), {0: {"a": [("PUT", "x")], "b": [("GET",)]}})
    clock, votes = clocks.proposal(cmd, 3)
    assert clock == 3
    assert {k: [(v.by, v.start, v.end) for v in vs]
            for k, vs in votes.items()} == {"a": [(1, 1, 3)],
                                            "b": [(1, 1, 3)]}


def _both(capacity):
    return AtomicKeyClocks(capacity), RAtomicKeyClocks(capacity)


def test_native_cases_match_the_reference():
    """``tests/test_native.py``'s single-threaded cases, call by call."""
    kc, rkc = _both(16)
    calls = [("proposal", [3], 0), ("proposal", [3], 0),
             ("proposal", [3], 10), ("clock", 3), ("proposal", [1], 5),
             ("proposal", [1, 2], 0), ("clock", 1), ("clock", 2),
             ("proposal", [7], 0), ("detached", [7, 8], 4),
             ("detached", [7], 2)]
    seen = []
    for name, *args in calls:
        got = getattr(kc, name)(*args)
        assert got == getattr(rkc, name)(*args), (name, args)
        seen.append(got)
    assert seen[:4] == [(1, [(3, 1, 1)]), (2, [(3, 2, 2)]),
                        (10, [(3, 3, 10)]), 10]
    assert seen[-1] == []


def test_native_random_proposals_match_the_reference():
    kc, rkc = _both(64)
    rng = random.Random(42)
    for _ in range(500):
        keys = rng.sample(range(20), rng.choice([1, 2, 3]))
        floor = rng.choice([0, 0, 0, rng.randrange(1, 40)])
        if rng.random() < 0.2:
            assert kc.detached(keys, floor) == rkc.detached(keys, floor)
        else:
            assert kc.proposal(keys, floor) == rkc.proposal(keys, floor)
    assert [kc.clock(k) for k in range(20)] == [
        rkc.clock(k) for k in range(20)]


@pytest.mark.parametrize("threads", [2, 8])
def test_native_votes_gap_free_under_threads(threads):
    ok, secs = AtomicKeyClocks(100).stress(
        threads, ops_per_thread=2000, key_count=100, keys_per_op=2)
    assert ok, "votes not gap-free/duplicate-free"
    assert secs > 0
    with pytest.raises(ValueError, match="keys_per_op"):
        AtomicKeyClocks(4).stress(2, 10, key_count=4, keys_per_op=5)


def test_native_library_lands_in_the_build_dir():
    AtomicKeyClocks(4)
    so = keyclocks.library_path()
    assert so.exists()
    assert so.parent == keyclocks.BUILD_DIR
    assert keyclocks.BUILD_DIR.parts[-2:] == ("_build", "native")
    assert keyclocks.BUILD_DIR.parent.parent == keyclocks.SRC.parent.parent
    beside = {p.name for p in keyclocks.SRC.parent.iterdir()
              if p.name != "__pycache__"}
    assert beside == {"__init__.py", "keyclocks.cpp", "keyclocks.py"}


def test_native_build_failure_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(keyclocks, "_lib", None)
    monkeypatch.setattr(keyclocks, "_build_error", None)
    monkeypatch.setattr(keyclocks, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(keyclocks, "COMPILE",
                        ["g++", "-DKC_BROKEN", "-include", "no_such.h"])
    for _ in range(2):  # and again, from the recorded error
        with pytest.raises(RuntimeError, match="no_such.h"):
            AtomicKeyClocks(4)
        with pytest.raises(RuntimeError, match="g\\+\\+ exited"):
            NativeAtomicKeyClocks(1, 0, capacity=4)
    assert not keyclocks.available()
    assert list(tmp_path.iterdir()) == []
