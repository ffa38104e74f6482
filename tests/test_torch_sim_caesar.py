"""Caesar, its clock and dependency structures and the predecessors
executor of the host oracle (``fantoch_tpu_torch/protocol/caesar.py``,
``pred.py``, ``executor/pred.py``) against the reference on the CPU.

* the port's ``sim.Runner`` against the reference's for the cases of
  ``tests/test_sim_caesar.py`` ((3,1) and (5,2), the wait condition on
  and off), at 3 clients a process x 10 commands: every region's
  latencies, every process's metrics (the wait-condition delays and
  committed-deps histograms included) and per-key execution orders
  equal; the reference's scale (10 x 100) is in the slow tier;
* ``KeyClocks`` (predecessors and blockers) and ``QuorumClocks`` /
  ``QuorumRetries`` on random commands and replies equal the
  reference's, sets in their iteration order;
* why a jittered Caesar fuzz lane's latencies differ between the engine
  and the oracle (the reference's both, which the port reproduces): the
  oracle broadcasts an empty GC message every interval, the engine
  none, so their channel emission indices, which key the jitter draws,
  part; the same lane without jitter agrees.

Tolerance: none."""

import random

import pytest

from fantoch_tpu.core import command as rcommand
from fantoch_tpu.core import ids as rids
from fantoch_tpu.protocol import pred as rpred
from fantoch_tpu_torch.core import command, ids
from fantoch_tpu_torch.protocol import pred
from torch_oracle import PORT, REF, sim_run, totals
from torch_threads import one_torch_thread  # noqa: F401

CASES = {
    "wait_3_1": dict(n=3, f=1, caesar_wait_condition=True),
    "no_wait_3_1": dict(n=3, f=1, caesar_wait_condition=False),
    "wait_5_2": dict(n=5, f=2, caesar_wait_condition=True),
    "no_wait_5_2": dict(n=5, f=2, caesar_wait_condition=False),
}


def _check(got, n, commands, clients):
    t = totals(got)
    cmds = commands * clients * n
    assert t["fast_path"] + t["slow_path"] == cmds
    assert t["stable"] == n * cmds
    orders = list(got["orders"].values())
    assert orders[0] and all(o == orders[0] for o in orders)


@pytest.mark.parametrize("case", list(CASES))
def test_caesar_matches_the_reference(case):
    kw = CASES[case]
    got = sim_run(PORT, "caesar", **kw)
    assert got == sim_run(REF, "caesar", **kw)
    _check(got, kw["n"], 10, 3)


@pytest.mark.slow
@pytest.mark.parametrize("case", ["wait_3_1", "wait_5_2"])
def test_caesar_matches_the_reference_at_its_scale(case):
    kw = CASES[case]
    got = sim_run(PORT, "caesar", commands=100, clients=10, **kw)
    assert got == sim_run(REF, "caesar", commands=100, clients=10, **kw)
    _check(got, kw["n"], 100, 10)


def _pred_trace(mods, seed):
    """Random commands through ``KeyClocks`` (each new command's
    predecessors and blockers at a random clock) and random replies
    through ``QuorumClocks`` and ``QuorumRetries``."""
    command, ids, pred = mods
    rng = random.Random(seed)

    def dots(deps):
        return [(d.source, d.sequence) for d in deps]

    out = []
    clocks = pred.KeyClocks(1, 0)
    used = set()
    for seq in range(1, 40):
        dot = ids.Dot(rng.randrange(1, 4), seq)
        keys = rng.sample(["a", "b", "c"], rng.choice([1, 2]))
        cmd = command.Command(ids.Rifl(1, seq),
                              {0: {k: [("PUT", "v")] for k in keys}})
        clock = pred.Clock(rng.randrange(1, 40), rng.randrange(2, 4))
        if rng.random() < 0.7 or (clock.seq, clock.process_id) in used:
            clock = clocks.clock_next()
        used.add((clock.seq, clock.process_id))
        clocks.clock_join(clock)
        blocking = set()
        preds = clocks.predecessors(dot, cmd, clock, blocking)
        out.append((clock.seq, clock.process_id, dots(preds),
                    dots(blocking)))
        clocks.add(dot, cmd, clock)
        if rng.random() < 0.2:
            clocks.remove(cmd, clock)
    for _ in range(10):
        q = pred.QuorumClocks(1, 4, 3)
        r = pred.QuorumRetries(3)
        for pid in range(1, 5):
            if q.all():
                break
            deps = {ids.Dot(rng.randrange(1, 4), rng.randrange(1, 9))
                    for _ in range(rng.choice([0, 1, 2]))}
            q.add(pid, pred.Clock(rng.randrange(1, 9), pid), deps,
                  rng.random() < 0.7)
            if pid <= 3:
                r.add(pid, deps)
        clock, deps, ok = q.aggregated()
        out.append((clock.seq, clock.process_id, dots(deps), ok,
                    dots(r.aggregated()) if r.all() else None))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_pred_structures_match_the_reference(seed):
    got = _pred_trace((command, ids, pred), seed)
    assert got == _pred_trace((rcommand, rids, rpred), seed)
    assert any(x[2] for x in got)


# ----------------------------------------------------------------------
# Caesar fuzz lanes against the oracle: the empty GC broadcasts
# ----------------------------------------------------------------------

CAESAR_FUZZ = dict(protocol="caesar", n=3, f=1, schedules=1)


def _engine_sends(spec, plan):
    """The lane through the engine's plain twins, with every process →
    process send recorded where K6's twin keys its jitter draw:
    ``{(src, dst): [(k, send ms, message type)]}``, and the lane's
    results."""
    import importlib
    import inspect

    from fantoch_tpu_torch.engine.protocols.caesar import CaesarDev
    from fantoch_tpu_torch.mc import fuzz

    er = importlib.import_module("fantoch_tpu_torch.kernels.emit_rewrite")
    names = {CaesarDev.MPROPOSE: "MPropose", CaesarDev.MPROPOSEACK:
             "MProposeAck", CaesarDev.MCOMMIT: "MCommit",
             CaesarDev.MRETRY: "MRetry", CaesarDev.MRETRYACK: "MRetryAck",
             CaesarDev.MGC: "MGarbageCollection"}
    sends = {}
    draw = er.jitter_draw

    def spy(k0, k1, emitter, dst, kcnt, num):
        step = inspect.currentframe().f_back.f_locals
        wired, mtype, at = step["wired"][0], step["mtype"][0], step["ep_e"][0]
        src = emitter.expand_as(kcnt)[0]
        for e in wired.nonzero().flatten().tolist():
            sends.setdefault((int(src[e]) + 1, int(dst[0, e]) + 1), []).append(
                (int(kcnt[0, e]), int(at[e]), names[int(mtype[e])]))
        return draw(k0, k1, emitter, dst, kcnt, num)

    er.jitter_draw = spy
    try:
        res = fuzz.run_fuzz_point(spec, confirm=False, device="cpu",
                                  plans=[plan])
    finally:
        er.jitter_draw = draw
    return {ch: sorted(v) for ch, v in sends.items()}, res.lane_results[0]


def _oracle_sends(monkeypatch, spec, plan):
    """The same lane through the host oracle, every process → process
    send recorded with its channel index: ``{(src, dst): [(k, send ms,
    message type, the GC message's dots or None)]}``, and the
    latencies."""
    from fantoch_tpu_torch.mc import fuzz
    from fantoch_tpu_torch.protocol.caesar import MGarbageCollection
    from fantoch_tpu_torch.sim import runner

    sends = {}
    schedule = runner.Runner._schedule_message

    def spy(self, from_region, to_region, action, extra_delay=0):
        schedule(self, from_region, to_region, action, extra_delay)
        if (from_region[0] == to_region[0] == "process"
                and from_region[1] != to_region[1]):
            msg = action[-1]
            chan = (from_region[1], to_region[1])
            sends.setdefault(chan, []).append((
                self._chan_seq[chan], self.simulation.time.millis(),
                type(msg).__name__,
                list(msg.executed) if isinstance(msg, MGarbageCollection)
                else None))

    monkeypatch.setattr(runner.Runner, "_schedule_message", spy)
    _m, _mon, latencies, _p = fuzz.host_run(spec, plan)
    return sends, latencies


def _same_latencies(card, latencies):
    cap = len(card.hist[0]) - 1
    return all(
        sorted(min(v, cap) for v in h.all_values())
        == card.histogram(r).all_values()
        for r, (_issued, h) in latencies.items())


def test_caesar_lanes_differ_from_the_oracle_by_empty_gc_broadcasts(
        monkeypatch):
    """The reference's engine sends Caesar's MGC only when executed dots
    wait in its buffer (``fantoch_tpu/engine/protocols/caesar.py:309
    periodic``, the GC_DRAIN chain under ``pre_n > 0``); its oracle
    broadcasts ``MGarbageCollection`` every GC interval, empty or not
    (``fantoch_tpu/protocol/caesar.py:207 handle_event``). An empty one
    changes no state, so a lane without keyed wire draws agrees; under
    jitter every channel's emission index on the engine runs behind the
    oracle's by its empty broadcasts, the k-th message draws another
    multiplier and the latencies part (the port reproduces both sides)."""
    from dataclasses import replace

    from fantoch_tpu_torch.mc import fuzz

    spec = fuzz.FuzzSpec(**CAESAR_FUZZ)
    (plan,) = fuzz.draw_plans(spec, fuzz.point_config(spec),
                              fuzz.point_protocol(spec))
    assert plan.jitter_max == 8 and not plan.drop_bp and not plan.crashes
    engine, card = _engine_sends(spec, plan)
    oracle, latencies = _oracle_sends(monkeypatch, spec, plan)
    assert card.requeues == 0 and not _same_latencies(card, latencies)
    # on channel 1 -> 2 both send MPropose first, then the oracle an
    # empty GC broadcast at 100 ms as its second emission; the engine's
    # second emission is the next protocol message
    assert oracle[(1, 2)][:2] == [(1, 0, "MPropose", None),
                                  (2, 100, "MGarbageCollection", [])]
    assert engine[(1, 2)][0] == (1, 0, "MPropose")
    assert engine[(1, 2)][1][2] != "MGarbageCollection"
    # the engine's first MGC on any channel carries dots: it leaves
    # after the oracle's first empty one
    first_gc = min(t for v in engine.values() for _k, t, m in v
                   if m == "MGarbageCollection")
    empty = [t for v in oracle.values() for _k, t, m, dots in v
             if m == "MGarbageCollection" and not dots]
    assert empty and min(empty) < first_gc
    # without the keyed draws (jitter 1) the same lane agrees
    flat = replace(plan, jitter_max=1)
    _sends, card = _engine_sends(spec, flat)
    _sends, latencies = _oracle_sends(monkeypatch, spec, flat)
    assert _same_latencies(card, latencies)
