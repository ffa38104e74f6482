"""Why the mc default grid's Atlas n = 5 point flags order divergence on
the device while the host oracle confirms none: the engine's graph
executor drains in another order than the reference's Tarjan executor.

Lane 3 of the point (seed 0, a jitter-only plan) through the port's
engine (the plain twins on the CPU; the device kernels equal them) and
through the host oracles of the port and of the reference:

* the device flags ``order-divergence`` and the host check clears it;
  ``run_fuzz_point(confirm=True)`` counts the lane flagged, not
  confirmed;
* both commit every dot with the same dependencies: the dependency set
  the engine holds for each dot it executes is the one the oracle's
  ``GraphAdd`` carries (port and reference alike);
* the engine's drain (``engine/protocols/graphdep.py _drain``: a vertex
  whose dependencies all executed, else the smallest dot of every
  vertex whose dependency closure is committed) is not an SCC order. At
  process 1 nothing is ready when the components {(2,5), (3,5), (5,3)}
  and {(1,4), (4,4)} (which depends on the first) are both committed,
  so it runs (1,4) first, ahead of its dependency (5,3), and (2,5)
  next; then (4,4) and (4,5), ready beside (5,3), run before it as the
  smaller dots. Process 2 commits (4,5) later and runs (5,3) first. The
  oracle runs the components in dependency order, each in dot order, at
  every process.

So the flags are a finding of the engine (the reference's as much as
the port's, which reproduces both sides), not of Atlas. The slow tier
runs the reference's own engine on the lane: the same flag at the same
step. Tolerance: none."""

import pytest

from fantoch_tpu.mc import fuzz as rfuzz
from fantoch_tpu_torch.engine.monitor import VIOL_ORDER
from fantoch_tpu_torch.engine.protocols import graphdep
from fantoch_tpu_torch.mc import fuzz
from torch_threads import one_torch_thread  # noqa: F401

SPEC = dict(protocol="atlas", n=5, f=1, schedules=16)
LANE = 3
N = 5


def _plans(mod):
    spec = mod.FuzzSpec(**SPEC)
    return spec, mod.draw_plans(spec, mod.point_config(spec),
                                mod.point_protocol(spec))


def _oracle_deps(monkeypatch, graph_mod, spec, plan, fuzz_mod):
    """Each process's ``GraphAdd`` dependencies by dot, and each
    process's key-0 execution order, of one host run."""
    deps = {}
    handle = graph_mod.GraphExecutor.handle

    def spy(self, info, time):
        if isinstance(info, graph_mod.GraphAdd):
            deps.setdefault(self.process_id, {})[
                (info.dot.source, info.dot.sequence)] = sorted(
                (d.dot.source, d.dot.sequence) for d in info.deps)
        return handle(self, info, time)

    runs = []
    run = fuzz_mod.Runner.run

    def recorded(self, *a, **kw):
        runs.append(run(self, *a, **kw))
        return runs[-1]

    with monkeypatch.context() as m:
        m.setattr(graph_mod.GraphExecutor, "handle", spy)
        m.setattr(fuzz_mod.Runner, "run", recorded)
        fuzz_mod.host_check(spec, plan)
    (_metrics, monitors, _latencies), = runs
    orders = {pid: [(r.source, r.sequence) for r in mon.get_order("0")]
              for pid, mon in monitors.items()}
    return deps, orders


@pytest.fixture(scope="module")
def engine_lane():
    """The lane through the engine with its executions recorded at the
    monitor hook: per process, each executed dot with the dependencies
    the engine holds for it."""
    spec, plans = _plans(fuzz)
    executed = {}
    hook = graphdep.mon_exec

    def spy(ps, key, src, seq, enable, premature=None):
        if "_mon_hash" in ps:
            shape = ps["_mon_hash"].shape[:2]
            s, q, e = (graphdep.torch.as_tensor(x).expand(shape)
                       for x in (src, seq, enable))
            D = ps["vx_seq"].shape[-1]
            for lane, p in e.nonzero().tolist():
                row, sq = int(s[lane, p]), int(q[lane, p])
                slot = (sq - 1) % D
                dsrc = ps["vx_dep_src"][lane, p, row, slot].tolist()
                dseq = ps["vx_dep_seq"][lane, p, row, slot].tolist()
                executed.setdefault(p + 1, []).append((
                    (row + 1, sq),
                    sorted((a + 1, b) for a, b in zip(dsrc, dseq) if b)))
        return hook(ps, key, src, seq, enable, premature)

    graphdep.mon_exec = spy
    try:
        res = fuzz.run_fuzz_point(spec, device="cpu", plans=[plans[LANE]])
    finally:
        graphdep.mon_exec = hook
    return spec, plans[LANE], res, executed


def test_the_device_flags_and_the_oracle_clears(engine_lane):
    _spec, _plan, res, _executed = engine_lane
    assert res.flagged == 1 and res.confirmed == 0
    (finding,) = res.findings
    assert finding.violation == VIOL_ORDER
    assert finding.host_violation is None
    rspec, rplans = _plans(rfuzz)
    assert rfuzz.host_check(rspec, rplans[LANE])[0] is None


def test_engine_and_oracles_commit_the_same_dependencies(engine_lane,
                                                         monkeypatch):
    from fantoch_tpu.executor import graph as rgraph
    from fantoch_tpu_torch.executor import graph

    spec, plan, _res, executed = engine_lane
    deps, orders = _oracle_deps(monkeypatch, graph, spec, plan, fuzz)
    rspec, rplans = _plans(rfuzz)
    rdeps, rorders = _oracle_deps(monkeypatch, rgraph, rspec, rplans[LANE],
                                  rfuzz)
    assert (deps, orders) == (rdeps, rorders)
    for pid in range(1, N + 1):
        assert len(executed[pid]) == 25
        for dot, dot_deps in executed[pid]:
            assert deps[pid][dot] == dot_deps, (pid, dot)
    # the oracle: one order at every process
    assert all(o == orders[1] for o in orders.values())


def test_the_engine_drain_runs_ahead_of_a_dependency(engine_lane,
                                                     monkeypatch):
    from fantoch_tpu_torch.executor import graph

    spec, plan, _res, executed = engine_lane
    deps, orders = _oracle_deps(monkeypatch, graph, spec, plan, fuzz)
    engine = {pid: [d for d, _ in xs] for pid, xs in executed.items()}
    # the engine's processes disagree: p1 runs (4,5) before (5,3), p2
    # the other way round
    first = next(i for i, (a, b) in enumerate(zip(engine[1], engine[2]))
                 if a != b)
    assert (engine[1][first:first + 2], engine[2][first:first + 2]) == (
        [(4, 5), (5, 3)], [(5, 3), (4, 5)])
    # (1,4) depends on (5,3), and p1's engine runs it first
    assert (5, 3) in deps[1][(1, 4)] and (1, 4) in deps[1][(4, 4)]
    assert engine[1].index((1, 4)) < engine[1].index((5, 3))
    # the oracle: the component {(2,5), (3,5), (5,3)}, then {(1,4),
    # (4,4)}, each in dot order, then (4,5)
    at = orders[1].index((2, 5))
    assert orders[1][at:at + 6] == [(2, 5), (3, 5), (5, 3), (1, 4), (4, 4),
                                    (4, 5)]


@pytest.mark.slow
def test_the_reference_engine_flags_the_lane(engine_lane):
    _spec, _plan, res, _executed = engine_lane
    rspec, rplans = _plans(rfuzz)
    ref = rfuzz.run_fuzz_point(rspec, confirm=False, plans=[rplans[LANE]])
    (rfinding,) = ref.findings
    (finding,) = res.findings
    assert (rfinding.violation, rfinding.violation_step) == (
        finding.violation, finding.violation_step)
