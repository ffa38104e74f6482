"""Atlas, EPaxos, their dependency structures and the graph executor of
the host oracle (``fantoch_tpu_torch/protocol/atlas.py``, ``epaxos.py``,
``graph_deps.py``, ``executor/graph.py``) against the reference on the
CPU.

* the port's ``sim.Runner`` against the reference's for the cases of
  ``tests/test_sim_atlas.py`` and ``tests/test_sim_epaxos.py`` ((3,1)
  and (5,2)), at 3 clients a process x 10 commands (and one reorder
  seed each): every region's latencies, every process's metrics and
  per-key execution orders equal; the reference's scale (10 x 100) is in
  the slow tier;
* the ``GraphExecutor`` on hand-built dependency graphs, drawn from a
  seed, with cycles and dependencies that arrive after their dependents:
  every command's execution order, the results to the clients and the
  executor metrics equal the reference's;
* ``QuorumDeps`` and ``SequentialKeyDeps`` on random reports: the fast
  path tests and the dependency sets equal the reference's.

Tolerance: none."""

import random

import pytest

from fantoch_tpu import core as rcore
from fantoch_tpu.core import command as rcommand
from fantoch_tpu.core import ids as rids
from fantoch_tpu.core import timing as rtiming
# the reference's protocols import its executors: load them first
from fantoch_tpu.protocol import graph_deps as rgraph_deps  # noqa: I001
from fantoch_tpu.executor import graph as rgraph
from fantoch_tpu_torch import core
from fantoch_tpu_torch.core import command, ids, timing
from fantoch_tpu_torch.executor import graph
from fantoch_tpu_torch.protocol import graph_deps
from torch_oracle import PORT, REF, sim_run, totals

CASES = {
    "3_1": dict(n=3, f=1),
    "5_2": dict(n=5, f=2),
    "3_1_seed_2": dict(n=3, f=1, seed=2),
}


def _check(got, n, commands, clients):
    t = totals(got)
    cmds = commands * clients * n
    assert t["fast_path"] + t["slow_path"] == cmds
    assert t["stable"] == n * cmds
    orders = list(got["orders"].values())
    assert orders[0] and all(o == orders[0] for o in orders)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("name", ["atlas", "epaxos"])
def test_graph_protocol_matches_the_reference(name, case):
    kw = CASES[case]
    got = sim_run(PORT, name, **kw)
    assert got == sim_run(REF, name, **kw)
    _check(got, kw["n"], 10, 3)
    if kw["n"] == 3:
        # the reference's pins: n = 3 is all fast path
        assert totals(got)["slow_path"] == 0


@pytest.mark.slow
@pytest.mark.parametrize("case", ["3_1", "5_2"])
@pytest.mark.parametrize("name", ["atlas", "epaxos"])
def test_graph_protocol_matches_the_reference_at_its_scale(name, case):
    kw = CASES[case]
    got = sim_run(PORT, name, commands=100, clients=10, **kw)
    assert got == sim_run(REF, name, commands=100, clients=10, **kw)
    _check(got, kw["n"], 100, 10)


# ----------------------------------------------------------------------
# the graph executor on hand-built graphs
# ----------------------------------------------------------------------

PORT_MODS = (core, command, ids, timing, graph, graph_deps)
REF_MODS = (rcore, rcommand, rids, rtiming, rgraph, rgraph_deps)


def _draw_graph(seed, size):
    """``size`` commands over 3 keys: each depends on a random subset of
    the others (cycles included), and they arrive in a random order, so
    some arrive before their dependencies. Returns plain data."""
    rng = random.Random(seed)
    dots = [(rng.randrange(1, 4), seq) for seq in range(1, size + 1)]
    nodes = []
    for i, dot in enumerate(dots):
        keys = rng.sample(["a", "b", "c"], rng.choice([1, 2]))
        others = [d for j, d in enumerate(dots) if j != i]
        deps = rng.sample(others, rng.choice([0, 1, 1, 2, 3]))
        nodes.append((dot, keys, deps))
    rng.shuffle(nodes)
    return nodes


def _execute(mods, nodes, step_ms=5):
    core, command, ids, timing, graph, graph_deps = mods
    config = core.Config(n=3, f=1, executor_monitor_execution_order=True)
    executor = graph.GraphExecutor(1, 0, config)
    time = timing.SimTime()
    out = []
    for (source, seq), keys, deps in nodes:
        time.add_millis(step_ms)
        dot = ids.Dot(source, seq)
        cmd = command.Command(ids.Rifl(source, seq),
                              {0: {k: [("PUT", f"{source}.{seq}")]
                                   for k in keys}})
        executor.handle(graph.GraphAdd(dot, cmd, {
            graph_deps.Dependency(ids.Dot(*d), frozenset({0}))
            for d in deps}), time)
        out.append([(r.rifl.source, r.rifl.sequence, r.key,
                      r.partial_results) for r in executor.to_clients()])
    monitor = executor.monitor()
    orders = {k: [(r.source, r.sequence) for r in monitor.get_order(k)]
              for k in sorted(monitor.keys())}
    m = executor.metrics()
    metrics = ({k.value: v for k, v in m.aggregated.items()},
               {k.value: h.all_values() for k, h in m.collected.items()})
    return out, orders, metrics


@pytest.mark.parametrize("seed", range(8))
def test_graph_executor_matches_the_reference_on_drawn_graphs(seed):
    nodes = _draw_graph(seed, 12)
    got = _execute(PORT_MODS, nodes)
    assert got == _execute(REF_MODS, nodes)
    _results, orders, _metrics = got
    # every command's dependencies are all added by the end: everything
    # executes, once
    executed = {d for order in orders.values() for d in order}
    assert executed == {dot for dot, _k, _d in nodes}


def test_graph_executor_runs_a_cycle_only_when_it_closes():
    # 1 -> 2 -> 3 -> 1 arrive in order: nothing runs until the last edge
    nodes = [((1, 1), ["a"], [(2, 2)]), ((2, 2), ["a"], [(3, 3)]),
             ((3, 3), ["a"], [(1, 1)])]
    results, orders, _ = _execute(PORT_MODS, nodes)
    assert results[:2] == [[], []]
    assert sorted(orders["a"]) == [(1, 1), (2, 2), (3, 3)]
    assert (results, orders) == _execute(REF_MODS, nodes)[:2]


def _deps_trace(mods, seed):
    """Random reports through ``QuorumDeps`` (Atlas's threshold union
    at f = 1, EPaxos's equal union) and random commands and noops
    through ``SequentialKeyDeps``, each set in its iteration order."""
    _core, command, ids, _timing, _graph, graph_deps = mods
    rng = random.Random(seed)

    def listed(deps):
        return [(d.dot.source, d.dot.sequence, d.shards) for d in deps]

    out = []
    for _ in range(20):
        q = graph_deps.QuorumDeps(3)
        for pid in range(1, 4):
            q.add(pid, {graph_deps.Dependency(
                ids.Dot(rng.randrange(1, 4), rng.randrange(1, 5)),
                frozenset({0})) for _ in range(rng.choice([0, 1, 2]))})
        threshold, fast = q.check_threshold_union(1)
        union, equal = q.check_union()
        out.append((listed(threshold), fast, listed(union), equal))
    key_deps = graph_deps.SequentialKeyDeps(0)
    for seq in range(1, 30):
        dot = ids.Dot(rng.randrange(1, 4), seq)
        if rng.random() < 0.1:
            out.append(listed(key_deps.add_noop(dot)))
            continue
        keys = rng.sample(["a", "b", "c", "d"], rng.choice([1, 2]))
        cmd = command.Command(ids.Rifl(1, seq),
                              {0: {k: [("GET",)] for k in keys}})
        out.append(listed(key_deps.add_cmd(dot, cmd)))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_dependency_structures_match_the_reference(seed):
    got = _deps_trace(PORT_MODS, seed)
    assert got == _deps_trace(REF_MODS, seed)
    assert any(len(x) > 1 for x in got if isinstance(x, list))
