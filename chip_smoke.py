#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

Run from the root of a checkout, with one CUDA card and no arguments:

    python3 chip_smoke.py

It builds the engine's thirteen CUDA kernels and the device loop's graph
code from ``fantoch_tpu_torch/kernels/csrc`` (one nvcc per source, in
parallel), holds each kernel against its plain PyTorch twin on the card
at the main paths' shapes (exact equality: all integer or bool data;
``key_table`` also on a batch of Zipf lanes; the whole step with every
third lane failed, and with its step cap a device word that stops some
lanes and not others (every plane of a frozen lane as it was, K2's
``running`` the predicate); ``loop_ctl`` (K14) before the loop and in a body on
ladders it has to walk; ``tempo_handle`` over further steps until every Tempo
message type and the GC and detached-send timers have been handled;
``graphdep_handle``, on the Atlas and on the EPaxos path, until every
message type, the GC timer and a drain chain have been;
``caesar_handle`` until every Caesar message type, both timers, an exec
and a wait chain, a reject reply and an MRetry broadcast have been;
``tempo_partial_handle`` until every one of its fifteen message types,
the GC and detached-send timers, a two-shard commit (MShardCommit →
MShardAgg) and a StableAtShard round have been, then on every step of a
small batch whose clock bump fires; ``atlas_partial_handle`` until every
one of its fourteen message types, both timers, a two-shard commit, a
request answered at once and one answered by the cleanup tick, and a
drain chain have been, then on every step of a small batch whose
cleanup tick runs every 5 ms; ``qualify_pop``, ``emit_rewrite`` and
``land_emissions`` under the fault flags on every step of a fault-coverage
batch until a crash purge, a crashed timer, a halted client, an
unavailable lane, a multiplier and an override window, a partition, an
overflowing multiplier, a jitter multiplier, a drop and a horizon-cut
result have been compared, ``emit_rewrite`` on every step of a small
reorder batch and of a partially replicated reorder lane, and at 1,060
and 1,540 emission rows a lane)
beside the
least time its region's work needs (each kernel module's ``work``,
``kernels/cost.py``) — a kernel's ``ms`` is its device time per launch
under ``torch.profiler``, ``call_ms`` the wrapper's whole call (host
included) — checks the Basic golden numbers and the committed
``tests/fixtures/torch_{basic,fpaxos,tempo,graphdep,caesar,tempo_partial,
atlas_partial,faults}_golden.json`` bytes on the card, then drives the nine
main paths — the
2,048-lane Basic, FPaxos, Tempo, Atlas, EPaxos and Caesar sweeps (n =
5, 256 five-region subsets × f ∈ {1, 2} × conflict ∈ {0, 10, 50, 100},
50 commands per client, one client per region) and the 512-lane sweep of
Tempo under partial replication (2 shards of 5 rows, 2 keys per command
from a pool of 4, the first 64 subsets, conflict 1 in place of 0) and
the same 512-lane grid of Atlas under partial replication at 9 commands
per client, and the 2,048-lane Tempo grid under four fault plans (the
first 64 subsets, each point once per plan; its fault-free lanes equal
the Tempo sweep's byte for byte) — through ``run_sweep``, each with
every launch counter set to 0 just before and read just after, and
holds sampled lanes of each to the plain twins on the host. Then the
safety monitors' paths: the monitor branches of the five handler
kernels and of ``emit_rewrite`` against their twins on every step of
small monitored batches of all six protocols (until executions, a
monitor-key-range, a missing-execution and, on the injected-bug point,
an order-divergence violation were seen; the injected-bug point's
per-lane violations, steps and digests equal
``tests/fixtures/torch_fuzz_bug_golden.json``), the 2,048-lane Tempo
sweep with the monitors on (equal to the unmonitored sweep outside the
three monitor fields), slice 9's main path — the ``mc --no-confirm``
default grid, Tempo, FPaxos and Atlas × n ∈ {3, 5} × 512 schedules,
counted, lanes 0–3 and the last of each point held to the host twins —
and the reference bench's fuzz point (nothing flagged), with
``mon_finalize`` against its twin on the final state of every
monitored batch. Then slice 10's paths: ``key_table``'s epoch branch
against its twin on every lane of the Tempo traffic sweeps' batches and
of an epoch-Zipf batch; ``emit_rewrite`` under the open-loop and think
flags on every step of small open-loop batches (Tempo and FPaxos, with
and without a crash and drops, Tempo also through a double-reply
wrapper) and of a diurnal batch, until a staged SUBMIT, a window-blocked
SUBMIT, a trigger-2 SUBMIT, a two-command completion, a think delay and
an epoch boundary were compared; the open-loop serving lanes against
``tests/fixtures/torch_open_loop_golden.json``; the open-loop Tempo
offered-load ladder (loads 50, 100, 200, 400; Poisson arrivals of mean
gap 4 ms, a window of 4; the Tempo grid's first 64 subsets, 512 lanes a
load; slice 10's main path) and the Tempo diurnal, flash and churn
sweeps on that grid, each counted, every kernel of its step held to its
twin and timed at step 301 of its first batch (phase 3), lanes 0 and 7
(and on the ladder a conflict-10 lane that ends in ERR_CAPACITY) held to
the host twins. Slice 11: every sweep, mc and ladder phase runs its step loop on the card, in
the device loop's graph (``kernels/step_loop.py``: a captured body of
64 steps under a conditional while node, K14 deciding the early exit),
one host dispatch a window; each checks that no step kernel was
launched through its wrapper and prints the loop's stats (capture and
instantiate seconds, device calls, windows, bodies, overshoot steps).
The segments phase holds the device loop's final state to the eager
loop's (``build_eager_runner``), whole state, byte for byte, on the
first 512-lane batch of Tempo and Basic at four (segment steps, scan
window, pipeline depth, max steps) settings and of Caesar at one, and
times the B6-loop row (one window of one body). The phases that hold
each call of a kernel to its twin drive the eager runner by name; the
mc grid's taps read the segment runner's output after every 4,096-step
segment. Slice 12, mixed-protocol batches (``run_sweep(...,
hetero=True)``: each protocol's lanes a group, each group's own kernels
in one graph a window): every group's kernels of a six-protocol mixed
batch (the main grid's first 8 subsets, 384 lanes) against their twins
at step 301 through the eager per-call path, that batch's device loop
against its eager loop (whole state, byte for byte, at (1000, 3, 2)),
then the mixed sweeps, counted: the reference bench's four mixed
protocols (Basic, FPaxos, Tempo, Atlas) over the main grid, interleaved
point by point, 8,192 lanes in 512-lane batches, and all six over the
first 8 subsets; every lane equals its protocol's phase-7 line byte for
byte, and K1, K6 and K2 launch once a group a step and each handler
only for its own protocol's groups; the mixed step's row (one window of
one body, the eager mixed step, the sum of the groups' bounds). The host
twins run in worker processes started before the build, overlapping the
card's phases. Slice 13: K2 and K10 update the pool and Caesar's process
state in place, on running lanes only, so every check hands each call
of them a fresh copy (``_fresh``; the copy is in ``call_ms``, not in
``ms``), and phase 3 holds both, with every third lane failed, to their
twins: running
lanes as the twin computes them, frozen lanes' rows byte for byte as
before, the planes returned the ones given (``frozen_check``; the
frozen-lane ms are printed before the kernels line). Slice 14: K4
(Basic) and K11 (Tempo partial) update their process state in place
too, so both are in ``IN_PLACE`` and get the same fresh copies and
frozen-lane checks, and the Tempo partial path runs its whole grid again (slice
12's cuts of the Tempo partial and Caesar grids are gone). Slice 15: K8
(Tempo) updates its process state in place too and is in ``IN_PLACE``;
K1 takes the step's cap and reads nothing of a frozen lane, and phase 3
holds it, with every third lane failed, to its twin and on running
lanes to an uncapped call, frozen lanes to the defined values
(``qualify_frozen_check``), and on a pool of 60,000 slots, past what a
block stages in shared memory (``qualify_large_pool``); the monitored
mc phase captures and times K1 and K2 on the mc grid's n = 5
batches too; the mc grid prints each point's share of running
lane-steps and runs again with eight steps in every 1,024 of each
batch stepped through the wrappers under the profiler
(``mc_grid_profile``: each kernel's device ms a launch over the sampled
steps, from the first steps to the frozen tail); an eager mixed body is
profiled by kernel too, and the kernels are ranked by launches x
(device ms - bound) before the kernels line (``bottlenecks``). Slice
16: K6 (the lane state's clients, metrics, channel counts and timers)
and K9 (Atlas's and EPaxos's process state) update in place too and are
in ``IN_PLACE`` (K6's fresh copy is of those planes only, ``_fresh``);
K6 takes the step's cap; the frozen-lane checks hold both on every path
that runs them, and on the mixed batch's groups and the monitored mc
batches; each sweep's host seconds outside the step loop (``prepare_batch``,
``finish_run`` + ``collect_results``) beside its points/s. Slice 17: K5
and K12 (FPaxos' and Atlas partial's process state) update in place too
and are in ``IN_PLACE``, so every handler does; their frozen-lane checks
run on the FPaxos and Atlas partial paths (K5 also in the mixed batches'
FPaxos groups and on the monitored mc FPaxos batches), and K5's and
K12's ms with all lanes running and with a third frozen are printed
before the kernels line. Slice 18: K7 ``lane_freeze`` is gone, folded
into K2 and the step's frozen-lane contract: every kernel of the step
writes a frozen lane's planes as they were (K1 its timers under the
crash flag too) and K2 writes the run predicate to ``running``, so a
step is four launches (a captured body's per-body counts are 64 of each
of K1, the handler, K6 and K2). Every path where K7 was held now holds
K2's ``running`` to ``lane_running`` (the cap an int and a device word)
and the whole step with every third lane failed: each leaf of its
output equals the pre-step copy on the frozen lanes, exactly
(``frozen_step_check``: every phase-3 path, the fault-coverage batch
under crash, the monitored mc batches, the mixed batch's groups and the
monitored open-loop Caesar batch). Any failure raises; nothing is
caught. Each phase prints its seconds. The last two lines
are one JSON object per kernel (``{"kernels": [...]}``) and the verdict
``{"ok": true, ...}``.
Without a CUDA card it exits non-zero and prints no result.
"""

from __future__ import annotations

import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIXTURES = ROOT / "tests" / "fixtures"

GOLDEN_POINTS = [(f, cf) for f in (0, 1, 2) for cf in (0, 100)]
# the FPaxos golden batch: (f, leader), conflict 100
FPAXOS_POINTS = [(1, 1), (1, 3), (2, 2)]
# the Tempo golden batches (tests/test_torch_tempo.py): (n, f, conflict,
# commands, clients per region, clock bump ms) in one batch, and (..., the
# skip_fast_ack knob) in one skip-capable batch
TEMPO_MAIN = [
    (3, 1, 100, 30, 2, None),
    (3, 1, 0, 30, 2, None),
    (5, 1, 100, 10, 1, None),
    (5, 2, 100, 20, 1, None),
    (5, 1, 100, 30, 2, None),
    (3, 1, 100, 30, 2, 50),
]
TEMPO_SKIP = [(3, 1, 100, 20, 1, True), (3, 1, 100, 20, 1, False)]
# the Atlas and EPaxos golden batches (tests/test_torch_graphdep.py):
# (n, f, conflict, commands, clients per region), one batch per protocol
GRAPHDEP_POINTS = [
    (3, 1, 100, 30, 1),
    (3, 1, 0, 30, 2),
    (5, 2, 100, 10, 1),
    (5, 2, 100, 20, 2),
]
# the partial-replication golden batches (tests/test_torch_tempo_partial.py,
# one batch each): (n, f, shards, conflict, pool, keys per command), 10
# commands per client
TEMPO_PARTIAL_POINTS = [(3, 1, 2, 0, 1, 1), (3, 1, 2, 100, 4, 2)]
# the Atlas partial golden batch (tests/test_torch_atlas_partial.py):
# (n, f, shards, conflict, pool, keys per command), 10 commands per
# client, one batch
ATLAS_PARTIAL_POINTS = [(3, 1, 2, 100, 4, 2), (3, 1, 2, 10, 4, 2)]
# the clock-bump batch of tests/test_torch_tempo_partial_step.py:
# (regions, f, conflict, clock bump ms), GC every 10 ms, detached sends
# every 20 ms, 4 commands per client
EU5 = ["europe-west1", "europe-west2", "europe-west3", "europe-west4",
       "europe-west6"]
EU3 = ["europe-west1", "europe-west3", "europe-west4"]
BUMP_POINTS = [(EU5, 2, 100, None), (EU5, 2, 50, 10), (EU3, 1, 100, None),
               (EU3, 1, 10, 10)]
# the batch of tests/test_torch_atlas_partial_step.py, on EU5: (f,
# conflict), GC every 10 ms, the cleanup tick every 5 ms, 4 commands per
# client
REQUEST_POINTS = [(2, 100), (2, 50), (1, 100), (1, 10)]
# the Caesar golden batch (tests/test_torch_caesar.py): (n, f, wait
# condition, conflict, commands, clients per region)
CAESAR_POINTS = [
    (3, 1, True, 100, 30, 1),
    (3, 1, False, 100, 30, 1),
    (3, 1, True, 0, 30, 2),
    (5, 2, True, 100, 10, 1),
    (5, 2, False, 100, 10, 1),
]
# the faults golden batches (tests/test_torch_faults.py): Tempo, n = 3,
# f = 1, one client per region; the fault batch's plans at 15 commands,
# the reorder batch's seeds at 20 commands with 30 s of extra time
FAULT_PLANS = [
    {"crash": {"0": 150}},
    {"crash": {"2": 150}},
    {"windows": [{"src": 0, "dst": 1, "t0": 50, "t1": 400, "mult": 6},
                 {"src": 1, "dst": 0, "t0": 50, "t1": 400, "mult": 6}]},
    {"windows": [{"src": 0, "dst": 1, "t0": 0, "t1": 800,
                  "mult": 1 << 29}], "horizon": 5000},
    {"crash": {"2": 200}},
    {"crash": {"1": 0}},
    {"crash": {"1": 100, "2": 400}},
]
REORDER_SEEDS = [0, 1]
# K6 is held to its twin on every one of a reorder batch's first steps
# (cut from the whole run, 3,584 and 5,184 steps, for the time the
# monitors' phases need)
REORDER_STEPS = 1024
# the fault-coverage batch: Tempo, n = 3, two clients in each of the
# COVERAGE_CLIENTS regions, GC and detached sends every 20 ms; lane i
# runs plan i, each plan made to show its event within a few hundred
# steps (the horizon's on one of three lanes)
COVERAGE_PLANS = [
    ("crash purges, crashed timers, halted clients", {"crash": {"1": 30}}),
    ("multiplier window", {"windows": [{"src": 0, "dst": 1, "t0": 0,
                                        "t1": 300, "mult": 6}]}),
    ("override window", {"windows": [{"src": 2, "dst": 0, "t0": 0,
                                      "t1": 300, "delay": 3}]}),
    ("partition loss", {"windows": [{"src": 1, "dst": 2, "t0": 0,
                                     "t1": 200, "delay": "inf"}],
                        "horizon": 5000}),
    ("overflow-multiplier partition",
     {"windows": [{"src": 0, "dst": 1, "t0": 0, "t1": 800,
                   "mult": 1 << 29}], "horizon": 5000}),
    ("jitter multiplier", {"jitter_max": 8, "jitter_seed": 1}),
    ("drop", {"drop_bp": 3000, "seed": 7, "horizon": 5000}),
    ("unavailable lane (ERR_UNAVAIL)", {"crash": {"1": 100, "2": 400}}),
    ("horizon-cut TO_CLIENT", {"horizon": 100}),
    ("horizon-cut TO_CLIENT", {"horizon": 150}),
    ("horizon-cut TO_CLIENT", {"horizon": 200}),
]
# the fault-coverage batch's client regions: two beside their process
# (rows 0 and 1), one 17 ms from it (row 1), so that a result can reach
# its client past the horizon
COVERAGE_CLIENTS = ["asia-east1", "asia-east2", "asia-southeast1"]
# sampled lanes held to the host's plain twins: (regions, f, conflict) =
# (0, 1, 0), (0, 2, 100), (125, 1, 0), (255, 2, 100); the twins of Tempo,
# Atlas, EPaxos and Caesar are slower on the host, so two of them, both
# f = 2 at conflict 100; a partial lane takes some 11,700 serialized
# steps, so one (subset 0, f = 2, conflict 100); so for Atlas partial;
# under faults the four plans of point 0 (subset 0, f = 1, conflict 0)
# and the drop plan of point 7, whose lane overflows a Tempo table; on
# the ladder's rungs and the traffic sweeps lane 0 and lane 7, which
# ends in ERR_CAPACITY on the ladder, as on the reference's engine (its
# tables are sized for the closed loop), and on the ladder lane
# LADDER_ERR as well (subset 39, f = 2, conflict 10), one of the four
# conflict-10 lanes that end so at load 100 (its reference bytes:
# tests/test_torch_open_ladder.py::test_ladder_capacity_lane_matches_reference)
LADDER_ERR = 317
SAMPLE = {"basic": [0, 7, 1000, 2047], "fpaxos": [0, 7, 1000, 2047],
          "tempo": [7, 2047], "atlas": [7, 2047], "epaxos": [7, 2047],
          "caesar": [7, 511], "tempo_partial": [7], "atlas_partial": [7],
          "tempo_faults": [0, 1, 2, 3, 31],
          "tempo_open": [0, 7, LADDER_ERR], "tempo_traffic": [0, 7]}


def base_path(name):
    """The ``cli.MAIN_PATHS`` key of path ``name``: a ladder rung
    ``tempo_open_<load>`` or a traffic sweep ``tempo_traffic_<preset>``
    is a setting of ``tempo_open`` or ``tempo_traffic``."""
    for base in ("tempo_open", "tempo_traffic"):
        if name.startswith(base + "_"):
            return base
    return name


def new_paths():
    """The slice 10 paths: the Tempo traffic sweeps, one a preset, and
    the open-loop Tempo offered-load ladder, one sweep a load."""
    from fantoch_tpu_torch import cli

    return ([f"tempo_traffic_{p}" for p in cli.TRAFFIC_PATHS]
            + [f"tempo_open_{load}" for load in cli.OPEN_LOADS])


def path_argv(name):
    """Path ``name``'s sweep command line as this script runs it (a
    ladder rung at its load, a traffic sweep under its preset)."""
    from fantoch_tpu_torch import cli

    base = base_path(name)
    argv = list(cli.MAIN_PATHS[base])
    flag = {"tempo_open": "--offered-load", "tempo_traffic": "--traffic"}
    if base in flag:
        argv[argv.index(flag[base]) + 1] = name[len(base) + 1:]
    return argv


# each main path's kernels' bounds (ms) from phase 3: the device loop's
# bound is its body's
BOUNDS = {}
# each main path's kernels' device ms a launch from phase 3 (step 301)
PHASE3_MS = {}
# device ms by kernel over the profiled device-loop windows: "mc" the mc
# grid's re-run (totals, with the records read), "hetero" the mixed
# body's windows (a step) with the step's bound by kernel
PROFILED = {}

# the reference region each kernel replaces
REPLACES = {
    "qualify_pop": "fantoch_tpu/engine/core.py:811",
    "land_emissions": "fantoch_tpu/engine/core.py:1457",
    "key_table": "fantoch_tpu/engine/core.py:439",
    "basic_handle": "fantoch_tpu/engine/protocols/basic.py:119",
    "fpaxos_handle": "fantoch_tpu/engine/protocols/fpaxos.py:127",
    "emit_rewrite": "fantoch_tpu/engine/core.py:941",
    "tempo_handle": "fantoch_tpu/engine/protocols/tempo.py:226",
    "graphdep_handle": "fantoch_tpu/engine/protocols/graphdep.py:215",
    "caesar_handle": "fantoch_tpu/engine/protocols/caesar.py:239",
    "tempo_partial_handle":
        "fantoch_tpu/engine/protocols/tempo_partial.py:198",
    "atlas_partial_handle":
        "fantoch_tpu/engine/protocols/graphdep_partial.py:219",
    "mon_finalize": "fantoch_tpu/engine/monitor.py:217",
    "loop_ctl": "fantoch_tpu/engine/core.py:1565",
    "step_loop": "fantoch_tpu/engine/core.py:1591",
}
HANDLERS = {"basic": "basic_handle", "fpaxos": "fpaxos_handle",
            "tempo": "tempo_handle", "atlas": "graphdep_handle",
            "epaxos": "graphdep_handle", "caesar": "caesar_handle",
            "tempo_partial": "tempo_partial_handle",
            "atlas_partial": "atlas_partial_handle",
            "tempo_faults": "tempo_handle", "tempo_open": "tempo_handle",
            "tempo_traffic": "tempo_handle"}
PATHS = ("basic", "fpaxos", "tempo", "atlas", "epaxos", "caesar",
         "tempo_partial", "atlas_partial", "tempo_faults")
# each protocol sweep's to_json lines and wall seconds: the Tempo sweep's
# first 512 lanes are the fault path's fault-free lanes, the monitored
# Tempo sweep must equal all of them outside the monitor fields, and every
# lane of the mixed sweeps must equal its protocol's line
LINES = {}
WALLS = {}
# the in-place kernels' ms with every third lane frozen, by kernel and
# path (phase 3's frozen-lane checks)
FROZEN = {}
# the whole step's frozen-lane checks (frozen_step_check), by path
FROZEN_STEPS = {}
OUTBOX_KEYS = ("valid", "dst", "mtype", "payload")


class HostTwins:
    """The host runs of the plain twins that the card's results are held
    to, in worker processes (one torch thread each, at the lowest
    priority) started before the build, so they overlap the card's
    phases: a task runs sampled lanes, or a segment of one, on the CPU. Started with ``spawn`` (the parent holds a CUDA context);
    :meth:`close` stops every worker."""

    def __init__(self, workers: int = 6):
        import concurrent.futures
        import multiprocessing

        self.pool = concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"),
            initializer=_host_worker)
        self.futures = {}

    def submit(self, key, fn, *args):
        self.futures[key] = self.pool.submit(fn, *args)

    def result(self, key):
        return self.futures.pop(key).result()

    def close(self):
        procs = list(getattr(self.pool, "_processes", {}).values())
        self.pool.shutdown(wait=False, cancel_futures=True)
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=30)


def _host_worker() -> None:
    """A host worker yields the CPU to the process that drives the card
    (its host-bound step loop sets the sweeps' points/s) and runs torch
    on one thread."""
    import os

    import torch

    os.nice(19)
    torch.set_num_threads(1)


def _host_sweep_lanes(name, lanes):
    """Worker task: lanes ``lanes`` of path ``name`` on the host."""
    from fantoch_tpu_torch import cli
    from fantoch_tpu_torch.engine import run_lanes

    t0 = time.perf_counter()
    protocol, dims, specs = cli.sweep_setup(
        cli.parse_args(path_argv(name)))
    host = run_lanes(protocol, dims, [specs[i] for i in lanes], device="cpu")
    return ([json.dumps(h.to_json(), sort_keys=True) for h in host],
            time.perf_counter() - t0)


def _host_segment(spec_kw, plan, state, steps, flags, last):
    """Worker task: one sampled mc lane on the host from the card's
    snapshot ``state`` (numpy, one lane), ``steps`` run-loop steps of the
    plain twins under the card batch's ``flags`` (reorder, fault flags,
    monitor keys), stopping early once the lane no longer runs (every
    later step is the identity). Returns the state, and for the ``last``
    segment also the run's end (``finish_run``) as a ``to_json`` line."""
    from fantoch_tpu_torch.carry import to_numpy, to_torch
    from fantoch_tpu_torch.engine.core import finish_run, frozen_step
    from fantoch_tpu_torch.engine.driver import prepare_batch
    from fantoch_tpu_torch.engine.faults import FaultFlags
    from fantoch_tpu_torch.engine.results import collect_results
    from fantoch_tpu_torch.mc.fuzz import FuzzSpec, point_lanes

    t0 = time.perf_counter()
    reorder, faults, mk = flags
    faults = FaultFlags(*faults)
    proto, dims, specs, _plans, _mk = point_lanes(FuzzSpec(**spec_kw),
                                                  plans=[plan])
    _state, ctx = prepare_batch(proto, dims, specs, "cpu", mk)
    st = to_torch(state, "cpu")
    for _ in range(steps):
        st, running = frozen_step(proto, dims, st, ctx, 1 << 22, reorder,
                                  faults, mk)
        if not bool(running.any()):
            break
    line = None
    if last:
        end = finish_run(proto, st, ctx, 1 << 22, reorder, faults, mk)
        line = json.dumps(collect_results(proto, dims, end, specs)[0].to_json(),
                          sort_keys=True)
    return to_numpy(st), line, time.perf_counter() - t0


# the host pool (main() opens it)
HOST = None


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _flatten(x):
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _flatten(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _flatten(v)]
    return [x]


def _clone(x):
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x.clone()


# the kernels that update an argument in place (its position): K2 the
# pool, every handler (K4, K5, K8, K9, K10, K11, K12) its process state
# (Basic's, FPaxos', Tempo's, Atlas's and EPaxos's, Caesar's, Tempo
# partial's, Atlas partial's), K6 the lane state's K6_PLANES. A call
# consumes it, so every check hands each call a fresh copy (a step
# consumes its input state)
IN_PLACE = {"land_emissions": 0, "basic_handle": 0, "fpaxos_handle": 0,
            "tempo_handle": 0, "caesar_handle": 0,
            "tempo_partial_handle": 0, "graphdep_handle": 0,
            "atlas_partial_handle": 0, "emit_rewrite": 0}
# the planes of the lane state K6 updates in place (the rest of the tree
# it takes is read only)
K6_PLANES = ("clients", "metrics", "pair_cnt", "next_periodic")


def _fresh(kname, a):
    """Kernel ``kname``'s arguments ``a`` with its in-place argument
    copied (the others as they are; of K6's lane state only the planes
    it writes)."""
    i = IN_PLACE.get(kname)
    if i is None:
        return a
    if kname == "emit_rewrite":
        x = dict(a[i], **{k: _clone(a[i][k]) for k in K6_PLANES})
    else:
        x = _clone(a[i])
    return a[:i] + (x,) + a[i + 1:]


def _in_place_planes(kname, got, given, before):
    """``(returned, given, before)`` plane triples of in-place kernel
    ``kname``'s call: its result ``got`` on the argument ``given``, and
    ``before``, a copy of that argument from before the call."""
    if kname == "land_emissions":
        return [(got[0], given, before)]
    if kname == "emit_rewrite":
        out = []
        for k in K6_PLANES:
            if isinstance(given[k], dict):
                out += [(got[2][k][j], given[k][j], before[k][j])
                        for j in given[k]]
            else:
                out.append((got[2][k], given[k], before[k]))
        return out
    return [(got[1][k], given[k], before[k]) for k in given]


def _compare(got, want) -> float:
    """Exact equality of two output trees; returns the max abs error."""
    import torch

    a, b = _flatten(got), _flatten(want)
    assert len(a) == len(b)
    err = 0.0
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype, (x.shape, y.shape)
        diff = (x.to(torch.float64) - y.to(torch.float64)).abs()
        err = max(err, float(diff.max()) if diff.numel() else 0.0)
        if not torch.equal(x, y):
            raise AssertionError(f"kernel differs from its twin ({err})")
    return err


def _handler_view(out):
    """A handler's outputs with the kernel's outbox planes: the twin
    also carries ``delay``/``src``, which must be all -1."""
    rdy, ps, pout, hout = out
    for ob in (pout, hout):
        for k in ("delay", "src"):
            assert k not in ob or bool((ob[k] == -1).all()), k
    return (rdy, ps, *({k: ob[k] for k in OUTBOX_KEYS}
                       for ob in (pout, hout)))


def _time_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _event_ms(fn, iters: int) -> float:
    """Device time per call of ``fn`` from a CUDA event pair around each
    call. The pairs queue behind a device-side sleep while the host
    issues them, so the host's issue time between calls is not counted;
    each pair also counts its launch's few microseconds on the device."""
    import torch

    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(200_000_000)  # about 0.1 s of the card's cycles
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def _device_ms(fn, kernel: str, iters: int) -> float:
    """Device time per launch of ``kernel`` over ``iters`` calls of
    ``fn``, from ``torch.profiler``: the kernel's own time, without the
    host's time to issue it (``_time_ms`` measures the call as a whole,
    which for a short kernel is the host's). The profiler may lose a few
    of a burst of short launches' records; the time is the mean over the
    launches it recorded, and the line says how many that was. Where it
    recorded none (seen for K3's launches of a few microseconds), the
    time comes from :func:`_event_ms`, and the line says so."""
    def calls():
        for _ in range(iters):  # each call's outputs freed before the next
            fn()

    fn()
    ms, n = _kernel_ms(calls).get(kernel, (0.0, 0))
    if not n:
        print(f"profiler: no {kernel} launch of {iters} recorded; ms is "
              f"from CUDA events around each launch instead")
        return _event_ms(fn, iters)
    assert n <= iters, (kernel, n)
    if n < iters:
        print(f"profiler: {n} of {iters} {kernel} launches recorded; "
              f"ms is their mean")
    return ms / n


def _kernel_ms(fn) -> dict:
    """``{kernel: (device ms, records)}`` of one call of ``fn`` under
    ``torch.profiler`` (CPU and CUDA activities), by kernel name. Read
    for launches through the wrappers: the profiler can misname the
    nodes of a replayed graph (seen in a long process), so graphs are
    not profiled here."""
    import torch

    from fantoch_tpu_torch import kernels

    names = sorted(kernels.WRAPPERS, key=len, reverse=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        k = next((k for k in names if e.name.startswith(k + "_kernel")),
                 None)
        if k is not None:
            ms, n = out.get(k, (0.0, 0))
            out[k] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return out


def check_kernels(name, dev, rows):
    """Phase 3 for one main path: its first batch, stepped 300 times
    through the run loop, then one step's kernel arguments recorded;
    each kernel of the step against its twin on them. Adds a row per
    kernel to ``rows`` (the last path's row wins for shared kernels)."""
    import torch

    from fantoch_tpu_torch import cli, kernels
    from fantoch_tpu_torch.carry import to_torch
    from fantoch_tpu_torch.engine import core as engine_core
    from fantoch_tpu_torch.engine.driver import (
        batch_reorder_flag, prepare_batch,
    )
    from fantoch_tpu_torch.engine.faults import batch_fault_flags, flag_bits
    from fantoch_tpu_torch.engine.spec import stack_lanes
    from fantoch_tpu_torch.kernels import cost

    argv = path_argv(name)
    sweep = cli.parse_args(argv)
    protocol, dims, specs = cli.sweep_setup(sweep)
    max_steps = 1 << 22
    batch = specs[:sweep.batch_lanes]
    # the batch's reorder flag and fault-flag union, as run_sweep's
    flags = (batch_reorder_flag(batch), batch_fault_flags(batch))
    state, ctx = prepare_batch(protocol, dims, batch, dev)
    for _ in range(300):
        state, _running = engine_core.frozen_step(protocol, dims, state,
                                                  ctx, max_steps, *flags)
    handler = HANDLERS[base_path(name)]
    mods = {k: importlib.import_module(f"fantoch_tpu_torch.kernels.{k}")
            for k in ("qualify_pop", "land_emissions", "emit_rewrite",
                      handler, "key_table")}
    patched = {
        "qualify_pop": engine_core,
        "land_emissions": engine_core,
        "emit_rewrite": engine_core,
        handler: mods[handler],
    }
    captured = {}

    def recorder(kname, fn):
        def wrapped(*args):
            # the in-place kernels write into their state: keep copies
            # from before the call
            captured[kname] = _fresh(kname, args)
            return fn(*args)
        # the wrapper counts through its module-global name, which is
        # this recorder while it stands in
        wrapped.launches = 0
        return wrapped

    saved = {k: getattr(m, k) for k, m in patched.items()}
    for k, m in patched.items():
        setattr(m, k, recorder(k, saved[k]))
    state, _running = engine_core.frozen_step(protocol, dims, state, ctx,
                                              max_steps, *flags)
    for k, m in patched.items():
        setattr(m, k, saved[k])
    T = ctx["key_table"].shape[2]
    captured["key_table"] = (
        ctx["rng_key"], ctx["conflict_rate"], ctx["pool_size"],
        ctx["key_gen_kind"], ctx["zipf_cum"], dims.C, T,
        mods["key_table"].traffic_tables(ctx),
    )
    L, M, W = captured["qualify_pop"][0].shape
    shapes = (f"L={L} N={dims.N} M={M} W={W} D={dims.D} F={dims.F} "
              f"E={captured['land_emissions'][2].shape[1]} C={dims.C} T={T}")
    for kname, a in captured.items():
        mod = mods[kname]
        kern, plain = getattr(mod, kname), getattr(mod, kname + "_plain")
        before = kern.launches
        # an in-place kernel gets a fresh copy each call: the copy's time
        # is in call_ms, not in ms (the kernel's own, by name)
        got, want = kern(*_fresh(kname, a)), plain(*_fresh(kname, a))
        run_kernel = (lambda a=a: kern(*_fresh(kname, a)))
        if kname == "land_emissions":
            # K2 reports the run predicate of the step's cap
            assert torch.equal(got[4], a[-1].running()), name
        if kname == handler:
            got, want = _handler_view(got), _handler_view(want)
        torch.cuda.synchronize()
        err = _compare(got, want)
        ms = _device_ms(run_kernel, kname, 50)
        call_ms = _time_ms(run_kernel, 50)
        plain_ms = _time_ms(lambda a=a: plain(*_fresh(kname, a)), 5)
        # the least bytes and operations the region needs on these inputs
        n_bytes, n_ops = mod.work(*a, got)
        bound_ms, bound_by = cost.bound(n_bytes, n_ops)
        library_ms = None
        if kname == "land_emissions":
            free = a[1] == (1 << 30)
            library_ms = _time_ms(
                lambda: torch.cumsum(free, dim=1, dtype=torch.int32), 50
            )
        rows[kname] = dict(
            path=name, max_abs_err=err, ms=ms, call_ms=call_ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms,
        )
        print(f"kernel {kname} ({name} path): exact=True max_abs_err={err} "
              f"ms={ms:.5f} call_ms={call_ms:.5f} plain_ms={plain_ms:.5f} "
              f"bound_us={1e3 * bound_ms:.3f} ({bound_by}: {n_bytes} "
              f"bytes, {n_ops} ops) library_ms={library_ms} "
              f"launches={kern.launches - before} shapes {shapes}")

    # the whole step with every third lane failed, the cap an int and a
    # device word that stops some lanes: no select after it (before the
    # coverage runs, which step this state on)
    fb = flag_bits(flags[1], flags[0])

    def step(st, cx, lim):
        return engine_core.frozen_step(protocol, dims, st, cx, lim, *flags)

    for word in (False, True):
        frozen_step_check(name, step, state, ctx, max_steps, fb, word)
    # K14's lanes at two step counts (their [L] lane words, which no
    # later step writes in place)
    old = dict(state, steps=state["steps"].clone())
    old["steps"][::2] -= 1

    if handler in COVERAGE and name in PATHS and name != "tempo_faults":
        rows[handler]["max_abs_err"] = max(
            rows[handler]["max_abs_err"],
            coverage(name, handler, protocol, dims, state, ctx, max_steps,
                     captured[handler], mods[handler]),
        )
    if name == "tempo_partial":
        rows[handler]["max_abs_err"] = max(
            rows[handler]["max_abs_err"], bump_coverage(dev, mods[handler]),
        )
    if name == "atlas_partial":
        rows[handler]["max_abs_err"] = max(
            rows[handler]["max_abs_err"],
            request_coverage(dev, mods[handler]),
        )

    # K2, K6, the in-place handler and K1 with every third lane failed:
    # running lanes equal the twin, frozen lanes' in-place planes are
    # untouched (K1 reads nothing of them)
    cap, frozen = _third_frozen(captured["land_emissions"][-1])
    for kname in [k for k in (handler, "emit_rewrite", "land_emissions")
                  if k in IN_PLACE]:
        a = captured[kname]
        a = a[:-1] + (cap,)
        rows[kname]["max_abs_err"] = max(
            rows[kname]["max_abs_err"],
            frozen_check(name, kname, mods[kname], a, frozen))
    rows["qualify_pop"]["max_abs_err"] = max(
        rows["qualify_pop"]["max_abs_err"],
        qualify_frozen_check(name, mods["qualify_pop"],
                             captured["qualify_pop"][:-1] + (cap,), frozen))
    BOUNDS[name] = {k: (r["bound_ms"], r["bound_by"])
                    for k, r in rows.items() if r["path"] == name}
    PHASE3_MS[name] = {k: r["ms"] for k, r in rows.items()
                       if r["path"] == name}
    check_loop_ctl(name, old, ctx, fb, rows)

    if name == "basic":
        # K3's Zipf branch, which the main path's ConflictPool lanes do
        # not take: one batch of Zipf lanes (the same grid's first 512
        # points with --zipf 1.0,1000)
        zargv = list(argv)
        zargv[zargv.index("--subsets") + 1] = "64"
        _zp, _zd, zspecs = cli.sweep_setup(
            cli.parse_args(zargv + ["--zipf", "1.0,1000"])
        )
        zctx = to_torch(stack_lanes(zspecs[:sweep.batch_lanes]), dev)
        assert bool((zctx["key_gen_kind"] == 1).all())
        za = (zctx["rng_key"], zctx["conflict_rate"], zctx["pool_size"],
              zctx["key_gen_kind"], zctx["zipf_cum"], dims.C, T)
        got = kernels.key_table(*za)
        want = mods["key_table"].key_table_plain(*za)
        torch.cuda.synchronize()
        err = _compare(got, want)
        assert int(got.max()) > 0 and int(got.min()) >= 0
        print(f"kernel key_table (zipf): exact=True max_abs_err={err} "
              f"L={got.shape[0]} C={dims.C} T={T} "
              f"K={zctx['zipf_cum'].shape[1]} distinct keys "
              f"{int(torch.unique(got).numel())}")


def frozen_check(name, kname, mod, a, frozen) -> float:
    """In-place kernel ``kname`` on arguments ``a`` whose cap freezes the
    lanes ``frozen``: kernel and twin, each on a fresh copy, are equal
    (running lanes as the twin computes them, a frozen lane's other
    outputs their defined values); the in-place planes returned are the
    tensors given; frozen lanes' rows of them are as before the call, byte
    for byte, and some running lane's changed. Prints the kernel's ms
    (device time, by name; the copy is not in it) and records it in
    :data:`FROZEN`. Returns the max abs error."""
    import torch

    kern, plain = getattr(mod, kname), getattr(mod, kname + "_plain")
    i = IN_PLACE[kname]
    fa = _fresh(kname, a)
    got = kern(*fa)
    want = plain(*_fresh(kname, a))
    torch.cuda.synchronize()
    moved = torch.zeros_like(frozen)
    for out, given, before in _in_place_planes(kname, got, fa[i], a[i]):
        assert out is given, f"{kname}: an in-place plane is a new tensor"
        assert torch.equal(out[frozen], before[frozen]), (
            f"{kname}: a frozen lane's row changed")
        moved |= (out != before).reshape(out.shape[0], -1).any(1)
    assert bool((moved & ~frozen).any()), f"{kname}: no running lane moved"
    if kname == "emit_rewrite":
        # a frozen lane's rows are zero and none lands
        assert not bool(got[0][frozen].any() | got[1][frozen].any())
    if kname == "land_emissions":
        assert torch.equal(got[4], ~frozen)  # K2 reports the predicate
    if kname in HANDLERS.values():
        got, want = _handler_view(got), _handler_view(want)
    err = _compare(got, want)
    ms = _device_ms(lambda: kern(*_fresh(kname, a)), kname, 50)
    print(f"kernel {kname} ({name} path, {int(frozen.sum())} of "
          f"{frozen.numel()} lanes frozen): exact=True max_abs_err={err} "
          f"ms={ms:.5f}; frozen lanes' in-place rows as before, byte for "
          f"byte; {int((moved & ~frozen).sum())} running lanes moved")
    FROZEN.setdefault(kname, {})[name] = dict(frozen=int(frozen.sum()),
                                              lanes=frozen.numel(), ms=ms)
    return err


def _third_frozen(cap):
    """A step's ``cap`` with every third lane failed, and the lanes it
    freezes."""
    old = dict(cap.st, err=cap.st["err"].clone())
    old["err"][::3] = 64
    cap = cap._replace(st=old)
    return cap, ~cap.running()


def frozen_step_check(label, step, state, ctx, lim, flags, word=False):
    """The step's frozen-lane contract on the card (no select follows a
    step): from a copy of ``state`` with every third lane failed (and
    with ``word`` every other lane one step behind the rest, the cap a
    device word at the top count), one ``step(st, ctx, lim) -> (state,
    running)`` gives ``running`` (K2's) equal to ``lane_running`` of the
    copy under the cap and the flag word ``flags``, and every leaf of
    its output equal to the copy's on the frozen lanes, exactly; a
    running lane moved. A mixed batch's trees are grouped (``{group:
    tree}``, ``running`` by group). Records the lanes frozen in
    :data:`FROZEN_STEPS`."""
    import torch

    from fantoch_tpu_torch.kernels.lane_freeze import lane_live, lane_running
    from fantoch_tpu_torch.kernels.step_loop import clone_tree

    grouped = "now" not in state
    pre = clone_tree(state)
    trees = pre if grouped else {"": pre}
    ctxs = ctx if grouped else {"": ctx}
    for t in trees.values():
        t["err"][::3] = 64
        if word:
            t["steps"][::2] -= 1
    if word:
        lim = max(int(t["steps"].max()) for t in trees.values())
        dev = next(iter(trees.values()))["now"].device
        lim_arg = torch.tensor([lim], dtype=torch.int32, device=dev)
    else:
        lim_arg = lim
    want = {g: lane_running(t, ctxs[g], lim, flags) for g, t in trees.items()}
    out, running = step(clone_tree(pre), ctx, lim_arg)
    outs, runs = (out, running) if grouped else ({"": out}, {"": running})
    torch.cuda.synchronize()
    frozen, moved, planes, stopped = 0, 0, 0, 0
    for g, t in trees.items():
        run = runs[g]
        assert torch.equal(run, want[g]), f"{label} {g}: running"
        assert sorted(outs[g]) == sorted(t), (label, g)
        for o, p in zip(_flatten(outs[g]), _flatten(t)):
            assert o.shape == p.shape and o.dtype == p.dtype, (label, g)
            assert torch.equal(o[~run], p[~run]), (
                f"{label} {g}: a frozen lane's plane changed")
            moved += int((o[run] != p[run]).sum())
            planes += 1
        frozen += int((~run).sum())
        stopped += int((lane_live(t, ctxs[g], flags) & ~run).sum())
    assert frozen > 0 and moved > 0, (label, frozen, moved)
    if word:
        assert stopped > 0, label  # live lanes that the cap word stopped
    key = f"{label} cap word" if word else label
    FROZEN_STEPS[key] = dict(frozen=frozen, stopped_by_cap=stopped,
                             planes=planes)
    print(f"step ({key}): every third lane failed, {frozen} lanes frozen"
          + (f" ({stopped} live ones stopped by the cap word {lim})"
             if word else "")
          + f"; K2's running == lane_running; all {planes} planes of the "
          f"frozen lanes as before the step, byte for byte")


def qualify_frozen_check(name, mod, a, frozen) -> float:
    """K1 on arguments ``a`` whose cap freezes the lanes ``frozen``:
    kernel and twin are equal; running lanes equal an uncapped call's
    outputs; frozen lanes hold the defined values (ep INF, active, fire
    and has false, slot 0, rows zero, now the lane's now plane, arrival
    INF, under the crash flag its input timers, copied). Prints the
    kernel's ms with
    those lanes frozen (device time, by name) and records it in
    :data:`FROZEN`. Returns the max abs error."""
    import torch

    from fantoch_tpu_torch.engine.faults import FLAG_CRASH

    kern, plain = mod.qualify_pop, mod.qualify_pop_plain
    got, want = kern(*a), plain(*a)
    free = kern(*a[:-1], None)
    torch.cuda.synchronize()
    err = _compare(got, want)
    run = ~frozen
    inf = 1 << 30
    for i, (g, u) in enumerate(zip(got, free)):
        assert torch.equal(g[run], u[run]), f"qualify_pop: output {i} of a " \
            "running lane differs from the uncapped call's"
    arrival, ep, now, active, fire, slot, has, rows_, timers = got
    assert bool((arrival[frozen] == inf).all() & (ep[frozen] == inf).all())
    assert not bool(active[frozen].any() | fire[frozen].any()
                    | has[frozen].any())
    assert not bool(slot[frozen].any() | rows_[frozen].any())
    assert torch.equal(now[frozen], a[-1].st["now"][frozen])
    if a[5] & FLAG_CRASH:
        assert torch.equal(timers[frozen], a[1][frozen])
    ms = _device_ms(lambda: kern(*a), "qualify_pop", 50)
    print(f"kernel qualify_pop ({name} path, {int(frozen.sum())} of "
          f"{frozen.numel()} lanes frozen): exact=True max_abs_err={err} "
          f"ms={ms:.5f}; running lanes == the uncapped call's, frozen lanes "
          f"the defined values")
    FROZEN.setdefault("qualify_pop", {})[name] = dict(
        frozen=int(frozen.sum()), lanes=frozen.numel(), ms=ms)
    return err


def check_loop_ctl(name, st, ctx, flags, rows) -> None:
    """K14 against its twin on a main path's state (its lanes at two
    step counts, ``top`` − 1 and ``top``): before the loop and in a
    body, on ladders whose first rungs no lane is active under, so the
    kernel walks them; every control word and the body counter equal.
    Timed in a body; adds its row to ``rows``."""
    import torch

    from fantoch_tpu_torch.kernels import cost

    k14 = importlib.import_module("fantoch_tpu_torch.kernels.loop_ctl")
    dev = st["now"].device
    top = int(st["steps"].max())
    err = 0.0
    for ladder in ([top - 5, top, top + 50], [top - 5, top - 1, top + 50],
                   [top + 64], [0, 0]):
        lad = torch.tensor(ladder, dtype=torch.int32, device=dev)
        ctl, iters, _ = k14.new_ctl(dev)
        ctl[k14.CTL_W], ctl[k14.CTL_MAXS] = len(ladder), 1 << 22
        for in_body in (False, True):
            kc, ki = ctl.clone(), iters.clone()
            k14.loop_ctl(st, ctx, lad, kc, ki, flags, in_body)
            tc, ti = ctl.clone(), iters.clone()
            k14.loop_ctl_plain(st, ctx, lad, tc, ti, flags, in_body)
            torch.cuda.synchronize()
            err = max(err, _compare((kc, ki), (tc, ti)))
            ctl, iters = kc, ki
        print(f"kernel loop_ctl ({name} path, ladder {ladder}): exact=True; "
              f"lim {int(ctl[k14.CTL_LIM])} rung {int(ctl[k14.CTL_RUNG])} "
              f"alive {int(ctl[k14.CTL_ALIVE])} cond "
              f"{int(ctl[k14.CTL_COND])}")
    a = (st, ctx, lad, ctl, iters, flags, True)
    ms = _device_ms(lambda: k14.loop_ctl(*a), "loop_ctl", 50)
    call_ms = _time_ms(lambda: k14.loop_ctl(*a), 50)
    plain_ms = _time_ms(lambda: k14.loop_ctl_plain(*a), 5)
    n_bytes, n_ops = k14.work(st, ctx, ctl, flags, True)
    bound_ms, bound_by = cost.bound(n_bytes, n_ops)
    rows["loop_ctl"] = dict(
        path=name, max_abs_err=err, ms=ms, call_ms=call_ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None,
    )
    BOUNDS[name]["loop_ctl"] = (bound_ms, bound_by)
    print(f"kernel loop_ctl ({name} path): exact=True max_abs_err={err} "
          f"ms={ms:.5f} call_ms={call_ms:.5f} plain_ms={plain_ms:.5f} "
          f"bound_us={1e3 * bound_ms:.3f} ({bound_by}: {n_bytes} bytes, "
          f"{n_ops} ops) L={int(st['now'].shape[0])}")


# the message types each handler's coverage phase waits for, in type
# order, the timer rows that must fire, and the further events that must
# have been seen in some compared step: each a count over the twin's
# outputs ``(rdy, ps, periodic outbox, handler outbox)``


def _slot_valid(slot):
    """Valid messages in handler outbox slot ``slot`` (negative: from
    the end)."""
    return lambda out, dims: int(out[3]["valid"][..., slot].sum())


def _tick_answers(out, dims):
    """Valid periodic messages past slot N: the cleanup tick's answers
    to buffered requests."""
    return int(out[2]["valid"][..., dims.N + 1:].sum())


def _sent(mtype, word=None, value=None):
    """Valid handler messages of type ``mtype`` (with payload ``word``
    equal to ``value``)."""
    def count(out, dims):
        hout = out[3]
        hit = hout["valid"] & (hout["mtype"] == mtype)
        if word is not None:
            hit = hit & (hout["payload"][..., word] == value)
        return int(hit.sum())
    return count


COVERAGE = {
    "tempo_handle": (("SUBMIT", "MCOLLECT", "MCOLLECTACK", "MCOMMIT",
                      "MDETACHED", "MCONSENSUS", "MCONSENSUSACK", "MGC",
                      "MDRAIN", "DETACH_DRAIN"), (0, 2), {}),
    "graphdep_handle": (("SUBMIT", "MCOLLECT", "MCOLLECTACK", "MCOMMIT",
                         "MCONSENSUS", "MCONSENSUSACK", "MGC", "MDRAIN"),
                        (0,),
                        {"drain chains (MDRAIN in slot F - 1)":
                         _slot_valid(-1)}),
    # Tempo partial (engine/protocols/tempo_partial.py): MSHARDAGG = 13,
    # which MShardCommit sends once every shard of a command reported;
    # STABLEAT = 14, which a drain sends once a multi-key command is
    # stable at its keys here
    "tempo_partial_handle": (("SUBMIT", "MCOLLECT", "MCOLLECTACK",
                              "MCOMMIT", "MDETACHED", "MCONSENSUS",
                              "MCONSENSUSACK", "MGC", "MDRAIN",
                              "DETACH_DRAIN", "MFWDSUBMIT", "MBUMP",
                              "MSHARDCOMMIT", "MSHARDAGG", "STABLEAT"),
                             (0, 2),
                             {"two-shard commits (MSHARDAGG sent)":
                              _sent(13),
                              "StableAtShard rounds (STABLEAT sent)":
                              _sent(14)}),
    # Atlas partial (engine/protocols/graphdep_partial.py): MDRAIN = 7,
    # which only the drain sends; MSHARDAGG = 10, which MShardCommit sends
    # once every shard of a command reported (the request events are
    # waited for on request_coverage's batch)
    "atlas_partial_handle": (("SUBMIT", "MCOLLECT", "MCOLLECTACK", "MCOMMIT",
                              "MCONSENSUS", "MCONSENSUSACK", "MGC", "MDRAIN",
                              "MFWDSUBMIT", "MSHARDCOMMIT", "MSHARDAGG",
                              "GREQ", "GREPLY", "GREPLYEXEC"),
                             (0, 1),
                             {"two-shard commits (MSHARDAGG sent)":
                              _sent(10),
                              "drain chains (MDRAIN sent)": _sent(7)}),
    # Caesar (engine/protocols/caesar.py): MPROPOSEACK = 2, MRETRY = 4;
    # a reject reply carries 0 in payload word 3 (an accept 1)
    "caesar_handle": (("SUBMIT", "MPROPOSE", "MPROPOSEACK", "MCOMMIT",
                       "MRETRY", "MRETRYACK", "MGC", "WAIT_DRAIN",
                       "EXEC_DRAIN", "GC_DRAIN"), (0, 1),
                      {"exec chains (EXEC_DRAIN in slot F - 3)":
                       _slot_valid(-3),
                       "wait chains (WAIT_DRAIN in slot F - 1)":
                       _slot_valid(-1),
                       "reject replies": _sent(2, 3, 0),
                       "MRETRY broadcasts": _sent(4)}),
}


def coverage(name, kname, protocol, dims, state, ctx, max_steps, first,
             mod, every=25, bound=80, rows_needed=None, start=301,
             extras=None):
    """A handler kernel against its twin, exactly, on the arguments of
    one step in every ``every`` after phase 3's, until each of its
    message types, the timer rows and the further events have been seen
    in some compared step (at most ``bound`` captures; the Tempo main
    paths never fire the clock-bump row, which the golden batch and, for
    the partial twin, :func:`bump_coverage` cover). Returns the max abs
    error."""
    import torch

    from fantoch_tpu_torch.engine import core as engine_core
    from fantoch_tpu_torch.engine.dims import PMT

    names, default_rows, main_extras = COVERAGE[kname]
    rows_needed = default_rows if rows_needed is None else rows_needed
    extras = main_extras if extras is None else extras
    kern, plain = getattr(mod, kname), getattr(mod, kname + "_plain")
    handled = [0] * len(names)
    fired = [0] * dims.R
    seen = dict.fromkeys(extras, 0)
    err, args, captures = 0.0, first, 0
    while True:
        got = kern(*_fresh(kname, args))
        want = plain(*_fresh(kname, args))
        torch.cuda.synchronize()
        err = max(err, _compare(_handler_view(got), _handler_view(want)))
        has, rows, fire = args[1], args[2], args[3]
        mt = torch.where(has & want[0], rows[..., PMT], -1)
        for t in range(len(names)):
            handled[t] += int((mt == t).sum())
        for r in range(dims.R):
            fired[r] += int(fire[..., r].sum())
        for label, count in extras.items():
            seen[label] += count(want, dims)
        captures += 1
        if (min(handled) > 0 and all(fired[r] > 0 for r in rows_needed)
                and all(seen.values())):
            break
        if captures >= bound:
            raise AssertionError(
                f"{kname} coverage incomplete after {captures} captures: "
                f"{dict(zip(names, handled))}, timers {fired}, {seen}")
        for _ in range(every - 1):
            state, _running = engine_core.frozen_step(protocol, dims, state,
                                                      ctx, max_steps)
        box = {}

        def record(*a):
            box["args"] = _fresh(kname, a)
            return kern(*a)

        # the wrapper counts through its module-global name
        record.launches = 0
        setattr(mod, kname, record)
        try:
            state, _running = engine_core.frozen_step(protocol, dims, state,
                                                      ctx, max_steps)
        finally:
            setattr(mod, kname, kern)
        args = box["args"]
    print(f"kernel {kname} ({name} path): exact=True over {captures} "
          f"compared steps, one in {every} from step {start}; handled "
          f"{dict(zip(names, handled))}; timer rows fired {fired}"
          + "".join(f"; {label} {n}" for label, n in seen.items())
          + f"; max_abs_err={err}")
    return err


def _batch_coverage(label, kname, proto, dims, specs, dev, mod, **kw):
    """``kname`` against its twin on every step of a small batch, from
    its first step (:func:`coverage` with ``every=1``)."""
    from fantoch_tpu_torch.engine import core as engine_core
    from fantoch_tpu_torch.engine.driver import prepare_batch

    state, ctx = prepare_batch(proto, dims, specs, dev)
    kern = getattr(mod, kname)
    box = {}

    def record(*a):
        box["args"] = _fresh(kname, a)
        return kern(*a)

    record.launches = 0
    setattr(mod, kname, record)
    try:
        state, _running = engine_core.frozen_step(proto, dims, state, ctx,
                                                  1 << 22)
    finally:
        setattr(mod, kname, kern)
    return coverage(label, kname, proto, dims, state, ctx, 1 << 22,
                    box["args"], mod, every=1, start=1, **kw)


def bump_coverage(dev, mod) -> float:
    """K11 against its twin on every step of the clock-bump batch of
    tests/test_torch_tempo_partial_step.py (close regions, GC every 10
    ms, the clock bump every 10 ms on two lanes), until all three timer
    rows and all fifteen types have been compared. Returns the max abs
    error."""
    from fantoch_tpu_torch.core import Config, Planet
    from fantoch_tpu_torch.engine import EngineDims, make_lane
    from fantoch_tpu_torch.engine.protocols import TempoPartialDev

    proto = TempoPartialDev(keys=4 + 5 + 1, shards=2, keys_per_cmd=2,
                            pending_per_key=8, detached_slots=6, gap_slots=4)
    dims = EngineDims.for_partial(proto, 5, 5, 20, regions=5)
    specs = [
        make_lane(proto, Planet.new(),
                  Config(n=len(regions), f=f, shard_count=2,
                         gc_interval_ms=10,
                         tempo_detached_send_interval_ms=20,
                         tempo_clock_bump_interval_ms=bump,
                         executor_executed_notification_interval_ms=100,
                         executor_cleanup_interval_ms=100),
                  conflict_rate=conflict, pool_size=4, commands_per_client=4,
                  clients_per_region=1, process_regions=regions,
                  client_regions=regions, dims=dims, extra_time_ms=100,
                  seed=i)
        for i, (regions, f, conflict, bump) in enumerate(BUMP_POINTS)
    ]
    return _batch_coverage("bump batch", "tempo_partial_handle", proto, dims,
                           specs, dev, mod, rows_needed=(0, 1, 2))


def request_coverage(dev, mod) -> float:
    """K12 against its twin on every step of the batch of
    tests/test_torch_atlas_partial_step.py (close regions, GC every 10
    ms, the cleanup tick every 5 ms, a request buffer of 4), until all
    fourteen types and both timer rows have been compared, and requests
    answered at once with either reply, one answered by the cleanup tick,
    a two-shard commit and a drain chain have been seen. Returns the max
    abs error."""
    from fantoch_tpu_torch.core import Config, Planet
    from fantoch_tpu_torch.engine import EngineDims, make_lane
    from fantoch_tpu_torch.engine.protocols import AtlasPartialDev

    proto = AtlasPartialDev(keys=4 + 5 + 1, shards=2, keys_per_cmd=2,
                            gap_slots=4, req_buffer=4)
    dims = EngineDims.for_partial(proto, 5, 5, 20, regions=5)
    specs = [
        make_lane(proto, Planet.new(),
                  Config(n=5, f=f, shard_count=2, gc_interval_ms=10,
                         executor_executed_notification_interval_ms=100,
                         executor_cleanup_interval_ms=5),
                  conflict_rate=conflict, pool_size=4, commands_per_client=4,
                  clients_per_region=1, process_regions=EU5,
                  client_regions=EU5, dims=dims, extra_time_ms=100, seed=i)
        for i, (f, conflict) in enumerate(REQUEST_POINTS)
    ]
    extras = {
        "two-shard commits (MSHARDAGG sent)": _sent(10),
        "requests answered at once (GREPLY sent)": _sent(12),
        "requests answered at once (GREPLYEXEC sent)": _sent(13),
        "requests answered by the cleanup tick": _tick_answers,
        "drain chains (MDRAIN sent)": _sent(7),
    }
    return _batch_coverage("request batch", "atlas_partial_handle", proto,
                           dims, specs, dev, mod, bound=200, extras=extras)


def _checked(mod_name, kname, compare):
    """A stand-in for kernel ``kname`` in ``engine.core``: each call runs
    the kernel and its twin on the same arguments (an in-place kernel's
    twin on a copy), ``compare(args, got, want)`` holds them equal (the
    arguments as before the call), and the kernel's result goes on. The
    stand-in counts nothing (the kernel's own counter does)."""
    mod = importlib.import_module(f"fantoch_tpu_torch.kernels.{mod_name}")
    kern, plain = getattr(mod, kname), getattr(mod, kname + "_plain")

    def run(*a):
        if kname in IN_PLACE:
            # the twin on a copy, the kernel on the step's own state;
            # compare sees the arguments as they were before the call
            before = _fresh(kname, a)
            want = plain(*_fresh(kname, a))
            got = kern(*a)
            a = before
        else:
            want = plain(*a)
            got = kern(*a)
        import torch

        torch.cuda.synchronize()
        compare(a, got, want)
        return got

    run.launches = 0
    return run


class _Patched:
    """Swaps ``engine.core``'s kernel names for stand-ins while open."""

    def __init__(self, **stand_ins):
        from fantoch_tpu_torch.engine import core as engine_core

        self.core, self.new = engine_core, stand_ins
        self.old = {k: getattr(engine_core, k) for k in stand_ins}

    def __enter__(self):
        for k, v in self.new.items():
            setattr(self.core, k, v)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            setattr(self.core, k, v)


def _tempo_lanes(plans, commands, cpr=1, seeds=None, reorder=False,
                 extra=1000, interval=100, client_regions=None):
    """``(protocol, dims, specs)``: Tempo lanes at n = 3 on the first
    three GCP regions, one per plan (from_json form or None); clients in
    those regions unless ``client_regions`` names others."""
    from fantoch_tpu_torch.core import Config, Planet
    from fantoch_tpu_torch.engine import EngineDims, make_lane
    from fantoch_tpu_torch.engine.faults import FaultPlan
    from fantoch_tpu_torch.engine.protocols import TempoDev

    n, clients = 3, 3 * cpr
    proto = TempoDev(keys=1 + clients)
    total = commands * clients
    dims = EngineDims.for_protocol(
        proto, n=n, clients=clients, payload=proto.payload_width(n),
        total_commands=total, dot_slots=total + 1, regions=n,
    )
    regions = Planet.new().regions()[:n]
    clients_at = client_regions or regions
    seeds = seeds or [0] * len(plans)
    specs = [
        make_lane(proto, Planet.new(),
                  Config(n=n, f=1, gc_interval_ms=interval,
                         tempo_detached_send_interval_ms=interval),
                  conflict_rate=100, pool_size=1,
                  commands_per_client=commands, clients_per_region=cpr,
                  process_regions=regions, client_regions=clients_at,
                  dims=dims, extra_time_ms=extra, seed=seed,
                  reorder=reorder,
                  faults=FaultPlan.from_json(plan) if plan else None)
        for plan, seed in zip(plans, seeds)
    ]
    return proto, dims, specs


def fault_coverage(dev) -> float:
    """K1, K6 and K2 against their twins under the fault flags on every
    step of the fault-coverage batch (lane i runs COVERAGE_PLANS[i]),
    until each plan's event has been seen in a compared step: the event
    is where the twin's result with the plan's flag differs from it with
    the flag taken away (lost rows for the lossy plans, the error bit for
    the unavailable lane). Then the whole step's frozen-lane check on
    the batch's last state under those flags (the crash flag among
    them), every third lane failed, the cap an int and a device word.
    Returns the max abs error."""
    import torch

    from fantoch_tpu_torch.engine import core as engine_core
    from fantoch_tpu_torch.engine import faults as fm
    from fantoch_tpu_torch.engine.driver import prepare_batch
    from fantoch_tpu_torch.engine.faults import batch_fault_flags

    er = importlib.import_module("fantoch_tpu_torch.kernels.emit_rewrite")
    qp = importlib.import_module("fantoch_tpu_torch.kernels.qualify_pop")
    labels = [label for label, _p in COVERAGE_PLANS]
    proto, dims, specs = _tempo_lanes(
        [plan for _l, plan in COVERAGE_PLANS], 6, cpr=2, interval=20,
        seeds=list(range(len(COVERAGE_PLANS))),
        client_regions=COVERAGE_CLIENTS)
    seen = dict.fromkeys(labels, 0)
    halted = specs[0].fault_meta["halted_clients"]
    errs = [0.0]

    def k1(a, got, want):
        errs[0] = max(errs[0], _compare(got, want))
        if not bool(a[6].running()[0]):
            return  # lane 0 frozen: its outputs are the defined ones
        off = qp.qualify_pop_plain(*a[:5], a[5] & ~fm.FLAG_CRASH, a[6])
        purged = (want[0] >= (1 << 30)) & (off[0] < (1 << 30))
        dead = (want[8] >= (1 << 30)) & (a[1] < (1 << 30))
        seen[labels[0]] += int(purged[0].sum()) + int(dead[0].sum())

    def k6(a, got, want):
        errs[0] = max(errs[0], _compare(got, want))
        lost = (want[2]["fault_dropped"] - a[0]["fault_dropped"]).tolist()
        for i in (3, 4, 6):
            seen[labels[i]] += lost[i]
        for i, bit in ((1, fm.FLAG_WINDOWS), (2, fm.FLAG_WINDOWS),
                       (5, fm.FLAG_JITTER)):
            off = er.emit_rewrite_plain(*_fresh("emit_rewrite", a)[:12],
                                        a[12] & ~bit)
            moved = (off[0][i, :, 0] != want[0][i, :, 0]) & want[1][i]
            seen[labels[i]] += int(moved.sum())
        seen[labels[7]] += int(want[2]["err"][7] & 128 != 0)
        off = er.emit_rewrite_plain(*_fresh("emit_rewrite", a)[:12],
                                    a[12] & ~fm.FLAG_HORIZON)
        done = [x[2]["clients"]["completed"][8:] for x in (off, want)]
        seen[labels[8]] += int((done[0] != done[1]).sum())

    def k2(a, got, want):
        errs[0] = max(errs[0], _compare(got, want))
        assert torch.equal(got[4], a[-1].running())

    flags = batch_fault_flags(specs)
    state, ctx = prepare_batch(proto, dims, specs, dev)
    steps = 0
    with _Patched(
        qualify_pop=_checked("qualify_pop", "qualify_pop", k1),
        emit_rewrite=_checked("emit_rewrite", "emit_rewrite", k6),
        land_emissions=_checked("land_emissions", "land_emissions", k2),
    ):
        while not (all(seen.values()) and halted):
            state, running = engine_core.frozen_step(
                proto, dims, state, ctx, 1 << 22, False, flags)
            steps += 1
            if steps >= 600 or not bool(running.any()):
                break
    torch.cuda.synchronize()
    assert halted > 0 and all(seen.values()), (
        f"fault coverage incomplete after {steps} steps: {seen}, "
        f"halted clients {halted}")
    fb = fm.flag_bits(flags)
    assert fb & fm.FLAG_CRASH and fb & fm.FLAG_HORIZON, fb

    def step(st, cx, lim):
        return engine_core.frozen_step(proto, dims, st, cx, lim, False,
                                       flags)

    for word in (False, True):
        frozen_step_check(f"fault-coverage batch at step {steps}", step,
                          state, ctx, 1 << 22, fb, word)
    print(f"kernels qualify_pop, emit_rewrite, land_emissions (fault-coverage "
          f"batch, flags {fm.flag_bits(flags)}): exact=True on every one of "
          f"{steps} steps; seen "
          + "; ".join(f"{k} {v}" for k, v in seen.items())
          + f"; halted clients {halted}; max_abs_err={errs[0]}")
    return errs[0]


def qualify_large_pool(dev) -> float:
    """K1 against its twin on a pool larger than a block stages in
    shared memory: 16 lanes of 60,000 slots of 29 words at N = 5 (an
    H100's 227 KB hold about 46,000 slots beside the per-process words),
    fault-free and under the crash and horizon flags, with the
    messages of every other lane all past slot 50,000, so that pops
    take slots that the pop and free passes re-read from the pool. Each
    output equals the twin's; some pop takes a slot past 50,000 under
    each flag word. Returns the max abs error."""
    import numpy as np
    import torch

    from fantoch_tpu_torch.engine.dims import INF, PA, PDST, PKC, PKS, PPR
    from fantoch_tpu_torch.engine.faults import FLAG_CRASH, FLAG_HORIZON

    qp = importlib.import_module("fantoch_tpu_torch.kernels.qualify_pop")
    L, M, N, R, W = 16, 60_000, 5, 2, 29
    rng = np.random.default_rng(15)
    pool = rng.integers(0, 9, (L, M, W)).astype(np.int32)
    pool[..., PA] = INF
    for lane in range(L):
        lo = 50_000 if lane % 2 else 0
        hot = lo + rng.choice(M - lo, 400, replace=False)
        pool[lane, hot, PA] = rng.integers(0, 6, hot.size)
    pool[..., PDST] = rng.integers(-1, N + 1, (L, M))
    pool[..., PKS] = rng.integers(0, 4, (L, M))
    pool[..., PKC] = rng.integers(0, 3, (L, M))
    pool[..., PPR] = rng.random((L, M)) < 0.2

    def inf_or(shape, hi, p_inf):
        v = rng.integers(0, hi, shape).astype(np.int32)
        return np.where(rng.random(shape) < p_inf, INF, v).astype(np.int32)

    timers = inf_or((L, N, R), 8, 0.5)
    lookahead = inf_or((L, N, N), 4, 0.2)
    lookahead[:, np.arange(N), np.arange(N)] = INF
    crash_t = inf_or((L, N), 8, 0.5)
    horizon = rng.integers(3, 9, (L,)).astype(np.int32)
    a = [torch.from_numpy(x).to(dev)
         for x in (pool, timers, lookahead, crash_t, horizon)]
    err = 0.0
    for flags in (0, FLAG_CRASH | FLAG_HORIZON):
        got = qp.qualify_pop(*a, flags)
        want = qp.qualify_pop_plain(*a, flags)
        torch.cuda.synchronize()
        err = max(err, _compare(got, want))
        slot, has = want[5], want[6]
        far = int((has & (slot >= 50_000)).sum())
        assert far > 0, "no pop past slot 50,000"
        ms = _device_ms(lambda: qp.qualify_pop(*a, flags), "qualify_pop", 20)
        print(f"kernel qualify_pop (L={L} M={M} W={W} N={N}, flags {flags}):"
              f" exact=True max_abs_err={err} ms={ms:.5f}; {far} of "
              f"{int(has.sum())} pops past slot 50,000")
    return err


def reorder_coverage(dev) -> float:
    """K6 against its twin on every one of the first
    :data:`REORDER_STEPS` steps of the faults golden batch's Tempo
    reorder lanes and of the Tempo partial reorder lane of
    tests/test_torch_faults_reorder.py (2 shards, seed 5); the golden
    phase runs the Tempo lanes to their end against the fixture. Returns
    the max abs error."""
    from fantoch_tpu_torch.core import Config, Planet
    from fantoch_tpu_torch.engine import EngineDims, make_lane
    from fantoch_tpu_torch.engine import core as engine_core
    from fantoch_tpu_torch.engine.driver import prepare_batch
    from fantoch_tpu_torch.engine.protocols import TempoPartialDev

    errs, calls = [0.0], [0]

    def k6(a, got, want):
        errs[0] = max(errs[0], _compare(got, want))
        calls[0] += 1

    batches = [_tempo_lanes([None] * len(REORDER_SEEDS), 20,
                            seeds=REORDER_SEEDS, reorder=True,
                            extra=30_000)]
    regions = Planet.new().regions()[:3]
    proto = TempoPartialDev(keys=4 + 3 + 1, shards=2, keys_per_cmd=2)
    dims = EngineDims.for_partial(proto, 3, 3, 30)
    batches.append((proto, dims, [make_lane(
        proto, Planet.new(),
        Config(n=3, f=1, shard_count=2, gc_interval_ms=100,
               executor_executed_notification_interval_ms=100,
               executor_cleanup_interval_ms=100,
               tempo_detached_send_interval_ms=100),
        conflict_rate=100, pool_size=4, commands_per_client=10,
        clients_per_region=1, process_regions=regions,
        client_regions=regions, dims=dims, extra_time_ms=30_000, seed=5,
        reorder=True)]))
    with _Patched(emit_rewrite=_checked("emit_rewrite", "emit_rewrite", k6)):
        for label, (p, d, specs) in zip(("tempo", "tempo partial"), batches):
            before = calls[0]
            state, ctx = prepare_batch(p, d, specs, dev)
            for _ in range(REORDER_STEPS):
                state, running = engine_core.frozen_step(
                    p, d, state, ctx, 1 << 22, True)
            assert not bool(state["err"].any()), state["err"]
            print(f"kernel emit_rewrite ({label} reorder batch): exact=True "
                  f"on every one of the first {calls[0] - before} steps; "
                  f"lanes' steps {state['steps'].tolist()}, requeues "
                  f"{state['requeues'].tolist()}, running "
                  f"{running.tolist()}")
    return errs[0]


def wide_emit(dev) -> float:
    """K6 at 1,060 and 1,540 emission rows a lane: one step's arguments
    of a small Tempo partial and Atlas partial batch at 4 shards of n = 5
    (N = 20), stepped on the host twins to step 40, on the card against
    the twin. Returns the max abs error."""
    import torch

    from fantoch_tpu_torch.core import Config, Planet
    from fantoch_tpu_torch.engine import EngineDims, make_lane
    from fantoch_tpu_torch.engine import core as engine_core
    from fantoch_tpu_torch.engine.driver import prepare_batch
    from fantoch_tpu_torch.engine.protocols import partial_dev_protocol

    er = importlib.import_module("fantoch_tpu_torch.kernels.emit_rewrite")
    err = 0.0
    regions = Planet.new().regions()[:5]
    for name in ("tempo", "atlas"):
        proto = partial_dev_protocol(name, 5, 4, keys_per_cmd=2, pool_size=4)
        dims = EngineDims.for_partial(proto, 5, 5, 10)
        kw = dict(tempo_detached_send_interval_ms=100) if name == "tempo" \
            else {}
        specs = [
            make_lane(proto, Planet.new(),
                      Config(n=5, f=f, shard_count=4, gc_interval_ms=100,
                             executor_executed_notification_interval_ms=100,
                             executor_cleanup_interval_ms=100, **kw),
                      conflict_rate=100, pool_size=4, commands_per_client=2,
                      clients_per_region=1, process_regions=regions,
                      client_regions=regions, dims=dims, seed=f)
            for f in (1, 2)
        ]
        state, ctx = prepare_batch(proto, dims, specs, "cpu")
        box = {}

        def record(*a):
            box["args"] = _fresh("emit_rewrite", a)
            return er.emit_rewrite_plain(*a)

        record.launches = 0
        with _Patched(emit_rewrite=record):
            for _ in range(40):
                state, _running = engine_core.frozen_step(
                    proto, dims, state, ctx, 1 << 22)
        a = box["args"]
        args = (*(to_torch_tree(x, dev) for x in a[:10]), *a[10:13])
        got = er.emit_rewrite(*_fresh("emit_rewrite", args))
        want = er.emit_rewrite_plain(*_fresh("emit_rewrite", args))
        torch.cuda.synchronize()
        err = max(err, _compare(got, want))
        E = got[0].shape[1]
        print(f"kernel emit_rewrite ({name} partial, 4 shards of n = 5): "
              f"exact=True at E={E} rows a lane, {int(got[1].sum())} rows "
              f"landing, {er.smem_bytes(dims.N, dims.F, dims.C)} bytes of "
              f"shared memory a block; max_abs_err={err}")
    return err


def to_torch_tree(x, dev):
    """A tree of CPU tensors moved to ``dev`` (ints pass through)."""
    if isinstance(x, dict):
        return {k: to_torch_tree(v, dev) for k, v in x.items()}
    return x.to(dev) if hasattr(x, "to") else x


def golden_faults(dev) -> None:
    """Phase 6: the faults golden batches (tests/test_torch_faults.py:
    the Tempo fault batch and the Tempo reorder batch) against their
    fixture."""
    from fantoch_tpu_torch.engine import run_lanes
    from fantoch_tpu_torch.engine.dims import ERR_UNAVAIL

    results = []
    for batch in (_tempo_lanes(FAULT_PLANS, 15),
                  _tempo_lanes([None] * len(REORDER_SEEDS), 20,
                               seeds=REORDER_SEEDS, reorder=True,
                               extra=30_000)):
        results += run_lanes(*batch, device=dev)
    unavail = results[len(FAULT_PLANS) - 1]
    assert unavail.err & ERR_UNAVAIL and unavail.steps <= 2
    for res in results[:4] + results[4:6] + results[len(FAULT_PLANS):]:
        assert res.err == 0, res.err_cause
    print(f"golden faults on {dev}: "
          + "; ".join(f"{r.faults or 'reorder'}: steps {r.steps} completed "
                      f"{r.completed} dropped {r.dropped} err {r.err}"
                      for r in results))
    _match_fixture(results, "torch_faults_golden.json")


def golden_basic(dev) -> None:
    """Phase 4: the reference's golden Basic numbers and fixture bytes."""
    from fantoch_tpu_torch.core import Config, Planet
    from fantoch_tpu_torch.engine import EngineDims, make_lane, run_lanes
    from fantoch_tpu_torch.engine.protocols import BasicDev

    gdims = EngineDims.for_protocol(
        BasicDev, n=3, clients=2, payload=3, total_commands=200,
        dot_slots=201, regions=2,
    )
    gspecs = [
        make_lane(BasicDev, Planet.new(), Config(n=3, f=f, gc_interval_ms=100),
                  conflict_rate=cf, pool_size=1, commands_per_client=100,
                  clients_per_region=1,
                  process_regions=["asia-east1", "us-central1", "us-west1"],
                  client_regions=["us-west1", "us-west2"], dims=gdims,
                  extra_time_ms=1000, seed=i)
        for i, (f, cf) in enumerate(GOLDEN_POINTS)
    ]
    golden = run_lanes(BasicDev, gdims, gspecs, device=dev)
    expected = {0: (0.0, 24.0), 1: (34.0, 58.0), 2: (118.0, 142.0)}
    for (f, cf), res in zip(GOLDEN_POINTS, golden):
        assert res.err == 0, res.err_cause
        assert list(res.protocol_metrics["stable"]) == [200, 200, 200]
        if cf == 100:
            got = (res.latency_mean("us-west1"), res.latency_mean("us-west2"))
            assert got == expected[f], (f, got)
    print("golden basic n=3 on cuda: means (us-west1, us-west2) "
          + ", ".join(f"f={f} {expected[f]}" for f in (0, 1, 2))
          + "; stable [200, 200, 200] at every f")
    _match_fixture(golden, "torch_basic_golden.json")


def golden_fpaxos(dev) -> None:
    """Phase 5: the FPaxos golden batch (the three configurations of
    tests/test_engine_fpaxos.py in one batch) against its fixture."""
    from fantoch_tpu_torch.core import Config, Planet
    from fantoch_tpu_torch.engine import EngineDims, make_lane, run_lanes
    from fantoch_tpu_torch.engine.protocols import FPaxosDev

    gdims = EngineDims.for_protocol(
        FPaxosDev, n=3, clients=2, payload=3, total_commands=100,
        dot_slots=101, regions=2,
    )
    gspecs = [
        make_lane(FPaxosDev, Planet.new(),
                  Config(n=3, f=f, leader=leader, gc_interval_ms=100),
                  conflict_rate=100, pool_size=1, commands_per_client=50,
                  clients_per_region=1,
                  process_regions=["asia-east1", "us-central1", "us-west1"],
                  client_regions=["us-west1", "us-west2"], dims=gdims,
                  extra_time_ms=1000, seed=i)
        for i, (f, leader) in enumerate(FPAXOS_POINTS)
    ]
    golden = run_lanes(FPaxosDev, gdims, gspecs, device=dev)
    for (f, leader), res in zip(FPAXOS_POINTS, golden):
        assert res.err == 0, res.err_cause
        assert int(res.lat_count.sum()) == 100
        means = (res.latency_mean("us-west1"), res.latency_mean("us-west2"))
        print(f"golden fpaxos n=3 on cuda: f={f} leader={leader} means "
              f"(us-west1, us-west2) {means} stable "
              f"{res.protocol_metrics['stable'].tolist()}")
    _match_fixture(golden, "torch_fpaxos_golden.json")


def golden_tempo(dev) -> None:
    """Phase 6: the Tempo golden batches (the configurations of
    tests/test_engine_tempo.py, a clock-bump lane and a skip-capable
    batch) against their fixture."""
    from fantoch_tpu_torch.core import Config, Planet
    from fantoch_tpu_torch.engine import EngineDims, make_lane, run_lanes
    from fantoch_tpu_torch.engine.protocols import TempoDev

    planet = Planet.new()
    regions = planet.regions()
    results = []
    for points, skip_capable in ((TEMPO_MAIN, False), (TEMPO_SKIP, True)):
        clients = max(n * cpr for n, _f, _c, _k, cpr, _x in points)
        total = max(k * n * cpr for n, _f, _c, k, cpr, _x in points)
        n_max = max(pt[0] for pt in points)
        proto = TempoDev(keys=1 + clients, skip_capable=skip_capable)
        dims = EngineDims.for_protocol(
            proto, n=n_max, clients=clients,
            payload=proto.payload_width(n_max), total_commands=total,
            dot_slots=total + 1, regions=n_max,
        )
        specs = [
            make_lane(
                proto, planet,
                Config(n=n, f=f, gc_interval_ms=100,
                       tempo_detached_send_interval_ms=100,
                       tempo_clock_bump_interval_ms=(
                           None if skip_capable else x),
                       skip_fast_ack=bool(skip_capable and x)),
                conflict_rate=conflict, pool_size=1,
                commands_per_client=commands, clients_per_region=cpr,
                process_regions=regions[:n], client_regions=regions[:n],
                dims=dims, seed=i,
            )
            for i, (n, f, conflict, commands, cpr, x) in enumerate(points)
        ]
        batch = run_lanes(proto, dims, specs, device=dev)
        for (n, f, _c, commands, cpr, x), res in zip(points, batch):
            assert res.err == 0, res.err_cause
            assert res.completed == commands * cpr * n
            m = {k: int(v.sum()) for k, v in res.protocol_metrics.items()}
            print(f"golden tempo on {dev}: n={n} f={f} commands={commands} "
                  f"x{cpr} {'skip' if skip_capable else 'bump'}={x} "
                  f"steps {res.steps} metrics {m}")
        results += batch
    _match_fixture(results, "torch_tempo_golden.json")


def golden_graphdep(dev) -> None:
    """Phase 6: the Atlas and EPaxos golden batches (the configurations
    of tests/test_engine_graphdep.py, one batch per protocol) against
    their fixture."""
    from fantoch_tpu_torch.core import Config, Planet
    from fantoch_tpu_torch.engine import EngineDims, make_lane, run_lanes
    from fantoch_tpu_torch.engine.protocols import AtlasDev, EPaxosDev

    planet = Planet.new()
    regions = planet.regions()
    points = GRAPHDEP_POINTS
    clients = max(n * cpr for n, _f, _c, _k, cpr in points)
    total = max(k * n * cpr for n, _f, _c, k, cpr in points)
    n_max = max(pt[0] for pt in points)
    results = []
    for cls in (AtlasDev, EPaxosDev):
        proto = cls(keys=1 + clients)
        dims = EngineDims.for_protocol(
            proto, n=n_max, clients=clients,
            payload=proto.payload_width(n_max), total_commands=total,
            dot_slots=total + 1, regions=n_max,
        )
        specs = [
            make_lane(proto, planet, Config(n=n, f=f, gc_interval_ms=100),
                      conflict_rate=conflict, pool_size=1,
                      commands_per_client=commands, clients_per_region=cpr,
                      process_regions=regions[:n],
                      client_regions=regions[:n], dims=dims, seed=i)
            for i, (n, f, conflict, commands, cpr) in enumerate(points)
        ]
        batch = run_lanes(proto, dims, specs, device=dev)
        for (n, f, _c, commands, cpr), res in zip(points, batch):
            assert res.err == 0, res.err_cause
            done = commands * cpr * n
            m = {k: int(v.sum()) for k, v in res.protocol_metrics.items()}
            assert m["fast_path"] + m["slow_path"] == done, m
            assert m["stable"] == n * done, m
            print(f"golden {cls.__name__} on {dev}: n={n} f={f} "
                  f"commands={commands} x{cpr} steps {res.steps} "
                  f"metrics {m}")
        results += batch
    _match_fixture(results, "torch_graphdep_golden.json")


def golden_caesar(dev) -> None:
    """Phase 6: the Caesar golden batch (the five configurations of
    tests/test_engine_caesar.py that are not slow, wait condition on and
    off, in one batch) against its fixture."""
    from fantoch_tpu_torch.core import Config, Planet
    from fantoch_tpu_torch.engine import EngineDims, make_lane, run_lanes
    from fantoch_tpu_torch.engine.protocols import CaesarDev

    planet = Planet.new()
    regions = planet.regions()
    points = CAESAR_POINTS
    clients = max(n * cpr for n, _f, _w, _c, _k, cpr in points)
    total = max(k * n * cpr for n, _f, _w, _c, k, cpr in points)
    n_max = max(pt[0] for pt in points)
    proto = CaesarDev.for_load(keys=1 + clients, clients=clients)
    dims = EngineDims.for_protocol(
        proto, n=n_max, clients=clients,
        payload=proto.payload_width(n_max), total_commands=total,
        dot_slots=total + 1, regions=n_max,
    )
    specs = [
        make_lane(proto, planet,
                  Config(n=n, f=f, gc_interval_ms=100,
                         caesar_wait_condition=wait),
                  conflict_rate=conflict, pool_size=1,
                  commands_per_client=commands, clients_per_region=cpr,
                  process_regions=regions[:n], client_regions=regions[:n],
                  dims=dims, seed=i)
        for i, (n, f, wait, conflict, commands, cpr) in enumerate(points)
    ]
    results = run_lanes(proto, dims, specs, device=dev)
    for (n, f, wait, _c, commands, cpr), res in zip(points, results):
        assert res.err == 0, res.err_cause
        done = commands * cpr * n
        m = {k: int(v.sum()) for k, v in res.protocol_metrics.items()}
        assert m["fast_path"] + m["slow_path"] == done, m
        assert m["stable"] == n * done, m
        print(f"golden caesar on {dev}: n={n} f={f} wait={wait} "
              f"commands={commands} x{cpr} steps {res.steps} metrics {m}")
    _match_fixture(results, "torch_caesar_golden.json")


def golden_tempo_partial(dev) -> None:
    """Phase 6: the partial-replication golden batches (the two
    configurations of tests/test_engine_partial.py that are not slow, one
    batch each) against their fixture."""
    from fantoch_tpu_torch.core import Config, Planet
    from fantoch_tpu_torch.engine import EngineDims, make_lane, run_lanes
    from fantoch_tpu_torch.engine.protocols import TempoPartialDev

    planet = Planet.new()
    results = []
    for n, f, shards, conflict, pool, kpc in TEMPO_PARTIAL_POINTS:
        regions = planet.regions()[:n]
        proto = TempoPartialDev(keys=pool + n + 1, shards=shards,
                                keys_per_cmd=kpc)
        dims = EngineDims.for_partial(proto, n, n, 10 * n, regions=n)
        config = Config(n=n, f=f, shard_count=shards, gc_interval_ms=100,
                        executor_executed_notification_interval_ms=100,
                        executor_cleanup_interval_ms=100,
                        tempo_detached_send_interval_ms=100)
        spec = make_lane(proto, planet, config, conflict_rate=conflict,
                         pool_size=pool, commands_per_client=10,
                         clients_per_region=1, process_regions=regions,
                         client_regions=regions, dims=dims)
        (res,) = run_lanes(proto, dims, [spec], device=dev)
        assert res.err == 0, res.err_cause
        assert res.completed == 10 * n
        m = {k: int(v.sum()) for k, v in res.protocol_metrics.items()}
        assert 10 * n <= m["fast_path"] + m["slow_path"] <= 10 * n * shards
        assert m["stable"] == n * 10 * n, m
        print(f"golden tempo partial on {dev}: n={n} f={f} shards={shards} "
              f"conflict={conflict} pool={pool} keys per command={kpc} "
              f"steps {res.steps} metrics {m}")
        results.append(res)
    _match_fixture(results, "torch_tempo_partial_golden.json")


def golden_atlas_partial(dev) -> None:
    """Phase 6: the Atlas partial golden batch (the configuration of
    tests/test_engine_partial.py's Atlas test that is not slow and one at
    conflict 10, in one batch) against its fixture."""
    from fantoch_tpu_torch.core import Config, Planet
    from fantoch_tpu_torch.engine import EngineDims, make_lane, run_lanes
    from fantoch_tpu_torch.engine.protocols import AtlasPartialDev

    planet = Planet.new()
    n, _f, shards, _c, pool, kpc = ATLAS_PARTIAL_POINTS[0]
    regions = planet.regions()[:n]
    proto = AtlasPartialDev(keys=pool + n + 1, shards=shards,
                            keys_per_cmd=kpc)
    dims = EngineDims.for_partial(proto, n, n, 10 * n, regions=n)
    specs = [
        make_lane(proto, planet,
                  Config(n=n, f=f, shard_count=shards, gc_interval_ms=100,
                         executor_executed_notification_interval_ms=100,
                         executor_cleanup_interval_ms=100),
                  conflict_rate=conflict, pool_size=pool,
                  commands_per_client=10, clients_per_region=1,
                  process_regions=regions, client_regions=regions, dims=dims)
        for n, f, shards, conflict, pool, kpc in ATLAS_PARTIAL_POINTS
    ]
    results = run_lanes(proto, dims, specs, device=dev)
    for (n, f, shards, conflict, pool, kpc), res in zip(ATLAS_PARTIAL_POINTS,
                                                        results):
        assert res.err == 0, res.err_cause
        assert res.completed == 10 * n
        m = {k: int(v.sum()) for k, v in res.protocol_metrics.items()}
        assert 10 * n <= m["fast_path"] + m["slow_path"] <= 10 * n * shards
        assert m["stable"] == n * 10 * n, m
        print(f"golden atlas partial on {dev}: n={n} f={f} shards={shards} "
              f"conflict={conflict} pool={pool} keys per command={kpc} "
              f"steps {res.steps} metrics {m}")
    _match_fixture(results, "torch_atlas_partial_golden.json")


def _match_fixture(results, name) -> None:
    text = json.dumps([r.to_json() for r in results], sort_keys=True) + "\n"
    path = FIXTURES / name
    assert text == path.read_text(), f"to_json differs from {name}"
    print(f"fixture {path.relative_to(ROOT)}: byte-identical "
          f"({len(text)} bytes)")


def sweep(name, dev):
    """Phase 7: one main path's sweep, counted: points/s, batch steps,
    steps per lane, errors, each lane's mean latency averaged over the
    sweep, the launches; sampled lanes against the plain twins on the
    host. Returns its launches."""
    import torch

    from fantoch_tpu_torch import cli, kernels
    from fantoch_tpu_torch.parallel import run_sweep
    from fantoch_tpu_torch.parallel import sweep as psweep

    args = cli.parse_args(path_argv(name))
    protocol, dims, specs = cli.sweep_setup(args)
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = run_sweep(protocol, dims, specs,
                        batch_lanes=args.batch_lanes, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = graph_only_counts(name)
    errors = sum(1 for r in results if r.err)
    steps = [r.steps for r in results]
    total = args.commands * dims.C
    steps_run = launches["qualify_pop"]
    stable = sorted({int(r.protocol_metrics["stable"].sum())
                     for r in results})
    means = [int(r.lat_sum.sum()) / int(r.lat_count.sum())
             for r in results if int(r.lat_count.sum())]
    clean = [int(r.lat_sum.sum()) / total for r in results if not r.err]
    print(f"sweep {name} n=5 (N={dims.N} M={dims.M} D={dims.D} F={dims.F}): "
          f"{len(results)} points "
          f"in {wall:.3f} s = {len(results) / wall:.3f} points/s "
          f"({stage_secs(psweep.LAST_STATS)}); errors "
          f"{errors} {sorted({r.err_cause for r in results if r.err})}; "
          f"steps per lane max {max(steps)} mean {sum(steps) / len(steps):.1f}"
          f"; batch steps {steps_run}; lanes complete "
          f"{sum(1 for r in results if r.completed == total)}; mean latency "
          f"(mean of the lanes' means) {sum(means) / len(means):.3f} ms, of "
          f"the {len(clean)} lanes without error "
          f"{sum(clean) / max(len(clean), 1):.3f} ms; pool_peak max "
          f"{max(r.pool_peak for r in results)}; requeues "
          f"{sum(r.requeues for r in results)}; stable totals {stable}; "
          f"launches {launches}; launches per batch step "
          f"{ {k: v / steps_run for k, v in launches.items()} }")
    handler = HANDLERS[base_path(name)]
    path_kernels = ["qualify_pop", handler, "emit_rewrite",
                    "land_emissions", "key_table"]
    assert all(launches[k] > 0 for k in path_kernels), launches
    other = set(HANDLERS.values()) - {handler}
    assert all(launches[k] == 0 for k in other), launches
    if name in cli.ENGINE_PROTOCOLS:
        LINES[name] = [json.dumps(r.to_json(), sort_keys=True)
                       for r in results]
        WALLS[name] = wall
    if name == "tempo_faults":
        fault_sweep_checks(specs, results, total, wall, launches)
    elif args.arrivals:
        # the reference's engine ends the same lanes in capacity
        # overflows (its tables are sized for the closed loop)
        assert len(results) == 512
        assert all(r.err_cause == "capacity-overflow"
                   for r in results if r.err)
        assert all(r.completed == total for r in results if not r.err)
        by_conflict = {}
        for i, (spec, r) in enumerate(zip(specs, results)):
            if r.err:
                cf = int(spec.ctx["conflict_rate"])
                by_conflict.setdefault(cf, []).append(i)
        print(f"{name}: erring lanes by conflict rate "
              f"{ {cf: len(v) for cf, v in sorted(by_conflict.items())} }, "
              f"at conflict 10 lanes {by_conflict.get(10, [])}")
    else:
        grid = args.subsets * len(args.fs) * len(args.conflicts)
        assert len(results) == grid and errors == 0
        assert grid == (2048 if name in ("basic", "fpaxos", "tempo", "atlas",
                                         "epaxos", "caesar") else 512)
        main_path_checks(name, dims, specs, results, total)
    t0 = time.perf_counter()
    sample = SAMPLE[base_path(name)]
    host, secs = HOST.result(("sweep", name))
    for i, line in zip(sample, host):
        assert line == json.dumps(results[i].to_json(), sort_keys=True), (
            f"{name} lane {i} differs from the host run")
    print(f"{name} lanes {sample}: card == host plain twins, byte for byte "
          f"({secs:.1f} s on the host, waited {time.perf_counter() - t0:.1f} "
          f"s)")
    return launches


# the segments phase: (segment_steps, scan_window or None for the
# default, pipeline_depth, max_steps); at 1,500 steps the longer lanes
# end in ERR_TRUNCATED
SEGMENT_CASES = [(8192, None, 2, 1 << 22), (1000, 3, 2, 1 << 22),
                 (100, 1, 1, 1 << 22), (8192, None, 2, 1500)]
SEGMENT_PATHS = {"tempo": SEGMENT_CASES, "basic": SEGMENT_CASES,
                 "caesar": SEGMENT_CASES[1:2]}


def _tree_exact(got, want) -> float:
    """Exact equality of two state trees, leaf by leaf; 0.0 or raises."""
    import torch

    a, b = _flatten(got), _flatten(want)
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.shape == y.shape and x.dtype == y.dtype, (i, x.shape)
        if not torch.equal(x, y):
            raise AssertionError(f"state leaf {i} differs")
    return 0.0


def segments(dev, rows) -> None:
    """The device loop against the eager loop on the card: on the
    first 512-lane batch of the Tempo and Basic main paths (Caesar at
    one setting), the batch through the segment loop of ``run_sweep``
    (``parallel/sweep.py run_windows``) at each of
    :data:`SEGMENT_CASES`, then ``finish_run``; its whole final state
    equals the eager loop's (``build_eager_runner``, every launch
    through its wrapper) at the same ``max_steps``, byte for byte. Then
    the B6-loop row: one window of one body on Tempo's batch, beside
    the eager loop over the same steps and a replay of the captured
    body alone."""
    import torch

    from fantoch_tpu_torch import cli
    from fantoch_tpu_torch.engine import core as engine_core
    from fantoch_tpu_torch.engine.dims import ERR_TRUNCATED
    from fantoch_tpu_torch.engine.driver import (
        batch_reorder_flag, prepare_batch,
    )
    from fantoch_tpu_torch.engine.faults import batch_fault_flags
    from fantoch_tpu_torch.parallel import sweep as psweep

    for name, cases in SEGMENT_PATHS.items():
        protocol, dims, specs = cli.sweep_setup(
            cli.parse_args(path_argv(name)))
        batch = specs[:512]
        flags = (batch_reorder_flag(batch), batch_fault_flags(batch))
        eager = {}
        for seg, win, depth, max_steps in cases:
            if max_steps not in eager:
                state, ctx = prepare_batch(protocol, dims, batch, dev)
                t0 = time.perf_counter()
                eager[max_steps] = engine_core.build_eager_runner(
                    protocol, dims, max_steps, *flags)(state, ctx)
                torch.cuda.synchronize()
                print(f"segments {name}: eager loop to max_steps={max_steps}"
                      f" in {time.perf_counter() - t0:.3f} s")
            W = psweep.default_scan_window(seg) if win is None else win
            runner, _alive = engine_core.build_window_runner(
                protocol, dims, max_steps, *flags)
            state, ctx = prepare_batch(protocol, dims, batch, dev)
            stats = dict(device_calls=0, segments_covered=0, windows=0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = psweep.run_windows(runner, state, ctx, seg, W, depth,
                                    max_steps, stats)
            final = engine_core.finish_run(protocol, st, ctx, max_steps,
                                           *flags)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            _tree_exact(final, eager[max_steps])
            bodies = runner.bodies()
            steps_max = int(final["steps"].max())
            cut = int(((final["err"] & ERR_TRUNCATED) != 0).sum())
            assert cut > 0 if max_steps == 1500 else cut == 0, cut
            print(f"segments {name} (segment_steps={seg}, scan_window={W}, "
                  f"pipeline_depth={depth}, max_steps={max_steps}): whole "
                  f"state == the eager loop's, byte for byte; {secs:.3f} s "
                  f"(capture + instantiate {runner.capture_s:.3f} s); "
                  f"stats {stats}; bodies {bodies} of {runner.loop.G} steps"
                  f" = {bodies * runner.loop.G} batch steps, longest lane "
                  f"{steps_max}, overshoot "
                  f"{bodies * runner.loop.G - steps_max}; truncated lanes "
                  f"{cut}")
        del eager
    rows["step_loop"] = step_loop_row(dev)


def _replay_ms(loop, until: int) -> float:
    """ms of one ``CUDAGraph.replay()`` of the device loop's captured body
    alone, its lanes stepping: at a window's end every running lane sits
    at the step cap ``until``, where the kernels skip it, so the cap word
    is first raised past the replays (a warm-up and ten timed)."""
    from fantoch_tpu_torch.kernels.loop_ctl import CTL_LIM

    loop.ctl[CTL_LIM] = until + 11 * loop.G
    return _time_ms(loop.graph.replay, 10)


def step_loop_row(dev) -> dict:
    """The B6-loop's row, on the Tempo main path's first batch after 320
    steps: ``ms`` one window that runs one body (``STEPS_PER_BODY``
    steps; CUDA events around the call, host included), ``plain_ms``
    the eager loop over as many steps, ``library_ms`` a
    ``CUDAGraph.replay()`` of the captured body alone (no while node,
    no K14; :func:`_replay_ms`), ``bound_ms`` the body's kernels' bounds (phase 3's, per
    step) times its steps plus K14's."""
    import torch

    from fantoch_tpu_torch import cli
    from fantoch_tpu_torch.engine import core as engine_core
    from fantoch_tpu_torch.engine.driver import (
        batch_reorder_flag, prepare_batch,
    )
    from fantoch_tpu_torch.engine.faults import batch_fault_flags

    name = "tempo"
    protocol, dims, specs = cli.sweep_setup(cli.parse_args(path_argv(name)))
    batch = specs[:512]
    flags = (batch_reorder_flag(batch), batch_fault_flags(batch))
    runner, _alive = engine_core.build_window_runner(protocol, dims,
                                                     1 << 22, *flags)
    state, ctx = prepare_batch(protocol, dims, batch, dev)
    box = {"until": 320}
    box["st"] = runner(state, ctx, [box["until"]])[0]
    loop = runner.loop
    G = loop.G

    def one_body():
        box["until"] += G
        box["st"] = runner(box["st"], ctx, [box["until"]])[0]

    torch.cuda.synchronize()
    it0 = loop.iterations()
    ms = _time_ms(one_body, 10)
    bodies = loop.iterations() - it0
    assert bodies == 11, bodies  # one body a window
    eager = {"st": engine_core.clone_tree(box["st"])}

    def eager_body():
        st = eager["st"]
        for _ in range(G):
            st, _r = engine_core.frozen_step(protocol, dims, st, ctx,
                                             1 << 22, *flags)
        eager["st"] = st

    plain_ms = _time_ms(eager_body, 3)
    library_ms = _replay_ms(loop, box["until"])
    step = ("qualify_pop", HANDLERS[name], "emit_rewrite", "land_emissions")
    # a captured body: four step kernels a step, nothing else counted
    assert loop.per_body == {k: G for k in step}, loop.per_body
    parts = [(G * BOUNDS[name][k][0], BOUNDS[name][k][1]) for k in step]
    parts.append(BOUNDS[name]["loop_ctl"])
    bound_ms = sum(ms_ for ms_, _by in parts)
    bound_by = max(parts)[1]  # the largest part's
    print(f"kernel step_loop ({name} path, L={len(batch)}): one window of "
          f"one body ({G} steps) ms={ms:.5f} ({ms / G:.5f} a step); the "
          f"eager loop over {G} steps plain_ms={plain_ms:.5f}; "
          f"CUDAGraph.replay of the body library_ms={library_ms:.5f}; "
          f"bound_ms={bound_ms:.5f} (the body's kernels' bounds x {G} "
          f"+ K14's); per body {loop.per_body}")
    return dict(path=name, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def graph_only_counts(label, single=True, groups=1) -> dict:
    """The launch counts of a main path's run, after checking that its
    step loop ran only inside the device loop's graph: no step kernel
    was launched through its wrapper, every one by a replayed body
    (counted from K14's body counter). For a ``single`` ``run_sweep``
    call, prints its stats and holds its batch steps times ``groups``
    (a mixed batch's protocols: K1 launches once a group a step) to K1's
    count."""
    from fantoch_tpu_torch import kernels
    from fantoch_tpu_torch.parallel import sweep as psweep

    step = ("qualify_pop", "emit_rewrite", "land_emissions",
            *sorted(set(HANDLERS.values())))
    direct = {k: kernels.WRAPPERS[k].launches for k in step}
    assert not any(direct.values()), direct
    launches = kernels.counts()
    assert launches["step_loop"] > 0 and launches["loop_ctl"] > 0, launches
    if not single:
        return launches
    st = psweep.LAST_STATS
    print(f"{label} device loop: {loop_stats(st)}; graph launches "
          f"{launches['step_loop']}, K14 launches {launches['loop_ctl']}")
    assert launches["qualify_pop"] == groups * st["batch_steps"], (
        launches["qualify_pop"], groups, st["batch_steps"])
    return launches


def loop_stats(st) -> str:
    """``run_sweep``'s stats as a line."""
    return (f"{st['batches']} batches, device_calls "
            f"{st['device_calls']}, windows {st['windows']}, segments "
            f"covered {st['segments_covered']} (scan_window "
            f"{st['scan_window']}, segment_steps {st['segment_steps']}), "
            f"body iterations {st['body_iterations']}, batch steps "
            f"{st['batch_steps']}, overshoot steps {st['overshoot_steps']}, "
            f"captures {st['captures']}, capture + instantiate "
            f"{st['capture_s']:.3f} s; {stage_secs(st)}")


def stage_secs(st) -> str:
    """A sweep's host seconds by stage, summed over its batches
    (``run_sweep``'s ``LAST_STATS``): the time outside the step loop
    beside the loop's."""
    return (f"outside the loop: prepare_batch {st['prepare_s']:.3f} s, "
            f"finish_run + collect_results {st['collect_s']:.3f} s; "
            f"run_windows {st['windows_s']:.3f} s")


def fault_sweep_checks(specs, results, total, wall, launches) -> None:
    """The fault path's checks: per plan its lanes, error causes,
    completed commands and lost messages; its fault-free lanes equal the
    Tempo sweep's first 512 lanes byte for byte; the fault-free and crash
    lanes end clean with every surviving client's budget done (the
    contract of test_engine_faults.py test_crash_liveness)."""
    from fantoch_tpu_torch import cli
    from fantoch_tpu_torch.engine.faults import parse_fault_specs

    plans = parse_fault_specs(cli.TEMPO_FAULT_PLANS)
    k = len(plans)
    assert len(results) == 2048 == 512 * k
    for j, plan in enumerate(plans):
        lanes = results[j::k]
        causes = sorted({r.err_cause for r in lanes if r.err})
        print(f"tempo_faults plan {j} {plan.meta() if plan else {}}: "
              f"{len(lanes)} lanes, erring {sum(1 for r in lanes if r.err)} "
              f"{causes}, completed {sum(r.completed for r in lanes)}, "
              f"dropped {sum(r.dropped for r in lanes)}, steps max "
              f"{max(r.steps for r in lanes)}")
    print(f"tempo_faults: {len(results) / wall:.3f} points/s over the four "
          f"plans, batch steps {launches['qualify_pop']}")
    clean = [json.dumps(r.to_json(), sort_keys=True) for r in results[::k]]
    assert len(LINES["tempo"]) == 2048 and clean == LINES["tempo"][:512], (
        "fault-free lanes differ from the Tempo sweep's")
    for spec, r in zip(specs, results):
        if spec.fault_meta is None or "crash" in spec.fault_meta:
            # halted clients' budgets are zeroed: the survivors' remain
            survivors = int(spec.ctx["cmd_budget"].sum())
            assert r.err == 0, r.err_cause
            assert r.completed == survivors < total or (
                spec.fault_meta is None and r.completed == total)
    print("tempo_faults: the 512 fault-free lanes equal the Tempo sweep's "
          "byte for byte; every fault-free and crash lane clean with its "
          "surviving clients' budgets done")


def main_path_checks(name, dims, specs, results, total) -> None:
    """A fault-free main path's checks on every lane."""
    for spec, r in zip(specs, results):
        assert r.completed == total
        assert int(r.lat_count.sum()) == total
        if name == "basic":
            assert r.requeues == 0
            assert list(r.protocol_metrics["stable"]) == [total] * dims.N
        if name in ("tempo", "atlas", "epaxos", "caesar"):
            # every command committed once, on the fast or the slow path;
            # every process GCs every command; with f = 1, Tempo's and
            # Atlas's fast path always holds (test_engine_tempo.py,
            # test_engine_graphdep.py, test_engine_caesar.py)
            m = {k: int(v.sum()) for k, v in r.protocol_metrics.items()}
            assert m["fast_path"] + m["slow_path"] == total, m
            assert m["stable"] == dims.N * total, m
            if spec.config.f == 1 and name in ("tempo", "atlas"):
                assert m["slow_path"] == 0, m
        if name in ("tempo_partial", "atlas_partial"):
            # a command commits once per shard it touches; the n rows of
            # its dot owner's shard GC it (test_engine_partial.py)
            m = {k: int(v.sum()) for k, v in r.protocol_metrics.items()}
            shards = spec.config.shard_count
            assert total <= m["fast_path"] + m["slow_path"] <= total * shards
            assert m["stable"] == spec.config.n * total, m
    if name in ("tempo", "atlas", "epaxos", "caesar"):
        slow = sum(int(r.protocol_metrics["slow_path"].sum())
                   for r in results)
        print(f"{name}: fast + slow == {total} and stable == "
              f"{dims.N * total} on every lane; slow-path commits {slow}")
    if name in ("tempo_partial", "atlas_partial"):
        commits = sorted({int(r.protocol_metrics["fast_path"].sum()
                              + r.protocol_metrics["slow_path"].sum())
                          for r in results})
        slow = sum(int(r.protocol_metrics["slow_path"].sum())
                   for r in results)
        print(f"{name}: {total} <= fast + slow <= {2 * total} (from "
              f"{commits[0]} to {commits[-1]}) and stable == 5 x {total} on "
              f"every lane; slow-path commits {slow}")


# ----------------------------------------------------------------------
# mixed-protocol batches (slice 12, B14)
# ----------------------------------------------------------------------

# the six-protocol mixed path: the main grid's first 8 region subsets
# (64 points of each protocol, lanes 0-63 of each phase-7 grid), 384
# lanes in one batch
HETERO_SIX_SUBSETS = 8
STEP_KERNELS = ("qualify_pop", "emit_rewrite", "land_emissions")


def mixed_setup(name):
    """``(args, protocols, dims, mixed)`` of mixed path ``name``:
    ``hetero`` the bench's four mixed protocols over the main grid
    (``cli.MAIN_PATHS["hetero"]``), ``hetero_six`` all six over its first
    :data:`HETERO_SIX_SUBSETS` subsets; lanes interleaved point by
    point."""
    from fantoch_tpu_torch import cli

    argv = list(cli.MAIN_PATHS["hetero"])
    if name == "hetero_six":
        argv[argv.index("--protocol") + 1] = ",".join(cli.ENGINE_PROTOCOLS)
        argv[argv.index("--subsets") + 1] = str(HETERO_SIX_SUBSETS)
    args = cli.parse_args(argv)
    protocols, dims, mixed = cli.hetero_setup(args)
    return args, protocols, dims, mixed


def _mixed_batch(name, dev):
    """The first batch of mixed path ``name`` on the card: ``(hb,
    state, ctx, flags)``."""
    from fantoch_tpu_torch.engine import hetero
    from fantoch_tpu_torch.engine.driver import batch_reorder_flag
    from fantoch_tpu_torch.engine.faults import batch_fault_flags

    args, protocols, dims, mixed = mixed_setup(name)
    batch = mixed[:args.batch_lanes]
    bare = [spec for _n, spec in batch]
    hb, state, ctx, _lanes = hetero.prepare_batch(protocols, dims, batch,
                                                  dev)
    return hb, state, ctx, (batch_reorder_flag(bare),
                            batch_fault_flags(bare))


def check_mixed_kernels(name, dev, rows, warmup=300):
    """Every group's kernels of a mixed batch against their twins: the
    first batch of mixed path ``name`` stepped ``warmup`` times through
    the eager per-call path (``hetero_frozen_step``), then one step's
    calls recorded, group by group (K1, the group's handler, K6, K2),
    and each launch of the kernel held to its twin on them; each group's
    key table (K3) too; the whole mixed step's frozen-lane check, every
    third lane of each group failed. Returns the state after the step, the
    step's bound (the sum of the groups' bounds, each kernel's ``work``
    on the recorded arguments) and that bound by kernel."""
    import torch

    from fantoch_tpu_torch.engine import core as engine_core
    from fantoch_tpu_torch.engine import hetero
    from fantoch_tpu_torch.engine.faults import flag_bits
    from fantoch_tpu_torch.kernels import cost

    hb, state, ctx, flags = _mixed_batch(name, dev)
    for _ in range(warmup):
        state, _running = hetero.hetero_frozen_step(hb, state, ctx, 1 << 22,
                                                    *flags)
    groups = list(state)
    handlers = sorted({HANDLERS[a] for a in groups})
    mods = {k: importlib.import_module(f"fantoch_tpu_torch.kernels.{k}")
            for k in STEP_KERNELS + tuple(handlers) + ("key_table",)}
    patched = {k: engine_core for k in STEP_KERNELS}
    patched.update({h: mods[h] for h in handlers})
    calls = []

    def recorder(kname, fn):
        def wrapped(*args):
            calls.append((kname, _fresh(kname, args)))
            return fn(*args)
        wrapped.launches = 0
        return wrapped

    saved = {k: getattr(m, k) for k, m in patched.items()}
    for k, m in patched.items():
        setattr(m, k, recorder(k, saved[k]))
    state, _running = hetero.hetero_frozen_step(hb, state, ctx, 1 << 22,
                                                *flags)
    for k, m in patched.items():
        setattr(m, k, saved[k])
    order = ("qualify_pop", "handler", "emit_rewrite", "land_emissions")
    assert [("handler" if k in handlers else k) for k, _a in calls] == (
        list(order) * len(groups)), [k for k, _a in calls]
    bound_ms, by_group, by_kernel = 0.0, {}, {}
    for i, (kname, a) in enumerate(calls):
        group = groups[i // len(order)]
        assert kname in STEP_KERNELS or kname == HANDLERS[group]
        mod = mods[kname]
        kern, plain = getattr(mod, kname), getattr(mod, kname + "_plain")
        got, want = kern(*_fresh(kname, a)), plain(*_fresh(kname, a))
        if kname == "land_emissions":
            assert torch.equal(got[4], a[-1].running()), group
        if kname in handlers:
            got, want = _handler_view(got), _handler_view(want)
        torch.cuda.synchronize()
        err = _compare(got, want)
        rows[kname]["max_abs_err"] = max(rows[kname]["max_abs_err"], err)
        n_bytes, n_ops = mod.work(*a, got)
        ms, _by = cost.bound(n_bytes, n_ops)
        bound_ms += ms
        by_group[group] = by_group.get(group, 0.0) + ms
        by_kernel[kname] = by_kernel.get(kname, 0.0) + ms
        lanes = int(state[group]["now"].shape[0])
        print(f"kernel {kname} ({name} batch, group {group}, {lanes} "
              f"lanes): exact=True max_abs_err={err} bound_us="
              f"{1e3 * ms:.3f}")
    kt = mods["key_table"]
    for group in groups:
        c = ctx[group]
        T = c["key_table"].shape[2]
        a = (c["rng_key"], c["conflict_rate"], c["pool_size"],
             c["key_gen_kind"], c["zipf_cum"], hb.dims[group].C, T,
             kt.traffic_tables(c))
        got, want = kt.key_table(*a), kt.key_table_plain(*a)
        torch.cuda.synchronize()
        err = _compare(got, want)
        assert torch.equal(got, c["key_table"])
        rows["key_table"]["max_abs_err"] = max(
            rows["key_table"]["max_abs_err"], err)
    print(f"mixed {name} batch ({list(groups)}): every group's kernels "
          f"== their twins after {warmup} steps, and each group's key "
          f"table; the step's bound {1e3 * bound_ms:.3f} us, by group "
          f"{ {g: round(1e3 * v, 3) for g, v in by_group.items()} }")
    # K6, K9, K5 and K2 in each group that runs them, with every third
    # lane failed
    for i, (kname, a) in enumerate(calls):
        group = groups[i // len(order)]
        if kname == "land_emissions":
            cap, frozen = _third_frozen(a[-1])
            for k2, a2 in calls[i - len(order) + 1:i + 1]:
                if k2 in ("emit_rewrite", "graphdep_handle",
                          "fpaxos_handle", "land_emissions"):
                    rows[k2]["max_abs_err"] = max(
                        rows[k2]["max_abs_err"],
                        frozen_check(f"{name} {group}", k2, mods[k2],
                                     a2[:-1] + (cap,), frozen))
    # the whole mixed step, every group's lanes, with every third lane of
    # each group failed, the cap an int and a device word
    fb = flag_bits(flags[1], flags[0])

    def step(st, cx, lim):
        return hetero.hetero_frozen_step(hb, st, cx, lim, *flags)

    for word in (False, True):
        frozen_step_check(f"{name} batch", step, state, ctx, 1 << 22, fb,
                          word)
    return state, ctx, hb, flags, bound_ms, by_kernel


def hetero_segments(dev) -> None:
    """The mixed device loop against its eager loop on the card: the
    six-protocol batch through ``run_sweep``'s segment loop at (1000, 3,
    2) (one graph a window, every group's kernels in its body, K14 over
    the whole batch), then ``finish_hetero``; its whole final state
    equals the eager loop's (``build_hetero_eager_runner``, every launch
    through its wrapper), byte for byte."""
    import torch

    from fantoch_tpu_torch.engine import hetero
    from fantoch_tpu_torch.parallel import sweep as psweep

    max_steps = 1 << 22
    hb, state, ctx, flags = _mixed_batch("hetero_six", dev)
    t0 = time.perf_counter()
    eager = hetero.build_hetero_eager_runner(hb, max_steps, *flags)(state,
                                                                   ctx)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    hb, state, ctx, flags = _mixed_batch("hetero_six", dev)
    runner, _alive = hetero.build_hetero_window_runner(hb, max_steps,
                                                       *flags)
    stats = dict(device_calls=0, segments_covered=0, windows=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = psweep.run_windows(runner, state, ctx, 1000, 3, 2, max_steps, stats)
    final = hetero.finish_hetero(st, max_steps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    _tree_exact(final, eager)
    bodies = runner.bodies()
    steps_max = max(int(t["steps"].max()) for t in final.values())
    print(f"segments hetero six ({sum(len(t['now']) for t in final.values())}"
          f" lanes, groups {list(final)}; segment_steps=1000, scan_window=3,"
          f" pipeline_depth=2): whole state == the eager loop's, byte for "
          f"byte; {secs:.3f} s (capture + instantiate "
          f"{runner.capture_s:.3f} s; the eager loop {eager_s:.3f} s); "
          f"stats {stats}; bodies {bodies} of {runner.loop.G} steps, "
          f"longest lane {steps_max}; per body "
          f"{getattr(runner.loop, 'per_body', None)}")


def hetero_sweep(name, dev):
    """Phase 7 for a mixed path: its sweep through ``run_sweep(...,
    hetero=True)``, counted; every lane equals its protocol's phase-7
    line byte for byte; K1, K6 and K2 launch once a group a batch
    step and each handler once for each group of its protocols (no
    handler runs on another protocol's lanes). Returns the launches."""
    from collections import Counter

    import torch

    from fantoch_tpu_torch import kernels
    from fantoch_tpu_torch.parallel import run_sweep
    from fantoch_tpu_torch.parallel import sweep as psweep

    args, protocols, dims, mixed = mixed_setup(name)
    names = list(protocols)
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = run_sweep(protocols, dims, mixed, batch_lanes=args.batch_lanes,
                        device=dev, hetero=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = graph_only_counts(f"sweep {name}", groups=len(names))
    steps = psweep.LAST_STATS["batch_steps"]
    for k in STEP_KERNELS:
        assert launches[k] == len(names) * steps, (k, launches)
    per_handler = Counter(HANDLERS[n] for n in names)
    for h in set(HANDLERS.values()):
        assert launches[h] == per_handler.get(h, 0) * steps, (h, launches)
    assert launches["key_table"] == len(names) * psweep.LAST_STATS["batches"]
    for i, r in enumerate(results):
        proto, point = names[i % len(names)], i // len(names)
        got = json.dumps(r.to_json(), sort_keys=True)
        assert got == LINES[proto][point], (
            f"{name} lane {i} ({proto} point {point}) differs from its "
            f"homogeneous sweep")
    rate = len(results) / wall
    line = (f"sweep {name} ({len(results)} lanes, {names}, "
            f"{psweep.LAST_STATS['batches']} mixed batches of "
            f"{args.batch_lanes}): {wall:.3f} s = {rate:.3f} points/s "
            f"({stage_secs(psweep.LAST_STATS)}); every "
            f"lane == its protocol's phase-7 line, byte for byte; batch "
            f"steps {steps}; launches per batch step "
            f"{ {k: v / steps for k, v in launches.items() if v} }")
    if name == "hetero":
        homo = sum(len(LINES[n]) for n in names) / sum(WALLS[n]
                                                       for n in names)
        line += (f"; the four homogeneous sweeps together "
                 f"{sum(len(LINES[n]) for n in names)} points in "
                 f"{sum(WALLS[n] for n in names):.3f} s = {homo:.3f} "
                 f"points/s (mixed / homogeneous {rate / homo:.3f})")
    print(line)
    return launches


def hetero_step_row(dev, rows) -> None:
    """B14's numbers, on the four-protocol path's first mixed batch
    (128 lanes a protocol) after 320 steps: its kernels against their
    twins (the step's bound the sum of its groups'), ``ms`` one window
    of one body (CUDA events, host included) over its steps, the eager
    mixed step (``plain_ms``) and a replay of the captured body alone
    (``library_ms``), each per step; then one more eager body profiled,
    the device ms a step by kernel (each kernel's time summed over its
    groups) into :data:`PROFILED`."""
    from fantoch_tpu_torch.engine import hetero
    from fantoch_tpu_torch.kernels.step_loop import clone_tree

    state, ctx, hb, flags, bound_ms, bound_by = check_mixed_kernels(
        "hetero", dev, rows, warmup=319)
    runner, _alive = hetero.build_hetero_window_runner(hb, 1 << 22, *flags)
    box = {"until": 320}
    box["st"] = runner(state, ctx, [box["until"]])[0]
    loop = runner.loop
    G = loop.G

    def one_body():
        box["until"] += G
        box["st"] = runner(box["st"], ctx, [box["until"]])[0]

    it0 = loop.iterations()
    ms = _time_ms(one_body, 10) / G
    assert loop.iterations() - it0 == 11
    eager = {"st": clone_tree(box["st"])}

    def eager_body():
        st = eager["st"]
        for _ in range(G):
            st, _r = hetero.hetero_frozen_step(hb, st, ctx, 1 << 22, *flags)
        eager["st"] = st

    plain_ms = _time_ms(eager_body, 3) / G
    prof = _kernel_ms(eager_body)
    assert set(prof) <= set(loop.per_body), (prof, loop.per_body)
    per_step = {k: ms / G for k, (ms, _n) in prof.items()}
    PROFILED["hetero"] = dict(ms=per_step, bound=bound_by, groups=len(state))
    print(f"B14 hetero step, one eager body profiled: device ms a step by "
          f"kernel { {k: round(v, 5) for k, v in sorted(per_step.items())} }")
    library_ms = _replay_ms(loop, box["until"]) / G
    print(f"B14 hetero step ({len(state)} groups {list(state)}, "
          f"{sum(len(t['now']) for t in state.values())} lanes): one window "
          f"of one body {ms:.5f} ms a step; the eager mixed step "
          f"{plain_ms:.5f} ms; CUDAGraph.replay of the body {library_ms:.5f} "
          f"ms a step; bound {bound_ms:.6f} ms a step (the sum of the "
          f"groups' kernels' bounds; {ms / bound_ms:.1f}x); per body "
          f"{loop.per_body}")


# ----------------------------------------------------------------------
# the safety monitors and the schedule-fuzz fan-out (mc)
# ----------------------------------------------------------------------

# the injected-bug point of tests/test_mc_fuzz.py:291-301 (jitter only)
BUG_POINT = dict(protocol="tempo", n=3, f=1, schedules=8,
                 commands_per_client=5, seed=3, inject_bug=True,
                 crash_share=0.0, drop_share=0.0)
# the monitor-coverage batches: per protocol a small point of jitter and
# crash lanes plus a jitter lane whose drain tail is 1 ms (its executors
# undrained at the end: missing-execution on Basic, Tempo, Atlas, EPaxos
# and Caesar). No drop lanes: a lost message can stall a lane in requeues
# up to its horizon, thousands of steps of the twins; the mc grid's drop
# and horizon lanes go through K13's check
MON_COVERAGE = dict(n=3, f=1, schedules=4, commands_per_client=3, seed=1,
                    crash_share=0.5, drop_share=0.0)
MON_PROTOCOLS = ("basic", "fpaxos", "tempo", "atlas", "epaxos", "caesar")
# every K13 launch of a monitored phase, held against its twin
K13_CHECKED = {"launches": 0, "err": 0.0}


def _k13_stand_in():
    """K13 in ``engine.core`` with its twin compared on every launch: the
    final state of every monitored batch (crash and horizon lanes
    included)."""
    def cmp(a, got, want):
        K13_CHECKED["err"] = max(K13_CHECKED["err"], _compare(got, want))
        K13_CHECKED["launches"] += 1

    return _checked("mon_finalize", "mon_finalize", cmp)


class _PatchedAttr:
    """Sets ``mod.name`` to ``value`` while open."""

    def __init__(self, mod, name, value):
        self.mod, self.name, self.new = mod, name, value

    def __enter__(self):
        self.old = getattr(self.mod, self.name)
        setattr(self.mod, self.name, self.new)

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.old)


class _PatchedHandler:
    """Swaps a handler kernel's module name for a stand-in while open
    (the protocols import their kernel from its module at each call)."""

    def __init__(self, kname, stand_in):
        self.mod = importlib.import_module(
            f"fantoch_tpu_torch.kernels.{kname}")
        self.kname, self.new = kname, stand_in

    def __enter__(self):
        self.old = getattr(self.mod, self.kname)
        setattr(self.mod, self.kname, self.new)

    def __exit__(self, *exc):
        setattr(self.mod, self.kname, self.old)


def _mon_json(r, drop_monitor=False):
    d = r.to_json()
    if drop_monitor:
        for k in ("violation", "violation_step", "coverage"):
            d.pop(k)
    return json.dumps(d, sort_keys=True)


# the mc grid's sampled lanes of each point, and the batch steps between
# the snapshots of them that the host replays from: a lossy lane may step
# over 100,000 times to its horizon, some 8 ms a step on the host, so each
# segment goes to a worker of its own
MC_SAMPLE = (0, 1, 2, 3, -1)
SEGMENT = 4096


def _lane(tree, i):
    """Lane ``i`` of a state tree on the card, as numpy with a lane axis
    of 1."""
    if isinstance(tree, dict):
        return {k: _lane(v, i) for k, v in tree.items()}
    return tree[i:i + 1].cpu().numpy()


def _tree_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k])
                                            for k in a)
    import numpy as np

    return a.dtype == b.dtype and np.array_equal(a, b)


class _McTaps:
    """The mc grid's sampled lanes, tapped from the card's own run: each
    lane's state before its batch's first window, after every window (a
    window is one :data:`SEGMENT`-step segment here: ``run_sweep`` at
    ``segment_steps=SEGMENT, scan_window=1``) and when its batch ends
    (the K13 call). Each segment in which a lane changed goes to the
    host pool, which replays it from the card's snapshot with the plain
    twins; :meth:`check` holds every replayed segment's end to the
    card's next snapshot and the last one's ``to_json`` to the card's
    result, byte for byte. Segments where the lane stayed as it was (a
    finished lane: a running lane counts its steps) need no replay."""

    def __init__(self, specs):
        from dataclasses import asdict

        from fantoch_tpu_torch.mc.fuzz import (
            draw_plans, point_config, point_protocol,
        )

        self.points = []
        for spec in specs:
            plans = draw_plans(spec, point_config(spec),
                               point_protocol(spec))
            lanes = [i % spec.schedules for i in MC_SAMPLE]
            self.points.append((asdict(spec), lanes,
                                [plans[i] for i in lanes]))
        self.point, self.steps, self.flags = 0, 0, None
        self.snaps = {}     # (point, lane) -> last (steps, state)
        self.pending = []   # (point, lane, future key, want state, last)
        self.host_s = 0.0

    def _snap(self, st, last):
        spec_kw, lanes, plans = self.points[self.point]
        for lane, plan in zip(lanes, plans):
            state = _lane(st, lane)
            prev = self.snaps.get((self.point, lane))
            self.snaps[(self.point, lane)] = (self.steps, state)
            if prev is None:
                continue
            steps0, state0 = prev
            if not last and _tree_equal(state0, state):
                continue  # a finished lane: nothing to replay
            key = ("mc", self.point, lane, steps0)
            HOST.submit(key, _host_segment, spec_kw, plan, state0,
                        self.steps - steps0, self.flags, last)
            self.pending.append((self.point, lane, key, state, last))

    def window_runner(self, orig):
        """A stand-in for ``engine.core.build_window_runner`` whose
        runner snapshots the sampled lanes around its windows."""
        taps = self

        class Tapped:
            def __init__(self, runner):
                self.runner = runner

            def __getattr__(self, k):
                return getattr(self.runner, k)

            def __call__(self, state, ctx, untils):
                if taps.steps == 0:
                    taps._snap(state, False)
                out = self.runner(state, ctx, untils)
                taps.steps = int(untils[-1])
                taps._snap(out[0], False)
                return out

        def build(protocol, dims, max_steps, reorder, faults, monitor_keys):
            self.flags = (reorder, tuple(faults), monitor_keys)
            runner, alive = orig(protocol, dims, max_steps, reorder, faults,
                                 monitor_keys)
            return Tapped(runner), alive
        return build

    def finalize(self, stand_in):
        def run(st, ctx, flags, order):
            self._snap(st, True)
            self.point, self.steps = self.point + 1, 0
            return stand_in(st, ctx, flags, order)
        return run

    def check(self, points) -> int:
        """Wait for every replayed segment and hold it to the card;
        returns the number of segments."""
        for point, lane, key, want, last in self.pending:
            got, line, secs = HOST.result(key)
            self.host_s += secs
            assert _tree_equal(got, want), (
                f"mc point {point} lane {lane}: the host twins' segment "
                f"{key[3]}+ differs from the card's state")
            if last:
                card = json.dumps(points[point].lane_results[lane].to_json(),
                                  sort_keys=True)
                assert line == card, (
                    f"mc point {point} lane {lane}: to_json differs from "
                    f"the host run")
        return len(self.pending)


def check_monitored_kernels(dev, rows) -> None:
    """Phase 3 for the monitored paths: the first batch of the mc grid's
    n = 5 points, stepped 300 times with the monitors on, then one
    step's K1, handler, K6 and K2 arguments (the monitor branches on)
    held against their twins and timed, K13 on that state, and the whole
    monitored step's frozen-lane check. K13's
    row goes to ``rows``; the other kernels' mc times go beside their
    rows (``monitored``); their time over the whole grid is
    :func:`mc_grid_profile`'s."""
    import torch

    from fantoch_tpu_torch import cli
    from fantoch_tpu_torch.engine import core as engine_core
    from fantoch_tpu_torch.engine.driver import (
        batch_reorder_flag, prepare_batch,
    )
    from fantoch_tpu_torch.engine.faults import batch_fault_flags, flag_bits
    from fantoch_tpu_torch.kernels import cost
    from fantoch_tpu_torch.mc.fuzz import point_lanes

    args = cli.parse_args(cli.MAIN_PATH_MC)
    for spec in cli.mc_specs(args):
        if spec.n != 5:
            continue
        proto, dims, specs, _plans, mk = point_lanes(spec)
        batch = specs[:512]
        flags = (batch_reorder_flag(batch), batch_fault_flags(batch))
        state, ctx = prepare_batch(proto, dims, batch, dev, mk)
        for _ in range(300):
            state, _r = engine_core.frozen_step(proto, dims, state, ctx,
                                                1 << 22, *flags, mk)
        handler = HANDLERS[spec.protocol]
        captured = {}
        mods = {k: importlib.import_module(f"fantoch_tpu_torch.kernels.{k}")
                for k in ("qualify_pop", handler, "emit_rewrite",
                          "land_emissions", "mon_finalize")}

        def rec(mod, kname):
            kern = getattr(mod, kname)

            def wrapped(*a):
                captured[kname] = _fresh(kname, a)
                return kern(*a)
            wrapped.launches = 0
            return wrapped

        step_kernels = ("qualify_pop", "emit_rewrite", "land_emissions")
        fb = flag_bits(flags[1], flags[0])

        def step(st, cx, lim):
            return engine_core.frozen_step(proto, dims, st, cx, lim, *flags,
                                           mk)

        label = f"mc {spec.protocol} n={spec.n}"
        for word in (False, True):
            frozen_step_check(label, step, state, ctx, 1 << 22, fb, word)
        with _Patched(**{k: rec(engine_core, k) for k in step_kernels}), \
                _PatchedHandler(handler, rec(mods[handler], handler)):
            state, _r = engine_core.frozen_step(proto, dims, state, ctx,
                                                1 << 22, *flags, mk)
        captured["mon_finalize"] = (state, ctx, fb,
                                    getattr(proto, "MONITOR_ORDER", True))
        for kname in ("qualify_pop", handler, "emit_rewrite",
                      "land_emissions", "mon_finalize"):
            a, mod = captured[kname], mods[kname]
            kern, plain = getattr(mod, kname), getattr(mod, kname + "_plain")

            def call(a=a, kname=kname, kern=kern):
                return kern(*_fresh(kname, a))
            got = call()
            want = plain(*_fresh(kname, a))
            if kname == "land_emissions":
                assert torch.equal(got[4], a[-1].running()), label
            if kname == handler:
                got, want = _handler_view(got), _handler_view(want)
            torch.cuda.synchronize()
            err = _compare(got, want)
            ms = _device_ms(call, kname, 50)
            call_ms = _time_ms(call, 50)
            plain_ms = _time_ms(
                lambda a=a, kname=kname, plain=plain:
                plain(*_fresh(kname, a)), 5)
            n_bytes, n_ops = mod.work(*a, call())
            bound_ms, bound_by = cost.bound(n_bytes, n_ops)
            print(f"kernel {kname} ({label}, monitored, {mk} keys): "
                  f"exact=True max_abs_err={err} ms={ms:.5f} "
                  f"call_ms={call_ms:.5f} plain_ms={plain_ms:.5f} "
                  f"bound_us={1e3 * bound_ms:.3f} ({bound_by}: {n_bytes} "
                  f"bytes, {n_ops} ops) L={len(batch)} N={dims.N}")
            row = dict(path="mc", max_abs_err=err, ms=ms, call_ms=call_ms,
                       plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=None)
            if kname == "mon_finalize":
                if spec.protocol == "tempo":
                    rows[kname] = row
            else:
                rows[kname].setdefault("monitored", {})[label] = row
        # K6, K2 and the in-place handler with every third lane failed
        cap, frozen = _third_frozen(captured["land_emissions"][-1])
        for kname in (handler, "emit_rewrite", "land_emissions"):
            if kname in IN_PLACE:
                rows[kname]["max_abs_err"] = max(
                    rows[kname]["max_abs_err"],
                    frozen_check(label, kname, mods[kname],
                                 captured[kname][:-1] + (cap,), frozen))


def mc_grid(dev):
    """Phase 8, slice 9's main path: the mc default grid (the
    reference CLI's defaults: Tempo, FPaxos and Atlas x n in {3, 5}, 512
    schedules a point, 3,072 lanes, seed 0) through ``run_fuzz_point``,
    the function ``mc --no-confirm`` runs, with every launch counter at 0
    just before and read just after; K13 against its twin on every
    batch's final state. Lanes 0-3 and the last lane of each point
    against the host twins: their segments replay on the host while the
    later phases run. Returns the launches and the function that waits
    for the replays and holds them to the card."""
    import functools

    import torch

    from fantoch_tpu_torch import cli, kernels
    from fantoch_tpu_torch.engine import core as engine_core
    from fantoch_tpu_torch.mc import fuzz
    from fantoch_tpu_torch.parallel import sweep as psweep

    args = cli.parse_args(cli.MAIN_PATH_MC)
    specs = cli.mc_specs(args)
    assert len(specs) == 6 and args.schedules == 512
    taps = _McTaps(specs)
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    points = []
    # the taps read one snapshot a window: one SEGMENT-step segment each
    segmented = functools.partial(psweep.run_sweep, segment_steps=SEGMENT,
                                  scan_window=1)
    with _Patched(mon_finalize=taps.finalize(_k13_stand_in()),
                  build_window_runner=taps.window_runner(
                      engine_core.build_window_runner)), \
            _PatchedAttr(fuzz, "run_sweep", segmented):
        for spec in specs:
            points.append(fuzz.run_fuzz_point(spec, confirm=False,
                                              device=dev))
            st = psweep.LAST_STATS
            lane_steps = sum(r.steps for r in points[-1].lane_results)
            slots = st["batch_steps"] * points[-1].schedules / st["batches"]
            print(f"mc {spec.protocol} n={spec.n} device loop: "
                  f"{loop_stats(st)}; running lane-steps {lane_steps} of "
                  f"{slots:.0f} (share {lane_steps / slots:.4f})")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = graph_only_counts("mc grid", single=False)
    total = sum(p.schedules for p in points)
    for p in points:
        res = p.lane_results
        print(f"mc {p.spec.protocol} n={p.spec.n}: {p.schedules} schedules "
              f"in {p.elapsed_s:.3f} s = {p.schedules_per_sec:.3f} "
              f"schedules/s; flagged {p.flagged} "
              f"{sorted({f.violation_cause for f in p.findings})}; engine "
              f"errors {p.engine_errors}; steps max "
              f"{max(r.steps for r in res)}; distinct digests "
              f"{len(set(p.digests))}")
    print(f"mc grid: {total} schedules in {wall:.3f} s = {total / wall:.3f} "
          f"schedules/s; flagged {sum(p.flagged for p in points)}; batch "
          f"steps {launches['qualify_pop']}; launches {launches}")
    assert total == 3072
    for k in ("qualify_pop", "tempo_handle", "fpaxos_handle",
              "graphdep_handle", "emit_rewrite", "land_emissions",
              "key_table"):
        assert launches[k] > 0, launches
    assert launches["mon_finalize"] == len(points), launches
    for k in ("basic_handle", "caesar_handle", "tempo_partial_handle",
              "atlas_partial_handle"):
        assert launches[k] == 0, launches
    assert all(all(r.coverage != 0 for r in p.lane_results) for p in points)

    def check_host() -> None:
        t0 = time.perf_counter()
        segments = taps.check(points)
        steps = {(p.spec.protocol, p.spec.n): [
            p.lane_results[i % p.schedules].steps for i in MC_SAMPLE]
            for p in points}
        print(f"mc grid lanes 0-3 and the last of each point (steps "
              f"{steps}): card == host plain twins, every {SEGMENT}-step "
              f"segment replayed from the card's snapshot ({segments} "
              f"segments) and to_json with the monitor fields byte for byte "
              f"({taps.host_s:.1f} s on the host, waited "
              f"{time.perf_counter() - t0:.1f} s)")

    return launches, check_host


def mc_grid_profile(dev, launches) -> None:
    """The mc grid again, as phase 8 runs it (its windows of one
    ``SEGMENT``-step segment), each window cut at every 16th body of its
    batch: there eight steps run through the wrappers on a copy of the
    batch's state under the profiler (:func:`_kernel_ms`), from the
    first steps to the tail where most lanes are frozen, and the window
    goes on from the uncopied state (a lane stops at a window's end as
    at a segment's, so the results are the sweep's). Each kernel's mean
    device ms a launch over the sampled steps goes to :data:`PROFILED`;
    a kernel the grid does not launch (``launches``) has no record. Not
    timed: phase 8's wall is the grid's."""
    import functools

    import torch

    from fantoch_tpu_torch import cli
    from fantoch_tpu_torch.engine.core import STEPS_PER_BODY, WindowRunner
    from fantoch_tpu_torch.kernels.step_loop import clone_tree
    from fantoch_tpu_torch.mc import fuzz
    from fantoch_tpu_torch.parallel import sweep as psweep

    specs = cli.mc_specs(cli.parse_args(cli.MAIN_PATH_MC))
    segmented = functools.partial(psweep.run_sweep, segment_steps=SEGMENT,
                                  scan_window=1)
    prof, sampled = {}, [0]
    orig = WindowRunner.__call__

    def sample(runner, until):
        loop = runner.loop
        st = [clone_tree(loop.state)]
        lim = torch.full((1,), until, dtype=torch.int32, device=dev)

        def body():
            for _ in range(8):
                st[0] = runner.step(st[0], loop.ctx, lim)
        for k, (ms, n) in _kernel_ms(body).items():
            ms0, n0 = prof.get(k, (0.0, 0))
            prof[k] = (ms0 + ms, n0 + n)
        sampled[0] += 8

    def call(runner, state, ctx, untils):
        (until,) = untils
        G = runner.steps_per_body or STEPS_PER_BODY
        pos = int(state["steps"].max())
        while (pos // (16 * G) + 1) * 16 * G + G <= until:
            pos = (pos // (16 * G) + 1) * 16 * G
            state = orig(runner, state, ctx, [pos])[0]
            sample(runner, pos + 8)
        return orig(runner, state, ctx, untils)

    with _PatchedAttr(WindowRunner, "__call__", call), \
            _PatchedAttr(fuzz, "run_sweep", segmented):
        for spec in specs:
            fuzz.run_fuzz_point(spec, confirm=False, device=dev)
    assert sampled[0] > 0 and prof["qualify_pop"][1] > 0, (sampled, prof)
    assert all(launches[k] for k in prof), (prof, launches)
    PROFILED["mc"] = prof
    print(f"mc grid profiled: {sampled[0]} of {launches['qualify_pop']} "
          f"batch steps sampled (8 steps every {16 * STEPS_PER_BODY}, "
          f"through the wrappers); "
          f"device ms a launch by kernel (records) "
          f"{ {k: (round(ms / n, 5), n) for k, (ms, n) in sorted(prof.items())} }")


def bottlenecks(rows, by_path) -> None:
    """Prints the kernels in order of launches x (device ms - bound ms),
    in seconds, summed over the paths with a device time: on the
    512-lane main paths phase 3's ms and bound at step 301; on the mc
    grid the profiled re-run's mean device ms a launch over its
    sampled bodies times the grid's launches, against the monitored
    n = 5 rows' bound at step 301 a launch; on the mixed sweep the
    profiled eager body's ms a step (steps 1,280-1,343 of its first
    batch) against the step's bound by kernel, times the sweep's batch
    steps. Each line gives the
    kernel's five largest paths."""
    gap = {}
    for path, counts in by_path.items():
        for k, n in counts.items():
            if n and k in PHASE3_MS.get(path, {}):
                t = n * (PHASE3_MS[path][k] - BOUNDS[path][k][0]) / 1e3
                gap.setdefault(k, {})[path] = t
    for k, (ms, rec) in PROFILED.get("mc", {}).items():
        n = by_path["mc"].get(k, 0)
        mon = rows.get(k, {}).get("monitored", {})
        if n and mon:
            bound = sum(r["bound_ms"] for r in mon.values()) / len(mon)
            gap.setdefault(k, {})["mc"] = n * (ms / rec - bound) / 1e3
    mixed = PROFILED.get("hetero")
    if mixed and "hetero" in by_path:
        steps = by_path["hetero"]["qualify_pop"] / mixed["groups"]
        for k, ms in mixed["ms"].items():
            if k in mixed["bound"]:
                gap.setdefault(k, {})["hetero"] = (
                    steps * (ms - mixed["bound"][k]) / 1e3)
    print("bottlenecks: launches x (device ms - bound ms), s, by kernel "
          "and path")
    for k, d in sorted(gap.items(), key=lambda kv: -sum(kv[1].values())):
        top = sorted(d.items(), key=lambda kv: -kv[1])[:5]
        print(f"bottleneck {k}: {sum(d.values()):.2f} s; "
              + ", ".join(f"{p} {v:.2f}" for p, v in top))


def bench_point(dev) -> None:
    """The reference bench's fuzz self-check point (bench.py
    _fuzz_selfcheck): correct Tempo, n = 5, 256 schedules of 10 commands
    a client, seed 0xF022, mixed plans. Nothing flagged, no engine error
    but requeue-livelock."""
    import torch

    from fantoch_tpu_torch import cli, kernels
    from fantoch_tpu_torch.mc.fuzz import FuzzSpec, run_fuzz_point

    spec = FuzzSpec(**cli.BENCH_FUZZ)
    kernels.reset_counts()
    with _Patched(mon_finalize=_k13_stand_in()):
        res = run_fuzz_point(spec, confirm=False, device=dev)
    torch.cuda.synchronize()
    graph_only_counts("bench fuzz point")
    bad = {k: v for k, v in res.engine_errors.items()
           if k != "requeue-livelock"}
    print(f"bench fuzz point (tempo n=5, 256 schedules, seed 0xF022): "
          f"{res.schedules_per_sec:.3f} schedules/s ({res.elapsed_s:.3f} s); "
          f"flagged {res.flagged}; engine errors {res.engine_errors}; steps "
          f"max {max(r.steps for r in res.lane_results)}")
    assert res.flagged == 0, res.summary()
    assert not bad, res.engine_errors


def _checked_handler(kname, seen, errs):
    """A stand-in for handler kernel ``kname``: kernel and twin on every
    call, held equal; ``seen`` counts the executions the monitors
    recorded and the guard bits raised."""
    import torch

    mod = importlib.import_module(f"fantoch_tpu_torch.kernels.{kname}")
    kern, plain = getattr(mod, kname), getattr(mod, kname + "_plain")

    def run(*a):
        want = plain(*_fresh(kname, a))
        ps, new = a[0], want[1]
        seen["executions"] += int((new["_mon_cnt"] - ps["_mon_cnt"]).sum())
        got = kern(*a)
        torch.cuda.synchronize()
        errs[kname] = max(errs.get(kname, 0.0),
                          _compare(_handler_view(got), _handler_view(want)))
        seen["premature guard words"] += int(
            ((new["_mon_flags"] & 1) != 0).sum())
        seen["steps"] += 1
        return got

    run.launches = 0
    return run


def _k6_checked(errs, seen):
    def cmp(a, got, want):
        errs["emit_rewrite"] = max(errs.get("emit_rewrite", 0.0),
                                   _compare(got, want))
        seen["viol words"] += int((want[2]["viol"] != 0).sum())
    return _checked("emit_rewrite", "emit_rewrite", cmp)


def _monitored_run(proto, dims, specs, mk, dev, errs, seen):
    """The eager runner on the card (every launch through its wrapper,
    so through the stand-ins; a graph replay passes none) with the
    monitors on and the handler kernel, K6 and K13 held against their
    twins on every call."""
    from fantoch_tpu_torch.engine.core import build_eager_runner
    from fantoch_tpu_torch.engine.driver import (
        batch_reorder_flag, prepare_batch,
    )
    from fantoch_tpu_torch.engine.faults import batch_fault_flags
    from fantoch_tpu_torch.engine.results import collect_results

    kname = HANDLERS[{"TempoDev": "tempo", "TempoStabilityBugDev": "tempo",
                      "BasicDev": "basic", "FPaxosDev": "fpaxos",
                      "AtlasDev": "atlas", "EPaxosDev": "epaxos",
                      "CaesarDev": "caesar"}[
        getattr(proto, "__name__", type(proto).__name__)]]
    with _Patched(emit_rewrite=_k6_checked(errs, seen),
                  mon_finalize=_k13_stand_in()), \
            _PatchedHandler(kname, _checked_handler(kname, seen, errs)):
        state, ctx = prepare_batch(proto, dims, specs, dev, mk)
        run = build_eager_runner(proto, dims, 1 << 22,
                                 batch_reorder_flag(specs),
                                 batch_fault_flags(specs), mk)
        return collect_results(proto, dims, run(state, ctx), specs)


def monitor_coverage(dev) -> dict:
    """The monitor branches of K4, K5, K8, K9, K10 and K6, and K13,
    against their twins on every step of small monitored batches: per
    protocol a point of jitter and crash lanes plus a lane whose drain
    tail is 1 ms (missing-execution); a Tempo batch at conflict 0
    with one monitor key (monitor-key-range); the injected-bug point
    (order-divergence), whose per-lane violations, steps and digests
    must equal the fixture made from the reference. Returns the max abs
    error by kernel."""
    from dataclasses import replace

    from fantoch_tpu_torch.engine.faults import FaultPlan
    from fantoch_tpu_torch.engine.monitor import (
        VIOL_KEYRANGE, VIOL_MISSING, VIOL_ORDER,
    )
    from fantoch_tpu_torch.mc.fuzz import FuzzSpec, point_lanes

    errs = {}
    raised = {VIOL_KEYRANGE: 0, VIOL_MISSING: 0, VIOL_ORDER: 0}
    for name in MON_PROTOCOLS:
        seen = dict.fromkeys(("executions", "premature guard words",
                              "viol words", "steps"), 0)
        spec = FuzzSpec(protocol=name, **MON_COVERAGE)
        proto, dims, specs, plans, mk = point_lanes(spec)
        short = point_lanes(replace(spec, extra_time_ms=1, schedules=1),
                            plans=[FaultPlan(jitter_max=8, jitter_seed=1)])[2]
        res = _monitored_run(proto, dims, specs + short, mk, dev, errs, seen)
        for r in res:
            for bit in raised:
                raised[bit] += bool(r.violation & bit)
        assert seen["executions"] > 0, (name, seen)
        print(f"monitor coverage {name}: kernels exact on every one of "
              f"{seen['steps']} steps; {seen} violations "
              f"{[r.violation for r in res]} steps "
              f"{[r.steps for r in res]}")
    # monitor keys below the lane's keys: conflict 0 draws private keys
    seen = dict.fromkeys(("executions", "premature guard words",
                          "viol words", "steps"), 0)
    spec = FuzzSpec(protocol="tempo", conflict=0, **MON_COVERAGE)
    proto, dims, specs, _plans, _mk = point_lanes(spec)
    res = _monitored_run(proto, dims, specs[:1], 1, dev, errs, seen)
    assert all(r.violation & VIOL_KEYRANGE for r in res), res
    raised[VIOL_KEYRANGE] += len(res)
    print(f"monitor coverage tempo (1 monitor key, conflict 0): {seen}; "
          f"violations {[r.violation for r in res]}")
    # the injected bug: order divergence, against the fixture
    seen = dict.fromkeys(("executions", "premature guard words",
                          "viol words", "steps"), 0)
    spec = FuzzSpec(**BUG_POINT)
    proto, dims, specs, _plans, mk = point_lanes(spec)
    res = _monitored_run(proto, dims, specs, mk, dev, errs, seen)
    got = {"violation": [r.violation for r in res],
           "violation_step": [r.violation_step for r in res],
           "digests": [r.coverage for r in res],
           "engine_errors": sorted({r.err_cause for r in res if r.err})}
    want = json.loads((FIXTURES / "torch_fuzz_bug_golden.json").read_text())
    assert got == want, (got, want)
    raised[VIOL_ORDER] += sum(bool(v & VIOL_ORDER) for v in got["violation"])
    assert all(raised.values()), raised
    print(f"injected-bug point (tempo n=3, 8 schedules, seed 3): equals "
          f"tests/fixtures/torch_fuzz_bug_golden.json; {seen}; lanes with "
          f"order-divergence {sum(bool(v & VIOL_ORDER) for v in got['violation'])}"
          f"; over the phase {raised} lanes raised keyrange/missing/order")
    return errs


def monitored_tempo_sweep(dev):
    """The 2,048-lane Tempo sweep with the monitors on (monitor keys =
    pool + clients), counted: its to_json equals the unmonitored sweep's
    byte for byte outside the three monitor fields, its batch steps equal
    the unmonitored sweep's, and every lane has a digest. Returns the
    launches."""
    import torch

    from fantoch_tpu_torch import cli, kernels
    from fantoch_tpu_torch.parallel import run_sweep

    args = cli.parse_args(cli.MAIN_PATHS["tempo"])
    protocol, dims, specs = cli.sweep_setup(args)
    mk = args.pool_size + args.n * args.clients_per_region
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _Patched(mon_finalize=_k13_stand_in()):
        results = run_sweep(protocol, dims, specs,
                            batch_lanes=args.batch_lanes, device=dev,
                            monitor_keys=mk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = graph_only_counts("sweep tempo monitored")
    lines = [_mon_json(r, drop_monitor=True) for r in results]
    plain = [json.dumps({k: v for k, v in json.loads(line).items()
                         if k not in ("violation", "violation_step",
                                      "coverage")}, sort_keys=True)
             for line in LINES["tempo"]]
    assert len(lines) == 2048 and lines == plain, (
        "the monitored Tempo sweep differs from the unmonitored one")
    assert all(r.coverage != 0 for r in results)
    print(f"sweep tempo monitored ({mk} keys): {len(results)} points in "
          f"{wall:.3f} s = {len(results) / wall:.3f} points/s; batch steps "
          f"{launches['qualify_pop']}; violations "
          f"{sum(1 for r in results if r.violation)}; distinct digests "
          f"{len({r.coverage for r in results})}; launches {launches}; "
          f"equal to the unmonitored sweep outside the monitor fields")
    assert launches["mon_finalize"] == 4, launches
    return launches


# ----------------------------------------------------------------------
# time-varying traffic and open-loop arrivals
# ----------------------------------------------------------------------

# the serving lanes of tests/test_torch_serving.py, in lane order (the
# fixture's): (protocol, commands, arrivals, load, window, seed, plan)
SERVING_LANES = [
    ("fpaxos", 8, "ramp", 150, 4, 4, {"drop_bp": 400, "seed": 5,
                                      "horizon": 250}),
    ("fpaxos", 8, "burst", 100, 3, 1, {
        "crash": {"2": 300},
        "windows": [{"src": 1, "dst": 0, "t0": 0, "t1": 150, "mult": 2}]}),
    ("tempo", 8, "poisson", 200, 2, 2, {"drop_bp": 500, "seed": 9,
                                        "horizon": 5000}),
    ("tempo", 8, "burst", 100, 3, 0, {
        "crash": {"2": 260},
        "windows": [{"src": 0, "dst": 1, "t0": 40, "t1": 220, "mult": 3}]}),
]
# the open-loop coverage batches' plans: fault-free, and a crash with
# drops under a horizon
OPEN_PLANS = [None, None, {"crash": {"2": 150}, "drop_bp": 300, "seed": 3,
                           "horizon": 2000}]
# steps of each coverage batch held to the twin (each batch's events
# come within its first hundred steps; a drop lane requeues to its
# horizon)
OPEN_STEPS = 400
# the epoch-Zipf schedule of K3's check: the coefficient moves per epoch
ZIPF_SCHEDULE = {"name": "zipf", "cycle": True, "phases": [
    {"commands": 10, "conflict_rate": 50, "zipf_coef": 0.5},
    {"commands": 15, "conflict_rate": 50},
    {"commands": 10, "conflict_rate": 50, "zipf_coef": 2.0},
]}
def traffic_keys(dev) -> float:
    """K3's epoch branch against its twin: every lane of the Tempo
    traffic sweeps' batches (diurnal, flash, churn) and of a batch of
    Basic lanes under an epoch-Zipf schedule (Zipf over 1,000 keys, the
    first 64 subsets); on churn each conflicting key lies in its epoch's
    rotated pool. Returns the max abs error."""
    import torch

    from fantoch_tpu_torch import cli
    from fantoch_tpu_torch.carry import to_torch
    from fantoch_tpu_torch.core import Planet
    from fantoch_tpu_torch.engine.protocols import BasicDev
    from fantoch_tpu_torch.engine.spec import stack_lanes
    from fantoch_tpu_torch.parallel import make_sweep_specs
    from fantoch_tpu_torch.traffic import TrafficSchedule

    kt = importlib.import_module("fantoch_tpu_torch.kernels.key_table")

    batches = {}
    for name in new_paths():
        if base_path(name) == "tempo_traffic":
            args = cli.parse_args(path_argv(name))
            _p, dims, specs = cli.sweep_setup(args)
            batches[name] = (specs[:args.batch_lanes], args.commands)
    _p, dims, specs = cli.sweep_setup(cli.parse_args(
        [a if a != "256" else "64" for a in cli.MAIN_PATH]))
    regions = sorted({tuple(s.process_regions) for s in specs})
    zspecs = make_sweep_specs(
        BasicDev, Planet.new(), region_sets=[list(r) for r in regions],
        fs=[1, 2], conflicts=[0, 10, 50, 100], commands_per_client=50,
        clients_per_region=1, dims=dims, zipf=(1.0, 1000),
        traffic=TrafficSchedule.from_json(ZIPF_SCHEDULE))
    batches["epoch zipf"] = (zspecs, 50)
    err = 0.0
    for label, (lanes, commands) in batches.items():
        ctx = to_torch(stack_lanes(lanes), dev)
        T = commands + 2
        a = (ctx["rng_key"], ctx["conflict_rate"], ctx["pool_size"],
             ctx["key_gen_kind"], ctx["zipf_cum"], dims.C, T,
             kt.traffic_tables(ctx))
        got = kt.key_table(*a)
        want = kt.key_table_plain(*a)
        torch.cuda.synchronize()
        err = max(err, _compare(got, want))
        note = ""
        if label.endswith("churn"):
            e = ctx["traffic_seq_epoch"].long()
            base = torch.gather(ctx["traffic_pool_base"].long(), 1, e)
            size = torch.gather(ctx["traffic_pool_size"].long(), 1, e)
            span = ctx["traffic_pool_span"].long()[:, None, None]
            pooled = got < span
            inside = (got >= base[:, None]) & (got < base[:, None]
                                                  + size[:, None])
            assert bool((inside | ~pooled).all())
            note = (f"; {int(pooled.sum())} pool keys, each in its epoch's "
                    f"pool (bases {sorted(set(base[0].tolist()))})")
        print(f"kernel key_table ({label}, {len(lanes)} lanes, "
              f"{ctx['traffic_seq_epoch'].shape[1]} seqs, "
              f"{ctx['traffic_conflict'].shape[1]} epochs): exact=True "
              f"max_abs_err={err} distinct keys "
              f"{int(torch.unique(got).numel())}{note}")
    return err


def _open_protocol(name, clients, commands, traffic=None):
    """``(protocol, dims)`` at n = 3 for ``clients`` clients of
    ``commands`` commands, the key table sized for ``traffic``."""
    from fantoch_tpu_torch.engine import EngineDims
    from fantoch_tpu_torch.engine.protocols import dev_protocol
    from fantoch_tpu_torch.traffic import traffic_key_capacity

    keys = traffic_key_capacity([traffic], conflict=100, pool_size=1,
                                commands=commands, clients=clients)
    proto = dev_protocol(name, clients, keys=keys)
    total = commands * clients
    return proto, EngineDims.for_protocol(
        proto, n=3, clients=clients, payload=proto.payload_width(3),
        total_commands=total, dot_slots=total + 1, regions=3)


def _open_lanes(name, plans, commands=6, cpr=2, arrivals="poisson",
                load=400, window=2, traffic=None):
    """``(protocol, dims, specs)``: n = 3 lanes on the first three GCP
    regions, one per plan, conflict 100 and 0 in turn, GC and detached
    sends every 20 ms."""
    from fantoch_tpu_torch.core import Config, Planet
    from fantoch_tpu_torch.engine import make_lane
    from fantoch_tpu_torch.engine.faults import FaultPlan
    from fantoch_tpu_torch.engine.protocols import dev_config_kwargs

    proto, dims = _open_protocol(name, 3 * cpr, commands, traffic)
    regions = Planet.new().regions()[:3]
    kw = dev_config_kwargs(name, 3, 1, gc_interval_ms=20)
    if name == "tempo":
        kw["tempo_detached_send_interval_ms"] = 20
    specs = [
        make_lane(proto, Planet.new(), Config(**kw),
                  conflict_rate=100 if i % 2 == 0 else 0, pool_size=1,
                  commands_per_client=commands, clients_per_region=cpr,
                  process_regions=regions, client_regions=regions,
                  dims=dims, seed=i,
                  faults=FaultPlan.from_json(plan) if plan else None,
                  arrivals=arrivals, arrival_load=load, open_window=window,
                  traffic=traffic)
        for i, plan in enumerate(plans)
    ]
    return proto, dims, specs


def _k6_events(a, want, seen) -> None:
    """Counts in ``seen`` what one K6 step compared: a staged SUBMIT
    (trigger 1), a window-blocked SUBMIT pop, a trigger-2 SUBMIT, a
    client completing two commands, and under the think flag an issued
    SUBMIT with a think delay and one whose epoch differs from the
    previous command's."""
    import torch

    from fantoch_tpu_torch.engine import faults as fm
    from fantoch_tpu_torch.engine.dims import PMT, PPAY, PSRC

    st, ctx, _ep, _fire, has, rdy, rows = a[:7]
    dims, submit, flags = a[10], a[11], a[12]
    new_rows, valid, upd = want
    N, F = dims.N, dims.F
    cl, new = st["clients"], upd["clients"]
    if flags & fm.FLAG_OPEN_LOOP:
        F2 = 2 * F + 2
        j = torch.arange(new_rows.shape[1], device=valid.device) % F2
        client = valid & (new_rows[..., PSRC] >= N)
        seen["trigger 1"] += int((client & (j == F2 - 2)).sum())
        seen["trigger 2"] += int((client & (j < F2 - 2)).sum())
        seen["multi-completion"] += int(
            ((new["completed"] - cl["completed"]) >= 2).sum())
        src = rows[..., PSRC]
        sc = (src - N).clamp(0, dims.C - 1).long()
        seq = rows[..., PPAY + 1]

        def take(x):
            return torch.gather(x, 1, sc)

        W = cl["ol_comp_t"].shape[2]
        blocked = (has & rdy & (rows[..., PMT] == submit) & (src >= N)
                   & (seq == take(cl["issued"]))
                   & (seq + 1 <= take(ctx["cmd_budget"]))
                   & (take(cl["completed"]) + W < seq + 1))
        seen["window-blocked SUBMIT"] += int(blocked.sum())
    if flags & fm.FLAG_THINK:
        issued = (new["issued"] - cl["issued"]) > 0
        nxt = cl["issued"].long() + 1
        tbl = ctx["traffic_seq_epoch"].long()
        top = tbl.shape[1] - 1
        e_new = torch.gather(tbl, 1, nxt.clamp(max=top))
        e_old = torch.gather(tbl, 1, (nxt - 1).clamp(min=0, max=top))
        think = torch.gather(ctx["traffic_think"].long(), 1, e_new)
        seen["think delay"] += int((issued & (think > 0)).sum())
        seen["epoch boundary"] += int((issued & (e_new != e_old)).sum())


def open_coverage(dev) -> float:
    """K6 against its twin on every step (up to :data:`OPEN_STEPS`) of
    the open-loop coverage batches — Tempo and FPaxos at load 400 and a
    window of 2, conflict 100 and 0, with and without a crash and drops,
    Tempo also through the double-reply wrapper — and of a Tempo diurnal
    batch (closed loop, think delays), until a staged SUBMIT, a
    window-blocked SUBMIT, a trigger-2 SUBMIT, a two-command completion,
    a think delay and an epoch boundary were compared. Returns the max
    abs error."""
    import torch

    from fantoch_tpu_torch.engine import core as engine_core
    from fantoch_tpu_torch.engine.driver import prepare_batch
    from fantoch_tpu_torch.engine.faults import batch_fault_flags

    seen = dict.fromkeys(("trigger 1", "window-blocked SUBMIT",
                          "trigger 2", "multi-completion", "think delay",
                          "epoch boundary"), 0)
    errs, calls = [0.0], [0]

    def k6(a, got, want):
        errs[0] = max(errs[0], _compare(got, want))
        calls[0] += 1
        _k6_events(a, want, seen)

    batches = {
        "tempo open": _open_lanes("tempo", OPEN_PLANS),
        "fpaxos open": _open_lanes("fpaxos", OPEN_PLANS),
        "tempo diurnal": _open_lanes("tempo", [None, None], commands=12,
                                     arrivals=None, traffic="diurnal"),
    }
    proto, dims, specs = _open_lanes("tempo", OPEN_PLANS[:2])
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_open_loop import PortDoubleReply

    batches["tempo double reply"] = (PortDoubleReply(proto), dims, specs)
    with _Patched(emit_rewrite=_checked("emit_rewrite", "emit_rewrite", k6)):
        for label, (p, d, lanes) in batches.items():
            before = calls[0]
            flags = batch_fault_flags(lanes)
            state, ctx = prepare_batch(p, d, lanes, dev)
            for _ in range(OPEN_STEPS):
                state, running = engine_core.frozen_step(
                    p, d, state, ctx, 1 << 22, False, flags)
                if not bool(running.any()):
                    break
            torch.cuda.synchronize()
            print(f"kernel emit_rewrite ({label} batch): exact=True on "
                  f"every one of {calls[0] - before} steps; lanes' steps "
                  f"{state['steps'].tolist()}, completed "
                  f"{state['clients']['completed'].sum(1).tolist()}, err "
                  f"{state['err'].tolist()}, dropped "
                  f"{state['fault_dropped'].tolist()}")
    assert all(seen.values()), f"open-loop coverage incomplete: {seen}"
    print("kernel emit_rewrite (open-loop and think coverage): seen "
          + "; ".join(f"{k} {v}" for k, v in seen.items())
          + f"; max_abs_err={errs[0]}")
    return errs[0]


def open_freeze(dev) -> float:
    """K2 (and K6) against their twins on monitored open-loop Caesar,
    the widest lane tree, on every one of 50 steps of a two-lane batch
    whose lane 0 is frozen from the start: K2's ``running`` is the cap's
    predicate at every step, and lane 0's whole tree (the ring and the
    release clamp, the monitor planes) is as it was at the start, byte
    for byte. Returns the max abs error."""
    import torch

    from fantoch_tpu_torch.engine import core as engine_core
    from fantoch_tpu_torch.engine.driver import prepare_batch
    from fantoch_tpu_torch.kernels.step_loop import clone_tree

    errs = [0.0]

    def k2(a, got, want):
        errs[0] = max(errs[0], _compare(got, want))
        assert torch.equal(got[4], a[-1].running())

    def k6(a, got, want):
        errs[0] = max(errs[0], _compare(got, want))

    proto, dims, lanes = _open_lanes("caesar", [None, None], commands=3,
                                     cpr=1)
    state, ctx = prepare_batch(proto, dims, lanes, dev, 4)
    state["err"][0] = 64
    start = clone_tree(state)
    with _Patched(
        land_emissions=_checked("land_emissions", "land_emissions", k2),
        emit_rewrite=_checked("emit_rewrite", "emit_rewrite", k6),
    ):
        for _ in range(50):
            state, running = engine_core.frozen_step(
                proto, dims, state, ctx, 1 << 22, monitor_keys=4)
            assert running.tolist() == [False, True], running
    planes = list(zip(_flatten(state), _flatten(start)))
    for got, was in planes:
        assert torch.equal(got[0], was[0]), "lane 0's tree changed"
    assert int(state["clients"]["completed"][1].sum()) > 0
    print(f"kernels land_emissions, emit_rewrite (monitored open-loop "
          f"Caesar, lane 0 frozen): exact=True on every one of 50 steps; "
          f"all {len(planes)} planes of lane 0 as at the start, byte for "
          f"byte; max_abs_err={errs[0]}")
    return errs[0]


def golden_open_loop(dev) -> None:
    """The serving lanes of tests/test_torch_serving.py (open-loop Tempo
    and FPaxos under crashes, windows and drops) against their
    fixture."""
    from fantoch_tpu_torch.core import Config, Planet
    from fantoch_tpu_torch.engine import make_lane, run_lanes
    from fantoch_tpu_torch.engine.faults import FaultPlan
    from fantoch_tpu_torch.engine.protocols import dev_config_kwargs

    regions = Planet.new().regions()[:3]
    text = ""
    for name, commands, arrivals, load, window, seed, plan in SERVING_LANES:
        proto, dims = _open_protocol(name, 3, commands)
        spec = make_lane(
            proto, Planet.new(), Config(**dev_config_kwargs(name, 3, 1)),
            conflict_rate=100, pool_size=1, commands_per_client=commands,
            clients_per_region=1, process_regions=regions,
            client_regions=regions, dims=dims, seed=seed,
            faults=FaultPlan.from_json(plan), arrivals=arrivals,
            arrival_load=load, open_window=window)
        (res,) = run_lanes(proto, dims, [spec], device=dev)
        print(f"golden open loop on {dev}: {name} {arrivals}@{load} window "
              f"{window} {res.faults}: steps {res.steps} completed "
              f"{res.completed} dropped {res.dropped} err {res.err}")
        text += json.dumps([res.to_json()], sort_keys=True) + "\n"
    path = FIXTURES / "torch_open_loop_golden.json"
    assert text == path.read_text(), "to_json differs from the fixture"
    print(f"fixture {path.relative_to(ROOT)}: byte-identical "
          f"({len(text)} bytes)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import fantoch_tpu_torch  # noqa: F401  (alone in a directory: fails)

    dev = torch.device("cuda")
    card = _nvidia_smi()
    global HOST
    HOST = HostTwins()
    try:
        return _main(dev, card)
    finally:
        HOST.close()


def _main(dev, card) -> int:
    import torch

    from fantoch_tpu_torch import kernels
    from fantoch_tpu_torch.kernels import build

    # 1. versions and the card
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} | {torch.cuda.get_device_name(0)}")
    print(card)

    def phase(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"phase {label}: {time.perf_counter() - t0:.1f} s")
        return out

    # the host runs the sampled lanes are held to, in the background (the
    # mc grid's go in segments while it runs)
    for name in PATHS + tuple(new_paths()):
        HOST.submit(("sweep", name), _host_sweep_lanes, name,
                    SAMPLE[base_path(name)])

    # 2. build
    phase("2 build", build.build)
    print(f"build: nvcc+link {build.BUILD_SECONDS} s")

    # 3. every kernel against its plain twin at the main paths' shapes
    rows = {}
    # (the ladder's rungs last: their rows are those of slice 10's main
    # path)
    for name in PATHS + tuple(new_paths()):
        phase(f"3 kernels ({name} path)", check_kernels, name, dev, rows)
    phase("3 kernels (monitored mc paths)", check_monitored_kernels, dev,
          rows)
    phase("3 kernels (hetero six batch)", check_mixed_kernels, "hetero_six",
          dev, rows)
    assert sorted(rows) == sorted(set(kernels.WRAPPERS) - {"step_loop"}), (
        sorted(rows))

    # 4-6. golden batches and fixture bytes on the card
    phase("4 golden basic", golden_basic, dev)
    phase("5 golden fpaxos", golden_fpaxos, dev)
    phase("6 golden tempo", golden_tempo, dev)
    phase("6 golden atlas/epaxos", golden_graphdep, dev)
    phase("6 golden caesar", golden_caesar, dev)
    phase("6 golden tempo partial", golden_tempo_partial, dev)
    phase("6 golden atlas partial", golden_atlas_partial, dev)
    phase("6 golden faults", golden_faults, dev)
    phase("6 golden open loop", golden_open_loop, dev)

    # the fault branches of K1, K6 and K2, K1 on a pool past its shared
    # staging, and K6's reorder draws and wide lanes, each against its
    # twin
    for label, fn, knames in (
        ("fault coverage", fault_coverage,
         ("qualify_pop", "emit_rewrite", "land_emissions")),
        ("large pool", qualify_large_pool, ("qualify_pop",)),
        ("reorder", reorder_coverage, ("emit_rewrite",)),
        ("wide emit", wide_emit, ("emit_rewrite",)),
        ("traffic keys", traffic_keys, ("key_table",)),
        ("open-loop coverage", open_coverage, ("emit_rewrite",)),
        ("open-loop freeze", open_freeze, ("land_emissions",
                                           "emit_rewrite")),
    ):
        err = phase(f"6 kernels ({label})", fn, dev)
        for kname in knames:
            rows[kname]["max_abs_err"] = max(rows[kname]["max_abs_err"], err)
    # the monitor branches of the handlers and K6, and K13, against their
    # twins on every step of small monitored batches
    for kname, err in phase("6 kernels (monitor coverage)",
                            monitor_coverage, dev).items():
        rows[kname]["max_abs_err"] = max(rows[kname]["max_abs_err"], err)
    # the device loop against the eager loop, whole state, and its row
    phase("6 segments", segments, dev, rows)
    phase("6 segments hetero", hetero_segments, dev)
    assert sorted(rows) == sorted(kernels.WRAPPERS), sorted(rows)

    # 8. slice 9's main path, the mc default grid, counted, before the
    # sweeps: the host replays its sampled lanes' segments meanwhile
    mc_launches, mc_check = phase("8 mc grid", mc_grid, dev)
    phase("8 mc grid profiled", mc_grid_profile, dev, mc_launches)

    # 7. the main paths, each counted on its own
    by_path = {name: phase(f"7 sweep {name}", sweep, name, dev)
               for name in PATHS}
    by_path["tempo_monitored"] = phase("7 sweep tempo monitored",
                                       monitored_tempo_sweep, dev)
    # slice 12: mixed-protocol batches, each lane held to its protocol's
    # sweep above
    by_path["hetero"] = phase("7 sweep hetero", hetero_sweep, "hetero", dev)
    by_path["hetero_six"] = phase("7 sweep hetero six", hetero_sweep,
                                  "hetero_six", dev)
    phase("7 hetero step", hetero_step_row, dev, rows)
    # the traffic sweeps and the open-loop offered-load ladder (slice
    # 10's main path), each counted on its own
    for name in new_paths():
        by_path[name] = phase(f"7 sweep {name}", sweep, name, dev)
    by_path["mc"] = mc_launches
    # 8. the bench's fuzz self-check point, then the mc grid's lanes
    # against the host replays
    phase("8 mc bench point", bench_point, dev)
    phase("8 mc grid host replays", mc_check)
    assert K13_CHECKED["launches"] > 0
    rows["mon_finalize"]["max_abs_err"] = max(
        rows["mon_finalize"]["max_abs_err"], K13_CHECKED["err"])
    print(f"kernel mon_finalize: exact=True on the final state of every one "
          f"of {K13_CHECKED['launches']} monitored batches")

    print("frozen-lane checks, every third lane failed (ms by kernel and "
          f"path): {json.dumps(FROZEN, sort_keys=True)}")
    print("the whole step with every third lane failed (frozen lanes, live "
          "ones stopped by the cap word, planes compared): "
          f"{json.dumps(FROZEN_STEPS, sort_keys=True)}")
    print("lane_freeze (K7) is folded into land_emissions (K2): no kernel "
          "selects after the step; K2 reports running; a step is four "
          "launches")
    for kname in ("fpaxos_handle", "atlas_partial_handle"):
        print(f"{kname} ({rows[kname]['path']} path) all lanes running "
              f"{rows[kname]['ms']:.5f} ms; every third lane failed: "
              + "; ".join(f"{p} {v['ms']:.5f} ms ({v['frozen']} of "
                          f"{v['lanes']} frozen)"
                          for p, v in FROZEN[kname].items()))
    bottlenecks(rows, by_path)

    # 9. the kernels line, then the verdict
    out = []
    for kname, row in rows.items():
        counts = {p: c[kname] for p, c in by_path.items()}
        out.append({
            "name": kname,
            "route": "cuda",
            "source": f"fantoch_tpu_torch/kernels/csrc/{kname}.cu",
            "replaces": REPLACES[kname],
            "launches": counts[row["path"]],
            "launches_by_path": counts,
            **row,
        })
    assert all(k["launches"] > 0 for k in out), out
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
