"""The in-place contract of K6 (``emit_rewrite``) on the CPU, through its
plain twin, and the step's frozen-lane contract once K6 and every
handler (K9 ``graphdep_handle`` since slice 16, K5 ``fpaxos_handle`` and
K12 ``atlas_partial_handle`` since slice 17) update in place.

K6 updates the lane's ``clients``, ``metrics``, ``pair_cnt`` and
``next_periodic`` planes in place, on the lanes whose run predicate
holds at the step's start (``kernels/lane_freeze.py Cap``), and returns
the very tensors it was given; a frozen lane gets zero rows, none of
which lands, and its ``[L]`` lane words as they were. All comparisons
are exact. The inputs are tests/test_torch_emit.py's seeded random stub
tables (16 lanes; K1's twin pops the pool) with each lane's fault plan
drawn as tests/test_torch_kernels.py draws it, every third lane's error
word set:

- K6's twin with that cap under each flag (fault-free, crash + horizon,
  windows + drops + jitter, reorder, open loop with a staged SUBMIT,
  think, monitor): running lanes equal the uncapped twin, frozen lanes'
  in-place planes are bit for bit as before, the planes returned are the
  ones given, a frozen lane's rows are zero and not delivered and its
  lane words are its own; ``work`` on a snapshot taken before the call
  equals its value on the out-of-place arithmetic;
- 64 ``frozen_step``s with lanes frozen against the reference's vmapped
  run loop, whole state, on the monitored Atlas and FPaxos batches of
  tests/torch_monitor_lanes.py (jitter, a crash, drops under a horizon:
  the mc fault envelope), the handler (K9, K5) and K6 in place
  throughout;
- a step under its cap, every third lane failed, leaves every plane of
  every frozen lane as it was (no select follows the step), its running
  lanes equal an uncapped step's and K2's ``running`` is the predicate,
  on all eight protocols and on Tempo under a crash plan, monitored,
  open loop and under a traffic schedule.

K5's, K9's and K12's twins with the cap, their ``work`` on a snapshot,
64 frozen FPaxos, Atlas, EPaxos and Atlas partial steps and the runners
run twice on one prepared Atlas batch are cases of the tests in
tests/test_torch_inplace.py; 64 frozen steps of an open-loop batch, of
tests/test_torch_inplace_k1_k8.py."""

import importlib

import numpy as np
import pytest
import test_torch_emit as emit_case
import torch
import torch_monitor_lanes
from test_torch_inplace_k1_k8 import frozen_steps_against_reference
from test_torch_kernels import _random_fault_ctx
from test_torch_monitor_step import _ctx_with_keys
from torch_threads import one_torch_thread  # noqa: F401

from fantoch_tpu.engine.driver import stack_states
from fantoch_tpu.engine.faults import batch_fault_flags as r_batch_flags
from fantoch_tpu_torch import carry, cli
from fantoch_tpu_torch.engine.core import frozen_step, lane_step
from fantoch_tpu_torch.engine.dims import ERR_STUCK, INF, PMT, PPAY, PSRC
from fantoch_tpu_torch.engine.driver import prepare_batch
from fantoch_tpu_torch.engine.faults import (
    FLAG_CRASH, FLAG_DROPS, FLAG_HORIZON, FLAG_JITTER, FLAG_MONITOR,
    FLAG_OPEN_LOOP, FLAG_REORDER, FLAG_THINK, FLAG_WINDOWS,
    batch_fault_flags, flag_bits,
)
from fantoch_tpu_torch.kernels import qualify_pop
from fantoch_tpu_torch.kernels.lane_freeze import Cap
from fantoch_tpu_torch.kernels.step_loop import clone_tree

k6 = importlib.import_module("fantoch_tpu_torch.kernels.emit_rewrite")
MAX_STEPS = 1 << 22
L, N, C = emit_case.L, emit_case.N, emit_case.C
# each case's flag word
FLAGS = {
    "fault_free": 0,
    "crash_horizon": FLAG_CRASH | FLAG_HORIZON,
    "windows_drops_jitter": FLAG_WINDOWS | FLAG_DROPS | FLAG_JITTER,
    "reorder": FLAG_REORDER,
    "open_loop": FLAG_OPEN_LOOP,
    "think": FLAG_THINK,
    "monitor": FLAG_MONITOR,
}
# the open-loop window and arrival table's extent, the think epochs
WINDOW, TA, EPOCHS = 2, 8, 3
# the lane words K6 writes out of place
LANE_WORDS = k6.LANE_KEYS + ("fault_dropped", "viol", "viol_step")


def _k6_case(name):
    """K6's arguments under case ``name`` and the step's cap: the stub's
    random state (every third lane's error word set, the others clear),
    ctx and fault plans; K1's twin pops the pool. On the open-loop case
    each lane whose process 0 pops is handed client 0's next SUBMIT,
    which its window admits (trigger 1)."""
    flags = FLAGS[name]
    st, ctx = emit_case._inputs(16)
    rng = np.random.default_rng(16)
    ctx.update(_random_fault_ctx(rng, L, N))
    ctx["extra_time"] = np.full((L,), 50, np.int32)
    st["err"] = np.where(np.arange(L) % 3 == 0, ERR_STUCK, 0).astype(np.int32)
    ri = lambda lo, hi, *s: rng.integers(lo, hi, (L, *s)).astype(np.int32)  # noqa: E731
    if flags & FLAG_OPEN_LOOP:
        st["clients"]["ol_comp_t"] = ri(0, 9, C, WINDOW)
        st["clients"]["ol_last_rel"] = ri(0, 9, C)
        st["clients"]["issued"][:, 0] = 1
        st["clients"]["completed"][:, 0] = 1
        ctx["ol_arrival"] = np.sort(ri(0, 20, C, TA), axis=2)
    if flags & FLAG_THINK:
        ctx["traffic_seq_epoch"] = np.sort(ri(0, EPOCHS, emit_case.T), axis=1)
        ctx["traffic_think"] = ri(0, 6, EPOCHS)
    mon_flags = None
    if flags & FLAG_MONITOR:
        st["viol"] = ri(0, 2) * 8
        st["viol_step"] = np.where(st["viol"] != 0, ri(0, 9), INF).astype(
            np.int32)
        mon_flags = torch.from_numpy(ri(0, 4, N))
    st, ctx = carry.to_torch(st, "cpu"), carry.to_torch(ctx, "cpu")
    ps = st["ps"]
    _arr, ep, _now, _act, fire, _slot, has, rows, timers = qualify_pop(
        st["pool"], st["next_periodic"], ctx["lookahead"],
        ctx["fault_crash_t"], ctx["fault_horizon"], flags)
    if flags & FLAG_OPEN_LOOP:
        pops = has[:, 0] & ps["rdy"][:, 0]
        rows[pops, 0, PMT] = 0
        rows[pops, 0, PSRC] = N
        rows[pops, 0, PPAY + 1] = 1
    if timers is not st["next_periodic"]:
        st = dict(st, next_periodic=timers)

    def outbox(side):
        return {"valid": ps[side + "v"], "dst": ps[side + "d"],
                "mtype": ps[side + "m"], "payload": ps[side + "p"]}

    args = (st, ctx, ep, fire, has, ps["rdy"], rows, outbox("p"),
            outbox("h"), ps["perr"], emit_case._dims()[1], 0, flags,
            mon_flags)
    return args, Cap(st, ctx, MAX_STEPS, flags)


def _fresh(a):
    """K6's arguments with its in-place planes copied."""
    st = dict(a[0], **{k: clone_tree(a[0][k]) for k in
                       ("clients", "metrics", "pair_cnt", "next_periodic")})
    return (st,) + a[1:]


def _planes(st):
    """``(path, tensor)`` of the planes K6 updates in place."""
    out = [(f"{g}/{k}", v) for g in ("clients", "metrics")
           for k, v in st[g].items()]
    return out + [(k, st[k]) for k in ("pair_cnt", "next_periodic")]


@pytest.mark.parametrize("name", sorted(FLAGS))
def test_emit_rewrite_twin_updates_running_lanes_in_place(name):
    a, cap = _k6_case(name)
    run = cap.running()
    frozen = ~run
    assert int(run.sum()) >= 4 and int(frozen.sum()) >= 5, run
    before, given = _fresh(a), _fresh(a)
    got = k6.emit_rewrite_plain(*given, cap)
    free = k6.emit_rewrite_plain(*_fresh(a))
    upd = {"clients": got[2]["clients"], "metrics": got[2]["metrics"],
           **{k: got[2][k] for k in ("pair_cnt", "next_periodic")}}
    moved = {"running": 0, "frozen": 0}
    for (path, g), (_p, giv), (_q, b), (_r, f) in zip(
            _planes(upd), _planes(given[0]), _planes(before[0]),
            _planes(free[2])):
        assert g is giv, f"{path}: a new tensor"
        assert torch.equal(g[frozen], b[frozen]), f"{path}: a frozen lane moved"
        assert torch.equal(g[run], f[run]), f"{path}: a running lane differs"
        moved["running"] += int((f[run] != b[run]).sum())
        moved["frozen"] += int((f[frozen] != b[frozen]).sum())
    # the cap holds back what the uncapped step would change
    assert moved["running"] > 0 and moved["frozen"] > 0, moved
    lead = run[:, None, None]
    assert torch.equal(got[0], torch.where(lead, free[0], 0))
    assert torch.equal(got[1], free[1] & run[:, None])
    for k in LANE_WORDS:
        if k in free[2]:
            assert torch.equal(got[2][k],
                               torch.where(run, free[2][k], a[0][k])), k
    if name == "open_loop":
        # a staged SUBMIT (trigger 1) on a running lane
        F2 = k6.rows_per_process(emit_case.F, FLAGS[name])
        assert bool(got[1][run][:, F2 - 2].any())


@pytest.mark.parametrize("name", sorted(FLAGS))
def test_emit_rewrite_work_on_a_snapshot_equals_out_of_place(name):
    """K6's ``work`` on the state copied before the call equals its value
    on the out-of-place arithmetic's result."""
    a, _cap = _k6_case(name)
    want = k6.work(*a, k6.emit_out_of_place(*_fresh(a)))
    given = _fresh(a)
    out = k6.emit_rewrite(*given)
    assert all(p is q for (_p, p), (_q, q) in zip(_planes(given[0]),
                                                  _planes(out[2])))
    assert k6.work(*a, out) == want


# ----------------------------------------------------------------------
# 64 frozen steps of a monitored batch against the reference
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["atlas", "fpaxos"])
def test_frozen_monitored_atlas_steps_match_the_reference_run_loop(name):
    """From the port's state after 20 steps, every third lane failed and
    every other lane one step behind the cap at 83: 64 ``frozen_step``s
    of the port and the reference's segment runner to 83 end in the same
    whole state, with the handler's process state and monitor planes
    (K9 on Atlas, K5 on FPaxos, the mc grid's monitored protocols) and
    K6's planes updated in place throughout."""
    ref, dims, specs = torch_monitor_lanes.lanes(True, name)
    port = torch_monitor_lanes.lanes(False, name)[0]
    mk = torch_monitor_lanes.MONITOR_KEYS
    frozen_steps_against_reference(
        ref, port, dims, _ctx_with_keys(specs, dims),
        stack_states(ref, dims, specs, monitor_keys=mk),
        r_batch_flags(specs), mk)


# ----------------------------------------------------------------------
# a step under its cap keeps every plane of every frozen lane
# ----------------------------------------------------------------------

SMALL = ["--n", "3", "--subsets", "2", "--fs", "1", "--commands", "3"]
PARTIAL = ["--shards", "2", "--keys-per-command", "2", "--pool-size", "4"]
PROTOCOLS = ["basic", "fpaxos", "tempo", "atlas", "epaxos", "caesar",
             "tempo_partial", "atlas_partial"]
# the other batches' sweep arguments (Tempo); "monitored" is the
# monitored Tempo batch of tests/torch_monitor_lanes.py
BATCHES = {
    "crash": ["--conflicts", "0,100", "--faults",
              '[{}, {"crash": {"1": 30}}]'],
    "open_loop": ["--conflicts", "0,100", "--arrivals", "burst",
                  "--open-window", "2"],
    "traffic": ["--conflicts", "0,50", "--traffic", "churn"],
}
WARM = 20


def _batch_case(name):
    """``(protocol, dims, state, ctx, faults, monitor_keys)`` of batch
    ``name`` on the CPU."""
    if name == "monitored":
        proto, dims, specs = torch_monitor_lanes.lanes(False, "tempo")
        mk = torch_monitor_lanes.MONITOR_KEYS
    else:
        protocol = name.replace("_partial", "")
        if name in BATCHES:
            argv = ["sweep", "--protocol", "tempo", *SMALL, *BATCHES[name]]
        elif "partial" in name:
            argv = ["sweep", "--protocol", protocol, *SMALL, *PARTIAL,
                    "--conflicts", "10,100"]
        else:
            argv = ["sweep", "--protocol", protocol, *SMALL,
                    "--conflicts", "0,100"]
        proto, dims, specs = cli.sweep_setup(cli.parse_args(argv))
        mk = 0
    st, ctx = prepare_batch(proto, dims, specs, "cpu", monitor_keys=mk)
    return proto, dims, st, ctx, batch_fault_flags(specs), mk


def _leaves(new, before, free, path=""):
    """``(path, new, before, free)`` for every plane of three trees."""
    if isinstance(new, dict):
        return [x for k in new for x in _leaves(new[k], before[k], free[k],
                                               f"{path}/{k}")]
    return [(path.lstrip("/"), new, before, free)]


@pytest.mark.parametrize("name", PROTOCOLS + ["crash", "monitored",
                                              "open_loop", "traffic"])
def test_a_step_under_its_cap_keeps_every_frozen_lane(name):
    """After 20 steps, every third lane failed: one ``frozen_step`` leaves
    every plane of every frozen lane (the pool, the process state, the
    lane state, the lane words, the clock, the timers) as it was, byte
    for byte, with no select after the step; the running lanes equal an
    uncapped step's, and K2's ``running`` is the cap's predicate. On all
    eight protocols, and on Tempo under a crash plan, monitored, open
    loop and under a traffic schedule."""
    proto, dims, st, ctx, faults, mk = _batch_case(name)
    for _ in range(WARM):
        st, _running = frozen_step(proto, dims, st, ctx, MAX_STEPS, False,
                                   faults, mk)
    failed = dict(st, err=st["err"].clone())
    failed["err"][::3] |= ERR_STUCK
    want_running = Cap(failed, ctx, MAX_STEPS, flag_bits(faults)).running()
    assert not bool(want_running[::3].any()) and bool(want_running.any())
    before = clone_tree(failed)
    free = lane_step(proto, dims, clone_tree(st), ctx, False, faults, mk)
    new, running = frozen_step(proto, dims, failed, ctx, MAX_STEPS, False,
                               faults, mk)
    assert torch.equal(running, want_running)
    frozen, moved = ~running, 0
    for path, n, b, f in _leaves(new, before, free):
        assert torch.equal(n[frozen], b[frozen]), f"{path}: a frozen lane"
        assert torch.equal(n[running], f[running]), f"{path}: a running lane"
        moved += int((n[running] != b[running]).sum())
    assert moved > 0
