"""Each kernel module's ``work``: the bytes and operations its region
needs on given inputs, which ``chip_smoke.py`` turns into the kernel's
bound. Small cases whose counts are worked out by hand."""

import math

import numpy as np
import pytest
import torch

from fantoch_tpu_torch.engine.dims import (
    INF, PA, PDST, PMT, PPAY, PSRC, EngineDims,
)
from fantoch_tpu_torch.engine.protocols import (
    AtlasDev, AtlasPartialDev, BasicDev, CaesarDev, FPaxosDev, TempoDev,
    TempoPartialDev,
)
from fantoch_tpu_torch.kernels import (
    atlas_partial_handle, basic_handle, caesar_handle, cost, emit_rewrite,
    fpaxos_handle,
    graphdep_handle, key_table, land_emissions, qualify_pop,
    tempo_handle, tempo_partial_handle,
)
from fantoch_tpu_torch.kernels.atlas_partial_handle import work as ap_work
from fantoch_tpu_torch.kernels.basic_handle import OUTBOX_KEYS
from fantoch_tpu_torch.kernels.basic_handle import work as bh_work
from fantoch_tpu_torch.kernels.caesar_handle import work as ch_work
from fantoch_tpu_torch.kernels.emit_rewrite import work as er_work
from fantoch_tpu_torch.kernels.fpaxos_handle import work as fh_work
from fantoch_tpu_torch.kernels.graphdep_handle import work as gh_work
from fantoch_tpu_torch.kernels.key_table import THREEFRY_OPS
from fantoch_tpu_torch.kernels.key_table import work as kt_work
from fantoch_tpu_torch.kernels.land_emissions import work as le_work
from fantoch_tpu_torch.kernels.qualify_pop import work as qp_work
from fantoch_tpu_torch.kernels.step_loop import clone_tree
from fantoch_tpu_torch.kernels.tempo_handle import work as th_work
from fantoch_tpu_torch.kernels.tempo_partial_handle import work as tp_work

P = 5
W = PPAY + P


def test_bound_is_the_larger_time():
    ms, by = cost.bound(3.35e9, 0)
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = cost.bound(0, cost.INT32_OPS_PER_S)
    assert by == "operations" and ms == pytest.approx(1e3)
    assert cost.nbytes(torch.zeros(3, dtype=torch.int32),
                       torch.zeros(5, dtype=torch.bool)) == 17


def test_qualify_pop_work_counts_the_competing_slots():
    # slots 0 and 1 compete for process 0 (arrival 3), slot 2 for
    # process 1; slot 3 is free
    pool = torch.zeros((1, 4, W), dtype=torch.int32)
    pool[0, :, PA] = torch.tensor([3, 3, 9, INF])
    pool[0, :, PDST] = torch.tensor([0, 0, 1, 0])
    timers = torch.full((1, 2, 1), INF, dtype=torch.int32)
    lookahead = torch.full((1, 2, 2), INF, dtype=torch.int32)
    out = qualify_pop(pool, timers, lookahead)
    n_bytes, n_ops = qp_work(pool, timers, lookahead, None, None, 0, out)
    read = 4 * (2 * 4 + 3 * 3 + 2 * W) + 8 + 16
    # the ninth output is the timers passed through (no crash flag)
    assert out[8] is timers
    assert n_bytes == read + cost.nbytes(*out[:8])
    assert n_ops == 2 * 4 + 4 * 3 + 3 * 4


@pytest.mark.parametrize(
    "deliver, n_land, n_freed",
    [
        ([1, 0, 1], 2, 0),   # both free slots take a row
        ([0, 1, 0], 1, 0),   # the freed slot 0 takes it
        ([0, 0, 0], 0, 1),   # the freed arrival word is written alone
        ([1, 1, 1], 2, 0),   # one row more than free slots: ERR_POOL
    ],
)
def test_land_emissions_work_counts_the_rows_that_land(deliver, n_land,
                                                       n_freed):
    pool = torch.arange(4 * W, dtype=torch.int32).reshape(1, 4, W)
    pool[0, :, PA] = torch.tensor([3, 5, INF, 7])
    arrival = torch.tensor([[INF, 5, INF, 7]], dtype=torch.int32)
    dl = torch.tensor([deliver], dtype=torch.bool)
    rows = torch.ones((1, 3, W), dtype=torch.int32)
    peak = torch.zeros((1,), dtype=torch.int32)
    err = torch.tensor([8], dtype=torch.int32)
    # the call updates the pool in place; work reads the one before it
    out = land_emissions(pool.clone(), arrival, dl, rows, peak, err)
    assert out[3].tolist() == [9 if sum(deliver) > 2 else 8]
    n_bytes, n_ops = le_work(pool, arrival, dl, rows, peak, err, out)
    read = 16 + 3 + 4 + 4 + 4 * W * n_land
    # and the overflow flag, peak, error word and running
    write = 4 * W * n_land + 4 * n_freed + 1 + 4 + 4 + 1
    assert n_bytes == read + write
    assert n_ops == 2 * (4 + 3) + W * n_land


def _kt_inputs(conflict, pool_size, kind, K=1):
    L = len(conflict)
    rng_key = torch.from_numpy(
        np.arange(2 * L, dtype=np.uint32).reshape(L, 2) + 7
    )
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    cum = torch.linspace(0.1, 1.0, K, dtype=torch.float32).expand(L, K)
    return (rng_key, i32(conflict), i32(pool_size), i32(kind),
            cum.contiguous())


@pytest.mark.parametrize(
    "conflict, pool_size, blocks_per_key",
    [
        (0, 1, 0),      # never a hit: the key is pool_size + client
        (100, 1, 0),    # always a hit on a one-key pool: key 0
        (50, 1, 5),     # the conflict draw and the seq fold
    ],
)
def test_key_table_work_counts_the_draws_a_key_needs(conflict, pool_size,
                                                     blocks_per_key):
    C, T = 2, 3
    a = _kt_inputs([conflict], [pool_size], [0])
    out = key_table(*a, C, T)
    n_bytes, n_ops = kt_work(*a, C, T, out)
    folds_c = C if blocks_per_key else 0
    assert n_ops == THREEFRY_OPS * (blocks_per_key * C * T + folds_c)
    assert n_bytes == 8 + 3 * 4 + 4 * C * T


def test_key_table_work_counts_pool_draws_on_hits_and_zipf_searches():
    C, T, K = 2, 8, 6
    a = _kt_inputs([50, 10], [4, 1], [0, 1], K)
    out = key_table(*a, C, T)
    n_bytes, n_ops = kt_work(*a, C, T, out)
    hits = int((out[0] < 4).sum())
    assert 0 < hits < C * T
    pool_lane = 5 * C * T + 5 * hits + C
    zipf_lane = 3 * C * T + C
    search = math.ceil(math.log2(K + 1)) * C * T
    assert n_ops == THREEFRY_OPS * (pool_lane + zipf_lane) + search
    assert n_bytes == 2 * 8 + 3 * 2 * 4 + 4 * K + 4 * 2 * C * T


def test_key_table_work_counts_the_epoch_branch():
    """Under a schedule each key's draws follow its epoch: seqs 0-1 in
    epoch 0 (conflict 0: the private key span + c, no draw), seqs 2-3 in
    epoch 1 (conflict 50 over the pool [2, 5): the conflict draw and the
    seq fold, and the pool draw on a hit, a key below the span); bytes
    add the seq → epoch row, the three knob tables and the span."""
    C, T = 2, 4
    a = _kt_inputs([100], [1], [0])
    i32 = lambda v: torch.tensor([v], dtype=torch.int32)  # noqa: E731
    traffic = {"traffic_seq_epoch": i32([0, 0, 1, 1]),
               "traffic_conflict": i32([0, 50]),
               "traffic_pool_base": i32([0, 2]),
               "traffic_pool_size": i32([1, 3]),
               "traffic_pool_span": torch.tensor([5], dtype=torch.int32)}
    out = key_table(*a, C, T, traffic)
    assert out[0, :, :2].tolist() == [[5, 5], [6, 6]]
    late = out[0, :, 2:]
    hits = int((late < 5).sum())
    assert ((late >= 2) & (late < 5) | (late >= 5)).all()
    n_bytes, n_ops = kt_work(*a, C, T, traffic, out)
    assert n_ops == THREEFRY_OPS * (5 * C * 2 + 5 * hits + C)
    assert n_bytes == 8 + 3 * 4 + 4 * C * T + 4 * 4 + 3 * 2 * 4 + 4


def _basic_idle(L=2):
    dims = EngineDims.for_protocol(BasicDev, n=3, clients=3, payload=P,
                                   dot_slots=4)
    N = dims.N
    ctx_np = {"rows": np.int32(N)}
    ps = {k: torch.from_numpy(np.stack([v] * L))
          for k, v in BasicDev.init_state(dims, ctx_np).items()}
    has = torch.zeros((L, N), dtype=torch.bool)
    rows = torch.zeros((L, N, W), dtype=torch.int32)
    fire = torch.zeros((L, N, dims.R), dtype=torch.bool)
    ctx = {"n": torch.full((L,), N, dtype=torch.int32),
           "quorum": torch.ones((L, N, N), dtype=torch.bool),
           "q_size": torch.full((L,), 2, dtype=torch.int32)}
    return dims, ps, has, rows, fire, ctx


def _outboxes_bytes(out):
    _rdy, _ps, pout, hout = out
    return cost.nbytes(*(ob[k] for ob in (pout, hout)
                         for k in OUTBOX_KEYS))


def _on_a_copy(kernel, ps, *rest):
    """An in-place handler kernel (K4, K5, K8, K9, K10, K11, K12) on a
    copy of ``ps``: the call updates its state in place; work reads the
    state before it."""
    return kernel({k: v.clone() for k, v in ps.items()}, *rest)


def _emit_on_a_copy(st, *rest):
    """K6 on a copy of the lane state ``st``: the call updates its
    clients, metrics, channel counts and timers in place; work reads the
    state before it."""
    return emit_rewrite(clone_tree(st), *rest)


def test_basic_handle_work_idle_submit_and_gc():
    dims, ps, has, rows, fire, ctx = _basic_idle()
    out = _on_a_copy(basic_handle, ps, has, rows, fire, ctx, dims)
    idle, _ = bh_work(ps, has, rows, fire, ctx, dims, out)
    L, N = has.shape
    flags = cost.nbytes(has, fire, ctx["n"], ctx["q_size"])
    assert idle == flags + L * N + _outboxes_bytes(out)
    # one SUBMIT of client 2: reads its message and the own seq, writes
    # the own seq and the slot's client (its ack count stays 0)
    has[0, 1] = True
    rows[0, 1, PMT] = BasicDev.SUBMIT
    rows[0, 1, PPAY] = 2
    out = _on_a_copy(basic_handle, ps, has, rows, fire, ctx, dims)
    n_bytes, _ = bh_work(ps, has, rows, fire, ctx, dims, out)
    assert n_bytes == idle + 4 * (2 + P) + 4 + 4 + 4
    # one GC message from process 0 (an all-zero frontier): reads the
    # frontiers, seen flags, stable clocks and the [N, D] dot slots, and
    # changes one seen flag
    has[1, 2] = True
    rows[1, 2, PMT] = BasicDev.MGC
    out = _on_a_copy(basic_handle, ps, has, rows, fire, ctx, dims)
    with_gc, _ = bh_work(ps, has, rows, fire, ctx, dims, out)
    D = dims.D
    gc_read = 4 * N * N + N + 8 * N + 4 + 4 * N * D
    assert with_gc == n_bytes + 4 * (2 + P) + gc_read + 1


def _fpaxos_idle(L=2):
    dims = EngineDims.for_protocol(FPaxosDev, n=3, clients=3, payload=P,
                                   dot_slots=4)
    N = dims.N
    ps = {k: torch.from_numpy(np.stack([v] * L))
          for k, v in FPaxosDev.init_state(dims, {}).items()}
    has = torch.zeros((L, N), dtype=torch.bool)
    rows = torch.zeros((L, N, W), dtype=torch.int32)
    fire = torch.zeros((L, N, dims.R), dtype=torch.bool)
    ctx = {"n": torch.full((L,), N, dtype=torch.int32),
           "leader": torch.zeros((L,), dtype=torch.int32),
           "write_quorum": torch.ones((L, N), dtype=torch.bool),
           "q_size": torch.full((L,), 2, dtype=torch.int32),
           "client_attach": torch.zeros((L, 3), dtype=torch.int32)}
    return dims, ps, has, rows, fire, ctx


def test_fpaxos_handle_work_idle_submit_and_gc():
    dims, ps, has, rows, fire, ctx = _fpaxos_idle()
    out = _on_a_copy(fpaxos_handle, ps, has, rows, fire, ctx, dims)
    idle, _ = fh_work(ps, has, rows, fire, ctx, dims, out)
    L, N = has.shape
    assert idle == cost.nbytes(has, fire, ctx["n"]) + L * N + \
        _outboxes_bytes(out)
    # a SUBMIT at the leader (process 0): reads its message, the leader
    # id, its last slot, the commander entry and the write quorum; writes
    # the last slot and the entry's slot (its count stays 0)
    has[0, 0] = True
    rows[0, 0, PMT] = FPaxosDev.SUBMIT
    out = _on_a_copy(fpaxos_handle, ps, has, rows, fire, ctx, dims)
    n_bytes, _ = fh_work(ps, has, rows, fire, ctx, dims, out)
    assert n_bytes == idle + 4 * (2 + P) + 4 + (4 + 4 + N) + 4 + 4
    # a GC message from process 0 at process 2 (an all-zero frontier):
    # reads the frontiers, seen flags, its own frontier, the [D] window
    # and the stable count; changes one seen flag
    has[1, 2] = True
    rows[1, 2, PMT] = FPaxosDev.MGC
    out = _on_a_copy(fpaxos_handle, ps, has, rows, fire, ctx, dims)
    with_gc, ops = fh_work(ps, has, rows, fire, ctx, dims, out)
    gc_read = 4 * N + N + 4 + 4 * dims.D + 4
    assert with_gc == n_bytes + 4 * (2 + P) + gc_read + 1
    assert ops == 30 * L * N + 2 * dims.D + 3 * N


def _tempo_idle(L=2):
    t = TempoDev(keys=2, pending_per_key=4, detached_slots=3, gap_slots=2)
    dims = EngineDims.for_protocol(t, n=3, clients=3,
                                   payload=t.payload_width(3), dot_slots=4)
    N = dims.N
    ps = {k: torch.from_numpy(np.stack([v] * L))
          for k, v in t.init_state(dims, {}).items()}
    has = torch.zeros((L, N), dtype=torch.bool)
    rows = torch.zeros((L, N, PPAY + dims.P), dtype=torch.int32)
    fire = torch.zeros((L, N, dims.R), dtype=torch.bool)
    now = torch.zeros((L, N), dtype=torch.int32)
    i32 = lambda v, *s: torch.full((L, *s), v, dtype=torch.int32)  # noqa: E731
    b = lambda v, *s: torch.full((L, *s), v, dtype=torch.bool)  # noqa: E731
    ctx = {"n": i32(N), "f": i32(1), "fast_quorum": b(True, N, N),
           "write_quorum": b(True, N, N), "fq_size": i32(2),
           "wq_size": i32(2), "threshold": i32(2),
           "clock_bump_mode": b(False), "skip_fast_ack": b(False),
           "client_attach": i32(0, 3)}
    return t, dims, ps, has, rows, fire, now, ctx


def test_tempo_handle_work_idle_submit_and_gc():
    t, dims, ps, has, rows, fire, now, ctx = _tempo_idle()
    args = (ps, has, rows, fire, now, ctx, dims, False)
    out = _on_a_copy(tempo_handle, *args)
    idle, idle_ops = th_work(*args, out)
    L, N = has.shape
    P = dims.P
    assert idle == cost.nbytes(has, fire, now) + L * N + \
        _outboxes_bytes(out)
    assert idle_ops == 40 * L * N
    # a SUBMIT at process 0 on key 0: reads its message, its sequence and
    # the key's clock; writes its sequence, the clock, the dot's vote
    # count and its own vote range (its voter id 0 and the zeroed quorum
    # counters do not change)
    has[0, 0] = True
    rows[0, 0, PMT] = TempoDev.SUBMIT
    out = _on_a_copy(tempo_handle, *args)
    n_bytes, _ = th_work(*args, out)
    assert n_bytes == idle + 4 * (2 + P) + 4 * 2 + 4 * 5
    # a GC message from process 0 at process 2 (an all-zero frontier):
    # reads the frontier table, the seen flags, the committed and stable
    # clocks and the [N, D] dot words; changes one seen flag (process 1
    # has not been seen, so nothing is stable yet)
    has[1, 2] = True
    rows[1, 2, PMT] = TempoDev.MGC
    out = _on_a_copy(tempo_handle, *args)
    with_gc, ops = th_work(*args, out)
    D = dims.D
    gc_read = 4 * N * N + N + 4 * 2 * N + 4 * N * D
    assert with_gc == n_bytes + 4 * (2 + P) + gc_read + 1
    assert ops == 40 * L * N + 2 * N * D + 3 * N * N
    # a firing GC timer reads the committed clock; a detached kick-off
    # the detached table
    fire[0, 1, 0] = True
    fire[0, 1, 2] = True
    out = _on_a_copy(tempo_handle, *args)
    with_timers, _ = th_work(*args, out)
    assert with_timers == with_gc + 4 * N + 4 * t.K * t.R



def _tempo_partial_idle(L=2):
    """Two shards of two rows; every command of both clients is key 0,
    alone on shard 0."""
    t = TempoPartialDev(keys=2, shards=2, keys_per_cmd=2, pending_per_key=4,
                        detached_slots=3, gap_slots=2)
    dims = EngineDims.for_partial(t, 2, 2, 3)
    N, C, S = dims.N, dims.C, t.S
    ps = {k: torch.from_numpy(np.stack([v] * L))
          for k, v in t.init_state(dims, {}).items()}
    has = torch.zeros((L, N), dtype=torch.bool)
    rows = torch.zeros((L, N, PPAY + dims.P), dtype=torch.int32)
    fire = torch.zeros((L, N, dims.R), dtype=torch.bool)
    now = torch.zeros((L, N), dtype=torch.int32)
    i32 = lambda v, *s: torch.full((L, *s), v, dtype=torch.int32)  # noqa: E731
    b = lambda v, *s: torch.full((L, *s), v, dtype=torch.bool)  # noqa: E731
    skey = i32(-1, C, 4, S, 2)
    skey[..., 0, 0] = 0
    ctx = {"n": i32(2), "f": i32(1), "fast_quorum": b(True, N, N),
           "write_quorum": b(True, N, N), "fq_size": i32(2),
           "wq_size": i32(2), "threshold": i32(2),
           "clock_bump_mode": b(False),
           "shard_of": torch.tensor([[0, 0, 1, 1]] * L, dtype=torch.int32),
           "closest": torch.tensor([[[0, 2]] * N] * L, dtype=torch.int32),
           "client_attach_s": torch.tensor([[[0, 2], [1, 3]]] * L,
                                           dtype=torch.int32),
           "cmd_kmask": i32(1, C, 4), "cmd_skey": skey}
    return t, dims, ps, has, rows, fire, now, ctx


def test_tempo_partial_handle_work_idle_submit_and_gc():
    t, dims, ps, has, rows, fire, now, ctx = _tempo_partial_idle()
    args = (ps, has, rows, fire, now, ctx, dims)
    out = _on_a_copy(tempo_partial_handle, *args)
    idle, idle_ops = tp_work(*args, out)
    L, N = has.shape
    P, D, S, KPC = dims.P, dims.D, t.S, t.KPC
    assert idle == cost.nbytes(has, fire, now) + L * N + \
        _outboxes_bytes(out)
    assert idle_ops == 40 * L * N
    # a SUBMIT of client 0's first command at process 0: reads its
    # message, its sequence, the command's table row (mask and S × KPC
    # keys) and both local keys' clocks and detached rows; writes its
    # sequence, key 0's clock, the dot's vote count and key 0's vote
    # range (its voter id 0, the pad key's empty range and the zeroed
    # counters do not change)
    has[0, 0] = True
    rows[0, 0, PMT] = TempoPartialDev.SUBMIT
    rows[0, 0, PPAY + 1] = 1
    out = _on_a_copy(tempo_partial_handle, *args)
    n_bytes, _ = tp_work(*args, out)
    cmd = 4 * (1 + S * KPC)
    keys = KPC * 4 * (1 + 2 * t.R)
    assert out[1]["votes_s"][0, 0, 0, 0, 0, 0] == 1
    assert n_bytes == idle + 4 * (2 + P) + 4 * 3 + cmd + keys + 4 * 5
    # a GC message from process 3 at process 2 (an all-zero frontier):
    # reads the frontier table, the seen flags, the committed and stable
    # clocks and the [N, D] dot words; changes one seen flag
    has[1, 2] = True
    rows[1, 2, PMT] = TempoPartialDev.MGC
    rows[1, 2, PSRC] = 3
    out = _on_a_copy(tempo_partial_handle, *args)
    with_gc, ops = tp_work(*args, out)
    gc_read = 4 * N * N + N + 4 * 2 * N + 4 * N * D
    assert with_gc == n_bytes + 4 * (2 + P) + gc_read + 1
    assert ops == 40 * L * N + 2 * N * D + 3 * N * N
    # a firing GC timer reads the committed clock; a detached kick-off
    # the detached table
    fire[0, 1, 0] = True
    fire[0, 1, 2] = True
    out = _on_a_copy(tempo_partial_handle, *args)
    with_timers, _ = tp_work(*args, out)
    assert with_timers == with_gc + 4 * N + 4 * t.K * t.R


def _graphdep_idle(L=2):
    t = AtlasDev(keys=2, gap_slots=2)
    dims = EngineDims.for_protocol(t, n=3, clients=3,
                                   payload=t.payload_width(3), dot_slots=4)
    N = dims.N
    ps = {k: torch.from_numpy(np.stack([v] * L))
          for k, v in t.init_state(dims, {}).items()}
    has = torch.zeros((L, N), dtype=torch.bool)
    rows = torch.zeros((L, N, PPAY + dims.P), dtype=torch.int32)
    fire = torch.zeros((L, N, dims.R), dtype=torch.bool)
    i32 = lambda v, *s: torch.full((L, *s), v, dtype=torch.int32)  # noqa: E731
    b = lambda v, *s: torch.full((L, *s), v, dtype=torch.bool)  # noqa: E731
    ctx = {"n": i32(N), "f": i32(1), "fast_quorum": b(True, N, N),
           "write_quorum": b(True, N, N), "expected_acks": i32(2),
           "fp_mode": i32(0), "ack_self": b(True),
           "client_attach": i32(0, 3)}
    return t, dims, ps, has, rows, fire, ctx


def test_graphdep_handle_work_idle_submit_gc_and_drain():
    t, dims, ps, has, rows, fire, ctx = _graphdep_idle()
    args = (ps, has, rows, fire, ctx, dims)
    out = _on_a_copy(graphdep_handle, *args)
    idle, idle_ops = gh_work(*args, out)
    L, N = has.shape
    P, D, Q, G = dims.P, dims.D, t.dep_slots(N), t.G
    # every process runs the drain: it reads the [N, D] committed flags,
    # the executed sets and the pick's client and attach entry
    drain = N * D + 4 * N * (1 + 2 * G) + 4 * 2
    assert idle == cost.nbytes(has, fire) + L * N * drain + L * N + \
        _outboxes_bytes(out)
    assert idle_ops == 40 * L * N + L * N * 2 * N * D
    # a SUBMIT at process 0 on key 0: reads its message, its sequence
    # and the key's latest dot; writes its sequence and the key's latest
    # sequence (its latest source, process 0, and the zeroed report
    # table do not change)
    has[0, 0] = True
    rows[0, 0, PMT] = AtlasDev.SUBMIT
    out = _on_a_copy(graphdep_handle, *args)
    n_bytes, _ = gh_work(*args, out)
    assert n_bytes == idle + 4 * (2 + P) + 4 * 3 + 4 * 2
    # a GC message from process 0 at process 2 (an all-zero frontier):
    # reads the frontier table, the seen flags, the committed and stable
    # clocks and the [N, D] dot words; changes one seen flag (process 1
    # has not been seen, so nothing is stable yet)
    has[1, 2] = True
    rows[1, 2, PMT] = AtlasDev.MGC
    out = _on_a_copy(graphdep_handle, *args)
    with_gc, ops = gh_work(*args, out)
    gc_read = 4 * N * N + N + 4 * 2 * N + 4 * N * D
    assert with_gc == n_bytes + 4 * (2 + P) + gc_read + 1
    assert ops == idle_ops + 2 * N * D + 3 * N * N
    # one committed vertex with no deps at process 1 of lane 0, its
    # drain disabled: the drain also reads its sequence, deps and their
    # vertex words, and checks its Q deps in one pass that changes
    # nothing
    ps["vx_committed"][0, 1, 2, 0] = True
    ps["vx_seq"][0, 1, 2, 0] = 1
    out = _on_a_copy(graphdep_handle, *args)
    with_vertex, vops = gh_work(*args, out)
    assert with_vertex == with_gc + 4 * (1 + 3 * Q)
    assert vops == ops + Q * (2 * G + 6) + Q * 3
    # a firing GC timer reads the committed clock
    fire[0, 1, 0] = True
    out = _on_a_copy(graphdep_handle, *args)
    with_timer, _ = gh_work(*args, out)
    assert with_timer == with_vertex + 4 * N

def _atlas_partial_idle(L=2):
    """Two shards of two rows; every command of both clients is key 0,
    alone on shard 0."""
    t = AtlasPartialDev(keys=2, shards=2, keys_per_cmd=2, gap_slots=2,
                        req_buffer=2)
    dims = EngineDims.for_partial(t, 2, 2, 3)
    N, C, S = dims.N, dims.C, t.S
    ps = {k: torch.from_numpy(np.stack([v] * L))
          for k, v in t.init_state(dims, {"n": 2}).items()}
    has = torch.zeros((L, N), dtype=torch.bool)
    rows = torch.zeros((L, N, PPAY + dims.P), dtype=torch.int32)
    fire = torch.zeros((L, N, dims.R), dtype=torch.bool)
    i32 = lambda v, *s: torch.full((L, *s), v, dtype=torch.int32)  # noqa: E731
    b = lambda v, *s: torch.full((L, *s), v, dtype=torch.bool)  # noqa: E731
    skey = i32(-1, C, 4, S, 2)
    skey[..., 0, 0] = 0
    ctx = {"n": i32(2), "f": i32(1), "expected_acks": i32(2),
           "fp_mode": i32(0), "ack_self": b(True),
           "fast_quorum": b(True, N, N), "write_quorum": b(True, N, N),
           "shard_of": torch.tensor([[0, 0, 1, 1]] * L, dtype=torch.int32),
           "closest": torch.tensor([[[0, 2]] * N] * L, dtype=torch.int32),
           "client_attach_s": torch.tensor([[[0, 2], [1, 3]]] * L,
                                           dtype=torch.int32),
           "cmd_kmask": i32(1, C, 4), "cmd_skey": skey}
    return t, dims, ps, has, rows, fire, ctx


def test_atlas_partial_handle_work_idle_submit_gc_drain_and_tick():
    t, dims, ps, has, rows, fire, ctx = _atlas_partial_idle()
    args = (ps, has, rows, fire, ctx, dims)
    out = _on_a_copy(atlas_partial_handle, *args)
    idle, idle_ops = ap_work(*args, out)
    L, N = has.shape
    P, D, G, S, KPC = dims.P, dims.D, t.G, t.S, t.KPC
    QS = t.q_union(2)
    assert idle == cost.nbytes(has, fire) + L * N + _outboxes_bytes(out)
    assert idle_ops == 40 * L * N
    # a SUBMIT of client 0's first command at process 0: reads its
    # message, its sequence, the command's table row (mask and S × KPC
    # keys) and both keys' latest (src, seq, km) deps; writes its
    # sequence and key 0's latest sequence and shard mask (its latest
    # source, process 0, and the zeroed tables do not change)
    has[0, 0] = True
    rows[0, 0, PMT] = AtlasPartialDev.SUBMIT
    rows[0, 0, PPAY + 1] = 1
    out = _on_a_copy(atlas_partial_handle, *args)
    n_bytes, _ = ap_work(*args, out)
    cmd = 4 * (1 + S * KPC)
    keys = 4 * 3 * KPC
    assert n_bytes == idle + 4 * (2 + P) + 4 * 3 + cmd + keys + 4 * 3
    # a GC message from process 1 at process 0 of lane 1 (an all-zero
    # frontier): reads the frontier table, the seen flags, the committed
    # and stable clocks and the [N, D] dot words; changes one seen flag
    has[1, 0] = True
    rows[1, 0, PMT] = AtlasPartialDev.MGC
    rows[1, 0, PSRC] = 1
    out = _on_a_copy(atlas_partial_handle, *args)
    with_gc, ops = ap_work(*args, out)
    gc_read = 4 * N * N + N + 4 * 2 * N + 4 * N * D
    assert with_gc == n_bytes + 4 * (2 + P) + gc_read + 1
    assert ops == idle_ops + 2 * N * D + 3 * N * N
    # an MDRAIN at process 2 of lane 0, whose one committed vertex (no
    # deps) executes: the drain reads the [N, D] committed flags, the
    # executed sets, the pick's vertex words and client row, and the
    # vertex's sequence, dep rows and their vertex and request words;
    # it writes the vertex's flag and sequence and the executed clock,
    # after one relaxation pass that changes nothing
    ps["vx_committed"][0, 2, 3, 0] = True
    ps["vx_seq"][0, 2, 3, 0] = 1
    has[0, 2] = True
    rows[0, 2, PMT] = AtlasPartialDev.MDRAIN
    out = _on_a_copy(atlas_partial_handle, *args)
    with_drain, dops = ap_work(*args, out)
    assert out[1]["exec_front"][0, 2, 3] == 1
    drain = N * D + 4 * N * (1 + 2 * G) + 4 * (5 + 3 * QS) + cmd
    assert with_drain == (with_gc + 4 * (2 + P) + drain
                          + 4 * (1 + 5 * QS) + 1 + 4 + 4)
    assert dops == ops + 4 * N * D + QS * (2 * G + 12) + QS * 3
    # the cleanup tick at process 1 of lane 1 with one buffered request
    # for a dot it does not know: reads the buffer, the dot's vertex
    # words and dep rows and the source's executed set; the GC timer at
    # the same process reads the committed clock
    ps["breq_from"][1, 1, 0] = 1
    ps["breq_src"][1, 1, 0] = 3
    ps["breq_seq"][1, 1, 0] = 2
    fire[1, 1] = True
    out = _on_a_copy(atlas_partial_handle, *args)
    with_tick, _ = ap_work(*args, out)
    assert not out[2]["valid"][1, 1, N + 1]
    assert with_tick == (with_drain + 4 * N + 4 * t.B
                         + 4 * (5 + 3 * QS) + 4 * (1 + 2 * G))


def _caesar_idle(L=2):
    t = CaesarDev(keys=2, key_slots=4, dep_slots=4, blocker_slots=2,
                  gap_slots=2, exec_buffer=4)
    dims = EngineDims.for_protocol(t, n=3, clients=3,
                                   payload=t.payload_width(3), dot_slots=4)
    N = dims.N
    ps = {k: torch.from_numpy(np.stack([v] * L))
          for k, v in t.init_state(dims, {}).items()}
    has = torch.zeros((L, N), dtype=torch.bool)
    rows = torch.zeros((L, N, PPAY + dims.P), dtype=torch.int32)
    fire = torch.zeros((L, N, dims.R), dtype=torch.bool)
    i32 = lambda v, *s: torch.full((L, *s), v, dtype=torch.int32)  # noqa: E731
    ctx = {"n": i32(N), "fq_size": i32(3), "wq_size": i32(2),
           "wait_condition": torch.ones((L,), dtype=torch.bool),
           "client_attach": i32(0, 3)}
    return t, dims, ps, has, rows, fire, ctx


def _caesar_call(ps, *rest):
    """K10 on a copy of ``ps`` (:func:`_on_a_copy`)."""
    return _on_a_copy(caesar_handle, ps, *rest)


def test_caesar_handle_work_idle_submit_and_gc():
    t, dims, ps, has, rows, fire, ctx = _caesar_idle()
    args = (ps, has, rows, fire, ctx, dims)
    out = _caesar_call(*args)
    idle, idle_ops = ch_work(*args, out)
    L, N = has.shape
    P, D, S, DEP, G = dims.P, dims.D, t.S, t.DEP, t.G
    # every process runs both scans: they read the [N, D] statuses, the
    # executed sets and the exec pick's client and attach entry
    scans = 4 * N * D + 4 * N * (1 + 2 * G) + 4 * 2
    assert idle == cost.nbytes(has, fire) + L * N * scans + L * N + \
        _outboxes_bytes(out)
    assert idle_ops == 40 * L * N + L * N * 2 * N * D
    # a SUBMIT at process 0 on key 0: reads its message, its sequence and
    # clock; writes both (the quorum bookkeeping of slot 0 is unchanged)
    has[0, 0] = True
    rows[0, 0, PMT] = CaesarDev.SUBMIT
    out = _caesar_call(*args)
    n_bytes, _ = ch_work(*args, out)
    assert n_bytes == idle + 4 * (2 + P) + 4 * 2 + 4 * 2
    # an MGC at process 2 of lane 1 with one sighting of dot (0, 1),
    # which it holds: reads the message and, for the dot, its words and
    # the key row's clocks; writes its sighting count (1 of n = 3)
    ps["pseq"][1, 2, 0, 0] = 1
    has[1, 2] = True
    rows[1, 2, PMT] = CaesarDev.MGC
    rows[1, 2, PPAY:PPAY + 3] = torch.tensor([1, 0, 1])
    out = _caesar_call(*args)
    with_gc, ops = ch_work(*args, out)
    assert bool(out[0][1, 2]) and int(out[1]["gc_cnt"][1, 2, 0, 0]) == 1
    assert with_gc == n_bytes + 4 * (2 + P) + 4 * (5 + 2 * S) + 4
    assert ops == idle_ops
    # a committed dot with no deps at process 1 of lane 0, its exec scan
    # disabled: the scan also reads its clock and its dep cells, and
    # checks its DEP deps
    ps["status"][0, 1, 2, 0] = 5                         # ST_COMMIT
    ps["pseq"][0, 1, 2, 0] = 1
    out = _caesar_call(*args)
    with_dot, dops = ch_work(*args, out)
    assert with_dot == with_gc + 4 * (2 + 6 * DEP)
    assert dops == ops + DEP * (2 * G + 8)
    # a firing notification timer reads the (empty) executed buffer
    fire[0, 1, 1] = True
    out = _caesar_call(*args)
    with_timer, _ = ch_work(*args, out)
    assert with_timer == with_dot + 4


def _emit_case():
    """One lane, N = 2, C = 2, F = 3: all rows empty but for process 0's
    handler slot 0, the result (TO_CLIENT) of client 0's first command."""
    dims = EngineDims(N=2, C=2, M=8, D=4, F=3, R=1, P=P, H=4, RR=2)
    N, C, F = dims.N, dims.C, dims.F
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32)  # noqa: E731
    b = lambda *s: torch.zeros(s, dtype=torch.bool)  # noqa: E731

    def outbox():
        return {"valid": b(1, N, F), "dst": i32(1, N, F),
                "mtype": i32(1, N, F), "payload": i32(1, N, F, P)}

    pout, hout = outbox(), outbox()
    hout["valid"][0, 0, 0] = True
    hout["dst"][0, 0, 0] = N + 0
    st = {
        "clients": {k: i32(1, C) for k in
                    ("issued", "completed", "start_time", "parts",
                     "part_max")},
        "metrics": {"hist": i32(1, dims.RR, dims.H),
                    "lat_sum": i32(1, dims.RR), "lat_count": i32(1, dims.RR),
                    "lat_log": torch.full((1, C, 64), -1, dtype=torch.int32)},
        "pair_cnt": i32(1, N, N),
        "next_periodic": torch.full((1, N, 1), INF, dtype=torch.int32),
        "requeues": i32(1), "max_completion": i32(1),
        "done_time": torch.full((1,), INF, dtype=torch.int32),
        "err": i32(1), "steps": i32(1), "fault_dropped": i32(1),
    }
    ctx = {
        "periodic_intervals": torch.full((1, 1), 100, dtype=torch.int32),
        "client_delay": torch.full((1, C, N), 3, dtype=torch.int32),
        "delay_pp": i32(1, N, N), "key_table": i32(1, C, 4),
        "cmd_budget": torch.tensor([[1, 0]], dtype=torch.int32),
        "client_attach": i32(1, C), "client_region_row": i32(1, C),
    }
    ep = torch.full((1, N), 5, dtype=torch.int32)
    args = (st, ctx, ep, b(1, N, 1), b(1, N), b(1, N), i32(1, N, 8 + P),
            pout, hout, i32(1, N), dims, 0)
    return args, hout


def test_emit_rewrite_work_counts_a_completion():
    args, hout = _emit_case()
    out = _emit_on_a_copy(*args)
    n_bytes, ops = er_work(*args, 0, out)
    # the lane's flags, times, error words, outbox flags and small state
    # and ctx planes (the histogram and latency log apart): 162 bytes;
    # the result row's words, its client delay, the issued SUBMIT's key
    # and delay, and the histogram word it increments
    read = 162 + 4 * (2 + P) + 4 + 8 + 4
    # the landing SUBMIT row (its latency is 5 + 3 = 8 ms) and every
    # valid flag; issued, completed, start time, histogram word,
    # lat_sum, lat_count, lat_log, max_completion, done time and steps
    write = 4 * (8 + P) + 14 + 10 * 4
    assert out[1].sum() == 1 and out[2]["done_time"].tolist() == [8]
    assert n_bytes == read + write
    assert ops == 14 * (7 + 2 * 2 + 2 + 32)
    # with no result at all only the step counter changes
    hout["valid"][:] = False
    out = _emit_on_a_copy(*args)
    assert er_work(*args, 0, out)[0] == 162 + 14 + 4


def _open_case(window=2):
    """``_emit_case`` with open-loop clients: the arrival table (client
    0's first command arrived at 2 ms), an empty ring of ``window``
    completion times and the release clamps."""
    args, hout = _emit_case()
    st, ctx = args[0], args[1]
    C = args[10].C
    st["clients"].update(
        ol_comp_t=torch.zeros((1, C, window), dtype=torch.int32),
        ol_last_rel=torch.full((1, C), 2, dtype=torch.int32))
    ctx["ol_arrival"] = torch.tensor([[[2, 2, 6, 9], [1, 1, 4, 8]]],
                                     dtype=torch.int32)
    return args, hout


def test_emit_rewrite_work_counts_the_open_loop_client():
    """Under ``FLAG_OPEN_LOOP`` each process gains its stage row (16 rows,
    not 14) and the result completes client 0's command without an issue
    (its budget is spent): the latency runs from the arrival (8 - 2 = 6
    ms), the ring takes the completion time. Reads add the old ring and
    clamps, each process's popped type, sender and seq and the result's
    arrival; writes the ring word; operations the result's rank and the
    ring."""
    from fantoch_tpu_torch.engine import faults as fm

    args, _hout = _open_case()
    out = _emit_on_a_copy(*args, fm.FLAG_OPEN_LOOP)
    new_rows, valid, upd = out
    assert new_rows.shape[1] == 16 and valid.sum() == 0
    assert upd["clients"]["completed"].tolist() == [[1, 0]]
    assert upd["clients"]["issued"].tolist() == [[0, 0]]
    assert upd["clients"]["ol_comp_t"].tolist() == [[[8, 0], [0, 0]]]
    assert upd["metrics"]["lat_sum"].tolist() == [[6, 0]]
    assert upd["metrics"]["lat_log"][0, 0, 0] == 6
    n_bytes, ops = er_work(*args, fm.FLAG_OPEN_LOOP, out)
    # the closed case's 162 bytes of planes and flags, the ring and
    # clamps (2 x 2 + 2 words), the result's words, client delay and
    # histogram word; per process its popped type, sender and seq, the
    # result's arrival
    read = 162 + 4 * 6 + 4 * (2 + P) + 4 + 4 + 12 * 2 + 4
    # 16 valid flags; completed, the histogram word, lat_sum, lat_count,
    # lat_log, the ring word, max_completion, done time and steps
    write = 16 + 9 * 4
    assert n_bytes == read + write
    assert ops == 16 * (8 + 2 * 2 + 2 + 32) + 16 + 2 * 2


def test_emit_rewrite_work_counts_the_think_delay():
    """Under ``FLAG_THINK`` the issued SUBMIT leaves its epoch's think
    delay later and K6 reads its epoch and delay (8 bytes)."""
    from fantoch_tpu_torch.engine import faults as fm

    args, _hout = _emit_case()
    ctx = args[1]
    ctx["cmd_budget"] = torch.tensor([[2, 0]], dtype=torch.int32)
    plain = _emit_on_a_copy(*args)
    ctx.update(traffic_seq_epoch=torch.tensor([[0, 0, 1, 1]],
                                              dtype=torch.int32),
               traffic_think=torch.tensor([[4, 7]], dtype=torch.int32))
    out = _emit_on_a_copy(*args, fm.FLAG_THINK)
    row = out[1][0].nonzero()[0, 0]
    # the SUBMIT of seq 1 is in epoch 0: 4 ms later
    assert out[0][0, row, PA] == plain[0][0, row, PA] + 4
    assert er_work(*args, fm.FLAG_THINK, out)[0] == (
        er_work(*args, 0, plain)[0] + 8)


def test_land_emissions_work_counts_the_running_word():
    """K2 reports the run predicate, a byte a lane: ``work`` counts it
    with or without a cap. Lane 0 is frozen (its error word set), so K6
    delivered nothing for it; lane 1 lands one row."""
    from fantoch_tpu_torch.kernels.lane_freeze import Cap

    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    pool = torch.zeros((2, 2, W), dtype=torch.int32)
    pool[:, :, PA] = INF
    arrival = pool[..., PA].clone()
    dl = torch.tensor([[False], [True]])
    rows = torch.ones((2, 1, W), dtype=torch.int32)
    peak, err = i32([0, 0]), i32([0, 0])
    old = {"done_time": i32([INF, INF]), "now": i32([3, 3]),
           "err": i32([8, 0]), "steps": i32([1, 1])}
    cap = Cap(old, {"extra_time": i32([10, 10])}, 100)
    a = (pool, arrival, dl, rows, peak, err, None, None, 0)
    out = land_emissions(pool.clone(), *a[1:], cap)
    assert out[4].tolist() == [False, True]
    free = land_emissions(pool.clone(), *a[1:])
    assert free[4].tolist() == [True, True]
    n_bytes, n_ops = le_work(*a, cap, out)
    # the free mask, deliver, the peak and error words, the landing row
    # read and written; overflow, peak, error word and running written
    read = 2 * 2 * 4 + 2 + 2 * 4 + 2 * 4 + 4 * W
    assert n_bytes == read + 4 * W + 2 + 2 * 4 + 2 * 4 + 2
    assert le_work(*a, free) == (n_bytes, n_ops)


def test_work_counts_the_fault_planes_under_their_flags():
    """Under the fault flags each module's ``work`` adds what the fault
    branches need: K1 the crash times, the masked timers it writes and
    the horizon; K6 the horizon and unavailability words, the windows,
    the wire keys and rates, the lost count and one threefry chain of 7
    blocks per wire hop and draw."""
    from fantoch_tpu_torch.engine import faults as fm
    from fantoch_tpu_torch.kernels.key_table import THREEFRY_OPS

    # K1: one crash time per process, the masked [1, 2, 1] timers
    pool = torch.zeros((1, 4, W), dtype=torch.int32)
    pool[0, :, PA] = torch.tensor([3, 3, 9, INF])
    pool[0, :, PDST] = torch.tensor([0, 0, 1, 0])
    timers = torch.full((1, 2, 1), INF, dtype=torch.int32)
    lookahead = torch.full((1, 2, 2), INF, dtype=torch.int32)
    crash, horizon = torch.full((1, 2), INF, dtype=torch.int32), \
        torch.full((1,), INF, dtype=torch.int32)
    base = qp_work(pool, timers, lookahead, None, None, 0,
                   qualify_pop(pool, timers, lookahead))
    flags = fm.FLAG_CRASH | fm.FLAG_HORIZON
    out = qualify_pop(pool, timers, lookahead, crash, horizon, flags)
    got = qp_work(pool, timers, lookahead, crash, horizon, flags, out)
    assert got[0] == base[0] + 8 + 8 + 4
    assert got[1] == base[1] + 4 + 2

    # K6: a wire hop from process 0 to 1 beside the completing result
    args, hout = _emit_case()
    hout["valid"][0, 0, 1] = True
    hout["dst"][0, 0, 1] = 1
    st, ctx = args[0], args[1]
    ctx.update({k: torch.zeros((1, 8), dtype=torch.int32) for k in
                ("fault_win_src", "fault_win_dst", "fault_win_t0",
                 "fault_win_t1", "fault_win_mul", "fault_win_ovr")})
    key = torch.zeros((1, 2), dtype=torch.uint32)
    ctx.update(fault_horizon=torch.full((1,), INF, dtype=torch.int32),
               fault_unavail=torch.zeros((1,), dtype=torch.int32),
               fault_drop_key=key, fault_jitter_key=key,
               fault_drop_num=torch.zeros((1,), dtype=torch.int32),
               fault_jitter_num=torch.ones((1,), dtype=torch.int32))
    plain = er_work(*args, 0, _emit_on_a_copy(*args))
    flags = (fm.FLAG_CRASH | fm.FLAG_HORIZON | fm.FLAG_WINDOWS
             | fm.FLAG_DROPS | fm.FLAG_JITTER)
    got = er_work(*args, flags, _emit_on_a_copy(*args, flags))
    assert got[0] == plain[0] + 4 + 4 + 6 * 32 + 2 * (8 + 4) + 4
    assert got[1] == plain[1] + 8 * 8 + 2 * 7 * THREEFRY_OPS

    # K1 under the crash flag with lane 0 frozen: the frozen lane's
    # timers are its input timers, copied (read and written like a
    # running lane's masked ones), not INF
    from fantoch_tpu_torch.kernels.lane_freeze import Cap

    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    pool2 = pool.expand(2, -1, -1).clone()
    timers2 = torch.tensor([[[7], [12]], [[7], [12]]], dtype=torch.int32)
    look2 = lookahead.expand(2, -1, -1).clone()
    # process 1 crashes at 10: its timer (12) masks, slot 2 (9) stays
    crash2 = torch.tensor([[INF, 10], [INF, 10]], dtype=torch.int32)
    old = {"done_time": i32([INF, INF]), "now": i32([3, 3]),
           "err": i32([8, 0]), "steps": i32([1, 1])}
    cap = Cap(old, {"extra_time": i32([10, 10])}, 100, fm.FLAG_CRASH)
    a = (pool2, timers2, look2, crash2, None, fm.FLAG_CRASH)
    out = qualify_pop(*a, cap)
    assert out[8][0].tolist() == [[7], [12]]    # frozen: as it was
    assert out[8][1].tolist() == [[7], [INF]]   # process 1 crashed
    cap0 = cap._replace(flags=0)
    plain = qp_work(*a[:5], 0, cap0, qualify_pop(*a[:5], 0, cap0))
    got = qp_work(*a, cap, out)
    # the crash times read, every lane's timers written (4 words), and
    # a compare a slot and a timer
    assert got[0] == plain[0] + 2 * 8 + 4 * 4
    assert got[1] == plain[1] + 2 * 4 + 4


def test_emit_rewrite_work_counts_the_monitor_fold():
    """Under ``FLAG_MONITOR`` K6 also reads the processes' guard words and
    the lane's violation word and step, writes the two that change (a
    premature bit on process 0: the word and the first step), and folds
    N words a lane."""
    from fantoch_tpu_torch.engine import faults as fm

    args, _hout = _emit_case()
    st = args[0]
    st.update(viol=torch.zeros(1, dtype=torch.int32),
              viol_step=torch.full((1,), INF, dtype=torch.int32))
    N = args[10].N
    flags_word = torch.zeros((1, N), dtype=torch.int32)
    flags_word[0, 0] = 1
    plain = er_work(*args, 0, _emit_on_a_copy(*args))
    out = _emit_on_a_copy(*args, fm.FLAG_MONITOR, flags_word)
    assert out[2]["viol"].tolist() == [8]
    assert out[2]["viol_step"].tolist() == [1]
    got = er_work(*args, fm.FLAG_MONITOR, flags_word, out)
    assert got[0] == plain[0] + 4 * N + 4 + 4 + 2 * 4
    assert got[1] == plain[1] + N + 4


def test_mon_finalize_work_counts_planes_words_and_the_order_test():
    """K13 reads each lane's two [N, K] planes once, its completed counts,
    its lane words and the digest's 2NK + 1 weights (under the crash and
    horizon flags also the crash times and the horizon), and writes three
    words a lane; its operations are a multiply-add a digest element, a
    few a process and, under MONITOR_ORDER, N*N*K compares of three
    operations."""
    from fantoch_tpu_torch.engine import faults as fm
    from fantoch_tpu_torch.kernels.mon_finalize import mon_finalize
    from fantoch_tpu_torch.kernels.mon_finalize import work as mf_work

    L, N, K, C = 2, 3, 4, 3
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32)  # noqa: E731
    st = {"mon_hash": i32(L, N, K), "mon_cnt": i32(L, N, K),
          "clients": {"completed": i32(L, C)}, "viol": i32(L),
          "viol_step": torch.full((L,), INF, dtype=torch.int32),
          "steps": i32(L), "done_time": i32(L), "err": i32(L),
          "fault_dropped": i32(L)}
    ctx = {"rows": torch.full((L,), N, dtype=torch.int32),
           "extra_time": i32(L), "fault_crash_t": i32(L, N),
           "fault_horizon": i32(L)}
    out = mon_finalize(st, ctx, 0, True)
    n_bytes, ops = mf_work(st, ctx, 0, True, out)
    lane_words = 4 * L * (6 + 2)   # 6 state words, extra time and rows
    assert n_bytes == (2 * 4 * L * N * K + 4 * L * C + lane_words
                       + 4 * (2 * N * K + 1) + 3 * 4 * L)
    assert ops == L * (4 * N * K + 8 * N + 3 * N * N * K)
    flags = fm.FLAG_CRASH | fm.FLAG_HORIZON
    got = mf_work(st, ctx, flags, False, out)
    assert got[0] == n_bytes + 4 * L * N + 4 * L
    assert got[1] == L * (4 * N * K + 8 * N)
