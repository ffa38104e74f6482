"""The safety monitors' plain twins (``fantoch_tpu_torch/engine/monitor.py``)
against the reference's ``fantoch_tpu/engine/monitor.py`` on random
inputs made with numpy: ``_digest_weights``, ``cov_digest`` (with values
whose products and sums overflow 32 bits), ``mon_exec`` (keys in and out
of range, the premature guard), ``step_viol`` and ``finalize_lane``
(the crash and horizon flags, ``MONITOR_ORDER`` on and off, lossy and
clean lanes) — K13 ``mon_finalize``'s wrapper on CPU tensors is the
twin. The reference runs under ``jax.vmap`` over the lanes (and
processes). Tolerance: none (integer arithmetic mod 2^32)."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fantoch_tpu.engine import monitor as rmon
from fantoch_tpu.engine.faults import FaultFlags as RFlags
from fantoch_tpu_torch.engine import monitor as mon
from fantoch_tpu_torch.engine.faults import FLAG_CRASH, FLAG_HORIZON
from fantoch_tpu_torch.kernels.mon_finalize import mon_finalize

INF = 1 << 30
I32 = np.int32


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_constants_and_names_match():
    assert mon.HASH_MUL == rmon.HASH_MUL
    assert mon.VIOL_NAMES == rmon.VIOL_NAMES
    assert (mon.MON_F_PREMATURE, mon.MON_F_KEYRANGE) == (
        rmon.MON_F_PREMATURE, rmon.MON_F_KEYRANGE)
    for code in (0, 1, 5, 31, 64):
        assert mon.viol_names(code) == rmon.viol_names(code)


@pytest.mark.parametrize("length", [1, 6, 60, 2 * 5 * 11])
def test_digest_weights_match(length):
    got = mon._digest_weights(length)
    want = rmon._digest_weights(length)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("seed,extreme", [(0, False), (1, True), (2, True)])
def test_cov_digest_matches_with_overflow(seed, extreme):
    rng = np.random.default_rng(seed)
    L, N, K = 5, 4, 7
    lo, hi = (-(1 << 31), (1 << 31) - 1) if extreme else (0, 50)
    h = rng.integers(lo, hi, size=(L, N, K), endpoint=True).astype(I32)
    c = rng.integers(lo, hi, size=(L, N, K), endpoint=True).astype(I32)
    if extreme:
        h[0] = np.iinfo(np.int32).min
        c[0] = np.iinfo(np.int32).max
        h[1] = 0
        c[1] = 0
    want = np.asarray(jax.vmap(rmon.cov_digest)(jnp.asarray(h),
                                                jnp.asarray(c)))
    got = mon.cov_digest(_t(h), _t(c)).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mon_exec_matches(seed):
    rng = np.random.default_rng(seed)
    L, N, K = 4, 3, 5
    ps = {
        "_mon_hash": rng.integers(-(1 << 31), (1 << 31) - 1,
                                  size=(L, N, K)).astype(I32),
        "_mon_cnt": rng.integers(0, 9, size=(L, N, K)).astype(I32),
        "_mon_flags": rng.integers(0, 4, size=(L, N)).astype(I32),
    }
    key = rng.integers(-2, K + 2, size=(L, N)).astype(I32)
    src = rng.integers(0, N, size=(L, N)).astype(I32)
    seq = rng.integers(0, 1 << 20, size=(L, N)).astype(I32)
    enable = rng.random((L, N)) < 0.7
    premature = rng.random((L, N)) < 0.5

    def one(p, k, s, q, e, pm):
        return rmon.mon_exec(p, k, s, q, e, premature=pm)

    flat = {k: jnp.asarray(v.reshape((L * N,) + v.shape[2:]))
            for k, v in ps.items()}
    want = jax.vmap(one)(flat, *(jnp.asarray(x.reshape(-1)) for x in
                                 (key, src, seq, enable, premature)))
    got = mon.mon_exec({k: _t(v) for k, v in ps.items()}, _t(key), _t(src),
                       _t(seq), _t(enable), _t(premature))
    for k in ps:
        assert np.array_equal(got[k].numpy().reshape(L * N, -1),
                              np.asarray(want[k]).reshape(L * N, -1)), k


def test_mon_exec_without_planes_is_a_no_op():
    ps = {"err": torch.zeros((2, 3), dtype=torch.int32)}
    assert mon.mon_exec(ps, 0, 0, 1, True) is ps


@pytest.mark.parametrize("seed", [0, 1])
def test_step_viol_matches(seed):
    rng = np.random.default_rng(seed)
    L, N = 6, 5
    st = {
        "viol": rng.choice([0, 0, 1, 8], size=L).astype(I32),
        "viol_step": rng.choice([INF, INF, 17], size=L).astype(I32),
        "steps": rng.integers(0, 1000, size=L).astype(I32),
    }
    flags = (rng.random((L, N)) < 0.15) * rng.integers(1, 4, size=(L, N))
    flags = flags.astype(I32)
    want = jax.vmap(rmon.step_viol)(
        {k: jnp.asarray(v) for k, v in st.items()}, jnp.asarray(flags))
    got = mon.step_viol({k: _t(v) for k, v in st.items()}, _t(flags))
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))


def _final_case(rng, L=8, N=4, K=3, C=5):
    """A batch of final lane states: equal and unequal per-key counts and
    hashes, clean and lossy, crashed and horizon-cut lanes."""
    total = rng.integers(0, 12, size=L)
    cnt = np.repeat(total[:, None, None] // K, N, 1).repeat(K, 2)
    cnt = cnt.astype(I32)
    cnt[1, 0, 0] += 1  # a duplicate
    cnt[2, 1, 1] -= 1  # a missing execution
    h = rng.integers(-(1 << 31), (1 << 31) - 1, size=(L, 1, K))
    h = np.repeat(h, N, 1).astype(I32)
    h[3, 2, 0] += 1    # an order divergence at equal counts
    h[4, 0, 2] += 1    # ... on a lossy lane
    completed = np.zeros((L, C), I32)
    completed[:, 0] = (total // K) * K
    st = {
        "mon_hash": h, "mon_cnt": cnt,
        "viol": rng.choice([0, 0, 0, 8], size=L).astype(I32),
        "viol_step": rng.choice([INF, INF, 40], size=L).astype(I32),
        "steps": rng.integers(100, 900, size=L).astype(I32),
        "done_time": rng.choice([INF, 500, 900, INF - 3], size=L).astype(I32),
        "err": rng.choice([0, 0, 0, 16], size=L).astype(I32),
        "fault_dropped": np.asarray([0, 0, 0, 0, 3] + [0] * (L - 5), I32),
        "clients": {"completed": completed},
    }
    crash = np.full((L, N), INF, I32)
    crash[5, 1] = 300
    ctx = {
        "rows": rng.choice([N, N - 1], size=L).astype(I32),
        "fault_crash_t": crash,
        "extra_time": rng.choice([100, 1 << 30], size=L).astype(I32),
        "fault_horizon": rng.choice([INF, 1000, 600], size=L).astype(I32),
    }
    return st, ctx


@pytest.mark.parametrize("crash", [False, True])
@pytest.mark.parametrize("horizon", [False, True])
@pytest.mark.parametrize("order", [False, True])
def test_finalize_lane_matches(crash, horizon, order):
    st, ctx = _final_case(np.random.default_rng(7))
    N = st["mon_hash"].shape[1]
    protocol = SimpleNamespace(MONITOR_ORDER=order)
    faults = RFlags(crash=crash, horizon=horizon)
    rst = {"cov": jnp.zeros(8, jnp.int32),
           **jax.tree_util.tree_map(jnp.asarray, st)}
    want = jax.vmap(lambda s, c: rmon.finalize_lane(
        protocol, SimpleNamespace(N=N), s, c, faults, False))(
        rst, jax.tree_util.tree_map(jnp.asarray, ctx))
    flags = (FLAG_CRASH if crash else 0) | (FLAG_HORIZON if horizon else 0)
    tst = {k: ({kk: _t(vv) for kk, vv in v.items()} if isinstance(v, dict)
               else _t(v)) for k, v in st.items()}
    got = mon_finalize(tst, {k: _t(v) for k, v in ctx.items()}, flags, order)
    for a, name in zip(got, ("viol", "viol_step", "cov")):
        assert np.array_equal(a.numpy(), np.asarray(want[name])), name
    # every check acts somewhere in the batch
    if order:
        assert (got[0].numpy() & rmon.VIOL_ORDER).any()
    assert (got[0].numpy() & (rmon.VIOL_DUP | rmon.VIOL_MISSING)).any()
