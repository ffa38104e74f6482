"""The port's interval sets (``fantoch_tpu_torch/engine/iset.py``) against
the reference's (``fantoch_tpu/engine/iset.py``), exactly, on seeded
numpy inputs: ranges adjacent to the frontier, overlapping it or a gap,
out of order, below the frontier, empty (end < start), disabled; gap
buffers holding chains that one add absorbs pass after pass; and full
buffers that overflow. The reference's functions take one set; they
run under ``jax.vmap`` over the batch the port takes as leading axes."""

import jax
import numpy as np
import pytest
import torch

from fantoch_tpu.engine import iset as R
from fantoch_tpu_torch.engine import iset as P

G = 4
B = 512
SEEDS = [0, 1, 2, 3, 4]


def _sets(rng, b=B, g=G):
    """Frontiers and gap buffers: a chain of gaps above the frontier, each
    a short step past the last (some touching, so one add can absorb a
    chain), a share of free slots, and a share of full buffers."""
    front = rng.integers(0, 6, (b,)).astype(np.int32)
    gaps = np.zeros((b, g, 2), np.int32)
    lo = front + 1 + rng.integers(0, 3, (b,))
    for j in range(g):
        start = lo + rng.integers(0, 3, (b,))
        end = start + rng.integers(0, 3, (b,))
        keep = rng.random(b) < 0.7
        gaps[:, j, 0] = np.where(keep, start, 0)
        gaps[:, j, 1] = np.where(keep, end, 0)
        lo = np.where(keep, end + 1, lo)
    full = rng.random(b) < 0.15
    gaps[full, :, 0] = np.maximum(gaps[full, :, 0], 40 + np.arange(g))
    gaps[full, :, 1] = np.maximum(gaps[full, :, 1], gaps[full, :, 0])
    # slot order is not range order
    perm = np.argsort(rng.random((b, g)), axis=1)
    gaps = np.take_along_axis(gaps, perm[..., None], axis=1)
    return front, gaps


def _ranges(rng, front, b=B):
    start = (front + rng.integers(-3, 12, (b,))).astype(np.int32)
    end = (start + rng.integers(-2, 8, (b,))).astype(np.int32)
    enable = rng.random(b) < 0.9
    return start, end, enable


def _eq(got, want, what):
    got = got.numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("seed", SEEDS)
def test_add_range_matches_reference(seed):
    rng = np.random.default_rng(seed)
    front, gaps = _sets(rng)
    start, end, enable = _ranges(rng, front)
    want = jax.jit(jax.vmap(R.iset_add_range))(front, gaps, start, end,
                                                enable)
    got = P.iset_add_range(*(torch.from_numpy(a) for a in
                             (front, gaps, start, end, enable)))
    for name, g, w in zip(("frontier", "gaps", "overflow"), got, want):
        _eq(g, w, name)
    # the cases are reached: direct extensions, absorbed chains (the
    # frontier moves past the range's end), gap stores and overflows
    f1 = np.asarray(want[0])
    ovf = np.asarray(want[2])
    assert ovf.any() and not ovf.all()
    assert (f1 > np.maximum(front, end)).any()
    stored = (np.asarray(want[1]) != gaps).any((1, 2)) & (f1 == front)
    assert stored.any()


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_add_matches_reference_in_sequence(seed):
    """Single events added one after another, in a shuffled order, to a
    growing set (the GC committed clock's use): the state after each add
    equals the reference's."""
    rng = np.random.default_rng(seed)
    front, gaps = np.zeros((64,), np.int32), np.zeros((64, G, 2), np.int32)
    pf, pg = torch.from_numpy(front), torch.from_numpy(gaps)
    order = np.argsort(rng.random((64, 12)), axis=1).astype(np.int32) + 1
    add = jax.jit(jax.vmap(R.iset_add))
    for i in range(order.shape[1]):
        ev = order[:, i]
        front, gaps, ovf = (np.asarray(x) for x in add(front, gaps, ev))
        pf, pg, povf = P.iset_add(pf, pg, torch.from_numpy(ev))
        _eq(pf, front, f"frontier after {i + 1}")
        _eq(pg, gaps, f"gaps after {i + 1}")
        _eq(povf, ovf, f"overflow after {i + 1}")
    assert (front == 12).any()


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_contains_matches_reference(seed):
    rng = np.random.default_rng(seed)
    front, gaps = _sets(rng)
    x = rng.integers(-1, 30, (B, 7)).astype(np.int32)
    want = jax.jit(R.iset_contains)(front[:, None], gaps[:, None], x)
    got = P.iset_contains(torch.from_numpy(front)[:, None],
                          torch.from_numpy(gaps)[:, None],
                          torch.from_numpy(x))
    _eq(got, want, "contains")
    assert np.asarray(want).any() and not np.asarray(want).all()

    S = 9
    src = rng.integers(-2, S + 2, (B, 7)).astype(np.int32)
    want = jax.jit(R.iset_contains_gathered)(front[:S], gaps[:S], src, x)
    got = P.iset_contains_gathered(
        torch.from_numpy(front[:S]), torch.from_numpy(gaps[:S]),
        torch.from_numpy(src), torch.from_numpy(x),
    )
    _eq(got, want, "contains_gathered")


def test_empty_matches_reference():
    f, g = R.iset_empty(G)
    pf, pg = P.iset_empty(G)
    _eq(pf, f, "frontier")
    _eq(pg, g, "gaps")
    pf, pg = P.iset_empty(G, (3, 2))
    assert pf.shape == (3, 2) and pg.shape == (3, 2, G, 2)
    assert not bool(pg.any()) and pf.dtype == pg.dtype == torch.int32


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_contains_gathered_on_the_exec_sets_shapes(seed):
    """The graph drain's call: every (lane, process)'s executed sets
    ``[L, N, S]`` / ``[L, N, S, G, 2]`` against its vertex store's dep
    cells ``[L, N, S, D, Q]`` (sources out of range, negative ones
    counting from the end), as the reference's per-process call under
    ``vmap`` over lanes and processes; and a batch of no cells."""
    rng = np.random.default_rng(seed)
    L, N, D, Q = 4, 5, 6, 6
    front, gaps = _sets(rng, L * N * N)
    front = front.reshape(L, N, N)
    gaps = gaps.reshape(L, N, N, G, 2)
    src = rng.integers(-N - 1, N + 2, (L, N, N, D, Q)).astype(np.int32)
    x = rng.integers(0, 16, (L, N, N, D, Q)).astype(np.int32)
    want = jax.jit(jax.vmap(jax.vmap(R.iset_contains_gathered)))(
        front, gaps, src, x)
    got = P.iset_contains_gathered(*(torch.from_numpy(a) for a in
                                     (front, gaps, src, x)))
    _eq(got, want, "contains_gathered [L, N]")
    assert np.asarray(want).any() and not np.asarray(want).all()
    # the twin's sparse form: one batch row per committed vertex, here
    # none
    none = torch.zeros((0, Q), dtype=torch.int32)
    got = P.iset_contains_gathered(torch.from_numpy(front[0, :0]),
                                   torch.from_numpy(gaps[0, :0]), none, none)
    assert got.shape == (0, Q) and got.dtype == torch.bool
