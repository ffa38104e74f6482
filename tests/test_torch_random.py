"""The port's threefry bits and key table equal the installed jax's bit
for bit: ``PRNGKey``/``fold_in``, and the plain twin of the
``key_table`` kernel against ``jax.vmap(key_table_fn(C, T))``."""

import itertools

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from fantoch_tpu.client.key_gen import zipf_weights
from fantoch_tpu.engine.core import key_table_fn
from fantoch_tpu_torch import random as rnd
from fantoch_tpu_torch.kernels.key_table import key_table, key_table_plain

C, T, K = 3, 12, 16


@pytest.mark.parametrize("seed", [0, 1, 7, 4242, (1 << 31) - 1])
def test_prngkey_and_fold_in_match_jax(seed):
    key = rnd.PRNGKey(seed)
    assert key.dtype == np.uint32
    np.testing.assert_array_equal(key, np.asarray(jr.PRNGKey(seed)))
    for data in [0, 1, 2, 0x5EED, 0xFA17, 123456789, (1 << 32) - 1]:
        np.testing.assert_array_equal(
            rnd.fold_in(key, data), np.asarray(jr.fold_in(key, data))
        )


def test_randint_and_uniform_match_jax():
    for seed, maxval in itertools.product(range(6), [1, 2, 3, 100, 65537]):
        key = rnd.fold_in(rnd.PRNGKey(seed), 9)
        k = key.astype(np.int64)
        got = rnd.randint2(k[0], k[1], np.int64(maxval))
        want = jr.randint(jnp.asarray(key), (), 0, maxval)
        assert int(got) == int(want), (seed, maxval)
        bits = np.array([rnd.uniform_bits(k[0], k[1])], np.int64)
        u = bits.astype(np.uint32).view(np.float32)[0] - np.float32(1)
        assert u == np.float32(jr.uniform(jnp.asarray(key), ())), seed


def _keygen_ctx():
    """One lane per (seed, conflict, pool size, generator kind)."""
    cum = np.cumsum(zipf_weights(K, 1.0)).astype(np.float32)
    lanes = list(itertools.product(
        range(3), [0, 10, 50, 100], [1, 3], [0, 1]
    ))
    return {
        "rng_key": np.stack([np.asarray(jr.PRNGKey(s)) for s, *_ in lanes]),
        "conflict_rate": np.array([c for _, c, _, _ in lanes], np.int32),
        "pool_size": np.array([p for _, _, p, _ in lanes], np.int32),
        "key_gen_kind": np.array([k for *_, k in lanes], np.int32),
        "zipf_cum": np.stack([cum] * len(lanes)),
    }


@pytest.fixture(scope="module")
def reference_table():
    ctx = _keygen_ctx()
    table = jax.jit(jax.vmap(key_table_fn(C, T)))(
        {k: jnp.asarray(v) for k, v in ctx.items()}
    )
    return ctx, np.asarray(table)


def test_key_table_twin_matches_jax(reference_table):
    ctx, want = reference_table
    got = key_table_plain(
        *(torch.from_numpy(ctx[k]) for k in
          ("rng_key", "conflict_rate", "pool_size", "key_gen_kind",
           "zipf_cum")),
        C, T,
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # both generator kinds and a spread of keys are exercised
    assert len(np.unique(want)) > 5


def test_key_table_wrapper_runs_the_twin_on_cpu(reference_table):
    ctx, want = reference_table
    before = key_table.launches
    got = key_table(
        *(torch.from_numpy(ctx[k]) for k in
          ("rng_key", "conflict_rate", "pool_size", "key_gen_kind",
           "zipf_cum")),
        C, T,
    )
    np.testing.assert_array_equal(got.numpy(), want)
    assert key_table.launches == before  # no kernel on the CPU


@pytest.mark.parametrize("seed", [0, 3, 255])
def test_lane_keys_match_reference(seed):
    from fantoch_tpu.core import Config as RConfig
    from fantoch_tpu.core import Planet as RPlanet
    from fantoch_tpu.engine import EngineDims as RDims
    from fantoch_tpu.engine import make_lane as r_make_lane
    from fantoch_tpu.engine.protocols import BasicDev as RBasic
    from fantoch_tpu_torch.core import Config, Planet
    from fantoch_tpu_torch.engine import EngineDims, make_lane
    from fantoch_tpu_torch.engine.protocols import BasicDev

    regions = ["asia-east1", "us-central1", "us-west1"]
    kw = dict(
        conflict_rate=50, commands_per_client=2, clients_per_region=1,
        process_regions=regions, client_regions=regions, seed=seed,
    )
    rd = RDims.for_protocol(RBasic, n=3, clients=3, payload=3)
    pd = EngineDims.for_protocol(BasicDev, n=3, clients=3, payload=3)
    ref = r_make_lane(RBasic, RPlanet.new(), RConfig(n=3, f=1), dims=rd, **kw)
    port = make_lane(BasicDev, Planet.new(), Config(n=3, f=1), dims=pd, **kw)
    for k in ("rng_key", "reorder_key", "fault_drop_key", "fault_jitter_key"):
        assert port.ctx[k].dtype == ref.ctx[k].dtype == np.uint32
        np.testing.assert_array_equal(port.ctx[k], ref.ctx[k])


@pytest.mark.parametrize("seed, steps, shape", [
    (0, 0, (3, 65)), (5, 17, (3, 44)), (4242, 3559, (3, 1060)),
])
def test_shaped_uniform_matches_jax(seed, steps, shape):
    """The reorder draws' source: ``jax.random.uniform(fold_in(key,
    steps), shape, maxval=10.0)``, whose bits are ``y0 ^ y1`` of
    ``threefry2x32(key, (0, i))`` over the flat index ``i``; and the
    twin's torch form of it (``emit_rewrite.reorder_draws``)."""
    from fantoch_tpu_torch.kernels.emit_rewrite import reorder_draws

    reorder_key = rnd.fold_in(rnd.PRNGKey(seed), 0x5EED)
    key = rnd.fold_in(reorder_key, steps)
    want = np.asarray(jr.uniform(jnp.asarray(key), shape, maxval=10.0))
    got = rnd.uniform(key, shape, 10.0)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    k = key.astype(np.int64)
    i = np.arange(int(np.prod(shape)), dtype=np.int64)
    np.testing.assert_array_equal(
        rnd.bits_at(k[0], k[1], i),
        np.asarray(jr.bits(jnp.asarray(key), (i.size,))).astype(np.int64))
    draws = reorder_draws(
        torch.from_numpy(np.stack([reorder_key] * 2)),
        torch.tensor([steps, steps], dtype=torch.int32), shape[1],
    )
    np.testing.assert_array_equal(
        draws[1].numpy().view(np.uint32), want.view(np.uint32))


def test_randint_with_per_element_maxval_matches_jax():
    """``randint2`` with an array of bounds (jitter's ``max(jmax, 1)``
    per lane), bounds below 1 included, against ``jax.random.randint``
    with the same array."""
    keys = np.stack([rnd.fold_in(rnd.PRNGKey(s), 0x717E) for s in range(8)])
    maxval = np.array([1, 2, 3, 8, 0, -4, 10_000, 65_537], np.int32)
    want = jax.vmap(lambda k, m: jr.randint(k, (), 0, m))(
        jnp.asarray(keys), jnp.asarray(maxval))
    k = keys.astype(np.int64)
    got = rnd.randint2(k[:, 0], k[:, 1], maxval.astype(np.int64))
    np.testing.assert_array_equal(got, np.asarray(want).astype(np.int64))
