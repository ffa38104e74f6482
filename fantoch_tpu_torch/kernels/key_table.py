"""K3 ``key_table``: every lane's (client, seq) → workload key table.

Replaces the static branch of ``fantoch_tpu/engine/core.py`` ``gen_key``
(:439-504) as ``key_table_fn`` (:560) and ``parallel/sweep.py:698-708``
batch it. CUDA source: ``csrc/key_table.cu`` (bound by integer
operations, :func:`work`). :func:`key_table_plain` is
its plain PyTorch twin, used for tensors on the CPU; both equal jax's
table bit for bit.
"""

from __future__ import annotations

import math

import torch

from .. import random as rnd
from . import build, cost

I32 = torch.int32

# 32-bit operations of one threefry2x32 block: 20 rounds of add, rotate
# and xor, 5 key injections of 3 adds, 2 initial adds
THREEFRY_OPS = 20 * 3 + 5 * 3 + 2


def key_table_plain(rng_key, conflict_rate, pool_size, key_gen_kind,
                    zipf_cum, C: int, T: int):
    """``[L, C, T]`` int32 keys: ConflictPool (kind 0) or Zipf (kind 1).
    rng_key ``[L, 2]`` uint32, zipf_cum ``[L, K]`` float32."""
    L, K = zipf_cum.shape
    dev = zipf_cum.device
    # reinterpret the u32 words as i32 (same width, any device) and widen
    k = rng_key.view(torch.int32).to(torch.int64) & rnd.MASK
    k0 = k[:, 0, None, None].expand(L, C, T)
    k1 = k[:, 1, None, None].expand(L, C, T)
    c = torch.arange(C, device=dev, dtype=torch.int64)[None, :, None]
    s = torch.arange(T, device=dev, dtype=torch.int64)[None, None, :]
    k0, k1 = rnd.fold_in2(k0, k1, c + k0 * 0)
    k0, k1 = rnd.fold_in2(k0, k1, s + k0 * 0)
    lane = lambda v: v.to(torch.int64)[:, None, None]  # noqa: E731
    hit = rnd.randint2(k0, k1, k0 * 0 + 100) < lane(conflict_rate)
    a0, a1 = rnd.fold_in2(k0, k1, k0 * 0 + 1)
    ps = lane(pool_size)
    pool_key = rnd.randint2(a0, a1, torch.clamp(ps, min=1) + k0 * 0)
    pool = torch.where(hit, pool_key, ps + c)
    u0, u1 = rnd.fold_in2(k0, k1, k0 * 0 + 2)
    u = rnd.uniform_bits(u0, u1).to(I32).view(torch.float32) - 1.0
    u = torch.clamp(u, min=0.0)
    # searchsorted(side="right") on a nondecreasing table
    zipf = (zipf_cum[:, None, None, :] <= u[..., None]).sum(-1)
    zipf = torch.clamp(zipf, max=K - 1)
    return torch.where(lane(key_gen_kind) == 0, pool, zipf).to(I32)


def work(rng_key, conflict_rate, pool_size, key_gen_kind, zipf_cum,
         C: int, T: int, out):
    """``(bytes, ops)`` the region needs on these inputs (``out`` is its
    table), counting the threefry blocks each key's value depends on:

    - a ConflictPool key needs the conflict draw (a ``randint``: split
      and two ``bits``, 4 blocks) unless the lane's rate is 0 or at least
      100, and the pool draw (a fold and a ``randint``, 5 blocks) only
      when it hit a pool of more than one key (a hit is a key below the
      pool size);
    - a Zipf key needs the fold of 2 and the ``uniform`` bits (2 blocks)
      and a binary search of the lane's cumulative table;
    - a key that needs any block needs its seq fold, and each client
      with such a key its client fold.

    Bytes: the lane scalars, the Zipf lanes' tables and the output."""
    L = out.shape[0]
    K = zipf_cum.shape[1]
    zipf = (key_gen_kind != 0)[:, None, None]
    cr, ps = conflict_rate[:, None, None], pool_size[:, None, None]
    pool_blocks = (
        4 * ((cr > 0) & (cr < 100)).to(I32)
        + 5 * ((out < ps) & (ps > 1)).to(I32)
    )
    blocks = torch.where(zipf, 2, pool_blocks.expand(L, C, T))
    blocks = blocks + (blocks > 0).to(I32)
    n_blocks = int(blocks.sum()) + int((blocks > 0).any(-1).sum())
    n_zipf = int((key_gen_kind != 0).sum())
    search = math.ceil(math.log2(K + 1))
    ops = THREEFRY_OPS * n_blocks + n_zipf * C * T * search
    n_bytes = (
        cost.nbytes(rng_key, conflict_rate, pool_size, key_gen_kind, out)
        + 4 * K * n_zipf
    )
    return n_bytes, ops


def key_table(rng_key, conflict_rate, pool_size, key_gen_kind, zipf_cum,
              C: int, T: int):
    """K3 on CUDA tensors, :func:`key_table_plain` on CPU tensors."""
    if zipf_cum.device.type == "cpu":
        return key_table_plain(
            rng_key, conflict_rate, pool_size, key_gen_kind, zipf_cum, C, T
        )
    L, K = zipf_cum.shape
    dev = zipf_cum.device
    build.check("rng_key", rng_key, torch.uint32, (L, 2), dev)
    build.check("conflict_rate", conflict_rate, I32, (L,), dev)
    build.check("pool_size", pool_size, I32, (L,), dev)
    build.check("key_gen_kind", key_gen_kind, I32, (L,), dev)
    build.check("zipf_cum", zipf_cum, torch.float32, (L, K), dev)
    out = torch.empty((L, C, T), dtype=I32, device=dev)
    fn = build.c_function("fantoch_key_table", 6, 4)
    build.launch(
        fn,
        [t.data_ptr() for t in (rng_key, conflict_rate, pool_size,
                                key_gen_kind, zipf_cum, out)],
        [L, C, T, K],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    key_table.launches += 1
    return out


key_table.launches = 0
