"""K3 ``key_table``: every lane's (client, seq) → workload key table.

Replaces ``fantoch_tpu/engine/core.py`` ``gen_key`` (:439-504) as
``key_table_fn`` (:560) and ``parallel/sweep.py:698-708`` batch it: the
static branch and, for lanes with a traffic schedule (``traffic`` of
:data:`TRAFFIC_KEYS`), the epoch branch (:459-476, :484-496): the
command's epoch ``traffic_seq_epoch[min(s, T - 1)]`` gives the conflict
rate and the rotated pool (``pool_base + randint(max(pool_size, 1))``,
private keys at ``traffic_pool_span + c``) and, on Zipf lanes with
``traffic_zipf_cum``, the epoch's cumulative row. CUDA source:
``csrc/key_table.cu`` (bound by integer operations, :func:`work`).
:func:`key_table_plain` is its plain PyTorch twin, used for tensors on
the CPU; both equal jax's table bit for bit.
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

# a traffic schedule's tables gen_key reads: the seq → epoch index
# ``[L, TE]``, the per-epoch conflict rate, pool base and pool size
# ``[L, Ep]``, the first private key ``[L]``; Zipf lanes under a schedule
# also carry ``traffic_zipf_cum`` ``[L, Ep, K]``
TRAFFIC_KEYS = ("traffic_seq_epoch", "traffic_conflict", "traffic_pool_base",
                "traffic_pool_size", "traffic_pool_span")


def traffic_tables(ctx):
    """The traffic tables of a batch's ctx for :func:`key_table`, or
    None on lanes without a schedule."""
    if "traffic_seq_epoch" not in ctx:
        return None
    keys = TRAFFIC_KEYS + (("traffic_zipf_cum",)
                           if "traffic_zipf_cum" in ctx else ())
    return {k: ctx[k] for k in keys}


def _epochs(traffic, T: int):
    """``[L, T]`` int64: the epoch of every seq (clamped to the table)."""
    tbl = traffic["traffic_seq_epoch"]
    s = torch.arange(T, device=tbl.device).clamp(max=tbl.shape[1] - 1)
    return tbl[:, s].long()


def key_table_plain(rng_key, conflict_rate, pool_size, key_gen_kind,
                    zipf_cum, C: int, T: int, traffic=None):
    """``[L, C, T]`` int32 keys: ConflictPool (kind 0) or Zipf (kind 1),
    under the epoch tables of ``traffic`` when given. rng_key ``[L, 2]``
    uint32, zipf_cum ``[L, K]`` float32."""
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
    if traffic is None:
        rate, base, size = lane(conflict_rate), 0, lane(pool_size)
        private = lane(pool_size) + c
    else:
        # the command's epoch picks the knobs
        e = _epochs(traffic, T)

        def knob(k):
            return torch.gather(traffic[k].long(), 1, e)[:, None, :]

        rate, base = knob("traffic_conflict"), knob("traffic_pool_base")
        size = knob("traffic_pool_size")
        private = lane(traffic["traffic_pool_span"]) + c
    hit = rnd.randint2(k0, k1, k0 * 0 + 100) < rate
    a0, a1 = rnd.fold_in2(k0, k1, k0 * 0 + 1)
    pool_key = base + rnd.randint2(a0, a1, torch.clamp(size, min=1) + k0 * 0)
    pool = torch.where(hit, pool_key, private)
    u0, u1 = rnd.fold_in2(k0, k1, k0 * 0 + 2)
    u = rnd.uniform_bits(u0, u1).to(I32).view(torch.float32) - 1.0
    u = torch.clamp(u, min=0.0)
    # searchsorted(side="right") on a nondecreasing table: the lane's,
    # or the row of the command's epoch
    if traffic is not None and "traffic_zipf_cum" in traffic:
        rows = traffic["traffic_zipf_cum"][
            torch.arange(L, device=dev)[:, None], _epochs(traffic, T)
        ]                                                     # [L, T, K]
        zipf = (rows[:, None] <= u[..., None]).sum(-1)
    else:
        zipf = (zipf_cum[:, None, None, :] <= u[..., None]).sum(-1)
    zipf = torch.clamp(zipf, max=K - 1)
    return torch.where(lane(key_gen_kind) == 0, pool, zipf).to(I32)


def work(rng_key, conflict_rate, pool_size, key_gen_kind, zipf_cum,
         C: int, T: int, *tail):
    """``(bytes, ops)`` the region needs on these inputs (``tail`` is
    ``(out,)`` or ``(traffic, out)``, ``out`` its table), counting the
    threefry blocks each key's value depends on:

    - a ConflictPool key needs the conflict draw (a ``randint``: split
      and two ``bits``, 4 blocks) unless the rate (the lane's, or its
      epoch's) is 0 or at least 100, and the pool draw (a fold and a
      ``randint``, 5 blocks) only when it hit a pool of more than one key
      (a hit is a key below the pool size, or under a schedule below its
      pool span);
    - a Zipf key needs the fold of 2 and the ``uniform`` bits (2 blocks)
      and a binary search of the lane's cumulative table (or its epoch's
      row);
    - a key that needs any block needs its seq fold, and each client
      with such a key its client fold.

    Bytes: the lane scalars, the Zipf lanes' tables, under a schedule its
    seq → epoch row and knob tables (and the Zipf rows), and the output."""
    *rest, out = tail
    traffic = rest[0] if rest else None
    L = out.shape[0]
    K = zipf_cum.shape[1]
    zipf = (key_gen_kind != 0)[:, None, None]
    if traffic is None:
        cr, ps = conflict_rate[:, None, None], pool_size[:, None, None]
        below = ps
    else:
        e = _epochs(traffic, T)
        cr, ps = (torch.gather(traffic[k], 1, e)[:, None, :]
                  for k in ("traffic_conflict", "traffic_pool_size"))
        below = traffic["traffic_pool_span"][:, None, None]
    pool_blocks = (
        4 * ((cr > 0) & (cr < 100)).to(I32)
        + 5 * ((out < below) & (ps > 1)).to(I32)
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
    if traffic is not None:
        n_bytes += cost.nbytes(*(traffic[k] for k in TRAFFIC_KEYS))
        if "traffic_zipf_cum" in traffic:
            n_bytes += (cost.nbytes(traffic["traffic_zipf_cum"])
                        * n_zipf // max(L, 1))
    return n_bytes, ops


def key_table(rng_key, conflict_rate, pool_size, key_gen_kind, zipf_cum,
              C: int, T: int, traffic=None):
    """K3 on CUDA tensors, :func:`key_table_plain` on CPU tensors;
    ``traffic`` (:func:`traffic_tables`) selects the epoch branch."""
    if zipf_cum.device.type == "cpu":
        return key_table_plain(
            rng_key, conflict_rate, pool_size, key_gen_kind, zipf_cum, C, T,
            traffic,
        )
    L, K = zipf_cum.shape
    dev = zipf_cum.device
    build.check("rng_key", rng_key, torch.uint32, (L, 2), dev)
    build.check("conflict_rate", conflict_rate, I32, (L,), dev)
    build.check("pool_size", pool_size, I32, (L,), dev)
    build.check("key_gen_kind", key_gen_kind, I32, (L,), dev)
    build.check("zipf_cum", zipf_cum, torch.float32, (L, K), dev)
    # the schedule's tables, or null pointers (static lanes)
    tables = [None] * 6
    TE = EP = 0
    if traffic is not None:
        TE = traffic["traffic_seq_epoch"].shape[1]
        EP = traffic["traffic_conflict"].shape[1]
        build.check("traffic_seq_epoch", traffic["traffic_seq_epoch"], I32,
                    (L, TE), dev)
        for k in TRAFFIC_KEYS[1:4]:
            build.check(k, traffic[k], I32, (L, EP), dev)
        build.check("traffic_pool_span", traffic["traffic_pool_span"], I32,
                    (L,), dev)
        tables = [traffic[k] for k in TRAFFIC_KEYS] + [None]
        if "traffic_zipf_cum" in traffic:
            build.check("traffic_zipf_cum", traffic["traffic_zipf_cum"],
                        torch.float32, (L, EP, K), dev)
            tables[5] = traffic["traffic_zipf_cum"]
    out = torch.empty((L, C, T), dtype=I32, device=dev)
    fn = build.c_function("fantoch_key_table", 12, 6)
    build.launch(
        fn,
        [t.data_ptr() for t in (rng_key, conflict_rate, pool_size,
                                key_gen_kind, zipf_cum, out)]
        + [0 if t is None else t.data_ptr() for t in tables],
        [L, C, T, K, TE, EP],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    key_table.launches += 1
    return out


key_table.launches = 0
