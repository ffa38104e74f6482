"""K2 ``land_emissions``: stream compaction of a step's emissions into
the free pool slots, in place.

Replaces ``fantoch_tpu/engine/core.py`` ``_lane_step`` section 6 (lines
1457-1492: ``cumsum_i32`` :99, ``searchsorted_left`` :125 and the row
scatter). CUDA source: ``csrc/land_emissions.cu`` (bound by bytes,
:func:`work`; exact int32 ranks from warp ballots — the reference's
f32-matmul cumsum is exact on this card's default tf32 path only up to
2^11). :func:`land_emissions_plain` is its plain PyTorch twin, used for
tensors on the CPU.

The pool is updated in place, like a donated buffer in JAX: the step
consumes its input state (the runners clone their caller's once, at
entry). Only the lanes whose run predicate holds at the step's start
are written (``cap``, :class:`lane_freeze.Cap`; every lane without
one), and the pool returned is the tensor given, so the device loop's
write-back skips it; a frozen lane's peak and error word are the ones
given. K2 also reports that predicate, ``running``, the run loop's
(the reference's ``_lane_running`` :1565 as ``build_runner``'s select
:1591 read it): the step's last kernel, it is where the loop learns
which lanes stepped.
"""

from __future__ import annotations

import ctypes

import torch

from ..engine.dims import ERR_POOL, INF, PA
from . import build, cost
from .lane_freeze import cap_args, cap_running

I32 = torch.int32
# threads of a block (csrc/land_emissions.cu THREADS)
THREADS = 512


def land_emissions_plain(pool, arrival, deliver, new_rows, pool_peak, err,
                         slot=None, has=None, flags: int = 0, cap=None):
    """``(pool, overflow, pool_peak, err, running)``: the k-th delivered row
    (in row order) lands in the k-th free slot (in index order) of
    ``pool``, in place; ranks past the free count drop and set
    ``ERR_POOL`` in the lane's error word. pool ``[L, M, W]``, arrival
    ``[L, M]`` (popped slots already freed), deliver ``[L, E]``,
    new_rows ``[L, E, W]``, err ``[L]``; ``slot``/``has`` (K1's popped
    slots) and ``flags`` tell the kernel which arrival words changed,
    which this twin need not know. A lane that ``cap`` freezes keeps
    its pool rows, and its overflow flag is false, its peak and error
    word the ones given; ``running`` ``[L]`` is the cap's predicate
    (every lane without one)."""
    del slot, has, flags
    L, M, W = pool.shape
    rank = torch.cumsum(deliver, dim=1, dtype=I32)          # 1-based
    free = arrival == INF
    free_cum = torch.cumsum(free, dim=1, dtype=I32)
    # how many free slots come before the rank-th one: the count of
    # free_cum entries below the rank (free_cum does not decrease)
    target = torch.searchsorted(free_cum, rank).to(I32)
    n_free = free.sum(1, dtype=I32)
    n_del = deliver.sum(1, dtype=I32)
    out = pool.clone()
    out[..., PA] = arrival
    li, ei = torch.nonzero(deliver & (target < M), as_tuple=True)
    out[li, target[li, ei].long()] = new_rows[li, ei]
    overflow = n_del > n_free
    peak = torch.maximum(pool_peak, M - n_free + n_del)
    new_err = err | ERR_POOL * overflow.to(I32)
    running = cap_running(cap)
    if running is None:
        pool.copy_(out)
        return pool, overflow, peak, new_err, torch.ones_like(overflow)
    pool[running] = out[running]
    return (pool, overflow & running, torch.where(running, peak, pool_peak),
            torch.where(running, new_err, err), running)


def work(pool, arrival, deliver, new_rows, pool_peak, err, *rest):
    """``(bytes, ops)`` the region needs on these inputs (``pool`` a
    snapshot taken before the call, which updates it in place; the last
    argument is the call's result, those before it the kernel's other
    arguments, which change nothing here). The region updates the pool:
    it reads the arrival column (the free mask), ``deliver`` and the
    rows that land, and writes the rows that land and the freed arrival
    words no landing row covers, besides the overflow flag, the peak,
    the error word and ``running``."""
    out = rest[-1]
    L, M, W = pool.shape
    free = arrival == INF
    n_del = deliver.sum(1, dtype=I32)
    lands = free & (torch.cumsum(free, 1, dtype=I32) <= n_del[:, None])
    n_land = int(lands.sum())
    n_freed = int(((pool[..., PA] != arrival) & ~lands).sum())
    read = cost.nbytes(arrival, deliver, pool_peak, err) + 4 * W * n_land
    write = 4 * W * n_land + 4 * n_freed + cost.nbytes(*out[1:])
    ops = 2 * L * (M + deliver.shape[1]) + W * n_land
    return read + write, ops


def smem_bytes(M: int, E: int) -> int:
    """Dynamic shared memory of one block (csrc/land_emissions.cu): the
    free and delivered bit words (the free row offset by up to 3 slots)
    and their prefixes, the k-th delivered row and free slot, 32 warp
    totals."""
    words = (3 + M + 31) // 32 + (E + 31) // 32
    return 4 * (2 * words + 2 * E + 32)


def land_emissions(pool, arrival, deliver, new_rows, pool_peak, err,
                   slot=None, has=None, flags: int = 0, cap=None):
    """K2 on CUDA tensors, :func:`land_emissions_plain` on CPU tensors.
    ``slot``/``has`` are K1's popped slots ``[L, N]`` (the kernel needs
    them; the twin does not) and ``flags`` the step's flag word: under
    the crash flag the changed arrival words (each now INF, as K1 leaves
    them) are found among the free slots. ``cap`` is the run
    predicate's inputs (:class:`lane_freeze.Cap`), or ``None`` to update
    every lane. Returns ``(pool, overflow, pool_peak, err, running)``,
    ``pool`` the tensor given, ``running`` ``[L]`` the cap's predicate
    as the kernel evaluated it (every lane true without a cap)."""
    if pool.device.type == "cpu":
        return land_emissions_plain(pool, arrival, deliver, new_rows,
                                    pool_peak, err, slot, has, flags, cap)
    L, M, W = pool.shape
    E = deliver.shape[1]
    dev = pool.device
    if slot is None or has is None:
        raise ValueError("land_emissions: the kernel takes K1's popped "
                         "slots (slot, has)")
    N = slot.shape[1]
    build.check("pool", pool, I32, (L, M, W), dev)
    build.check("arrival", arrival, I32, (L, M), dev)
    build.check("deliver", deliver, torch.bool, (L, E), dev)
    build.check("new_rows", new_rows, I32, (L, E, W), dev)
    build.check("pool_peak", pool_peak, I32, (L,), dev)
    build.check("err", err, I32, (L,), dev)
    build.check("slot", slot, I32, (L, N), dev)
    build.check("has", has, torch.bool, (L, N), dev)
    if arrival.data_ptr() % 16 or N > THREADS:
        raise ValueError("land_emissions: arrival not 16-byte aligned, or "
                         f"N={N} > {THREADS}")
    overflow = torch.empty((L,), dtype=torch.bool, device=dev)
    peak = torch.empty((L,), dtype=I32, device=dev)
    new_err = torch.empty_like(err)
    running = torch.empty((L,), dtype=torch.bool, device=dev)
    tab, cap_flags = cap_args(cap, L, dev)
    fn = build.c_function("fantoch_land_emissions", 13, 7)
    build.launch(
        fn,
        [t.data_ptr() for t in (pool, arrival, deliver, new_rows, pool_peak,
                                err, slot, has)]
        + [ctypes.addressof(tab)]
        + [t.data_ptr() for t in (overflow, peak, new_err, running)],
        [L, M, W, E, N, flags | cap_flags, smem_bytes(M, E)],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    land_emissions.launches += 1
    return pool, overflow, peak, new_err, running


land_emissions.launches = 0
