"""K2 ``land_emissions``: stream compaction of a step's emissions into
the free pool slots.

Replaces ``fantoch_tpu/engine/core.py`` ``_lane_step`` section 6 (lines
1457-1492: ``cumsum_i32`` :99, ``searchsorted_left`` :125 and the row
scatter). CUDA source: ``csrc/land_emissions.cu`` (bound by bytes,
:func:`work`; an exact int32 block scan — the reference's f32-matmul cumsum is exact on
this card's default tf32 path only up to 2^11). :func:`land_emissions_plain`
is its plain PyTorch twin, used for tensors on the CPU.
"""

from __future__ import annotations

import torch

from ..engine.dims import ERR_POOL, INF, PA
from . import build, cost

I32 = torch.int32


def land_emissions_plain(pool, arrival, deliver, new_rows, pool_peak, err):
    """``(new_pool, overflow, pool_peak, err)``: the k-th delivered row
    (in row order) lands in the k-th free slot (in index order); ranks
    past the free count drop and set ``ERR_POOL`` in the lane's error
    word. pool ``[L, M, W]``, arrival ``[L, M]`` (popped slots already
    freed), deliver ``[L, E]``, new_rows ``[L, E, W]``, err ``[L]``."""
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
    return (out, overflow, torch.maximum(pool_peak, M - n_free + n_del),
            err | ERR_POOL * overflow.to(I32))


def work(pool, arrival, deliver, new_rows, pool_peak, err, out):
    """``(bytes, ops)`` the region needs on these inputs (``out`` is its
    result). The region updates the pool: it reads the arrival column
    (the free mask), ``deliver`` and the rows that land, and writes the
    rows that land and the freed arrival words no landing row covers,
    besides the overflow flag, the peak and the error word."""
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


def land_emissions(pool, arrival, deliver, new_rows, pool_peak, err):
    """K2 on CUDA tensors, :func:`land_emissions_plain` on CPU tensors."""
    if pool.device.type == "cpu":
        return land_emissions_plain(
            pool, arrival, deliver, new_rows, pool_peak, err
        )
    L, M, W = pool.shape
    E = deliver.shape[1]
    dev = pool.device
    build.check("pool", pool, I32, (L, M, W), dev)
    build.check("arrival", arrival, I32, (L, M), dev)
    build.check("deliver", deliver, torch.bool, (L, E), dev)
    build.check("new_rows", new_rows, I32, (L, E, W), dev)
    build.check("pool_peak", pool_peak, I32, (L,), dev)
    build.check("err", err, I32, (L,), dev)
    out = torch.empty_like(pool)
    overflow = torch.empty((L,), dtype=torch.bool, device=dev)
    peak = torch.empty((L,), dtype=I32, device=dev)
    new_err = torch.empty_like(err)
    fn = build.c_function("fantoch_land_emissions", 10, 4)
    build.launch(
        fn,
        [t.data_ptr() for t in (pool, arrival, deliver, new_rows, pool_peak,
                                err, out, overflow, peak, new_err)],
        [L, M, W, E],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    land_emissions.launches += 1
    return out, overflow, peak, new_err


land_emissions.launches = 0
