"""K1 ``qualify_pop``: event-time qualification and message pop.

Replaces ``fantoch_tpu/engine/core.py`` ``_lane_step`` sections 1-2
(lines 811-904, with ``frontier_min`` :274 and ``mark_popped`` :261).
CUDA source: ``csrc/qualify_pop.cu`` (bound by bytes, :func:`work`).
:func:`qualify_pop_plain` is its plain PyTorch twin, used for tensors on
the CPU.
"""

from __future__ import annotations

import torch

from ..engine.dims import INF, PA, PDST, PKC, PKS, PPR
from . import build, cost

I32 = torch.int32


def qualify_pop_plain(pool, next_periodic, lookahead):
    """``(arrival, ep, now, active, fire, slot, has, rows)`` for a batch:
    pool ``[L, M, W]``, timers ``[L, N, R]``, lookahead ``[L, N, N]``.
    Each slot is reduced into its destination's row (a slot whose
    destination is out of range takes part in no pop), so the work is
    ``[L, M]`` per reduction."""
    L, M, W = pool.shape
    N = next_periodic.shape[1]
    dev = pool.device
    arrival = pool[..., PA]
    ksrc = pool[..., PKS]
    prio = pool[..., PPR] != 0
    dst = pool[..., PDST]
    inf = torch.tensor(INF, dtype=I32, device=dev)
    mine = (dst >= 0) & (dst < N)
    d = torch.where(mine, dst, N).long()        # column N collects the rest

    def per_process(vals, reduce, init):
        """``[L, N]``: ``reduce`` of each destination's slot values."""
        out = torch.full((L, N + 1), init, dtype=vals.dtype, device=dev)
        return out.scatter_reduce(1, d, vals, reduce)[:, :N]

    def at_dst(per):
        """``[L, M]``: each slot's destination's value of ``per``."""
        return torch.gather(per, 1, d.clamp(max=N - 1))

    arr_p = per_process(arrival, "amin", INF)
    ep = torch.minimum(arr_p, next_periodic.amin(-1))
    reach = torch.where(
        (ep[..., None] >= INF) | (lookahead >= INF), inf,
        ep[..., None] + lookahead,
    )                                                       # [L, q, p]
    bound = reach.amin(1)
    now = ep.amin(1)
    active = (ep < INF) & ((ep < bound) | (ep == now[:, None]))
    fire = (next_periodic == ep[..., None]) & active[..., None]
    pops = active & ~fire.any(-1)
    cand = mine & (arrival == at_dst(ep)) & at_dst(pops)
    any_prio = per_process((cand & prio).to(I32), "amax", 0) > 0
    use = cand & (prio | ~at_dst(any_prio))
    min_src = per_process(torch.where(use, ksrc, inf), "amin", INF)
    first = use & (ksrc == at_dst(min_src))
    min_kcnt = per_process(torch.where(first, pool[..., PKC], inf), "amin",
                           INF)
    best = first & (pool[..., PKC] == at_dst(min_kcnt))
    # the first slot among the best (jnp.argmin's tie-break); 0 if none
    idx = torch.arange(M, device=dev, dtype=I32).expand(L, M)
    slot = per_process(torch.where(best, idx, M), "amin", M)
    has = slot < M
    slot = torch.where(has, slot, 0)
    rows = torch.gather(
        pool, 1, slot.long()[..., None].expand(L, N, W)
    )
    popped = torch.zeros((L, M + 1), dtype=torch.bool, device=dev)
    popped.scatter_(1, torch.where(has, slot, M).long(),
                    torch.ones_like(has))
    arrival = torch.where(popped[:, :M], inf, arrival)
    return arrival, ep, now, active, fire, slot, has, rows


def work(pool, next_periodic, lookahead, out):
    """``(bytes, ops)`` the region needs on these inputs (``out`` is its
    result): every slot's arrival and destination words, the prio, ksrc
    and kcnt words of the slots that compete in a pop, the timers and
    lookahead, the popped rows, and every output written once."""
    L, M, W = pool.shape
    N = next_periodic.shape[1]
    _arrival, ep, _now, active, fire, _slot, _has, _rows = out
    dst = pool[..., PDST]
    d = dst.clamp(0, N - 1).long()
    pops = active & ~fire.any(-1)
    cand = (
        (dst >= 0) & (dst < N) & torch.gather(pops, 1, d)
        & (pool[..., PA] == torch.gather(ep, 1, d))
    )
    n_cand = int(cand.sum())
    read = (
        4 * (2 * L * M + 3 * n_cand + L * N * W)
        + cost.nbytes(next_periodic, lookahead)
    )
    ops = 2 * L * M + 4 * n_cand + 3 * L * N * N
    return read + cost.nbytes(*out), ops


def qualify_pop(pool, next_periodic, lookahead):
    """K1 on CUDA tensors, :func:`qualify_pop_plain` on CPU tensors."""
    if pool.device.type == "cpu":
        return qualify_pop_plain(pool, next_periodic, lookahead)
    L, M, W = pool.shape
    _, N, R = next_periodic.shape
    dev = pool.device
    if not 1 <= N <= 32:
        raise ValueError(f"qualify_pop: N={N} outside 1..32")
    build.check("pool", pool, I32, (L, M, W), dev)
    build.check("next_periodic", next_periodic, I32, (L, N, R), dev)
    build.check("lookahead", lookahead, I32, (L, N, N), dev)
    arrival = torch.empty((L, M), dtype=I32, device=dev)
    ep = torch.empty((L, N), dtype=I32, device=dev)
    now = torch.empty((L,), dtype=I32, device=dev)
    active = torch.empty((L, N), dtype=torch.bool, device=dev)
    fire = torch.empty((L, N, R), dtype=torch.bool, device=dev)
    slot = torch.empty((L, N), dtype=I32, device=dev)
    has = torch.empty((L, N), dtype=torch.bool, device=dev)
    rows = torch.empty((L, N, W), dtype=I32, device=dev)
    fn = build.c_function("fantoch_qualify_pop", 11, 5)
    build.launch(
        fn,
        [t.data_ptr() for t in (pool, next_periodic, lookahead, arrival,
                                ep, now, active, fire, slot, has, rows)],
        [L, M, W, N, R],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    qualify_pop.launches += 1
    return arrival, ep, now, active, fire, slot, has, rows


qualify_pop.launches = 0
