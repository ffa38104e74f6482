"""K1 ``qualify_pop``: event-time qualification and message pop.

Replaces ``fantoch_tpu/engine/core.py`` ``_lane_step`` sections 1-2
(lines 811-904, with ``frontier_min`` :274 and ``mark_popped`` :261),
with the fault plan's crash cut-off (:799-809) and horizon (:836-840)
under their flags.
CUDA source: ``csrc/qualify_pop.cu`` (bound by bytes, :func:`work`).
:func:`qualify_pop_plain` is its plain PyTorch twin, used for tensors on
the CPU.

A lane whose run predicate is false at the step's start (``cap``,
:class:`lane_freeze.Cap`; every lane runs without one) reads nothing of
the pool: its outputs are the defined "nothing happens" values of
:func:`frozen_out`, and the state planes K1 writes (``now``, and the
timers under the crash flag) keep its rows as they were, so the step
needs no select after it.
"""

from __future__ import annotations

import ctypes

import torch

from ..engine.dims import INF, PA, PDST, PKC, PKS, PPR
from ..engine.faults import FLAG_CRASH, FLAG_HORIZON
from . import build, cost
from .lane_freeze import cap_args, cap_running

I32 = torch.int32


def block_threads(L: int, M: int) -> int:
    """Threads a block for ``L`` lanes of ``M`` pool slots: 1,024 for a
    small batch (a mixed batch's 128-lane group) or a large pool (Tempo
    partial's 10,064 slots), else 256, the fastest of 128-1,024 on the
    512-lane batches of 2,069 slots when they were compared on the
    card."""
    return 1024 if L < 256 or M > 4096 else 256


def frozen_out(out, running, now0, timers0, flags: int):
    """``out`` with the lanes not ``running`` set to the defined values
    of a frozen lane: ep INF, active, fire and has false, slot 0, rows
    zero, arrival INF, now ``now0`` (the lane's ``now`` plane) and the
    timers ``timers0`` (the input timers; under :data:`FLAG_CRASH` the
    masked copy keeps a frozen lane's rows as they were)."""
    arrival, ep, now, active, fire, slot, has, rows, timers = out

    def sel(t, v):
        return torch.where(
            running.reshape(running.shape + (1,) * (t.dim() - 1)), t, v)

    if flags & FLAG_CRASH:
        timers = sel(timers, timers0)
    return (sel(arrival, INF), sel(ep, INF), torch.where(running, now, now0),
            sel(active, False), sel(fire, False), sel(slot, 0),
            sel(has, False), sel(rows, 0), timers)


def qualify_pop_plain(pool, next_periodic, lookahead, crash_t=None,
                      horizon=None, flags: int = 0, cap=None):
    """``(arrival, ep, now, active, fire, slot, has, rows, timers)`` for
    a batch: pool ``[L, M, W]``, timers ``[L, N, R]``, lookahead
    ``[L, N, N]``, the fault plan's crash times ``[L, N]`` and horizon
    ``[L]`` (read only under their flags), and the step's flag word. Under :data:`FLAG_CRASH` a slot
    at or past its destination's crash time (a destination out of range
    reads 0, the reference's one-hot take) and a crashed process's
    timers become INF, and ``timers`` is that masked copy (else the
    input itself); under :data:`FLAG_HORIZON` no event at or past the
    horizon is active. Each slot is reduced into its destination's row
    (a slot whose destination is out of range takes part in no pop), so
    the work is ``[L, M]`` per reduction. The lanes ``cap`` freezes
    give :func:`frozen_out`'s values."""
    L, M, W = pool.shape
    N = next_periodic.shape[1]
    dev = pool.device
    timers0 = next_periodic
    arrival = pool[..., PA]
    ksrc = pool[..., PKS]
    prio = pool[..., PPR] != 0
    dst = pool[..., PDST]
    inf = torch.tensor(INF, dtype=I32, device=dev)
    mine = (dst >= 0) & (dst < N)
    d = torch.where(mine, dst, N).long()        # column N collects the rest
    if flags & FLAG_CRASH:
        cut = torch.where(mine, torch.gather(crash_t, 1, d.clamp(max=N - 1)),
                          0)
        arrival = torch.where(arrival >= cut, inf, arrival)
        next_periodic = torch.where(next_periodic >= crash_t[..., None], inf,
                                    next_periodic)

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
    if flags & FLAG_HORIZON:
        active = active & (ep < horizon[:, None])
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
    out = (arrival, ep, now, active, fire, slot, has, rows, next_periodic)
    running = cap_running(cap)
    if running is None:
        return out
    return frozen_out(out, running, cap.st["now"], timers0, flags)


def work(pool, next_periodic, lookahead, crash_t, horizon, flags: int,
         *rest):
    """``(bytes, ops)`` the region needs on these inputs (the last
    argument is its result, one before it may be the cap): every slot's
    arrival and destination words, the prio, ksrc and kcnt words of the
    slots that compete in a pop, the timers and lookahead, the popped
    rows, the crash times and the horizon under their flags, and every
    output written once (the masked timers only under the crash
    flag; a frozen lane's are its input timers, copied)."""
    out = rest[-1]
    L, M, W = pool.shape
    N = next_periodic.shape[1]
    _arrival, ep, _now, active, fire, _slot, _has, _rows, timers = out
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
    written = cost.nbytes(*out[:8])
    if flags & FLAG_CRASH:
        read += cost.nbytes(crash_t)
        written += cost.nbytes(timers)
        ops += L * M + timers.numel()
    if flags & FLAG_HORIZON:
        read += cost.nbytes(horizon)
    return read + written, ops


def qualify_pop(pool, next_periodic, lookahead, crash_t=None, horizon=None,
                flags: int = 0, cap=None):
    """K1 on CUDA tensors, :func:`qualify_pop_plain` on CPU tensors; the
    lanes ``cap`` freezes read nothing of the pool and give
    :func:`frozen_out`'s values."""
    if pool.device.type == "cpu":
        return qualify_pop_plain(pool, next_periodic, lookahead, crash_t,
                                 horizon, flags, cap)
    L, M, W = pool.shape
    _, N, R = next_periodic.shape
    dev = pool.device
    if not 1 <= N <= 32:
        raise ValueError(f"qualify_pop: N={N} outside 1..32")
    build.check("pool", pool, I32, (L, M, W), dev)
    build.check("next_periodic", next_periodic, I32, (L, N, R), dev)
    build.check("lookahead", lookahead, I32, (L, N, N), dev)
    if flags & FLAG_CRASH:
        build.check("crash_t", crash_t, I32, (L, N), dev)
    if flags & FLAG_HORIZON:
        build.check("horizon", horizon, I32, (L,), dev)
    timers = (torch.empty((L, N, R), dtype=I32, device=dev)
              if flags & FLAG_CRASH else next_periodic)
    arrival = torch.empty((L, M), dtype=I32, device=dev)
    ep = torch.empty((L, N), dtype=I32, device=dev)
    now = torch.empty((L,), dtype=I32, device=dev)
    active = torch.empty((L, N), dtype=torch.bool, device=dev)
    fire = torch.empty((L, N, R), dtype=torch.bool, device=dev)
    slot = torch.empty((L, N), dtype=I32, device=dev)
    has = torch.empty((L, N), dtype=torch.bool, device=dev)
    rows = torch.empty((L, N, W), dtype=I32, device=dev)
    tab, cap_flags = cap_args(cap, L, dev)
    fn = build.c_function("fantoch_qualify_pop", 15, 8)
    build.launch(
        fn,
        [0 if t is None else t.data_ptr()
         for t in (pool, next_periodic, lookahead, crash_t, horizon)]
        + [ctypes.addressof(tab)]
        + [t.data_ptr() for t in (arrival, ep, now, active, fire, slot, has,
                                  rows, timers)],
        [L, M, W, N, R, flags, cap_flags, block_threads(L, M)],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    qualify_pop.launches += 1
    return arrival, ep, now, active, fire, slot, has, rows, timers


qualify_pop.launches = 0
