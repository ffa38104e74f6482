"""Fixed-shape interval sets, batched over leading axes.

The counterpart of the reference's ``fantoch_tpu/engine/iset.py``: a
*frontier* (all of 1..=frontier present) plus up to G buffered gap
ranges above it, ``gaps [..., G, 2]`` as (start, end) with start == 0
marking a free slot. Tempo keeps one per (key, voter) for its table
executor's vote clocks, Atlas and EPaxos one per source for the graph
executor's executed clock, and all three one per source for the GC
committed clock.
Every function works elementwise over the leading axes that
``frontier`` and ``gaps`` share; overflowing G is returned as a flag,
which callers raise as a lane error.

The handler kernels carry both sides on the card
(``kernels/csrc/iset.cuh``): Tempo's the add side, Atlas/EPaxos's the
add side and the membership test of the graph drain.
"""

from __future__ import annotations

import torch

I32 = torch.int32


def first_true(mask):
    """Index of the first True along the last axis, 0 where none is (the
    reference's ``jnp.argmax`` of a bool vector)."""
    return mask.to(I32).argmax(-1).to(I32)


def iset_empty(g: int, lead=(), device=None):
    """An empty set per element of ``lead``: ``(frontier, gaps)``."""
    return (torch.zeros(tuple(lead), dtype=I32, device=device),
            torch.zeros(tuple(lead) + (g, 2), dtype=I32, device=device))


def iset_add_range(frontier, gaps, start, end, enable=True):
    """Union ``start..=end`` into the set: ``(frontier, gaps, overflow)``.
    ``start`` is lifted to ``frontier + 1``; a range adjacent to the
    frontier extends it, any other goes into the first free gap slot
    (a full buffer drops it and flags overflow); then G passes each
    absorb every gap that touches the frontier at the start of the pass
    (iset.py:29-65)."""
    g = gaps.shape[-2]
    start = torch.maximum(torch.as_tensor(start, dtype=I32,
                                          device=gaps.device), frontier + 1)
    end = torch.as_tensor(end, dtype=I32, device=gaps.device)
    do = torch.as_tensor(enable, device=gaps.device) & (end >= start)
    direct = do & (start == frontier + 1)
    frontier = torch.where(direct, torch.maximum(frontier, end), frontier)

    store = do & ~direct
    free = gaps[..., 0] == 0
    overflow = store & ~free.any(-1)
    slot = torch.where(store & ~overflow, first_true(free), g)
    hit = torch.arange(g, device=gaps.device, dtype=I32) == slot[..., None]
    pair = torch.stack(torch.broadcast_tensors(start, end), -1)
    gaps = torch.where(hit[..., None], pair[..., None, :], gaps)

    for _ in range(g):
        hit = (gaps[..., 0] > 0) & (gaps[..., 0] <= frontier[..., None] + 1)
        if not bool(hit.any()):
            break  # nothing moves, so no later pass can absorb either
        reach = torch.where(hit, gaps[..., 1], 0).amax(-1)
        frontier = torch.maximum(frontier, reach)
        gaps = torch.where(hit[..., None], 0, gaps)
    return frontier, gaps, overflow


def iset_add(frontier, gaps, event, enable=True):
    return iset_add_range(frontier, gaps, event, event, enable)


def iset_contains(frontier, gaps, x):
    """Membership of ``x``; ``frontier`` and ``gaps`` broadcast against
    it (gaps' trailing axes ``[..., G, 2]``). 0 is never a member."""
    s, e = gaps[..., 0], gaps[..., 1]
    in_gap = ((s > 0) & (s <= x[..., None]) & (x[..., None] <= e)).any(-1)
    return (x >= 1) & ((x <= frontier) | in_gap)


def iset_contains_gathered(front_by_src, gaps_by_src, src, x):
    """Membership of ``x[...]`` in the set of ``src[...]``, per-source
    state ``front_by_src [*B, S]`` and ``gaps_by_src [*B, S, G, 2]``
    (``src`` and ``x`` lead with the same batch axes ``B``, which may be
    none). ``src`` indexes as jnp's does: a negative entry counts from
    the end, and the result is clamped into range."""
    S = front_by_src.shape[-1]
    b = front_by_src.dim() - 1
    src = torch.where(src < 0, src + S, src).clamp(0, S - 1).long()
    idx = src.flatten(b)

    def at(plane):                                  # [*B, S] → src's shape
        return torch.gather(plane, b, idx).reshape(src.shape)

    out = (x >= 1) & (x <= at(front_by_src))
    for g in range(gaps_by_src.shape[-2]):
        s = at(gaps_by_src[..., g, 0])
        e = at(gaps_by_src[..., g, 1])
        out = out | ((s > 0) & (s <= x) & (x <= e))
    return out
