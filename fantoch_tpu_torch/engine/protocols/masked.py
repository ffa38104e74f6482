"""Masked per-(lane, process) reads, writes and selects of the handler
twins: the batched forms of the reference's one-hot helpers
(``oh_get``/``oh_set``, ``fantoch_tpu/engine/core.py:135-160``). Every
tensor has the ``[L, N]`` (lane, process) leading axes; an index out of
range reads 0/False and a write to it drops."""

from __future__ import annotations

import torch

I32 = torch.int32


def bcast(x, like):
    """Append trailing singleton axes to ``x`` up to ``like``'s rank."""
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))


def take(arr, idx):
    """``arr[l, p, idx[l, p], ...]`` along axis 2; an out-of-range index
    reads 0/False (the reference's ``oh_get``)."""
    K = arr.shape[2]
    ok = (idx >= 0) & (idx < K)
    i = idx.clamp(0, K - 1).long()
    i = i.reshape(i.shape + (1,) * (arr.dim() - 2)).expand(
        arr.shape[:2] + (1,) + arr.shape[3:]
    )
    v = torch.gather(arr, 2, i).squeeze(2)
    return torch.where(bcast(ok, v), v, torch.zeros_like(v))


def hit(idx, K):
    """One-hot ``[L, N, K]`` of ``idx`` (out of range hits nothing)."""
    return torch.arange(K, device=idx.device, dtype=I32) == idx[..., None]


def put(arr, idx, val):
    """``arr[l, p, idx] = val`` along axis 2; out-of-range drops."""
    h = hit(idx, arr.shape[2])
    h = h.reshape(h.shape + (1,) * (arr.dim() - 3))
    return torch.where(h, val.unsqueeze(2), arr)


def put2(arr, i, j, val):
    """``arr[l, p, i, j] = val`` for ``[L, N, A, B, ...]`` (``val``
    ``[L, N, ...]``); out-of-range drops."""
    h = hit(i, arr.shape[2])[..., :, None] & hit(j, arr.shape[3])[
        ..., None, :
    ]
    h = h.reshape(h.shape + (1,) * (arr.dim() - 4))
    return torch.where(h, val.reshape(val.shape[:2] + (1, 1)
                                      + val.shape[2:]), arr)


def select(masks, values):
    """``values[k]`` where ``masks[k]`` (first match), else the last."""
    out = values[-1]
    for m, v in zip(reversed(masks), reversed(values[:-1])):
        out = torch.where(bcast(m, out), v, out)
    return out


def take2(arr, i, j):
    """``arr[l, p, i, j, ...]`` with the one-hot reads' semantics on both
    axes (the reference's ``oh_get(oh_get(arr, i), j)``)."""
    return take(take(arr, i), j)


def gather_cell(arr, src, slot):
    """``arr[l, p, src, slot, ...]`` for index tensors ``src``/``slot``
    of shape ``[L, N, *idx]``: the reference's plain ``jnp`` gather on
    the two axes (a negative index counts from the end, and the result
    is clamped into range). Returns ``[L, N, *idx, *rest]``."""
    L, N, A, B = arr.shape[:4]
    s = torch.where(src < 0, src + A, src).clamp(0, A - 1).long()
    t = torch.where(slot < 0, slot + B, slot).clamp(0, B - 1).long()
    flat = arr.reshape((L * N, A * B) + arr.shape[4:])
    lp = torch.arange(L * N, device=arr.device).reshape(
        (L, N) + (1,) * (src.dim() - 2)).expand(src.shape)
    return flat[lp, s * B + t]


def take_words(pay, idx):
    """``pay[..., idx]`` for a 1-D index vector; an index out of range
    reads 0 (the reference's ``oh_take``)."""
    P = pay.shape[-1]
    ok = (idx >= 0) & (idx < P)
    return torch.where(ok, pay[..., idx.clamp(0, P - 1).long()],
                       torch.zeros((), dtype=pay.dtype, device=pay.device))


def compact_order(mask, limit: int):
    """``(order, count)``: each True entry of ``mask`` (last axis) gets
    its 0-based rank in mask order, masked-out entries and ranks >=
    ``limit`` get INF (the reference's ``compact_order``)."""
    order = mask.to(I32).cumsum(-1, dtype=I32) - 1
    order = torch.where(mask & (order < limit), order, 1 << 30)
    return order, mask.sum(-1, dtype=I32)


def pack_pairs(pay, lo, a, b):
    """Add ``a[..., i]`` at word ``lo[..., i]`` and ``b[..., i]`` at
    ``lo[..., i] + 1`` of ``pay [..., P]``; entries out of range drop
    (the reference's ``oh_pack_pairs``: an add, not a set)."""
    at = torch.arange(pay.shape[-1], device=pay.device, dtype=I32)
    lo = lo[..., None]
    return pay + (
        torch.where(lo == at, a[..., None], 0)
        + torch.where(lo + 1 == at, b[..., None], 0)
    ).sum(-2, dtype=I32)


def match_take(match, vals):
    """``out[..., j] = sum_i vals[..., i] where match[..., i, j]`` (the
    reference's ``oh_match``: at most one match per column)."""
    return torch.where(match, vals[..., :, None], 0).sum(-2, dtype=I32)
