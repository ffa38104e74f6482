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
