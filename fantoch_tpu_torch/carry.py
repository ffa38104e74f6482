"""Lane trees between numpy and torch.

A lane tree is a nested dict of arrays — a lane ctx, a lane state, or a
stack of either — holding i32, bool, u32 and f32 planes.
:func:`to_torch` turns numpy trees (this package's own, or the JAX
reference's ``make_lane``/``init_lane_state``/``stack_states`` output)
into tensors with the same keys and dtypes; :func:`to_numpy` goes back.
This system has no weights; its lane state is what is carried.
"""

from __future__ import annotations

import numpy as np
import torch

_DTYPES = {
    np.dtype(np.int32): torch.int32,
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.float32): torch.float32,
}


def to_torch(tree, device):
    """numpy tree → tensor tree on ``device``, dtype for dtype."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype not in _DTYPES:
        raise TypeError(f"lane tree leaf of dtype {a.dtype} is not carried")
    # a private writable copy: reference arrays may be read-only views
    return torch.from_numpy(np.array(a, order="C", copy=True)).to(device)


def to_numpy(tree):
    """tensor tree → numpy tree on the host, dtype for dtype."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def stack_trees(trees):
    """Stack per-lane numpy trees into one batched tree."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    return np.stack(trees)
