"""Lane trees between numpy and torch.

A lane tree is a nested dict of arrays — a lane ctx, a lane state, or a
stack of either — holding i32, bool, u32 and f32 planes.
:func:`to_torch` turns numpy trees (this package's own, or the JAX
reference's ``make_lane``/``init_lane_state``/``stack_states`` output)
into tensors with the same keys and dtypes; :func:`to_numpy` goes back.
A mixed-protocol batch's trees go between the union skeleton's packed
layout (the reference's ``engine/hetero.py prepare_batch`` output, lanes
in the caller's order) and the port's grouped layout
(``engine/hetero.py``): :func:`packed_to_groups` and
:func:`groups_to_packed`.
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
    """tensor tree → numpy tree on the host, dtype for dtype: a copy,
    which a later step (it updates the pool and some handlers' process
    state in place) leaves as it is."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def stack_trees(trees):
    """Stack per-lane numpy trees into one batched tree."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    return np.stack(trees)


def _take(tree, idx):
    if isinstance(tree, dict):
        return {k: _take(v, idx) for k, v in tree.items()}
    return np.asarray(tree)[idx]


def packed_to_groups(skeleton, packed_state, packed_ctx, device):
    """A batch's packed ``(state, ctx)`` numpy trees (a lane axis in
    front) → ``(state, ctx, lanes)``: the grouped tensor trees on
    ``device``, groups in skeleton audit order with their liveness
    planes linked, and each group's lane indices in the packed batch."""
    from .engine.skeleton import unpack_ctx, unpack_state
    from .kernels.step_loop import link

    pid = np.asarray(packed_state["protocol_id"])
    state, ctx, lanes = {}, {}, {}
    for a in skeleton.audits:
        idx = np.flatnonzero(pid == skeleton.protocol_id(a))
        if not idx.size:
            continue
        state[a] = to_torch(unpack_state(
            skeleton, a, _take(packed_state, idx), lead=1), device)
        ctx[a] = to_torch(unpack_ctx(
            skeleton, a, _take(packed_ctx, idx), lead=1), device)
        lanes[a] = idx.tolist()
    return link(state), link(ctx), lanes


def groups_to_packed(skeleton, tree, lanes, prefix: str = "state"):
    """A grouped state (or with ``prefix="ctx"`` ctx) tree → the batch's
    packed numpy tree, lanes back in the order ``lanes`` gives (each
    group's lane indices)."""
    from .engine.skeleton import pack_ctx, pack_state

    pack = pack_state if prefix == "state" else pack_ctx
    parts = {a: pack(skeleton, a, to_numpy(tree[a]), lead=1) for a in tree}
    L = sum(len(v) for v in lanes.values())

    def gather(nodes):
        first = next(iter(nodes.values()))
        if isinstance(first, dict):
            return {k: gather({a: n[k] for a, n in nodes.items()})
                    for k in first}
        out = np.zeros((L,) + first.shape[1:], first.dtype)
        for a, n in nodes.items():
            out[lanes[a]] = n
        return out

    return gather(parts)
