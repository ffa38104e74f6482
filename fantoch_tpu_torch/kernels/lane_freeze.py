"""K7 ``lane_freeze``: the run loop's per-lane predicate and freeze.

Replaces ``fantoch_tpu/engine/core.py`` ``_lane_running`` (:1565) and the
per-lane select of the vmapped ``lax.while_loop`` in ``build_runner``
(:1591): a lane whose predicate is false on the state a step started
from keeps that state, so a finished lane is a fixed point. CUDA
source: ``csrc/lane_freeze.cu`` (bound by bytes, :func:`work`).
:func:`lane_freeze_plain` is its plain PyTorch twin, used for tensors on
the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from ..engine.dims import INF
from ..engine.faults import FLAG_HORIZON
from . import build, cost

I32 = torch.int32

# planes one launch can carry (csrc/lane_freeze.cu MAX_PLANES); a Tempo
# lane tree has 52, a Caesar one 60, and the safety monitors add five
# (mon_hash, mon_cnt, mon_flags, viol, viol_step). The table goes to the
# kernel by value: 128 planes are 3,076 bytes of its 4 KB of parameters
MAX_PLANES = 128


class TooManyPlanesError(ValueError):
    """A lane tree with more changed planes than one launch carries."""


def lane_running(st, ctx, max_steps: int, flags: int = 0):
    """Per-lane loop predicate ``[L]`` (reference ``_lane_running``);
    ``flags`` is the step's flag word (``faults.flag_bits``)."""
    done = st["done_time"]
    end = torch.where(done >= INF, INF, done + ctx["extra_time"])
    finished = (done < INF) & (st["now"] >= end)
    idle = st["now"] >= INF
    running = (~(finished | idle | (st["err"] != 0))
               & (st["steps"] < max_steps))
    if flags & FLAG_HORIZON:
        running = running & (st["now"] < ctx["fault_horizon"])
    return running


def _tree_where(mask, new, old):
    """Per-lane select over two state trees: ``new`` where ``mask``; a
    plane the step passed through (``new is old``) stays as it is."""
    if isinstance(new, dict):
        return {k: _tree_where(mask, new[k], old[k]) for k in new}
    if new is old:
        return new
    return torch.where(
        mask.reshape(mask.shape + (1,) * (new.dim() - 1)), new, old
    )


def lane_freeze_plain(new, old, ctx, max_steps: int, flags: int = 0):
    """``(state, running)``: ``running`` is the predicate on ``old``, the
    state the step started from; ``state`` is ``new`` for running lanes
    and ``old`` for the others."""
    running = lane_running(old, ctx, max_steps, flags)
    if bool(running.all()):
        return new, running  # no lane is frozen: the select is ``new``
    return _tree_where(running, new, old), running


def _leaves(new, old):
    """``(new, old)`` plane pairs in tree order."""
    if isinstance(new, dict):
        return [pair for k in new for pair in _leaves(new[k], old[k])]
    return [(new, old)]


def plane_pairs(new, old):
    """The ``(new, old)`` planes the kernel copies (those the step did
    not pass through), at most :data:`MAX_PLANES`; raises
    :class:`TooManyPlanesError` for a larger tree."""
    pairs = [(n, o) for n, o in _leaves(new, old) if n is not o]
    if len(pairs) > MAX_PLANES:
        raise TooManyPlanesError(
            f"lane_freeze: {len(pairs)} planes > MAX_PLANES = {MAX_PLANES}"
        )
    return pairs


def work(new, old, ctx, max_steps: int, flags: int, out):
    """``(bytes, ops)`` the region needs on these inputs (``new`` as the
    step left it, ``out`` the result): the predicate reads four words of
    each lane's old state, its extra time and, under the horizon flag,
    its horizon, and writes ``running``; a frozen lane's words that the
    step changed are read from ``old`` and written back."""
    _state, running = out
    frozen = ~running
    read = cost.nbytes(old["done_time"], old["now"], old["err"],
                       old["steps"], ctx["extra_time"])
    if flags & FLAG_HORIZON:
        read += cost.nbytes(ctx["fault_horizon"])
    moved = 0
    for n, o in _leaves(new, old):
        if n is o:
            continue
        diff = (n != o).reshape(n.shape[0], -1) & frozen[:, None]
        moved += int(diff.sum()) * n.element_size()
    ops = 8 * running.numel() + moved // 4
    return read + 2 * moved + cost.nbytes(running), ops


def lane_freeze(new, old, ctx, max_steps: int, flags: int = 0):
    """K7 on CUDA tensors, :func:`lane_freeze_plain` on CPU tensors. The
    kernel writes the frozen lanes' rows of ``old`` into ``new``'s
    planes in place (they are the step's own fresh outputs) and returns
    ``(new, running)``."""
    dev = old["now"].device
    if dev.type == "cpu":
        return lane_freeze_plain(new, old, ctx, max_steps, flags)
    L = old["now"].shape[0]
    for k in ("done_time", "now", "err", "steps"):
        build.check(f"old/{k}", old[k], I32, (L,), dev)
    build.check("extra_time", ctx["extra_time"], I32, (L,), dev)
    build.check("fault_horizon", ctx["fault_horizon"], I32, (L,), dev)
    pairs = plane_pairs(new, old)
    for i, (n, o) in enumerate(pairs):
        build.check(f"plane {i}", n, o.dtype, tuple(o.shape), dev)
        build.check(f"plane {i} (old)", o, o.dtype, (L,) + o.shape[1:], dev)
    K = len(pairs)
    dst = (ctypes.c_void_p * MAX_PLANES)(*[n.data_ptr() for n, _ in pairs])
    src = (ctypes.c_void_p * MAX_PLANES)(*[o.data_ptr() for _, o in pairs])
    row = (ctypes.c_longlong * MAX_PLANES)(
        *[o[0].numel() * o.element_size() for _, o in pairs]
    )
    running = torch.empty((L,), dtype=torch.bool, device=dev)
    fn = build.c_function("fantoch_lane_freeze", 10, 4)
    build.launch(
        fn,
        [ctypes.addressof(dst), ctypes.addressof(src), ctypes.addressof(row)]
        + [t.data_ptr() for t in (old["done_time"], old["now"], old["err"],
                                  old["steps"], ctx["extra_time"],
                                  ctx["fault_horizon"], running)],
        [L, K, max_steps, flags],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    lane_freeze.launches += 1
    return new, running


lane_freeze.launches = 0
