"""K7 ``lane_freeze``: the run loop's per-lane predicate and freeze.

Replaces ``fantoch_tpu/engine/core.py`` ``_lane_running`` (:1565) and the
per-lane select of the vmapped ``lax.while_loop`` in ``build_runner``
(:1591): a lane whose predicate is false on the state a step started
from keeps that state, so a finished lane is a fixed point. The step cap
is ``lim = min(until, max_steps)``, the segment cut of the reference's
``segment_lane_fn`` (:1757-1773): an int, or on the card an int32 device
word that the device loop moves between graph bodies (``loop_ctl``).
CUDA source: ``csrc/lane_freeze.cu`` (bound by bytes, :func:`work`).
:func:`lane_freeze_plain` is its plain PyTorch twin, used for tensors on
the CPU.

The same predicate (``csrc/common.cuh RunCap``; :func:`lane_running`
here) tells K2, K6 and every handler (K4, K5, K8, K9, K10, K11, K12)
which lanes to update: they write the pool, every protocol's process
state, and the clients, metrics, channel counts and timers in place, on
running lanes only, and return the very tensors they took, so K7 leaves
those planes out of its table (:func:`plane_pairs` selects by
identity): on a fault-free, unmonitored step of any protocol only the
seven lane planes K1, K2 and K6 write out of place. K1 and K6 read
nothing of a frozen lane and give it defined outputs, which K7
discards. A step hands them its :class:`Cap`.
"""

from __future__ import annotations

import ctypes
from typing import Any, NamedTuple

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


def limit(lim) -> int:
    """The step cap as an int (``lim`` an int, or a one-word tensor on
    the CPU)."""
    return int(lim.reshape(-1)[0]) if torch.is_tensor(lim) else int(lim)


def lane_live(st, ctx, flags: int = 0):
    """Per-lane ``[L]``: the reference's ``_lane_running`` without its
    step cap (not finished, not idle, no error, and under the horizon
    flag before the horizon)."""
    done = st["done_time"]
    end = torch.where(done >= INF, INF, done + ctx["extra_time"])
    finished = (done < INF) & (st["now"] >= end)
    idle = st["now"] >= INF
    live = ~(finished | idle | (st["err"] != 0))
    if flags & FLAG_HORIZON:
        live = live & (st["now"] < ctx["fault_horizon"])
    return live


def lane_running(st, ctx, lim, flags: int = 0):
    """Per-lane loop predicate ``[L]`` (reference ``_lane_running``, cut
    at ``lim``); ``flags`` is the step's flag word
    (``faults.flag_bits``)."""
    return lane_live(st, ctx, flags) & (st["steps"] < limit(lim))


class Cap(NamedTuple):
    """The run predicate's inputs at a step's start: the state ``st``
    (its ``done_time``, ``now``, ``err`` and ``steps`` planes), the ctx
    (``extra_time``, ``fault_horizon``), the step cap ``lim`` (an int,
    or on the card the device loop's limit word) and the batch's flag
    word (``faults.flag_bits``; only the horizon bit is read). A step
    never writes these planes in place, so every kernel of the step
    reads one predicate."""

    st: Any
    ctx: Any
    lim: Any
    flags: int = 0

    def running(self):
        return lane_running(self.st, self.ctx, self.lim, self.flags)


def cap_running(cap):
    """The lanes a step updates: ``None`` (every lane) without a cap,
    else :meth:`Cap.running`."""
    return None if cap is None else cap.running()


def cap_args(cap, L: int, dev):
    """A kernel's cap arguments (``csrc/common.cuh run_cap``): a ctypes
    table of the six planes' and the limit word's addresses (all null
    without a cap; every lane runs) and the flag word. Keep the table
    alive until the launch."""
    if cap is None:
        return (ctypes.c_void_p * 7)(), 0
    planes = [cap.st[k] for k in ("done_time", "now", "err", "steps")]
    planes += [cap.ctx["extra_time"], cap.ctx["fault_horizon"]]
    for i, t in enumerate(planes):
        build.check(f"cap plane {i}", t, I32, (L,), dev)
    word = lim_word(cap.lim, dev)
    tab = (ctypes.c_void_p * 7)(*[t.data_ptr() for t in planes + [word]])
    return tab, int(cap.flags)


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


def lane_freeze_plain(new, old, ctx, lim, flags: int = 0):
    """``(state, running)``: ``running`` is the predicate on ``old``, the
    state the step started from, cut at ``lim``; ``state`` is ``new``
    for running lanes and ``old`` for the others."""
    running = lane_running(old, ctx, lim, flags)
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


def work(new, old, ctx, lim, flags: int, out):
    """``(bytes, ops)`` the region needs on these inputs (``new`` as the
    step left it, ``out`` the result): the predicate reads four words of
    each lane's old state, its extra time and, under the horizon flag,
    its horizon, and the step cap's word, and writes ``running``; a frozen lane's words that the
    step changed are read from ``old`` and written back."""
    _state, running = out
    frozen = ~running
    read = cost.nbytes(old["done_time"], old["now"], old["err"],
                       old["steps"], ctx["extra_time"]) + 4
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


# constant limit words on the card, one per (device, value): the eager
# loop's max_steps, made once
_LIM_WORDS: dict = {}


def lim_word(lim, dev):
    """K7's step cap on ``dev`` as an int32 device word: ``lim`` itself
    when it is one (the device loop's control word), else a constant
    word holding the int, made once per value."""
    if torch.is_tensor(lim):
        build.check("lim", lim, I32, (1,), dev)
        return lim
    key = (dev, int(lim))
    if key not in _LIM_WORDS:
        _LIM_WORDS[key] = torch.tensor([int(lim)], dtype=I32, device=dev)
    return _LIM_WORDS[key]


def lane_freeze(new, old, ctx, lim, flags: int = 0):
    """K7 on CUDA tensors, :func:`lane_freeze_plain` on CPU tensors.
    ``lim`` is the step cap: an int, or on the card an int32 word ``[1]``
    read when the kernel runs. The kernel writes the frozen lanes' rows
    of ``old`` into ``new``'s planes in place (they are the step's own
    fresh outputs; a plane the step updated in place is ``old``'s own
    and not in the table) and returns ``(new, running)``."""
    dev = old["now"].device
    if dev.type == "cpu":
        return lane_freeze_plain(new, old, ctx, lim, flags)
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
    word = lim_word(lim, dev)
    running = torch.empty((L,), dtype=torch.bool, device=dev)
    fn = build.c_function("fantoch_lane_freeze", 11, 3)
    build.launch(
        fn,
        [ctypes.addressof(dst), ctypes.addressof(src), ctypes.addressof(row)]
        + [t.data_ptr() for t in (old["done_time"], old["now"], old["err"],
                                  old["steps"], ctx["extra_time"],
                                  ctx["fault_horizon"], word, running)],
        [L, K, flags],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    lane_freeze.launches += 1
    return new, running


lane_freeze.launches = 0
