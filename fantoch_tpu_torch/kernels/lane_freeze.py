"""The run loop's per-lane predicate, read by every kernel of the step.

Replaces ``fantoch_tpu/engine/core.py`` ``_lane_running`` (:1565) and
the per-lane select of the vmapped ``lax.while_loop`` in
``build_runner`` (:1591): a lane whose predicate is false on the state
a step started from keeps that state, so a finished lane is a fixed
point. The step cap is ``lim = min(until, max_steps)``, the segment cut
of the reference's ``segment_lane_fn`` (:1757-1773): an int, or on the
card an int32 device word that the device loop moves between graph
bodies (``loop_ctl``).

The select is a contract, not a kernel: every kernel of the step (K1,
the handler K4, K5, K8, K9, K10, K11 or K12, K6 and K2) takes the
step's :class:`Cap`, evaluates the predicate (``csrc/common.cuh
RunCap``; :func:`lane_running` here) and writes every plane of a frozen
lane as it was: the pool, the process state and the lane state's
clients, metrics, channel counts and timers in place, on running lanes
only; the ``[L]`` lane words, K1's clock and, under the crash flag,
its masked timers out of place with a frozen lane's rows copied. So no
select follows the step, and K2 (``land_emissions``), the step's last
kernel, reports the predicate as ``running``. A new kernel of the step
keeps to this contract.
"""

from __future__ import annotations

import ctypes
from typing import Any, NamedTuple

import torch

from ..engine.dims import INF
from ..engine.faults import FLAG_HORIZON
from . import build

I32 = torch.int32


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


# constant limit words on the card, one per (device, value): the eager
# loop's max_steps, made once
_LIM_WORDS: dict = {}


def lim_word(lim, dev):
    """The step cap on ``dev`` as an int32 device word: ``lim`` itself
    when it is one (the device loop's control word), else a constant
    word holding the int, made once per value."""
    if torch.is_tensor(lim):
        build.check("lim", lim, I32, (1,), dev)
        return lim
    key = (dev, int(lim))
    if key not in _LIM_WORDS:
        _LIM_WORDS[key] = torch.tensor([int(lim)], dtype=I32, device=dev)
    return _LIM_WORDS[key]
