"""K14 ``loop_ctl``: the device loop's control step.

Replaces the loop condition and segment cut of
``fantoch_tpu/engine/core.py``: the vmapped ``lax.while_loop``'s
predicate in ``build_runner`` (:1591), its cut at ``until`` in
``segment_lane_fn`` (:1740) and the scan over a window's ``[W]`` ladder
of segment ends in ``window_batch_fn`` (:1860), with the last segment's
``any(running)`` carried out. It runs once before a window's loop and
once at the end of every loop body, over the resident state:

- every lane's predicate (``_lane_running`` :1565, the horizon under
  ``FLAG_HORIZON``) under the step limit ``lim`` ("active") and under
  ``max_steps`` ("alive"), each OR-ed over the batch;
- while no lane is active, one is alive and the window has rungs left,
  ``lim`` moves to the next rung ``min(untils[rung], max_steps)``: a
  segment in which no lane steps is a no-op, so the ladder is walked
  until one does, as the reference's scan walks it;
- in a body, the body counter goes up by one;
- ``alive`` is the window's liveness word and ``cond`` = any(active)
  the while node's condition (``cudaGraphSetConditional`` in the graph,
  ``csrc/step_loop.cu``).

The control block ``ctl`` (int32, :data:`CTL_WORDS`): ``W`` and
``max_steps`` from the host; ``lim``, ``rung``, ``alive`` and ``cond``
from K14. The ladder lies in a buffer of its own. CUDA source:
``csrc/loop_ctl.cu`` (one block; bound by bytes, :func:`work`).
:func:`loop_ctl_plain` is its plain PyTorch twin, used for tensors on the
CPU.
"""

from __future__ import annotations

import torch

from ..engine.faults import FLAG_HORIZON
from . import build
from .lane_freeze import lane_live

I32 = torch.int32

# control block word offsets (csrc/loop_ctl.cu CTL_*)
CTL_W, CTL_MAXS, CTL_LIM, CTL_RUNG, CTL_ALIVE, CTL_COND = range(6)
CTL_WORDS = 8


def new_ctl(device):
    """A zeroed control block, body counter and one-rung ladder on
    ``device``: ``(ctl, iters, ladder)``."""
    return (torch.zeros((CTL_WORDS,), dtype=I32, device=device),
            torch.zeros((1,), dtype=I32, device=device),
            torch.zeros((1,), dtype=I32, device=device))


def loop_ctl_plain(st, ctx, ladder, ctl, iters, flags: int = 0,
                   in_body: bool = False) -> bool:
    """K14's twin: updates ``ctl`` (and under ``in_body`` the body
    counter ``iters``) in place, as the kernel does, and returns the
    loop condition any(active)."""
    W, maxs = int(ctl[CTL_W]), int(ctl[CTL_MAXS])
    if in_body:
        rung, lim = int(ctl[CTL_RUNG]), int(ctl[CTL_LIM])
    else:
        rung, lim = 0, min(int(ladder[0]), maxs)
    live = lane_live(st, ctx, flags)
    steps = st["steps"]
    alive = bool((live & (steps < maxs)).any())
    active = bool((live & (steps < lim)).any())
    while not active and alive and rung < W - 1:
        rung += 1
        lim = min(int(ladder[rung]), maxs)
        active = bool((live & (steps < lim)).any())
    ctl[CTL_LIM], ctl[CTL_RUNG] = lim, rung
    ctl[CTL_ALIVE], ctl[CTL_COND] = int(alive), int(active)
    if in_body:
        iters += 1
    return active


def work(st, ctx, ctl, flags: int, in_body: bool):
    """``(bytes, ops)`` the region needs on these inputs (``ctl`` as the
    call left it): each lane's done time, now, error word, step count
    and extra time (and under the horizon flag its horizon) read once,
    the rungs walked read, the header read, the four words it writes
    (and the body counter) written; about ten integer operations a
    lane."""
    L = st["now"].shape[0]
    n = 5 * 4 * L + (4 * L if flags & FLAG_HORIZON else 0)
    rungs = int(ctl[CTL_RUNG]) + 1
    n += 4 * rungs + 2 * 4 + 4 * 4 + (2 * 4 if in_body else 0)
    return n, 10 * L + 4 * rungs


def loop_ctl(st, ctx, ladder, ctl, iters, flags: int = 0,
             in_body: bool = False):
    """K14 on CUDA tensors (outside a graph: the words only, no
    condition handle; returns None), :func:`loop_ctl_plain` on CPU
    tensors (returns the condition). ``ladder`` is the window's
    ``untils`` (int32 ``[>= W]``), ``ctl`` the control block, ``iters``
    the body counter ``[1]``."""
    dev = st["now"].device
    if dev.type == "cpu":
        return loop_ctl_plain(st, ctx, ladder, ctl, iters, flags, in_body)
    L = st["now"].shape[0]
    for k in ("done_time", "now", "err", "steps"):
        build.check(f"st/{k}", st[k], I32, (L,), dev)
    build.check("extra_time", ctx["extra_time"], I32, (L,), dev)
    build.check("fault_horizon", ctx["fault_horizon"], I32, (L,), dev)
    build.check("ladder", ladder, I32, (ladder.numel(),), dev)
    build.check("ctl", ctl, I32, (CTL_WORDS,), dev)
    build.check("iters", iters, I32, (1,), dev)
    fn = build.c_function("fantoch_loop_ctl", 9, 3)
    build.launch(
        fn,
        [t.data_ptr() for t in (st["done_time"], st["now"], st["err"],
                                st["steps"], ctx["extra_time"],
                                ctx["fault_horizon"], ladder, ctl, iters)],
        [L, flags, int(bool(in_body))],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    loop_ctl.launches += 1
    return None


loop_ctl.launches = 0
