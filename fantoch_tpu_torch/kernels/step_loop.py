"""B6-loop: the device loop, a CUDA graph under a conditional while node.

Replaces the on-device loop of ``fantoch_tpu/engine/core.py``: the
vmapped ``lax.while_loop`` of ``build_runner`` (:1591) over
``_lane_step``, its cut at ``until`` in ``segment_lane_fn`` (:1740), and
the ``lax.scan`` of W segments a call in ``window_batch_fn`` (:1860).

:class:`DeviceLoop` captures a body of G = ``steps_per_body`` engine
steps with ``torch.cuda.CUDAGraph(keep_graph=True)`` over **resident**
state and ctx buffers (each step K1, the handler kernel, K6 and K2, each
kernel cut at the control block's step limit: a frozen lane's planes are
written as they were), ending with the final state written back into the
resident buffers (a plane the body passes through, or updates in place
as K2 does the pool, every handler its process state and K6 the clients,
metrics, channel counts and timers, is not copied: it stays resident
across the body's steps).
``csrc/step_loop.cu`` builds the outer graph around it,

    K14 → while (cond) { body → K14 }

and one launch of it is one window: one host dispatch, the early exit
decided on the device by K14 (``loop_ctl``), liveness in the control
block. A later batch of the same shape copies its state and ctx into the
resident buffers and is not captured again (:func:`device_loop` keeps
the last :data:`MAX_LOOPS` loops). A finished batch is a fixed point: a
speculative window costs one K14 launch and no step.

A replayed body launches kernels their wrappers never see: their
launches are counted from the body counter K14 keeps on the device, G ×
bodies × each kernel's launches in the captured body
(:func:`replayed_counts`, read by ``kernels.counts()``).

A mixed-protocol batch (``engine/hetero.py``) is a **grouped** tree,
``{group: native tree}``, its groups' lanes one after the other. K14
reads the batch's liveness planes (:data:`LIVE`) as ``[L]`` buffers:
:func:`link` makes each group's liveness plane a view of its lanes'
span of one such buffer, so the body's write-back into a group's plane
lands in it, and :func:`live_planes` hands K14 the buffers.

:class:`HostLoop` is the plain twin: the same control on the host (K14's
twin between bodies), each body G steps through the wrappers; it runs
for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import time
from collections import OrderedDict, defaultdict

import numpy as np
import torch

from . import build
from .loop_ctl import CTL_ALIVE, CTL_LIM, CTL_MAXS, CTL_W, loop_ctl, new_ctl

I32 = torch.int32

# engine steps in one graph body: the eager loop's liveness read came
# every this many steps too
STEPS_PER_BODY = 64
# device loops kept (each holds resident state and ctx and its graph's
# memory pool)
MAX_LOOPS = 2


def _leaves(tree, prefix=""):
    """``(path, leaf)`` of every leaf, keys in sorted order (a step may
    return its planes in another order than it took them)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def tree_device(tree) -> torch.device:
    """The device of a tree's (first) plane."""
    return _leaves(tree)[0][1].device


def tree_signature(tree) -> tuple:
    """Every leaf's path, shape and dtype: the layout a loop is
    captured over."""
    return tuple((p, tuple(t.shape), t.dtype) for p, t in _leaves(tree))


# the planes K14 reads, each ``[L]``: of the state, then of the ctx
LIVE_STATE = ("done_time", "now", "err", "steps")
LIVE_CTX = ("extra_time", "fault_horizon")
LIVE = LIVE_STATE + LIVE_CTX


def grouped(tree) -> bool:
    """Whether ``tree`` is a grouped tree (``{group: native tree}``): a
    native state or ctx has planes at its top."""
    return (isinstance(tree, dict) and bool(tree)
            and all(isinstance(v, dict) for v in tree.values()))


def link(tree):
    """A grouped tree's liveness planes as views of ``[L]`` buffers, one
    a plane, each group's lanes a span in group order (a copy of those
    planes; the other planes are the tree's own). A native tree is
    returned as it is."""
    if not grouped(tree):
        return tree
    groups = {g: dict(t) for g, t in tree.items()}
    for name in LIVE:
        planes = [t[name] for t in groups.values() if name in t]
        if not planes:
            continue
        if len(planes) != len(groups):
            raise ValueError(f"liveness plane {name} is missing from a group")
        first = planes[0]
        buf = torch.empty((sum(p.shape[0] for p in planes),),
                          dtype=first.dtype, device=first.device)
        off = 0
        for t in groups.values():
            n = t[name].shape[0]
            view = buf[off:off + n]
            view.copy_(t[name])
            t[name] = view
            off += n
    return groups


def live_planes(state, ctx):
    """``(state planes, ctx planes)`` with K14's planes as ``[L]``
    tensors: a native tree's own; a grouped tree's buffers (linked by
    :func:`link`), or on the CPU the groups' planes concatenated. On a
    card an unlinked grouped tree is refused: a copy would not be the
    planes the loop writes."""
    if not grouped(state):
        return state, ctx
    out = []
    for tree, names in ((state, LIVE_STATE), (ctx, LIVE_CTX)):
        planes = {}
        for name in names:
            parts = [t[name] for t in tree.values()]
            base = parts[0]._base
            off = 0
            for p in parts:
                if (base is None or p._base is not base
                        or p.storage_offset() != base.storage_offset() + off):
                    base = None
                    break
                off += p.shape[0]
            if base is not None and base.shape[0] == off:
                planes[name] = base
            elif parts[0].device.type == "cpu":
                planes[name] = torch.cat(parts)
            else:
                raise RuntimeError(
                    f"grouped tree's {name} planes are not linked (link)")
        out.append(planes)
    return out[0], out[1]


def clone_tree(tree):
    """A copy of ``tree``; a grouped tree's copy is linked again."""
    if grouped(tree):
        return link({g: clone_tree(t) for g, t in tree.items()})
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def _pairs(dst, src):
    """``(path, dst leaf, src leaf)`` by path; the layouts must agree."""
    a, b = _leaves(dst), _leaves(src)
    if [(p, t.shape, t.dtype) for p, t in a] != [
            (p, t.shape, t.dtype) for p, t in b]:
        raise ValueError("state layout differs from the loop's")
    return [(p, d, s) for (p, d), (_q, s) in zip(a, b)]


def _copy_into(dst, src) -> None:
    """Copy tree ``src`` into the resident tree ``dst``, leaf by leaf."""
    for _p, d, s in _pairs(dst, src):
        if s is not d:
            d.copy_(s)


def _write_back(resident, final) -> None:
    """Inside the capture: the body's final planes into the resident
    ones. A final plane that overlaps another resident plane would be
    read after it is overwritten, so it is refused."""
    spans = [(t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
             for _p, t in _leaves(resident)]
    for p, r, f in _pairs(resident, final):
        if f is r:
            continue
        lo, hi = f.data_ptr(), f.data_ptr() + f.numel() * f.element_size()
        if any(a < hi and lo < b for a, b in spans):
            raise RuntimeError(f"step output {p} aliases a resident plane")
        r.copy_(f)


@functools.lru_cache(maxsize=None)
def _bind(name, argtypes):
    """Entry point ``name`` of the kernel library, bound once."""
    fn = getattr(build.library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def launch_window(loop, stream) -> None:
    """Launch ``loop``'s instantiated graph once on ``stream``: one
    window (``csrc/step_loop.cu``)."""
    fn = _bind("fantoch_step_loop_launch", (ctypes.c_void_p,) * 2)
    rc = fn(loop.handle, stream)
    if rc != 0:
        raise RuntimeError(f"fantoch_step_loop_launch failed: cudaError {rc}")
    launch_window.launches += 1
    loop.windows += 1


launch_window.launches = 0


class DeviceLoop:
    """The body of ``steps_per_body`` calls of ``step(st, ctx, lim) ->
    st``, captured over resident copies of ``state`` and ``ctx`` on
    their CUDA device, inside the outer graph of ``csrc/step_loop.cu``.
    ``flags`` is the batch's flag word (K14 reads the horizon bit)."""

    def __init__(self, step, state, ctx, steps_per_body: int, flags: int):
        from . import WRAPPERS

        t0 = time.perf_counter()
        self.state, self.ctx = clone_tree(state), clone_tree(ctx)
        live, _ = live_planes(self.state, self.ctx)
        self.dev = dev = live["now"].device
        self.G, self.flags = int(steps_per_body), int(flags)
        self.L = int(live["now"].shape[0])
        self._ctx_in = ctx
        self.ctl, self.iters, _ = new_ctl(dev)
        self.ladder = torch.zeros((8,), dtype=I32, device=dev)
        self.windows, self.handle = 0, None
        lim = self.ctl[CTL_LIM:CTL_LIM + 1]
        before = {k: f.launches for k, f in WRAPPERS.items()}
        # warm-up on a copy: every kernel's module is loaded before the
        # capture, which may not load one
        step(clone_tree(self.state), self.ctx, lim)
        torch.cuda.synchronize(dev)
        warm = {k: f.launches for k, f in WRAPPERS.items()}
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(self.graph):
            st = self.state
            for _ in range(self.G):
                st = step(st, self.ctx, lim)
            _write_back(self.state, st)
        # the warm-up and the capture launched nothing that counts
        self.per_body = {}
        for k, f in WRAPPERS.items():
            n = f.launches - warm[k]
            if n:
                self.per_body[k] = n
            f.launches = before[k]
        self._build()
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0

    def _build(self) -> None:
        st, ctx = live_planes(self.state, self.ctx)
        ptrs = (ctypes.c_void_p * 9)(*[t.data_ptr() for t in (
            st["done_time"], st["now"], st["err"], st["steps"],
            ctx["extra_time"], ctx["fault_horizon"], self.ladder, self.ctl,
            self.iters)])
        out = ctypes.c_void_p()
        fn = _bind("fantoch_step_loop_build",
                   (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p))
        rc = fn(self.graph.raw_cuda_graph(), ctypes.addressof(ptrs), self.L,
                self.flags, ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(
                f"fantoch_step_loop_build failed at stage {rc // 1000}: "
                f"cudaError {rc % 1000}")
        self.handle = out.value

    def _destroy(self) -> None:
        if self.handle is not None:
            fn = _bind("fantoch_step_loop_destroy", (ctypes.c_void_p,))
            fn(self.handle)
            self.handle = None

    def close(self) -> None:
        """Free the outer graph, then (with the last reference) the
        captured body's memory pool and the resident buffers."""
        if self.handle is not None:
            torch.cuda.synchronize(self.dev)
            self._destroy()

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown: the context is gone
            pass

    def run(self, state, ctx, untils, max_steps: int):
        """One window: ``state`` and ``ctx`` into the resident buffers
        (skipped for the buffers themselves), the header and the ladder
        ``untils`` into the control block, one graph launch. Returns
        the window's liveness word (a copy, stream-ordered)."""
        dev = self.dev
        if state is not self.state:
            _copy_into(self.state, state)
        if ctx is not self._ctx_in:
            _copy_into(self.ctx, ctx)
            self._ctx_in = ctx
        W = len(untils)
        if W > self.ladder.numel():
            # the graph's K14 nodes hold the ladder's address
            torch.cuda.synchronize(dev)
            self._destroy()
            self.ladder = torch.zeros((1 << (W - 1).bit_length(),),
                                      dtype=I32, device=dev)
            self._build()
        head = torch.tensor([W, int(max_steps)], dtype=I32).pin_memory()
        lad = torch.from_numpy(np.asarray(untils, np.int32)).pin_memory()
        self.ctl[CTL_W:CTL_MAXS + 1].copy_(head, non_blocking=True)
        self.ladder[:W].copy_(lad, non_blocking=True)
        launch_window(self, torch.cuda.current_stream(dev).cuda_stream)
        return self.ctl[CTL_ALIVE:CTL_ALIVE + 1].clone()

    def iterations(self) -> int:
        """Bodies run since the last count reset (reads the device)."""
        return int(self.iters.item())

    def launch_counts(self) -> dict:
        """Launches the replayed graph made: each body's kernels per body
        run, and K14 once a window and once a body."""
        it = self.iterations()
        out = {k: n * it for k, n in self.per_body.items()}
        out["loop_ctl"] = self.windows + it
        return out

    def reset_counts(self) -> None:
        self.iters.zero_()
        self.windows = 0


class HostLoop:
    """The plain twin of :class:`DeviceLoop`: K14's twin before the
    window and after each body of ``steps_per_body`` calls of
    ``step(st, ctx, lim)``, on the host (tensors on the CPU)."""

    def __init__(self, step, steps_per_body: int, flags: int):
        self.step, self.G, self.flags = step, int(steps_per_body), int(flags)
        self.ctl, self.iters, _ = new_ctl("cpu")
        self.capture_s = 0.0

    def run(self, state, ctx, untils, max_steps: int):
        """One window; returns ``(state, liveness word)``. The steps
        consume their input, so the window runs on a copy of ``state``
        (made once, here), as the device loop runs on its resident
        buffers."""
        ladder = torch.as_tensor(np.asarray(untils, np.int32))
        self.ctl[CTL_W], self.ctl[CTL_MAXS] = len(untils), int(max_steps)
        lim = self.ctl[CTL_LIM:CTL_LIM + 1]
        st = clone_tree(state)
        cond = loop_ctl(*live_planes(st, ctx), ladder, self.ctl, self.iters,
                        self.flags)
        while cond:
            for _ in range(self.G):
                st = self.step(st, ctx, lim)
            cond = loop_ctl(*live_planes(st, ctx), ladder, self.ctl,
                            self.iters, self.flags, in_body=True)
        return st, self.ctl[CTL_ALIVE:CTL_ALIVE + 1].clone()

    def iterations(self) -> int:
        return int(self.iters[0])


_LOOPS: "OrderedDict[tuple, DeviceLoop]" = OrderedDict()
# launches of loops evicted since the last count reset
_FOLDED: dict = defaultdict(int)


def device_loop(key, make):
    """``(loop, made)``: the cached loop of ``key``, or ``make()``'s
    (evicting the least recently used beyond :data:`MAX_LOOPS`)."""
    loop = _LOOPS.pop(key, None)
    made = loop is None
    if made:
        while len(_LOOPS) >= MAX_LOOPS:
            _key, old = _LOOPS.popitem(last=False)
            for k, n in old.launch_counts().items():
                _FOLDED[k] += n
            old.close()
            del old
            torch.cuda.empty_cache()
        loop = make()
    _LOOPS[key] = loop
    return loop, made


def replayed_counts() -> dict:
    """Launches made by replayed graphs since the last reset, by kernel."""
    out = defaultdict(int, _FOLDED)
    for loop in _LOOPS.values():
        for k, n in loop.launch_counts().items():
            out[k] += n
    return out


def reset_replayed_counts() -> None:
    _FOLDED.clear()
    for loop in _LOOPS.values():
        loop.reset_counts()
