"""The K-deep in-flight window of the pipelined sweep driver.

The port's twin of the reference's ``parallel/pipeline.py``
``SegmentWindow`` (:50). ``run_sweep`` dispatches window i+1 right after
window i (a window is one launch of the device loop's graph, which
returns at once) and resolves window i−K+1's liveness flag only when its
slot is reused, so up to ``depth`` windows are in flight and the host's
dispatch overlaps the card's work. Each flag is a CUDA event plus a
pinned host word: :meth:`SegmentWindow.push` starts the word's copy home
on the stream and records the event after it; resolving waits for that
event alone. On the CPU a flag is the word itself.

Speculative dispatch is safe because a finished batch is a fixed point
of the device loop (a window past the batch's end runs no step), so the
final state equals the serial loop's (``depth=1``). The flags are
monotone: lanes only ever finish, so the first False ends ``running``
and no younger flag needs resolving.

:class:`CheckpointBuffer` is the port's twin of the reference's
(:107): a checkpoint save at a drained window boundary whose copy home
and file write overlap the next window.
"""

from __future__ import annotations

import time
from collections import deque

import torch

from ..kernels.step_loop import tree_device


class SegmentWindow:
    """Host-side bookkeeping for up to ``depth`` dispatched but
    unresolved windows' liveness flags."""

    def __init__(self, depth: int):
        self.depth = max(1, int(depth))
        self._flags: deque = deque()
        #: False once any resolved window reported the batch finished
        self.running = True
        #: windows whose liveness came home
        self.resolved = 0

    @property
    def in_flight(self) -> int:
        return len(self._flags)

    def push(self, any_alive) -> None:
        """Record a freshly dispatched window's liveness word (a
        one-element tensor): on the card its copy into a pinned host
        word starts now, with an event recorded after it."""
        if any_alive.device.type == "cuda":
            word = torch.empty(any_alive.shape, dtype=any_alive.dtype,
                               pin_memory=True)
            word.copy_(any_alive, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            self._flags.append((done, word))
        else:
            self._flags.append((None, any_alive))

    def _resolve(self) -> bool:
        done, word = self._flags.popleft()
        if done is not None:
            done.synchronize()
        self.resolved += 1
        return bool(word.reshape(-1)[0])

    def poll(self) -> bool:
        """Resolve just enough old flags to keep at most ``depth − 1`` in
        flight; returns the batch's running verdict as of the oldest
        resolved window."""
        while self.running and len(self._flags) >= self.depth:
            self.running = self._resolve()
        return self.running

    def drain(self) -> bool:
        """Resolve every in-flight flag (the end of a batch): afterwards
        the newest state is determinate. Returns the final verdict."""
        while self.running and self._flags:
            self.running = self._resolve()
        self._flags.clear()
        return self.running


class CheckpointBuffer:
    """Overlapped checkpoint saves: the device-to-host copy and the npz
    write of a boundary's state run while the next window runs.

    On the card a window hands back the device loop's resident buffers,
    which the next window overwrites in place. :meth:`begin`, called at a
    drained boundary before the next window's launch, enqueues the copy
    of every state leaf into pinned host buffers (kept across saves) on
    the current stream and records an event after it: stream order keeps
    the copy ahead of the overwrite. :meth:`flush`, called right after
    the next window's dispatch, waits on that event alone and hands the
    host tree to the save, so the write overlaps the window on the card.
    On the CPU ``begin`` copies the leaves at once.

    At most one save is pending; a kill before :meth:`flush` loses that
    boundary's save and leaves the previous checkpoint. ``blocking_s``
    and ``overlapped_s`` sum the host seconds of the saves flushed with
    ``overlapped`` false and true."""

    def __init__(self):
        self._pinned: dict = {}
        self._pending = None
        self.blocking_s = 0.0
        self.overlapped_s = 0.0

    def _host(self, tree, path=""):
        if isinstance(tree, dict):
            return {k: self._host(v, f"{path}/{k}") for k, v in tree.items()}
        if tree.device.type != "cuda":
            return tree.detach().clone()
        buf = self._pinned.get(path)
        if buf is None or buf.shape != tree.shape or buf.dtype != tree.dtype:
            buf = torch.empty(tree.shape, dtype=tree.dtype, pin_memory=True)
            self._pinned[path] = buf
        buf.copy_(tree, non_blocking=True)
        return buf

    def begin(self, state, until: int) -> None:
        """Start the copy home of a drained boundary's ``state``."""
        if self._pending is not None:
            raise RuntimeError("the previous boundary's save is not flushed")
        t0 = time.perf_counter()
        host = self._host(state)
        done = None
        if tree_device(state).type == "cuda":
            done = torch.cuda.Event()
            done.record()
        self._pending = (host, int(until), done, time.perf_counter() - t0)

    def flush(self, save, overlapped: bool = True) -> bool:
        """Complete the pending save: wait for its copy, then
        ``save(host_state, until)``. Returns whether a save was
        written."""
        if self._pending is None:
            return False
        host, until, done, spent = self._pending
        self._pending = None
        t0 = time.perf_counter()
        if done is not None:
            done.synchronize()
        save(host, until)
        spent += time.perf_counter() - t0
        if overlapped:
            self.overlapped_s += spent
        else:
            self.blocking_s += spent
        return True
