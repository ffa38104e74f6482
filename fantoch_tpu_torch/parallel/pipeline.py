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

The reference's ``CheckpointBuffer`` comes with checkpoints (ROADMAP
item 12).
"""

from __future__ import annotations

from collections import deque

import torch


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
