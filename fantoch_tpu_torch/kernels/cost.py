"""The least time a kernel's work could take on the card.

Each kernel module's ``work`` counts the bytes and integer operations
that the region it replaces needs on one run's inputs: every input word
the region has to read, read once; every output word it has to write,
written once; data-dependent work (a branch taken by few processes, a
draw a lane's rate makes constant) counted as these inputs need it.
:func:`bound` turns that count into milliseconds at the card's peaks, so
a kernel's time can be held against a floor.

Peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet): 3.35 TB/s
of HBM3, and the int32 rate, 132 SMs × 64 int32 lanes × 1.98 GHz (Hopper
has half as many int32 as fp32 lanes).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def nbytes(*tensors) -> int:
    """Total size in bytes of ``tensors``."""
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: int, n_ops: int):
    """``(ms, "bytes" | "operations")``: the larger of the two times."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT32_OPS_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes"
    return t_ops, "operations"
