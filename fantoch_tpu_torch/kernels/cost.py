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
has half as many int32 as fp32 lanes); K15 (bote's search) computes in
f32 outside the tensor cores, at 67 TFLOP/s.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
FP32_OPS_PER_S = 67e12


def nbytes(*tensors) -> int:
    """Total size in bytes of ``tensors``."""
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: int, n_ops: int, ops_per_s: float = INT32_OPS_PER_S):
    """``(ms, "bytes" | "operations")``: the larger of the two times, the
    operations at ``ops_per_s`` (default the int32 rate)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes"
    return t_ops, "operations"


def monitor_bytes(ps, new_ps) -> int:
    """The monitor planes' share of a monitored handler step
    (``csrc/monitor.cuh``): every process's guard word read, each hash
    and count word that an execution changes read and written, each
    changed guard word written; 0 on an unmonitored ``ps``."""
    if "_mon_hash" not in ps:
        return 0
    n = nbytes(ps["_mon_flags"])
    for k in ("_mon_hash", "_mon_cnt"):
        n += 2 * 4 * int((new_ps[k] != ps[k]).sum())
    return n + 4 * int((new_ps["_mon_flags"] != ps["_mon_flags"]).sum())
