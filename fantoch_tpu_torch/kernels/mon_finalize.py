"""K13 ``mon_finalize``: the safety monitors' reduction at the end of a
monitored run, once per batch.

Replaces ``fantoch_tpu/engine/monitor.py`` ``finalize_lane`` (:217) with
``cov_digest`` (:130), which the reference's ``build_runner`` applies to
every lane after its ``while_loop`` (``engine/core.py:1620-1623``): the
live set, the pairwise equal-count/different-hash order check over
``[N, N, K]`` (under ``MONITOR_ORDER``, on lossless lanes), the
clean-quiescence test (the crash and horizon terms under their flags),
the duplicate/missing counts against the completed commands, the first
violating step and the coverage digest over ``2 N K`` words. CUDA
source: ``csrc/mon_finalize.cu`` (bound by bytes, :func:`work`).
:func:`mon_finalize_plain` is its plain PyTorch twin
(``engine/monitor.finalize_lane``), used for tensors on the CPU.
"""

from __future__ import annotations

import functools

import torch

from ..engine.faults import FLAG_CRASH, FLAG_HORIZON
from ..engine.monitor import _digest_weights, finalize_lane
from . import build, cost

I32 = torch.int32


def mon_finalize_plain(st, ctx, flags: int, order: bool):
    """``(viol, viol_step, cov)``, each ``[L]`` int32."""
    return finalize_lane(st, ctx, flags, order)


@functools.lru_cache(maxsize=8)
def _weights(length: int, device) -> torch.Tensor:
    """The digest's ``[length + 1]`` weights on ``device`` (computed on
    the host in exact integers, uploaded once per shape)."""
    return torch.as_tensor(_digest_weights(length), device=device)


def work(st, ctx, flags: int, order: bool, out):
    """``(bytes, ops)`` the region needs on these inputs: it reads every
    lane's hash and count planes once, its completed counts, the lane
    words of the clean test (done time, error word, lost count, extra
    time, rows, and under the flags the crash times and the horizon),
    its violation word and step, step count and the digest's weights,
    and writes three words a lane. Its operations: per lane N*N*K
    compares of the order check (when ``order``), a multiply-add per
    digest element and a few per process."""
    del out
    h, c = st["mon_hash"], st["mon_cnt"]
    L, N, K = h.shape
    read = cost.nbytes(h, c, st["clients"]["completed"], st["done_time"],
                       st["err"], st["fault_dropped"], st["viol"],
                       st["viol_step"], st["steps"], ctx["extra_time"],
                       ctx["rows"])
    read += 4 * (2 * N * K + 1)
    if flags & FLAG_CRASH:
        read += cost.nbytes(ctx["fault_crash_t"])
    if flags & FLAG_HORIZON:
        read += cost.nbytes(ctx["fault_horizon"])
    ops = L * (2 * 2 * N * K + 8 * N + (3 * N * N * K if order else 0))
    return read + 3 * 4 * L, ops


def mon_finalize(st, ctx, flags: int, order: bool):
    """K13 on CUDA tensors, :func:`mon_finalize_plain` on CPU tensors.
    ``flags`` is the batch's flag word (``faults.flag_bits``; the kernel
    reads its crash and horizon bits), ``order`` the protocol's
    ``MONITOR_ORDER``."""
    h = st["mon_hash"]
    if h.device.type == "cpu":
        return mon_finalize_plain(st, ctx, flags, order)
    L, N, K = h.shape
    C = st["clients"]["completed"].shape[1]
    dev = h.device
    chk = build.check
    chk("mon_hash", h, I32, (L, N, K), dev)
    chk("mon_cnt", st["mon_cnt"], I32, (L, N, K), dev)
    chk("completed", st["clients"]["completed"], I32, (L, C), dev)
    for k in ("viol", "viol_step", "steps", "done_time", "err",
              "fault_dropped"):
        chk(k, st[k], I32, (L,), dev)
    for k in ("rows", "extra_time", "fault_horizon"):
        chk(k, ctx[k], I32, (L,), dev)
    chk("fault_crash_t", ctx["fault_crash_t"], I32, (L, N), dev)
    w = _weights(2 * N * K, dev)
    viol = torch.empty((L,), dtype=I32, device=dev)
    viol_step = torch.empty((L,), dtype=I32, device=dev)
    cov = torch.empty((L,), dtype=I32, device=dev)
    tensors = [h, st["mon_cnt"], st["clients"]["completed"], st["viol"],
               st["viol_step"], st["steps"], st["done_time"], st["err"],
               st["fault_dropped"], ctx["rows"], ctx["extra_time"],
               ctx["fault_horizon"], ctx["fault_crash_t"], w, viol,
               viol_step, cov]
    fn = build.c_function("fantoch_mon_finalize", len(tensors), 6)
    build.launch(
        fn, [t.data_ptr() for t in tensors],
        [L, N, K, C, flags, int(bool(order))],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    mon_finalize.launches += 1
    return viol, viol_step, cov


mon_finalize.launches = 0
