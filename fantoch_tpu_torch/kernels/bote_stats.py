"""K15 ``bote_stats``: bote's batched region-set search, every
configuration of a ``[B, n]`` batch of server subsets at once.

Replaces ``fantoch_tpu/bote/model.py`` ``batched_config_stats`` (:91-151)
with the device gathers of ``fantoch_tpu/bote/search.py``
``Search._rank_n`` (:216-226, :244-250). For each configuration and
client: the leaderless latency client → closest server (the first
minimum in subset order) → that server's q-th closest member, for each
leaderless quorum size; with a leader quorum size, each candidate
leader's COV over the clients (the reference's f32 order of summation,
sequential in client order), the first best-COV leader, and the FPaxos
latencies client → leader → the leader's q-th closest member for each
FPaxos quorum size. CUDA source: ``csrc/bote_stats.cu`` (bound by bytes,
:func:`work`). :func:`bote_stats_plain` is its plain PyTorch twin, used
for tensors on the CPU; it loops over the clients with elementwise ops
(never ``torch.mean``/``torch.std``, whose reductions take other
orders) and divides by a tensor, never by a Python number (on the card
PyTorch multiplies by the reciprocal of a scalar divisor).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import build, cost

F32 = torch.float32
I32 = torch.int32
I64 = torch.int64

# the kernel's limits (csrc/bote_stats.cu MAXN, MAXQ) and its static
# shared memory: the [R, R] matrix and the client indices
MAX_N = 32
MAX_Q = 8
SHARED_BYTES = 48 * 1024


def _first_min(planes):
    """``(values, index)`` of the first minimum over a list of equally
    shaped tensors (strict ``<``, as ``argmin`` breaks ties)."""
    best = planes[0]
    arg = torch.zeros(best.shape, dtype=I64, device=best.device)
    for j, v in enumerate(planes[1:], 1):
        lt = v < best
        best = torch.where(lt, v, best)
        arg = torch.where(lt, torch.full_like(arg, j), arg)
    return best, arg


def bote_stats_plain(lat, subsets, clients, quorum_sizes: Sequence[int],
                     leader_quorum_size: Optional[int] = None,
                     leader_quorum_sizes: Sequence[int] = ()):
    """``(lat_q [Q, B, C] f32, leader [B] i64, leader_lat [F, B, C] f32,
    cov [B, n] f32)``; the last three are None without a leader quorum
    size."""
    B, n = subsets.shape
    C = clients.shape[0]
    subsets = subsets.long()
    clients = clients.long()
    within = lat[subsets[:, :, None], subsets[:, None, :]]      # [B, n, n]
    srt = torch.sort(within, dim=2).values
    c2s = lat[clients[None, :, None], subsets[:, None, :]]      # [B, C, n]
    closest_lat, closest = _first_min([c2s[:, :, j] for j in range(n)])
    lat_q = torch.stack(
        [closest_lat + torch.gather(srt[:, :, q - 1], 1, closest)
         for q in quorum_sizes]
    ) if quorum_sizes else torch.empty((0, B, C), dtype=F32,
                                       device=lat.device)
    if leader_quorum_size is None:
        return lat_q, None, None, None
    x = c2s + srt[:, :, leader_quorum_size - 1][:, None, :]     # [B, C, n]
    div = torch.full((B, n), float(C), dtype=F32, device=lat.device)
    s = x[:, 0, :]
    for c in range(1, C):
        s = s + x[:, c, :]
    mean = s / div
    d = x[:, 0, :] - mean
    ss = d * d
    for c in range(1, C):
        d = x[:, c, :] - mean
        ss = ss + d * d
    std = torch.sqrt(ss / div)
    cov = std / torch.maximum(mean, torch.full_like(mean, 1e-9))
    _best, leader = _first_min([cov[:, j] for j in range(n)])
    c2l = torch.gather(c2s, 2, leader[:, None, None].expand(B, C, 1))[:, :, 0]
    leader_lat = torch.stack(
        [c2l + torch.gather(srt[:, :, q - 1], 1, leader[:, None])
         for q in leader_quorum_sizes]
    ) if leader_quorum_sizes else torch.empty((0, B, C), dtype=F32,
                                              device=lat.device)
    return lat_q, leader, leader_lat, cov


def work(lat, subsets, clients, quorum_sizes, leader_quorum_size=None,
         leader_quorum_sizes=()):
    """``(bytes, ops)`` the region needs: it reads the subsets, the
    matrix and the client indices once and writes every output plane
    once (the latency planes, and with a leader the leader and the COV
    plane). Its f32 operations a configuration: an ordering of each of
    the n rows of n distances (n log2 n compares a row), n compares a
    client for the closest server, an add a client a quorum size, and
    with a leader five a client a candidate (add, sum, subtract, square,
    sum) and four a candidate (two divides, a square root, a max)."""
    B, n = subsets.shape
    C = clients.shape[0]
    Q, F = len(quorum_sizes), len(leader_quorum_sizes)
    log_n = max((n - 1).bit_length(), 1)
    out = 4 * Q * B * C
    ops = B * (n * n * log_n + C * n + Q * C)
    if leader_quorum_size is not None:
        out += 4 * F * B * C + 8 * B + 4 * B * n
        ops += B * (5 * n * C + 4 * n + F * C)
    return cost.nbytes(lat, subsets, clients) + out, ops


def bound(*args):
    """``(ms, "bytes" | "operations")`` of :func:`work` on ``args``, its
    operations at the card's f32 rate."""
    n_bytes, n_ops = work(*args)
    return cost.bound(n_bytes, n_ops, cost.FP32_OPS_PER_S)


def bote_stats(lat, subsets, clients, quorum_sizes: Sequence[int],
               leader_quorum_size: Optional[int] = None,
               leader_quorum_sizes: Sequence[int] = ()) -> Tuple:
    """K15 on CUDA tensors, :func:`bote_stats_plain` on CPU tensors.
    ``lat`` is the f32 ``[R, R]`` matrix, ``subsets`` the int32 ``[B, n]``
    region indices, ``clients`` the int32 ``[C]`` client region
    indices."""
    if lat.device.type == "cpu":
        return bote_stats_plain(lat, subsets, clients, quorum_sizes,
                                leader_quorum_size, leader_quorum_sizes)
    R = lat.shape[0]
    B, n = subsets.shape
    C = clients.shape[0]
    dev = lat.device
    build.check("lat", lat, F32, (R, R), dev)
    build.check("subsets", subsets, I32, (B, n), dev)
    build.check("clients", clients, I32, (C,), dev)
    if 4 * (R * R + C) > SHARED_BYTES:
        raise ValueError(
            f"bote_stats: a latency matrix of {R} regions and {C} clients "
            f"does not fit in the block's {SHARED_BYTES} bytes of shared "
            "memory")
    if n > MAX_N:
        raise ValueError(f"bote_stats: subsets of {n} regions exceed "
                         f"the kernel's {MAX_N}")
    lead = leader_quorum_size is not None
    qs = [*quorum_sizes, *(leader_quorum_sizes if lead else ())]
    if len(qs) > MAX_Q:
        raise ValueError(f"bote_stats: {len(qs)} quorum sizes exceed the "
                         f"kernel's {MAX_Q}")
    if any(not 1 <= q <= n for q in
           qs + ([leader_quorum_size] if leader_quorum_size else [])):
        raise ValueError(f"bote_stats: quorum sizes {qs} (leader "
                         f"{leader_quorum_size}) outside 1..{n}")
    Q = len(quorum_sizes)
    F = len(qs) - Q
    lat_q = torch.empty((Q, B, C), dtype=F32, device=dev)
    leader_lat = torch.empty((F, B, C), dtype=F32, device=dev)
    leader = torch.empty((B if lead else 0,), dtype=I64, device=dev)
    cov = torch.empty((B if lead else 0, n), dtype=F32, device=dev)
    tensors = [lat, subsets, clients, lat_q, leader_lat, leader, cov]
    fn = build.c_function("fantoch_bote_stats", len(tensors), 15)
    build.launch(
        fn, [t.data_ptr() for t in tensors],
        [R, B, n, C, Q, F, leader_quorum_size or 0,
         *(qs + [0] * (MAX_Q - len(qs)))],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    bote_stats.launches += 1
    if not lead:
        return lat_q, None, None, None
    return lat_q, leader, leader_lat, cov


bote_stats.launches = 0
