"""Counter-based threefry2x32 random bits, bit-identical to ``jax.random``.

The engine derives every workload key from (lane key, client, command
seq), so the port must reproduce the reference's bits exactly: the lane
keys ``make_lane`` stores in ctx (``PRNGKey``/``fold_in``) and the
``randint``/``uniform`` arithmetic behind each key draw, as jax computes
them with ``jax_threefry_partitionable`` on (its default since 0.5):

* ``fold_in(key, d)``   = threefry2x32(key, (0, d));
* ``split(key)[i]``     = threefry2x32(key, (0, i));
* 32 random bits        = y0 ^ y1 of threefry2x32(key, (0, 0));
* ``randint``           = two sub-keys' bits folded modulo the span;
* ``uniform`` (float32) = the top 23 bits as a mantissa in [1, 2), minus 1.

The functions below take int64 arrays holding u32 values — numpy arrays
or torch tensors alike (only ``+ ^ & << >> %`` are used) — so the host
code here and the plain twin of the key-table kernel
(``kernels/key_table.py``) share one implementation.
"""

from __future__ import annotations

import numpy as np

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1):
    """The 20-round threefry2x32 block on u32 values held in int64."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r)
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def fold_in2(k0, k1, data):
    """``jax.random.fold_in`` on a key pair; ``data`` as u32."""
    return threefry2x32(k0, k1, data * 0, data & MASK)


def bits32(k0, k1):
    """``jax.random.bits(key, (), uint32)``."""
    y0, y1 = threefry2x32(k0, k1, k0 * 0, k0 * 0)
    return y0 ^ y1


def randint2(k0, k1, maxval):
    """``jax.random.randint(key, (), 0, maxval)`` (int32 result)."""
    zero = k0 * 0
    a0, a1 = threefry2x32(k0, k1, zero, zero)       # split(key)[0]
    b0, b1 = threefry2x32(k0, k1, zero, zero + 1)   # split(key)[1]
    higher = bits32(a0, a1)
    lower = bits32(b0, b1)
    # span = 1 wherever maxval <= minval (jax then returns minval)
    span = (maxval & MASK) * (maxval > 0) + (maxval <= 0) * 1
    mult = (1 << 16) % span
    mult = ((mult * mult) & MASK) % span
    off = ((((higher % span) * mult) & MASK) + (lower % span)) & MASK
    return off % span


def uniform_bits(k0, k1):
    """The float32 bit pattern of ``jax.random.uniform(key, ())`` plus
    1.0: a mantissa in [1, 2). View it as float32 and subtract 1."""
    return (bits32(k0, k1) >> 9) | 0x3F800000


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as a ``[2]`` uint32 array."""
    seed = int(seed)
    if not 0 <= seed < 1 << 31:
        raise ValueError(f"seed {seed} outside [0, 2^31)")
    return np.array([0, seed], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` on a ``[2]`` uint32 key."""
    k = np.asarray(key, np.uint32).astype(np.int64)
    y0, y1 = fold_in2(k[0], k[1], np.int64(int(data) & MASK))
    return np.array([y0, y1], np.int64).astype(np.uint32)
