// The device threefry2x32 of jax.random, as the installed jax computes it
// with jax_threefry_partitionable on: the 20-round block, fold_in, the
// 32 bits of a key and of a shaped draw's flat index, randint's uint32
// arithmetic and uniform's mantissa. Shared by K3 key_table and K6
// emit_rewrite (the fault plan's jitter and drop draws, the reorder
// draws).
#pragma once

#include "common.cuh"

namespace fantoch {

__device__ __forceinline__ unsigned rotl(unsigned x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry(unsigned k0, unsigned k1,
                                         unsigned& x0, unsigned& x1) {
  const unsigned ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (unsigned)(i + 1);
  }
}

// jax.random.fold_in: threefry(key, (0, data))
__device__ __forceinline__ void fold_in(unsigned& k0, unsigned& k1,
                                        unsigned data) {
  unsigned x0 = 0, x1 = data;
  threefry(k0, k1, x0, x1);
  k0 = x0;
  k1 = x1;
}

// the 32 bits at flat index i of jax.random.bits(key, shape, uint32)
__device__ __forceinline__ unsigned bits_at(unsigned k0, unsigned k1,
                                            unsigned i) {
  unsigned x0 = 0, x1 = i;
  threefry(k0, k1, x0, x1);
  return x0 ^ x1;
}

// jax.random.bits(key, (), uint32)
__device__ __forceinline__ unsigned bits32(unsigned k0, unsigned k1) {
  return bits_at(k0, k1, 0);
}

// jax.random.randint(key, (), 0, maxval) for int32
__device__ __forceinline__ int randint(unsigned k0, unsigned k1,
                                       int maxval) {
  unsigned a0 = k0, a1 = k1, b0 = k0, b1 = k1;
  fold_in(a0, a1, 0);  // split(key)[0] == threefry(key, (0, 0))
  fold_in(b0, b1, 1);  // split(key)[1] == threefry(key, (0, 1))
  const unsigned higher = bits32(a0, a1), lower = bits32(b0, b1);
  const unsigned span = maxval > 0 ? (unsigned)maxval : 1u;
  unsigned mult = (1u << 16) % span;
  mult = (mult * mult) % span;
  const unsigned off = ((higher % span) * mult + (lower % span)) % span;
  return (int)off;
}

// jax.random.uniform(key, (), float32)
__device__ __forceinline__ float uniform(unsigned k0, unsigned k1) {
  const unsigned fb = (bits32(k0, k1) >> 9) | 0x3F800000u;
  return fmaxf(0.0f, __uint_as_float(fb) - 1.0f);
}

}  // namespace fantoch
