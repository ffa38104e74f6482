// K3 key_table: every lane's (client, seq) → key table (replaces the
// static branch of fantoch_tpu/engine/core.py gen_key :439-504 as the
// sweep batches it, key_table_fn :560 and parallel/sweep.py:698-708).
//
// One thread per (lane, client, seq). The thread runs jax's threefry2x32
// fold-in chain fold_in(fold_in(rng_key, c), seq) and sub-keys 1 and 2,
// then jax.random.randint's uint32 arithmetic (two split sub-keys' bits
// folded modulo the span) and uniform's mantissa trick, exactly as the
// installed jax computes them with jax_threefry_partitionable on. The key
// is the ConflictPool choice, or the Zipf inverse CDF: searchsorted
// (side="right") over the float32 cumulative table, clamped to its last
// index. The output equals the reference's table bit for bit.
//
// Bound on this card: integer operations, the threefry blocks of 20
// rounds each key's value depends on (key_table.py work); this kernel
// runs all 13 blocks of both branches for every key and writes 4 bytes.
#include "common.cuh"

using namespace fantoch;

namespace {

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

// jax.random.bits(key, (), uint32)
__device__ __forceinline__ unsigned bits32(unsigned k0, unsigned k1) {
  unsigned x0 = 0, x1 = 0;
  threefry(k0, k1, x0, x1);
  return x0 ^ x1;
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

}  // namespace

__global__ void key_table_kernel(
    const unsigned* __restrict__ rng_key, const int* __restrict__ conflict,
    const int* __restrict__ pool_size, const int* __restrict__ kind,
    const float* __restrict__ zipf_cum, int L, int C, int T, int K,
    int* __restrict__ out) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)L * C * T) return;
  const int s = (int)(g % T);
  const int c = (int)((g / T) % C);
  const int l = (int)(g / ((long long)T * C));
  unsigned k0 = rng_key[2 * l], k1 = rng_key[2 * l + 1];
  fold_in(k0, k1, (unsigned)c);
  fold_in(k0, k1, (unsigned)s);
  const bool hit = randint(k0, k1, 100) < conflict[l];
  unsigned a0 = k0, a1 = k1;
  fold_in(a0, a1, 1);
  const int ps = pool_size[l];
  const int pool_key = randint(a0, a1, max(ps, 1));
  const int pool = hit ? pool_key : ps + c;
  unsigned u0 = k0, u1 = k1;
  fold_in(u0, u1, 2);
  const float u = uniform(u0, u1);
  // searchsorted(side="right"): the count of entries <= u
  const float* cum = zipf_cum + (size_t)l * K;
  int lo = 0, hi = K;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cum[mid] <= u)
      lo = mid + 1;
    else
      hi = mid;
  }
  const int zipf = min(lo, K - 1);
  out[g] = kind[l] == 0 ? pool : zipf;
}

extern "C" int fantoch_key_table(const void* rng_key, const void* conflict,
                                 const void* pool_size, const void* kind,
                                 const void* zipf_cum, void* out, int L,
                                 int C, int T, int K, void* stream) {
  const long long total = (long long)L * C * T;
  if (total == 0) return 0;
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads);
  key_table_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const unsigned*)rng_key, (const int*)conflict, (const int*)pool_size,
      (const int*)kind, (const float*)zipf_cum, L, C, T, K, (int*)out);
  return (int)cudaGetLastError();
}
