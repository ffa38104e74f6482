// K3 key_table: every lane's (client, seq) → key table (replaces the
// static branch of fantoch_tpu/engine/core.py gen_key :439-504 as the
// sweep batches it, key_table_fn :560 and parallel/sweep.py:698-708).
//
// One thread per (lane, client, seq). The thread runs jax's threefry2x32
// (csrc/threefry.cuh) fold-in chain fold_in(fold_in(rng_key, c), seq) and sub-keys 1 and 2,
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
#include "threefry.cuh"

using namespace fantoch;

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
