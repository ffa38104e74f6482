// K3 key_table: every lane's (client, seq) → key table (replaces
// fantoch_tpu/engine/core.py gen_key :439-504 as the sweep batches it,
// key_table_fn :560 and parallel/sweep.py:698-708): the static branch and,
// when the lane carries a traffic schedule (seq_epoch non-null), the epoch
// branch (:459-476, :484-496).
//
// One thread per (lane, client, seq). The thread runs jax's threefry2x32
// (csrc/threefry.cuh) fold-in chain fold_in(fold_in(rng_key, c), seq) and sub-keys 1 and 2,
// then jax.random.randint's uint32 arithmetic (two split sub-keys' bits
// folded modulo the span) and uniform's mantissa trick, exactly as the
// installed jax computes them with jax_threefry_partitionable on. The key
// is the ConflictPool choice, or the Zipf inverse CDF: searchsorted
// (side="right") over the float32 cumulative table, clamped to its last
// index. Under a schedule the command's epoch e = seq_epoch[min(s, TE-1)]
// gives the conflict rate, the pool pool_base[e] + randint(max(size[e], 1))
// and the private key pool_span + c; the Zipf search reads the epoch's
// row of zcum_e when it is given. The fold-in stream is the static
// branch's. The output equals the reference's table bit for bit.
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
    int* __restrict__ out, const int* __restrict__ seq_epoch,
    const int* __restrict__ conflict_e, const int* __restrict__ base_e,
    const int* __restrict__ size_e, const int* __restrict__ span,
    const float* __restrict__ zcum_e, int TE, int EP) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)L * C * T) return;
  const int s = (int)(g % T);
  const int c = (int)((g / T) % C);
  const int l = (int)(g / ((long long)T * C));
  unsigned k0 = rng_key[2 * l], k1 = rng_key[2 * l + 1];
  fold_in(k0, k1, (unsigned)c);
  fold_in(k0, k1, (unsigned)s);
  // the knobs: the lane's, or those of the command's epoch
  int rate = conflict[l], base = 0, size = pool_size[l],
      private_key = pool_size[l] + c;
  const float* cum = zipf_cum + (size_t)l * K;
  if (seq_epoch) {
    const int e = seq_epoch[(size_t)l * TE + min(s, TE - 1)];
    const size_t le = (size_t)l * EP + e;
    rate = conflict_e[le];
    base = base_e[le];
    size = size_e[le];
    private_key = span[l] + c;
    if (zcum_e) cum = zcum_e + le * K;
  }
  const bool hit = randint(k0, k1, 100) < rate;
  unsigned a0 = k0, a1 = k1;
  fold_in(a0, a1, 1);
  const int pool_key = base + randint(a0, a1, max(size, 1));
  const int pool = hit ? pool_key : private_key;
  unsigned u0 = k0, u1 = k1;
  fold_in(u0, u1, 2);
  const float u = uniform(u0, u1);
  // searchsorted(side="right"): the count of entries <= u
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

extern "C" int fantoch_key_table(
    const void* rng_key, const void* conflict, const void* pool_size,
    const void* kind, const void* zipf_cum, void* out, const void* seq_epoch,
    const void* conflict_e, const void* base_e, const void* size_e,
    const void* span, const void* zcum_e, int L, int C, int T, int K, int TE,
    int EP, void* stream) {
  const long long total = (long long)L * C * T;
  if (total == 0) return 0;
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads);
  key_table_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const unsigned*)rng_key, (const int*)conflict, (const int*)pool_size,
      (const int*)kind, (const float*)zipf_cum, L, C, T, K, (int*)out,
      (const int*)seq_epoch, (const int*)conflict_e, (const int*)base_e,
      (const int*)size_e, (const int*)span, (const float*)zcum_e, TE, EP);
  return (int)cudaGetLastError();
}
