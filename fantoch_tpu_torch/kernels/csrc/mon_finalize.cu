// K13 mon_finalize: the safety monitors' reduction at the end of a
// monitored run (replaces fantoch_tpu/engine/monitor.py finalize_lane
// :217 with cov_digest :130, applied per lane by build_runner,
// fantoch_tpu/engine/core.py:1620-1623).
//
// One block per lane, once per batch. The block
//   1. marks the live processes (rows below the lane's row count, and
//      under FLAG_CRASH those the plan never crashes);
//   2. under `order` (the protocol's MONITOR_ORDER) tests every (p, q, k)
//      of live processes for equal counts and different hashes, on a
//      lossless lane only (__syncthreads_or);
//   3. tests clean quiescence: budget done, no error, nothing lost, under
//      FLAG_CRASH no crash in the plan, under FLAG_HORIZON the drain tail
//      inside the horizon (done time + extra time in 64 bits, so no sum
//      overflows);
//   4. one warp per process sums its per-key counts and holds the sum
//      against the lane's completed commands (duplicate, missing);
//   5. folds the 2 N K words of the hash and count planes into the
//      coverage digest: weights[0] + sum x_i * weights[1 + i], every
//      product and sum in uint32_t (wrapping, exactly the reference's
//      int32 arithmetic), reduced by warp shuffles and one shared row.
//      Sums mod 2^32 do not depend on the order of addition, so the
//      digest equals the twin's exactly;
//   6. thread 0 writes the violation word, its first step and the digest.
//
// Bound on this card: bytes. The region reads the two [N, K] planes and a
// few words per lane and writes three (mon_finalize.py work); the kernel
// reads the planes twice (the order test and the digest), from L2 the
// second time.
#include "common.cuh"

using namespace fantoch;

namespace {

constexpr int THREADS = 256;
constexpr int FLAG_CRASH = 1, FLAG_HORIZON = 8;  // engine/faults.py
constexpr int VIOL_ORDER = 1, VIOL_DUP = 2, VIOL_MISSING = 4;

}  // namespace

__global__ void __launch_bounds__(THREADS) mon_finalize_kernel(
    const int* __restrict__ hash, const int* __restrict__ cnt,
    const int* __restrict__ completed, const int* __restrict__ viol_in,
    const int* __restrict__ vstep_in, const int* __restrict__ steps,
    const int* __restrict__ done_time, const int* __restrict__ err,
    const int* __restrict__ dropped, const int* __restrict__ rows,
    const int* __restrict__ extra, const int* __restrict__ horizon,
    const int* __restrict__ crash_t, const unsigned* __restrict__ w,
    int* __restrict__ viol_o, int* __restrict__ vstep_o,
    int* __restrict__ cov_o, int N, int K, int C, int flags, int order) {
  __shared__ unsigned s_red[THREADS / 32];
  const int l = blockIdx.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const long long NK = (long long)N * K;
  const int* h = hash + (long long)l * NK;
  const int* c = cnt + (long long)l * NK;
  const int* ct = crash_t + (long long)l * N;
  const bool crash = flags & FLAG_CRASH;
  auto live = [&](int p) {
    return p < rows[l] && (!crash || ct[p] >= INF);
  };
  const bool lossless = dropped[l] == 0;

  // 2. equal counts, different hashes, among live processes
  bool bad = false;
  if (order && lossless) {
    for (long long i = t; i < NK * N; i += THREADS) {
      const int p = (int)(i / NK), q = (int)(i / K % N), k = (int)(i % K);
      if (live(p) && live(q) && c[(long long)p * K + k] == c[(long long)q * K + k] &&
          h[(long long)p * K + k] != h[(long long)q * K + k])
        bad = true;
    }
  }
  const bool order_bad = __syncthreads_or(bad);

  // 3. clean quiescence
  bool clean = done_time[l] < INF && err[l] == 0 && lossless;
  if (crash)
    for (int p = 0; p < N; ++p) clean = clean && ct[p] >= INF;
  if (flags & FLAG_HORIZON)
    clean = clean && (long long)done_time[l] + (long long)extra[l] <=
                         (long long)horizon[l];

  // 4. per-process totals against the completed commands
  unsigned total = 0;
  for (int k = 0; k < C; ++k) total += (unsigned)completed[(long long)l * C + k];
  bool dup = false, missing = false;
  for (int p = warp; p < N; p += THREADS / 32) {
    unsigned s = 0;
    for (int k = lane; k < K; k += 32) s += (unsigned)c[(long long)p * K + k];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
    if (lane == 0 && live(p)) {
      dup = dup || (int)s > (int)total;
      missing = missing || (int)s < (int)total;
    }
  }
  const bool any_dup = __syncthreads_or(dup);
  const bool any_missing = __syncthreads_or(missing);

  // 5. the coverage digest, in uint32_t
  unsigned acc = 0;
  for (long long i = t; i < 2 * NK; i += THREADS) {
    const unsigned x = (unsigned)(i < NK ? h[i] : c[i - NK]);
    acc += x * w[1 + i];
  }
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
  if (lane == 0) s_red[warp] = acc;
  __syncthreads();

  // 6. the lane's words
  if (t == 0) {
    unsigned digest = w[0];
    for (int i = 0; i < THREADS / 32; ++i) digest += s_red[i];
    int viol = viol_in[l];
    if (order_bad) viol |= VIOL_ORDER;
    if (clean && any_dup) viol |= VIOL_DUP;
    if (clean && any_missing) viol |= VIOL_MISSING;
    viol_o[l] = viol;
    vstep_o[l] = (viol != 0 && vstep_in[l] >= INF) ? steps[l] : vstep_in[l];
    cov_o[l] = (int)digest;
  }
}

extern "C" int fantoch_mon_finalize(
    const void* hash, const void* cnt, const void* completed,
    const void* viol_in, const void* vstep_in, const void* steps,
    const void* done_time, const void* err, const void* dropped,
    const void* rows, const void* extra, const void* horizon,
    const void* crash_t, const void* weights, void* viol_o, void* vstep_o,
    void* cov_o, int L, int N, int K, int C, int flags, int order,
    void* stream) {
  if (L == 0) return 0;
  mon_finalize_kernel<<<L, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)hash, (const int*)cnt, (const int*)completed,
      (const int*)viol_in, (const int*)vstep_in, (const int*)steps,
      (const int*)done_time, (const int*)err, (const int*)dropped,
      (const int*)rows, (const int*)extra, (const int*)horizon,
      (const int*)crash_t, (const unsigned*)weights, (int*)viol_o,
      (int*)vstep_o, (int*)cov_o, N, K, C, flags, order);
  return (int)cudaGetLastError();
}
