// K15 bote_stats: bote's batched region-set search (replaces
// fantoch_tpu/bote/model.py batched_config_stats :91-151 with the gathers
// of fantoch_tpu/bote/search.py Search._rank_n :216-226, :244-250).
//
// One thread a configuration (a subset of n regions). The block stages the
// [R, R] latency matrix and the client indices in shared memory; each
// thread then
//   1. gathers the n x n distances inside its subset, insertion-sorts each
//      server's row in local memory and keeps, for every quorum size the
//      caller asks for, that server's distance to its q-th closest member
//      (self included);
//   2. for each client takes its closest server, the FIRST minimum in
//      subset order (strict <, as argmin breaks ties), and writes the
//      leaderless latency client -> closest -> quorum for each quorum size;
//   3. with a leader quorum size lq: for each candidate leader l the
//      latencies x_c = client_c -> l + l's lq-th distance, their mean and
//      standard deviation and COV = std / max(mean, 1e-9), summed in the
//      reference's order, which is sequential in client order (numpy
//      reduces the reference's swapped [B, n, C] view along a strided axis):
//        s = x0; s += x1; ...; mean = s / C
//        ss = (x0 - mean)^2; ss += (x1 - mean)^2; ...
//        std = sqrt(ss / C); cov = std / max(mean, 1e-9)
//      every operation a correctly rounded f32 intrinsic, so nvcc's default
//      --fmad=true cannot contract d * d + ss into an FMA; the best leader
//      is the FIRST minimum COV; then the FPaxos latencies client -> leader
//      + the leader's distance to its q-th closest, for each FPaxos quorum
//      size.
//
// Bound on this card: bytes. The region reads the subsets and the small
// matrix and writes (Q + F) [B, C] latency planes, the leader and the
// [B, n] COV plane (bote_stats.py work); a thread writes its C latencies
// of a plane as one contiguous run.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAXN = 32;   // largest subset (bote_stats.py MAX_N)
constexpr int MAXQ = 8;    // quorum sizes a call (bote_stats.py MAX_Q)

struct Quorums {
  int q[MAXQ];
};

}  // namespace

__global__ void __launch_bounds__(THREADS) bote_stats_kernel(
    const float* __restrict__ lat, const int* __restrict__ subsets,
    const int* __restrict__ clients, float* __restrict__ lat_out,
    float* __restrict__ fl_out, long long* __restrict__ leader,
    float* __restrict__ cov, int R, int B, int n, int C, int Q, int F,
    int lq, Quorums qs) {
  extern __shared__ float smem[];
  float* s_lat = smem;
  int* s_cli = reinterpret_cast<int*>(smem + R * R);
  for (int i = threadIdx.x; i < R * R; i += THREADS) s_lat[i] = lat[i];
  for (int i = threadIdx.x; i < C; i += THREADS) s_cli[i] = clients[i];
  __syncthreads();
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;

  int sub[MAXN];
  for (int j = 0; j < n; ++j) sub[j] = subsets[(long long)b * n + j];

  // 1. each server's distance to its q-th closest member, for the Q
  // leaderless sizes, the F FPaxos sizes and (last) the leader size
  const int NQ = Q + F + (lq > 0 ? 1 : 0);
  float ql[MAXN][MAXQ + 1];
  for (int j = 0; j < n; ++j) {
    float row[MAXN];
    const float* lrow = s_lat + sub[j] * R;
    for (int k = 0; k < n; ++k) {
      const float v = lrow[sub[k]];
      int i = k;
      while (i > 0 && row[i - 1] > v) {
        row[i] = row[i - 1];
        --i;
      }
      row[i] = v;
    }
    for (int t = 0; t < Q + F; ++t) ql[j][t] = row[qs.q[t] - 1];
    if (lq > 0) ql[j][NQ - 1] = row[lq - 1];
  }

  // 2. leaderless: client -> closest server (first minimum) -> quorum
  for (int c = 0; c < C; ++c) {
    const float* crow = s_lat + s_cli[c] * R;
    float best = crow[sub[0]];
    int arg = 0;
    for (int j = 1; j < n; ++j) {
      const float v = crow[sub[j]];
      if (v < best) {
        best = v;
        arg = j;
      }
    }
    for (int t = 0; t < Q; ++t)
      lat_out[((long long)t * B + b) * C + c] = __fadd_rn(best, ql[arg][t]);
  }
  if (lq <= 0) return;

  // 3. the best-COV leader, in the reference's summation order
  const float fc = (float)C;
  float best_cov = 0.0f;
  int bl = 0;
  for (int l = 0; l < n; ++l) {
    const float q = ql[l][NQ - 1];
    const int sl = sub[l];
    float s = __fadd_rn(s_lat[s_cli[0] * R + sl], q);
    for (int c = 1; c < C; ++c)
      s = __fadd_rn(s, __fadd_rn(s_lat[s_cli[c] * R + sl], q));
    const float mean = __fdiv_rn(s, fc);
    float d = __fsub_rn(__fadd_rn(s_lat[s_cli[0] * R + sl], q), mean);
    float ss = __fmul_rn(d, d);
    for (int c = 1; c < C; ++c) {
      d = __fsub_rn(__fadd_rn(s_lat[s_cli[c] * R + sl], q), mean);
      ss = __fadd_rn(ss, __fmul_rn(d, d));
    }
    const float sd = __fsqrt_rn(__fdiv_rn(ss, fc));
    const float cv = __fdiv_rn(sd, fmaxf(mean, 1e-9f));
    cov[(long long)b * n + l] = cv;
    if (l == 0 || cv < best_cov) {
      best_cov = cv;
      bl = l;
    }
  }
  leader[b] = bl;
  for (int t = 0; t < F; ++t)
    for (int c = 0; c < C; ++c)
      fl_out[((long long)t * B + b) * C + c] =
          __fadd_rn(s_lat[s_cli[c] * R + sub[bl]], ql[bl][Q + t]);
}

extern "C" int fantoch_bote_stats(
    const void* lat, const void* subsets, const void* clients, void* lat_out,
    void* fl_out, void* leader, void* cov, int R, int B, int n, int C, int Q,
    int F, int lq, int q0, int q1, int q2, int q3, int q4, int q5, int q6,
    int q7, void* stream) {
  if (B == 0) return 0;
  const Quorums qs = {{q0, q1, q2, q3, q4, q5, q6, q7}};
  const size_t shared = (size_t)R * R * sizeof(float) + (size_t)C * sizeof(int);
  bote_stats_kernel<<<(B + THREADS - 1) / THREADS, THREADS, shared,
                      (cudaStream_t)stream>>>(
      (const float*)lat, (const int*)subsets, (const int*)clients,
      (float*)lat_out, (float*)fl_out, (long long*)leader, (float*)cov, R, B,
      n, C, Q, F, lq, qs);
  return (int)cudaGetLastError();
}
