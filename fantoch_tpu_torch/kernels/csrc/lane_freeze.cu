// K7 lane_freeze: the run loop's per-lane predicate and freeze (replaces
// fantoch_tpu/engine/core.py _lane_running :1565 and the per-lane select
// of the vmapped lax.while_loop in build_runner :1591, with the fault
// plan's horizon :1574-1577 under FLAG_HORIZON).
//
// One launch per step over a table of up to MAX_PLANES state planes,
// passed by value: for each plane the step's new tensor, the old one and
// the bytes of one lane's row. Block (l, k) evaluates lane l's predicate
// on the state the step started from (done time, now, error word, step
// count, extra time, max_steps, and under FLAG_HORIZON the lane's
// horizon); block (l, 0) writes it to running[l].
// A running lane's blocks stop there. For a frozen lane, block (l, k)
// copies the old row of plane k over the new one, 16 bytes a thread
// where the row is aligned, else 4 or 1. Planes the step passed through
// unchanged are not in the table, so the step's outputs of running lanes
// are never touched.
//
// Bound on this card: bytes. The region needs the predicate's words and
// the words of frozen lanes that the step changed (lane_freeze.py work);
// this kernel copies frozen lanes' whole rows, which on the main path
// is dominated by the [M, 8+P] pool row of each frozen lane.
#include <cstdint>

#include "common.cuh"

using namespace fantoch;

namespace {

// lane_freeze.py MAX_PLANES: the Planes table below is 24 bytes a plane,
// 3,076 bytes in all, inside the 4 KB a kernel's parameters may take
constexpr int MAX_PLANES = 128;
constexpr int FLAG_HORIZON = 8;  // engine/faults.py FLAG_HORIZON

struct Planes {
  char* dst[MAX_PLANES];
  const char* src[MAX_PLANES];
  long long row[MAX_PLANES];
  int K;
};
static_assert(sizeof(Planes) + 7 * sizeof(void*) + 2 * sizeof(int) <= 4096,
              "lane_freeze's parameters exceed the 4 KB kernel limit");

}  // namespace

__global__ void lane_freeze_kernel(const Planes pl,
                                   const int* __restrict__ done_time,
                                   const int* __restrict__ now,
                                   const int* __restrict__ err,
                                   const int* __restrict__ steps,
                                   const int* __restrict__ extra,
                                   const int* __restrict__ horizon,
                                   bool* __restrict__ running,
                                   int max_steps, int flags) {
  const int l = blockIdx.x, k = blockIdx.y, t = threadIdx.x;
  const int done = done_time[l], nw = now[l];
  const int end = done >= INF ? INF : done + extra[l];
  const bool finished = done < INF && nw >= end;
  const bool idle = nw >= INF;
  const bool run =
      !(finished || idle || err[l] != 0) && steps[l] < max_steps &&
      (!(flags & FLAG_HORIZON) || nw < horizon[l]);
  if (k == 0 && t == 0) running[l] = run;
  if (run || k >= pl.K) return;
  const long long n = pl.row[k];
  char* d = pl.dst[k] + (size_t)l * n;
  const char* s = pl.src[k] + (size_t)l * n;
  const uintptr_t align = (uintptr_t)d | (uintptr_t)s | (uintptr_t)n;
  if (align % 16 == 0) {
    int4* d4 = reinterpret_cast<int4*>(d);
    const int4* s4 = reinterpret_cast<const int4*>(s);
    for (long long i = t; i < n / 16; i += blockDim.x) d4[i] = s4[i];
  } else if (align % 4 == 0) {
    int* d1 = reinterpret_cast<int*>(d);
    const int* s1 = reinterpret_cast<const int*>(s);
    for (long long i = t; i < n / 4; i += blockDim.x) d1[i] = s1[i];
  } else {
    for (long long i = t; i < n; i += blockDim.x) d[i] = s[i];
  }
}

extern "C" int fantoch_lane_freeze(
    const void* dst_tab, const void* src_tab, const void* row_tab,
    const void* done_time, const void* now, const void* err,
    const void* steps, const void* extra, const void* horizon,
    void* running, int L, int K, int max_steps, int flags, void* stream) {
  if (L == 0) return 0;
  if (K < 0 || K > MAX_PLANES) return (int)cudaErrorInvalidValue;
  Planes pl{};
  for (int k = 0; k < K; ++k) {
    pl.dst[k] = ((char* const*)dst_tab)[k];
    pl.src[k] = ((const char* const*)src_tab)[k];
    pl.row[k] = ((const long long*)row_tab)[k];
  }
  pl.K = K;
  const dim3 grid(L, K > 0 ? K : 1);
  lane_freeze_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      pl, (const int*)done_time, (const int*)now, (const int*)err,
      (const int*)steps, (const int*)extra, (const int*)horizon,
      (bool*)running, max_steps, flags);
  return (int)cudaGetLastError();
}
