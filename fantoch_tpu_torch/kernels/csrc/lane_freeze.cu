// K7 lane_freeze: the run loop's per-lane predicate and freeze (replaces
// fantoch_tpu/engine/core.py _lane_running :1565 and the per-lane select
// of the vmapped lax.while_loop in build_runner :1591, with the fault
// plan's horizon :1574-1577 under FLAG_HORIZON).
//
// One launch per step over a table of up to MAX_PLANES state planes,
// passed by value: for each plane the step's new tensor, the old one and
// the bytes of one lane's row. Block (l, k) evaluates lane l's predicate
// on the state the step started from (common.cuh RunCap: done time, now,
// error word, step count, extra time, the step limit, and under
// FLAG_HORIZON the lane's horizon); block (l, 0) writes it to
// running[l]. The step limit is a device word, lim = min(until,
// max_steps): the segment cut of the reference's segment_lane_fn
// (core.py:1757-1773). The device loop
// (step_loop.py) moves it up the window's ladder between graph bodies
// (loop_ctl.cu), so a captured step reads it where a launch would have
// baked it in.
// A running lane's blocks stop there. For a frozen lane, block (l, k)
// copies the old row of plane k over the new one, 16 bytes a thread
// where the row is aligned, else 4 or 1. Planes the step passed through
// unchanged are not in the table, so the step's outputs of running lanes
// are never touched; nor are the planes K2, K6 and every handler update in
// place (the pool; K6's clients, metrics, channel counts and timers;
// every protocol's process state), which the step returns as the very
// tensors it took: their kernels wrote only running lanes' rows.
//
// Bound on this card: bytes. The region needs the predicate's words and
// the words of frozen lanes that the step changed (lane_freeze.py work);
// this kernel copies frozen lanes' whole rows of the planes the step
// wrote out of place (the seven lane planes of K1, K2 and K6; nine under
// faults).
#include <cstdint>

#include "common.cuh"

using namespace fantoch;

namespace {

// lane_freeze.py MAX_PLANES: the Planes table below is 24 bytes a plane,
// 3,076 bytes in all, inside the 4 KB a kernel's parameters may take
constexpr int MAX_PLANES = 128;

struct Planes {
  char* dst[MAX_PLANES];
  const char* src[MAX_PLANES];
  long long row[MAX_PLANES];
  int K;
};
static_assert(sizeof(Planes) + sizeof(RunCap) + sizeof(void*) <= 4096,
              "lane_freeze's parameters exceed the 4 KB kernel limit");

}  // namespace

__global__ void lane_freeze_kernel(const Planes pl, const RunCap cap,
                                   bool* __restrict__ running) {
  const int l = blockIdx.x, k = blockIdx.y, t = threadIdx.x;
  const bool run = cap.runs(l);
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
    const void* lim, void* running, int L, int K, int flags, void* stream) {
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
  const void* cap[7] = {done_time, now, err, steps, extra, horizon, lim};
  lane_freeze_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      pl, run_cap(cap, flags), (bool*)running);
  return (int)cudaGetLastError();
}
