// Shared constants and warp helpers of the engine's CUDA kernels.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace fantoch {

constexpr int INF = 1 << 30;  // engine/dims.py INF
constexpr int ERR_POOL = 1;   // engine/dims.py ERR_POOL
constexpr unsigned FULL = 0xffffffffu;

// pool row layout (engine/dims.py)
constexpr int PA = 0, PKS = 1, PKC = 2, PSRC = 3, PDST = 4, PMT = 5,
              PRQ = 6, PPR = 7, PPAY = 8;

// The run loop's per-lane predicate (fantoch_tpu/engine/core.py
// _lane_running :1565, with the fault plan's horizon :1574-1577), read on
// the planes a step started from: not finished (done time + extra time
// reached), not idle, no error, fewer steps than the cap *lim, and under
// the horizon flag before the horizon. It replaces the reference's
// per-lane select after the step (build_runner :1591): every kernel of
// the step (K1, the handler K4, K5, K8, K9, K10, K11 or K12, K6, K2)
// writes every plane of a lane it does not hold for as it was (in place
// planes untouched, out-of-place planes copied), K1 and K6 read nothing
// of such a lane's pool or outboxes, and K2 writes it to `running`, the
// run loop's predicate. A null lim is no cap at all: every lane runs (a
// step outside the run loop). The planes are never written in place by a
// step (K6 writes its lane words out of place), so every kernel of the
// step reads the same predicate.
struct RunCap {
  static constexpr int CRASH = 1, HORIZON = 8;  // engine/faults.py FLAG_*
  const int *done_time, *now, *err, *steps, *extra, *horizon, *lim;
  int flags;

  __device__ __forceinline__ bool runs(int l) const {
    if (lim == nullptr) return true;
    const int done = done_time[l], nw = now[l];
    const int end = done >= INF ? INF : done + extra[l];
    const bool finished = done < INF && nw >= end;
    const bool idle = nw >= INF;
    return !(finished || idle || err[l] != 0) && steps[l] < *lim &&
           (!(flags & HORIZON) || nw < horizon[l]);
  }
};

// A kernel entry's cap arguments: the six planes and the cap word (all
// null for no cap) and the step's flag word.
inline RunCap run_cap(const void* const* cap, int flags) {
  return RunCap{(const int*)cap[0], (const int*)cap[1], (const int*)cap[2],
                (const int*)cap[3], (const int*)cap[4], (const int*)cap[5],
                (const int*)cap[6], flags};
}

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// floor modulo for b > 0, as jnp's % (CUDA's % truncates toward zero)
__device__ __forceinline__ int floor_mod(int a, int b) {
  int r = a % b;
  return r < 0 ? r + b : r;
}

}  // namespace fantoch
