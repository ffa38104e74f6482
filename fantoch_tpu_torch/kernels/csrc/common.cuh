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

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// floor modulo for b > 0, as jnp's % (CUDA's % truncates toward zero)
__device__ __forceinline__ int floor_mod(int a, int b) {
  int r = a % b;
  return r < 0 ? r + b : r;
}

// Exclusive prefix count of flag(i) over i in [0, n), in index order:
// calls visit(i, rank) for every flagged i and returns the total. Each
// thread owns one contiguous chunk; the per-chunk counts are scanned with
// warp shuffles and one shared row of warp totals (s_warp[32]). Needs
// blockDim.x a multiple of 32 and at most 1024; every thread must call.
template <class Flag, class Visit>
__device__ int block_scan_visit(int n, Flag flag, Visit visit, int* s_warp) {
  const int t = threadIdx.x, nt = blockDim.x;
  const int lane = t & 31, w = t >> 5, nw = nt >> 5;
  const int chunk = (n + nt - 1) / nt;
  const int lo = min(t * chunk, n), hi = min(lo + chunk, n);
  int cnt = 0;
  for (int i = lo; i < hi; ++i) cnt += flag(i) ? 1 : 0;
  int x = cnt;  // inclusive scan inside the warp
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[w] = x;
  __syncthreads();
  if (w == 0) {
    int v = lane < nw ? s_warp[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(FULL, v, o);
      if (lane >= o) v += y;
    }
    s_warp[lane] = v;
  }
  __syncthreads();
  int r = (w > 0 ? s_warp[w - 1] : 0) + x - cnt;
  const int total = s_warp[nw - 1];
  __syncthreads();  // s_warp may be reused by the caller
  for (int i = lo; i < hi; ++i)
    if (flag(i)) visit(i, r++);
  return total;
}

}  // namespace fantoch
