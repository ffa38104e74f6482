// K2 land_emissions: the engine step's stream compaction of emissions
// into free pool slots (replaces fantoch_tpu/engine/core.py _lane_step
// section 6, lines 1457-1492: cumsum_i32 :99 + searchsorted_left :125 +
// the one row scatter).
//
// One block per lane. An exact int32 block scan (no float matmul) ranks
// the delivered emissions in row order and the free slots in index order;
// the k-th delivered row lands in the k-th free slot, so the pool image
// equals the reference's at every step. Ranks beyond the free count are
// dropped (searchsorted returning M) and flagged as pool overflow, which
// also sets ERR_POOL in the lane's error word. Every
// slot first copies its row with the freed arrival column, then the free
// slots of rank < delivered count take their emission row.
//
// Bound on this card: bytes. The region needs the arrival column, the
// rows that land and the words that change (land_emissions.py work);
// this kernel copies the whole [M, 8+P] pool out of place, so it moves
// about ten times that on the main path. The scans are a few shuffles
// per warp.
#include "common.cuh"

using namespace fantoch;

__global__ void land_emissions_kernel(
    const int* __restrict__ pool, const int* __restrict__ arrival,
    const bool* __restrict__ deliver, const int* __restrict__ new_rows,
    const int* __restrict__ peak_in, const int* __restrict__ err_in, int M,
    int W, int E, int* __restrict__ pool_out, bool* __restrict__ overflow_out,
    int* __restrict__ peak_out, int* __restrict__ err_out) {
  extern __shared__ int smem[];
  int* s_warp = smem;          // [32]
  int* s_row_of = smem + 32;   // [E]: k-th delivered emission row
  const int l = blockIdx.x, t = threadIdx.x;
  const bool* dl = deliver + (size_t)l * E;
  const int* ar = arrival + (size_t)l * M;
  const int* in = pool + (size_t)l * M * W;
  const int* nr = new_rows + (size_t)l * E * W;
  int* out = pool_out + (size_t)l * M * W;

  const int n_del = block_scan_visit(
      E, [&](int e) { return dl[e]; },
      [&](int e, int k) { s_row_of[k] = e; }, s_warp);
  for (int i = t; i < M * W; i += blockDim.x)
    out[i] = (i % W == PA) ? ar[i / W] : in[i];
  __syncthreads();
  const int n_free = block_scan_visit(
      M, [&](int m) { return ar[m] == INF; },
      [&](int m, int k) {
        if (k < n_del) {
          const int* src = nr + (size_t)s_row_of[k] * W;
          for (int j = 0; j < W; ++j) out[(size_t)m * W + j] = src[j];
        }
      },
      s_warp);
  if (t == 0) {
    overflow_out[l] = n_del > n_free;
    peak_out[l] = max(peak_in[l], M - n_free + n_del);
    err_out[l] = err_in[l] | (n_del > n_free ? ERR_POOL : 0);
  }
}

extern "C" int fantoch_land_emissions(
    const void* pool, const void* arrival, const void* deliver,
    const void* new_rows, const void* peak_in, const void* err_in,
    void* pool_out, void* overflow_out, void* peak_out, void* err_out, int L,
    int M, int W, int E, void* stream) {
  if (L == 0) return 0;
  land_emissions_kernel<<<L, 256, (32 + E) * sizeof(int),
                          (cudaStream_t)stream>>>(
      (const int*)pool, (const int*)arrival, (const bool*)deliver,
      (const int*)new_rows, (const int*)peak_in, (const int*)err_in, M, W, E,
      (int*)pool_out, (bool*)overflow_out, (int*)peak_out, (int*)err_out);
  return (int)cudaGetLastError();
}
