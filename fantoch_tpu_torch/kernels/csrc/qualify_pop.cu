// K1 qualify_pop: the engine step's event-time qualification and message
// pop (replaces fantoch_tpu/engine/core.py _lane_step sections 1-2,
// lines 811-904, with frontier_min :274 and mark_popped :261).
//
// One block per lane, one warp per process. Warp p takes the min over the
// pool arrivals addressed to p and over p's timers (e_p), the block shares
// e through shared memory, then warp p evaluates the conservative bound
// (column min of e_q + lookahead[q, p]), the lane minimum T, `active` and
// the timers that fire. An active process with no firing timer pops its
// earliest message: prio rows first, then the lexicographic (ksrc, kcnt)
// minimum, ties to the lowest slot index as jnp.argmin breaks them (so an
// empty process reports slot 0). The 13-word popped row is gathered and
// the popped slots' arrival column is freed to INF.
//
// Bound on this card: bytes: every slot's arrival and destination words,
// the key words of the slots that compete in a pop and the outputs
// (qualify_pop.py work). Each warp scans the pool's rows for its process
// (N passes, from L1/L2 after the first); the work per byte is a handful
// of integer compares. A warp per
// process keeps every reduction in shuffles, with two block barriers.
#include "common.cuh"

using namespace fantoch;

__global__ void qualify_pop_kernel(
    const int* __restrict__ pool, const int* __restrict__ next_periodic,
    const int* __restrict__ lookahead, int M, int W, int N, int R,
    int* __restrict__ arrival_out, int* __restrict__ ep_out,
    int* __restrict__ now_out, bool* __restrict__ active_out,
    bool* __restrict__ fire_out, int* __restrict__ slot_out,
    bool* __restrict__ has_out, int* __restrict__ rows_out) {
  extern __shared__ int smem[];
  int* s_ep = smem;        // [N]
  int* s_slot = smem + N;  // [N], -1 = nothing popped
  const int l = blockIdx.x;
  const int p = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int* P = pool + (size_t)l * M * W;
  const int* np = next_periodic + ((size_t)l * N + p) * R;
  const size_t lp = (size_t)l * N + p;

  // 1. earliest local event of process p
  int arr = INF;
  for (int m = lane; m < M; m += 32)
    if (P[(size_t)m * W + PDST] == p) arr = min(arr, P[(size_t)m * W + PA]);
  arr = warp_min(arr);
  int tmin = INF;
  for (int r = 0; r < R; ++r) tmin = min(tmin, np[r]);
  const int ep = min(arr, tmin);
  if (lane == 0) s_ep[p] = ep;
  __syncthreads();

  // conservative bound, lane-wide minimum, qualification
  int bound = INF, T = INF;
  for (int q = 0; q < N; ++q) {
    const int eq = s_ep[q];
    const int la = lookahead[((size_t)l * N + q) * N + p];
    const int reach = (eq >= INF || la >= INF) ? INF : eq + la;
    bound = min(bound, reach);
    T = min(T, eq);
  }
  const bool active = ep < INF && (ep < bound || ep == T);
  bool fired_any = false;
  for (int r = 0; r < R; ++r) {
    const bool f = active && np[r] == ep;
    fired_any |= f;
    if (lane == 0) fire_out[lp * R + r] = f;
  }

  // 2. pop: lexicographic min of (!prio, ksrc, kcnt, slot) over the
  // candidates; signed keys are biased into unsigned order
  unsigned long long bh = ~0ull, bl = ~0ull;
  if (active && !fired_any) {
    for (int m = lane; m < M; m += 32) {
      const int* row = P + (size_t)m * W;
      if (row[PDST] == p && row[PA] == ep) {
        const unsigned long long hi =
            ((unsigned long long)(row[PPR] == 0) << 32) |
            (unsigned)(row[PKS] ^ 0x80000000);
        const unsigned long long lo =
            ((unsigned long long)(unsigned)(row[PKC] ^ 0x80000000) << 32) |
            (unsigned)m;
        if (hi < bh || (hi == bh && lo < bl)) {
          bh = hi;
          bl = lo;
        }
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long oh = __shfl_xor_sync(FULL, bh, o);
    const unsigned long long ol = __shfl_xor_sync(FULL, bl, o);
    if (oh < bh || (oh == bh && ol < bl)) {
      bh = oh;
      bl = ol;
    }
  }
  const bool has = bh != ~0ull;
  const int slot = has ? (int)(bl & 0xffffffffu) : 0;
  for (int j = lane; j < W; j += 32)
    rows_out[lp * W + j] = P[(size_t)slot * W + j];
  if (lane == 0) {
    ep_out[lp] = ep;
    active_out[lp] = active;
    has_out[lp] = has;
    slot_out[lp] = slot;
    s_slot[p] = has ? slot : -1;
  }
  if (threadIdx.x == 0) now_out[l] = T;
  __syncthreads();

  // free the popped slots
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    int a = P[(size_t)m * W + PA];
    for (int q = 0; q < N; ++q)
      if (s_slot[q] == m) a = INF;
    arrival_out[(size_t)l * M + m] = a;
  }
}

extern "C" int fantoch_qualify_pop(
    const void* pool, const void* next_periodic, const void* lookahead,
    void* arrival_out, void* ep_out, void* now_out, void* active_out,
    void* fire_out, void* slot_out, void* has_out, void* rows_out, int L,
    int M, int W, int N, int R, void* stream) {
  if (L == 0) return 0;
  qualify_pop_kernel<<<L, 32 * N, 2 * N * sizeof(int),
                       (cudaStream_t)stream>>>(
      (const int*)pool, (const int*)next_periodic, (const int*)lookahead, M,
      W, N, R, (int*)arrival_out, (int*)ep_out, (int*)now_out,
      (bool*)active_out, (bool*)fire_out, (int*)slot_out, (bool*)has_out,
      (int*)rows_out);
  return (int)cudaGetLastError();
}
