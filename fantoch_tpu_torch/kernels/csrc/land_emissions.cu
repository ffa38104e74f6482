// K2 land_emissions: the engine step's stream compaction of emissions
// into free pool slots (replaces fantoch_tpu/engine/core.py _lane_step
// section 6, lines 1457-1492: cumsum_i32 :99 + searchsorted_left :125 +
// the one row scatter).
//
// In place: the k-th delivered row (in row order) lands in the k-th free
// slot (in index order) of the step's own pool, and only on lanes whose
// run predicate holds at the step's start (common.cuh RunCap; every lane
// without a cap). A frozen lane's block writes nothing of the pool and
// exits: its overflow flag false, its peak and error word as they came,
// so the step writes every plane of a frozen lane as it was and no
// select follows it. Thread 0 of every block writes the predicate to
// running_out (true on every lane without a cap): the run loop's
// `running` (replaces the predicate of fantoch_tpu/engine/core.py
// _lane_running :1565 that the per-lane select of build_runner :1591
// read). Ranks beyond the free count are dropped (searchsorted returning
// M) and flagged as pool overflow, which also sets ERR_POOL in the lane's
// error word.
//
// One block of 512 threads per lane:
// 1. The lane's free mask (arrival == INF over M slots) goes to shared
//    memory as bits, read with 16-byte loads: bit b is slot b - off, off
//    the row's offset in its first 16-byte quad, so each aligned quad is
//    one nibble and each group of eight lanes ORs its nibbles into one
//    word with shuffles. The delivered emissions go to bits with one
//    __ballot_sync per 32.
// 2. One block scan of the words' popcounts ranks both: a slot's rank is
//    its word's prefix plus __popc(word & lanemask_lt); the k-th
//    delivered row and the k-th free slot go to two [E] tables.
// 3. Each landing row is written by one warp, lane j on word j (W is
//    11-141, mostly not a multiple of 4), the rows spread over the warps.
// 4. The arrival words that changed are written: K1 freed the slots it
//    popped (its slot/has outputs), and under the crash flag the slots
//    at or past their destination's crash time, found among the free
//    slots whose pool word is not INF. A slot that takes a landing row
//    gets the row's word instead.
//
// Bound on this card: bytes. The region needs the arrival row (the free
// mask), deliver, the rows that land, the words that change and running,
// a byte a lane (land_emissions.py work); this kernel reads and writes
// just those, plus K1's [N] popped slots, the run predicate's words (as
// every kernel of the step reads them) and under the crash flag a word of
// each free slot. Tensor cores play no part: the ranks are integer.
#include "common.cuh"

using namespace fantoch;

namespace {

constexpr int THREADS = 512, WARPS = THREADS / 32;  // land_emissions.py

// Exclusive prefix of __popc(bits[i]) over i < n into pre[i]; returns the
// total. Each thread owns a contiguous chunk of words; the chunk counts
// are scanned with warp shuffles and one shared row of warp totals
// (s_warp[32]). Every thread must call.
__device__ int scan_popc(const unsigned* bits, int n, int* pre, int* s_warp) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int chunk = (n + THREADS - 1) / THREADS;
  const int lo = min(t * chunk, n), hi = min(lo + chunk, n);
  int cnt = 0;
  for (int i = lo; i < hi; ++i) cnt += __popc(bits[i]);
  int x = cnt;  // inclusive scan inside the warp
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[w] = x;
  __syncthreads();
  if (w == 0) {
    int v = lane < WARPS ? s_warp[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, v, o);
      if (lane >= o) v += y;
    }
    s_warp[lane] = v;
  }
  __syncthreads();
  int r = (w > 0 ? s_warp[w - 1] : 0) + x - cnt;
  for (int i = lo; i < hi; ++i) {
    pre[i] = r;
    r += __popc(bits[i]);
  }
  const int total = s_warp[WARPS - 1];
  __syncthreads();
  return total;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

}  // namespace

__global__ void __launch_bounds__(THREADS) land_emissions_kernel(
    int* __restrict__ pool, const int* __restrict__ arrival,
    const bool* __restrict__ deliver, const int* __restrict__ new_rows,
    const int* __restrict__ peak_in, const int* __restrict__ err_in,
    const int* __restrict__ popped, const bool* __restrict__ has,
    const RunCap cap, int M, int W, int E, int N,
    bool* __restrict__ overflow_out, int* __restrict__ peak_out,
    int* __restrict__ err_out, bool* __restrict__ running_out) {
  extern __shared__ unsigned smem[];
  const int l = blockIdx.x, t = threadIdx.x, lane = t & 31, w = t >> 5;
  const bool runs = cap.runs(l);
  if (t == 0) running_out[l] = runs;
  if (!runs) {
    if (t == 0) {
      overflow_out[l] = false;
      peak_out[l] = peak_in[l];
      err_out[l] = err_in[l];
    }
    return;
  }
  const long long g0 = (long long)l * M;  // the lane's first arrival word
  const int off = (int)(g0 & 3);
  const int nfw = (off + M + 31) >> 5, ndw = (E + 31) >> 5;
  const int nq = (off + M + 3) >> 2;  // 16-byte quads of the row
  // shared memory (land_emissions.py smem_bytes): the free bits then the
  // delivered bits, their exclusive prefixes, the k-th delivered row, the
  // k-th free slot, the warp totals
  unsigned* bits = smem;
  int* pre = (int*)(bits + nfw + ndw);
  int* row_of = pre + nfw + ndw;
  int* slot_of = row_of + E;
  int* s_warp = slot_of + E;
  int* pl = pool + (long long)l * M * W;

  // 1. the free mask, a nibble per aligned quad, and the delivered bits
  const int4* ar4 = reinterpret_cast<const int4*>(arrival);
  const long long qa = g0 >> 2;
  for (int base = w * 32; base < nq; base += THREADS) {
    const int j = base + lane;
    unsigned nib = 0;
    if (j < nq) {
      const long long gw = (qa + j) * 4;
      if (gw >= g0 && gw + 4 <= g0 + M) {
        const int4 v = ar4[qa + j];
        nib = (v.x == INF) | (v.y == INF) << 1 | (v.z == INF) << 2 |
              (v.w == INF) << 3;
      } else {
        for (int k = 0; k < 4; ++k) {
          const long long x = gw + k;
          if (x >= g0 && x < g0 + M && arrival[x] == INF) nib |= 1u << k;
        }
      }
    }
    unsigned word = nib << (4 * (lane & 7));
    word |= __shfl_xor_sync(FULL, word, 1);
    word |= __shfl_xor_sync(FULL, word, 2);
    word |= __shfl_xor_sync(FULL, word, 4);
    if ((lane & 7) == 0 && j < nq) bits[j >> 3] = word;
  }
  const bool* dl = deliver + (long long)l * E;
  for (int c = w; c < ndw; c += WARPS) {
    const int e = c * 32 + lane;
    const unsigned word = __ballot_sync(FULL, e < E && dl[e]);
    if (lane == 0) bits[nfw + c] = word;
  }
  __syncthreads();

  // 2. ranks: free slots, then delivered rows, in one scan
  const int total = scan_popc(bits, nfw + ndw, pre, s_warp);
  const int n_free = ndw > 0 ? pre[nfw] : total;
  const int n_del = total - n_free;
  const int n_land = min(n_del, n_free);
  for (int c = w; c < ndw; c += WARPS) {
    const unsigned word = bits[nfw + c];
    if (word >> lane & 1u)
      row_of[pre[nfw + c] - n_free + __popc(word & lanemask_lt())] =
          c * 32 + lane;
  }
  for (int c = w; c < nfw && pre[c] < n_land; c += WARPS) {
    const unsigned word = bits[c];
    const int k = pre[c] + __popc(word & lanemask_lt());
    if ((word >> lane & 1u) && k < n_land) slot_of[k] = c * 32 + lane - off;
  }
  __syncthreads();

  // 3. the landing rows, a warp each
  const int* nr = new_rows + (long long)l * E * W;
  for (int k = w; k < n_land; k += WARPS) {
    const int* src = nr + (long long)row_of[k] * W;
    int* dst = pl + (long long)slot_of[k] * W;
    for (int j = lane; j < W; j += 32) dst[j] = src[j];
  }

  // 4. the arrival words that changed, where no row landed
  auto lands = [&](int m) {
    const int b = m + off;
    const unsigned word = bits[b >> 5];
    return (word >> (b & 31) & 1u) &&
           pre[b >> 5] + __popc(word & ((1u << (b & 31)) - 1u)) < n_land;
  };
  if (cap.flags & RunCap::CRASH) {
    for (int c = w; c < nfw; c += WARPS) {
      const unsigned word = bits[c];
      const int m = c * 32 + lane - off;
      if ((word >> lane & 1u) &&
          pre[c] + __popc(word & lanemask_lt()) >= n_land &&
          pl[(long long)m * W + PA] != INF)
        pl[(long long)m * W + PA] = INF;
    }
  } else if (t < N && has[(long long)l * N + t]) {
    const int m = popped[(long long)l * N + t];
    if (!lands(m)) pl[(long long)m * W + PA] = arrival[g0 + m];
  }
  if (t == 0) {
    overflow_out[l] = n_del > n_free;
    peak_out[l] = max(peak_in[l], M - n_free + n_del);
    err_out[l] = err_in[l] | (n_del > n_free ? ERR_POOL : 0);
  }
}

extern "C" int fantoch_land_emissions(
    void* pool, const void* arrival, const void* deliver,
    const void* new_rows, const void* peak_in, const void* err_in,
    const void* popped, const void* has, const void* cap_tab,
    void* overflow_out, void* peak_out, void* err_out, void* running_out,
    int L, int M, int W, int E, int N, int flags, int smem, void* stream) {
  if (L == 0) return 0;
  land_emissions_kernel<<<L, THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      (int*)pool, (const int*)arrival, (const bool*)deliver,
      (const int*)new_rows, (const int*)peak_in, (const int*)err_in,
      (const int*)popped, (const bool*)has,
      run_cap((const void* const*)cap_tab, flags), M, W, E, N,
      (bool*)overflow_out, (int*)peak_out, (int*)err_out,
      (bool*)running_out);
  return (int)cudaGetLastError();
}
