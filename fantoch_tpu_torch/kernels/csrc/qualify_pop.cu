// K1 qualify_pop: the engine step's event-time qualification and message
// pop (replaces fantoch_tpu/engine/core.py _lane_step sections 1-2,
// lines 811-904, with frontier_min :274 and mark_popped :261, and the
// fault plan's crash cut-off :799-809 and horizon :836-840).
//
// Under FLAG_CRASH every slot at or past its destination's crash time
// reads as INF (a destination out of range reads crash time 0, the
// reference's one-hot take), here and in the freed arrival column that
// K2 writes back to the pool, and a crashed process's timers read as INF
// and are written to timers_out, which the handlers' fire and K6's timer
// update read. Under FLAG_HORIZON no event at or past the lane's horizon
// is active. Without the flags the kernel runs the fault-free code.
//
// One block per lane, its threads over the lane's pool slots (a block
// size from qualify_pop.py block_threads), in five parts:
// 1. One pass over the pool: each thread reads the arrival and
//    destination words of its slots once (UNROLL slots in flight), cuts
//    the arrival at the destination's crash time, and stages both in
//    shared memory: the arrival as an int, the destination as a byte
//    (NO_DST for one out of range), 5 bytes a slot. The first S slots
//    are staged, S the most that fits the card's shared memory beside
//    the per-process words (about 46,000 slots on an H100 at N = 5;
//    every slot of the main paths' pools); parts 3 and 5 re-read a slot
//    past S from the pool, so any pool size runs. The per-destination
//    minima fold in the same pass: the threads of a warp with one
//    destination (__match_any_sync) reduce their arrivals
//    (__reduce_min_sync) and the group's first thread takes one shared
//    atomicMin. The [N, R] timers fold into the same minima.
// 2. After a barrier, thread p (of the first N) evaluates process p's
//    conservative bound (column min of e_q + lookahead[q, p]), the lane
//    minimum T, `active`, the timers that fire and whether p pops.
// 3. Only if some process pops: the slots whose destination pops and
//    whose staged arrival equals its event time read their prio, ksrc
//    and kcnt words from the pool. The lexicographic minimum of
//    (!prio, ksrc, kcnt, slot) is taken exactly in two rounds of 64-bit
//    shared atomicMin: the high word (!prio, ksrc) per destination, a
//    barrier, then the low word (kcnt, slot) among the candidates whose
//    high word won. Ties go to the lowest slot, as jnp.argmin breaks
//    them, and a process that pops nothing reports slot 0.
// 4. The block gathers the N popped rows (row 0 where nothing popped).
// 5. It writes the freed arrival column once, coalesced, from the
//    staged arrivals (past S, re-read), with the popped slots set to
//    INF.
//
// Frozen lanes: a lane whose run predicate is false at the step's start
// (common.cuh RunCap; every lane without a cap) reads nothing of the pool.
// Its block writes the defined "nothing happens" outputs and returns: ep
// INF, active, fire and has false, slot 0, rows zero, arrival INF, now the
// lane's now plane and, under FLAG_CRASH, timers_out its input timers as
// they were. The step's state planes that K1 writes (now, and the timers
// under the crash flag) keep a frozen lane's rows, as every kernel of the
// step does: no select follows the step.
//
// Bound on this card: bytes: every slot's arrival and destination words,
// the key words of the slots that compete in a pop and the outputs
// (qualify_pop.py work). The pool's rows are W words, so the arrival and
// destination words of a slot share one 32-byte sector at best (PERF.md
// §6's sector floor), and on the card the kernel's time grows with the
// rows' width at one pool size (PERF.md §6): the row layout, not this
// kernel's work, sets it. A column of arrivals and destinations would
// read 8 bytes a slot. The work per byte is a handful of integer
// compares.
#include <algorithm>

#include "common.cuh"

using namespace fantoch;

namespace {

constexpr int FLAG_CRASH = 1;    // engine/faults.py FLAG_CRASH
constexpr int FLAG_HORIZON = 8;  // engine/faults.py FLAG_HORIZON
constexpr int NO_DST = 0xff;     // a staged destination out of [0, N)
constexpr int UNROLL = 4;        // slots a thread has in flight
constexpr unsigned long long NONE = ~0ull;

}  // namespace

__global__ void qualify_pop_kernel(
    const int* __restrict__ pool, const int* __restrict__ next_periodic,
    const int* __restrict__ lookahead, const int* __restrict__ crash_t,
    const int* __restrict__ horizon, const RunCap cap, int M, int S, int W,
    int N, int R, int flags, int* __restrict__ arrival_out,
    int* __restrict__ ep_out, int* __restrict__ now_out,
    bool* __restrict__ active_out, bool* __restrict__ fire_out,
    int* __restrict__ slot_out, bool* __restrict__ has_out,
    int* __restrict__ rows_out, int* __restrict__ timers_out) {
  extern __shared__ unsigned long long smem[];
  const int l = blockIdx.x;
  const int t = threadIdx.x, nt = blockDim.x, lane = t & 31;
  const size_t lN = (size_t)l * N;
  const bool crash = flags & FLAG_CRASH;

  if (!cap.runs(l)) {  // frozen: nothing read, the defined outputs
    for (int i = t; i < N; i += nt) {
      ep_out[lN + i] = INF;
      active_out[lN + i] = false;
      has_out[lN + i] = false;
      slot_out[lN + i] = 0;
    }
    for (int i = t; i < N * R; i += nt) {
      fire_out[lN * R + i] = false;
      if (crash) timers_out[lN * R + i] = next_periodic[lN * R + i];
    }
    for (int i = t; i < N * W; i += nt) rows_out[lN * W + i] = 0;
    for (int m = t; m < M; m += nt) arrival_out[(size_t)l * M + m] = INF;
    if (t == 0) now_out[l] = cap.now[l];
    return;
  }

  // shared memory: the pop's two words per process, then per process its
  // event time, crash time, popped slot (-1: none) and pop flag, the
  // masked timers, the first S slots' staged arrivals and destinations
  unsigned long long* s_hi = smem;
  unsigned long long* s_lo = smem + N;
  int* s_ep = (int*)(smem + 2 * N);
  int* s_crash = s_ep + N;
  int* s_slot = s_crash + N;
  int* s_pops = s_slot + N;
  int* s_tim = s_pops + N;
  int* s_arr = s_tim + N * R;
  unsigned char* s_dst = (unsigned char*)(s_arr + S);
  const int* P = pool + (size_t)l * M * W;

  // a slot's arrival, INF at or past its destination's crash time, and
  // its destination, NO_DST out of range
  auto cut = [&](int& a, int& d) {
    const bool in = d >= 0 && d < N;
    if (crash && a >= (in ? s_crash[d] : 0)) a = INF;
    if (!in) d = NO_DST;
  };
  // slot m's cut arrival and destination: staged below S, else re-read
  auto slot_of = [&](int m, int& a, int& d) {
    if (m < S) {
      a = s_arr[m];
      d = s_dst[m];
    } else {
      a = P[(size_t)m * W + PA];
      d = P[(size_t)m * W + PDST];
      cut(a, d);
    }
  };

  for (int i = t; i < N; i += nt) {
    s_ep[i] = INF;
    s_hi[i] = s_lo[i] = NONE;
    if (crash) s_crash[i] = crash_t[lN + i];
  }
  __syncthreads();

  // 1. timers (INF once at or past the process's crash time), then the
  // pool's arrivals, each folded into its destination's minimum
  for (int i = t; i < N * R; i += nt) {
    int v = next_periodic[lN * R + i];
    if (crash && v >= s_crash[i / R]) v = INF;
    s_tim[i] = v;
    if (crash) timers_out[lN * R + i] = v;
    atomicMin(&s_ep[i / R], v);
  }
  for (int base = 0; base < M; base += UNROLL * nt) {
    int a[UNROLL], d[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int m = base + u * nt + t;
      a[u] = INF;
      d[u] = NO_DST;
      if (m < M) {
        a[u] = P[(size_t)m * W + PA];
        d[u] = P[(size_t)m * W + PDST];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int m = base + u * nt + t;
      cut(a[u], d[u]);
      if (m < S) {
        s_arr[m] = a[u];
        s_dst[m] = (unsigned char)d[u];
      }
      // every thread of the warp takes part (m past M: NO_DST, INF)
      const unsigned grp = __match_any_sync(FULL, d[u]);
      const int low = __reduce_min_sync(grp, a[u]);
      if (d[u] != NO_DST && lane == __ffs(grp) - 1)
        atomicMin(&s_ep[d[u]], low);
    }
  }
  __syncthreads();

  // 2. conservative bound, lane-wide minimum, qualification
  if (t < N) {
    const int p = t, ep = s_ep[p];
    int bound = INF, T = INF;
    for (int q = 0; q < N; ++q) {
      const int eq = s_ep[q];
      const int la = lookahead[(lN + q) * N + p];
      const int reach = (eq >= INF || la >= INF) ? INF : eq + la;
      bound = min(bound, reach);
      T = min(T, eq);
    }
    const bool active = ep < INF && (ep < bound || ep == T) &&
                        (!(flags & FLAG_HORIZON) || ep < horizon[l]);
    bool fired_any = false;
    for (int r = 0; r < R; ++r) {
      const bool f = active && s_tim[p * R + r] == ep;
      fired_any |= f;
      fire_out[(lN + p) * R + r] = f;
    }
    ep_out[lN + p] = ep;
    active_out[lN + p] = active;
    s_pops[p] = active && !fired_any;
    if (p == 0) now_out[l] = T;
  }
  __syncthreads();

  // 3. pop: lexicographic min of (!prio, ksrc, kcnt, slot) over each
  // popping process's candidates; signed keys are biased into unsigned
  // order
  bool any_pops = false;
  for (int q = 0; q < N; ++q) any_pops |= s_pops[q] != 0;
  if (any_pops) {  // block-uniform
    auto high = [&](int m) {
      const int* row = P + (size_t)m * W;
      return ((unsigned long long)(row[PPR] == 0) << 32) |
             (unsigned)(row[PKS] ^ 0x80000000);
    };
    auto candidate = [&](int a, int d) {
      return d != NO_DST && s_pops[d] && a == s_ep[d];
    };
    for (int m = t; m < M; m += nt) {
      int a, d;
      slot_of(m, a, d);
      if (candidate(a, d)) atomicMin(&s_hi[d], high(m));
    }
    __syncthreads();
    for (int m = t; m < M; m += nt) {
      int a, d;
      slot_of(m, a, d);
      if (candidate(a, d) && high(m) == s_hi[d]) {
        const int kcnt = P[(size_t)m * W + PKC];
        atomicMin(&s_lo[d],
                  ((unsigned long long)(unsigned)(kcnt ^ 0x80000000) << 32) |
                      (unsigned)m);
      }
    }
    __syncthreads();
  }
  if (t < N) {
    const bool has = s_hi[t] != NONE;
    const int slot = has ? (int)(s_lo[t] & 0xffffffffu) : 0;
    has_out[lN + t] = has;
    slot_out[lN + t] = slot;
    s_slot[t] = has ? slot : -1;
  }
  __syncthreads();

  // 4. the popped rows (row 0 where nothing popped)
  for (int i = t; i < N * W; i += nt) {
    const int p = i / W, s = s_slot[p];
    rows_out[lN * W + i] = P[(size_t)(s < 0 ? 0 : s) * W + (i - p * W)];
  }
  // 5. free the popped slots: a popped slot is its destination's
  for (int m = t; m < M; m += nt) {
    int a, d;
    slot_of(m, a, d);
    arrival_out[(size_t)l * M + m] = (d != NO_DST && s_slot[d] == m) ? INF : a;
  }
}

extern "C" int fantoch_qualify_pop(
    const void* pool, const void* next_periodic, const void* lookahead,
    const void* crash_t, const void* horizon, const void* cap_tab,
    void* arrival_out, void* ep_out, void* now_out, void* active_out,
    void* fire_out, void* slot_out, void* has_out, void* rows_out,
    void* timers_out, int L, int M, int W, int N, int R, int flags,
    int cap_flags, int threads, void* stream) {
  if (L == 0) return 0;
  if (N < 1 || N > 32 || threads < 32 || threads > 1024 || threads % 32)
    return (int)cudaErrorInvalidValue;
  // the per-process words, then as many staged slots as the card's
  // shared memory a block takes (5 bytes a slot)
  int dev = 0, most = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return (int)e;
  const size_t fixed = (size_t)2 * N * sizeof(unsigned long long) +
                       (size_t)(4 * N + N * R) * sizeof(int);
  if (fixed > (size_t)most) return (int)cudaErrorInvalidValue;
  const int S = (int)std::min((size_t)M, ((size_t)most - fixed) / 5);
  const size_t smem = fixed + (size_t)5 * S;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(qualify_pop_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  qualify_pop_kernel<<<L, threads, smem, (cudaStream_t)stream>>>(
      (const int*)pool, (const int*)next_periodic, (const int*)lookahead,
      (const int*)crash_t, (const int*)horizon,
      run_cap((const void* const*)cap_tab, cap_flags), M, S, W, N, R, flags,
      (int*)arrival_out, (int*)ep_out, (int*)now_out, (bool*)active_out,
      (bool*)fire_out, (int*)slot_out, (bool*)has_out, (int*)rows_out,
      (int*)timers_out);
  return (int)cudaGetLastError();
}
