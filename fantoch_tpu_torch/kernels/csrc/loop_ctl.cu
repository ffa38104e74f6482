// K14 loop_ctl: the device loop's control step (replaces the loop
// predicate and segment cut of fantoch_tpu/engine/core.py build_runner
// :1591, segment_lane_fn :1740 and window_batch_fn :1860: the condition
// of the vmapped lax.while_loop, its cut at `until`, and the scan over a
// window's [W] ladder of segment ends with liveness carried out).
//
// One block. It runs once before a window's while loop and once at the
// end of every loop body (step_loop.cu), over the resident state:
//   - every lane's predicate (_lane_running :1565, the fault horizon
//     under FLAG_HORIZON) is evaluated twice, under the current step
//     limit lim ("active") and under max_steps ("alive"), and each is
//     OR-ed over the batch;
//   - while no lane is active, one is alive and the window has rungs
//     left, lim moves to the next rung, min(untils[rung], max_steps):
//     the reference's next segment of the window (a segment in which no
//     lane steps is a no-op, so the ladder is walked until one does);
//   - in a body, the body counter goes up by one (the launch counts of
//     the kernels a replayed body runs come from it);
//   - the window's liveness word is any(alive), the last segment's
//     verdict as window_batch_fn returns it;
//   - the condition, any(active), goes to the while node through
//     cudaGraphSetConditional (and to ctl[COND] for the host and the
//     twin). Outside a graph (handle 0) only the words are written.
// The control block ctl (kernels/loop_ctl.py): W and max_steps from the
// host, lim, rung, alive and cond from this kernel; the window's ladder
// of segment ends, untils[W], in a buffer of its own.
//
// Bound on this card: bytes, the predicate's five words per lane (six
// under the horizon flag), read once, and the rungs it walks; a launch
// costs its latency (a few microseconds), not its bytes.
#include <cstdint>

#include "common.cuh"

using namespace fantoch;

namespace {

constexpr int FLAG_HORIZON = 8;  // engine/faults.py FLAG_HORIZON
// loop_ctl.py CTL_* word offsets
constexpr int CTL_W = 0, CTL_MAXS = 1, CTL_LIM = 2, CTL_RUNG = 3,
              CTL_ALIVE = 4, CTL_COND = 5;

}  // namespace

__global__ void loop_ctl_kernel(const int* __restrict__ done_time,
                                const int* __restrict__ now,
                                const int* __restrict__ err,
                                const int* __restrict__ steps,
                                const int* __restrict__ extra,
                                const int* __restrict__ horizon,
                                const int* __restrict__ ladder,
                                int* __restrict__ ctl, int* __restrict__ iters,
                                int L, int flags, int in_body,
                                cudaGraphConditionalHandle handle) {
  const int t = threadIdx.x;
  const int W = ctl[CTL_W], maxs = ctl[CTL_MAXS];
  int rung = in_body ? ctl[CTL_RUNG] : 0;
  int lim = in_body ? ctl[CTL_LIM] : min(ladder[0], maxs);
  // each thread's lanes: live (the predicate without its step cap) and
  // the least step count among them
  int least = INF;
  bool alive = false;
  for (int l = t; l < L; l += blockDim.x) {
    const int done = done_time[l], nw = now[l];
    const int end = done >= INF ? INF : done + extra[l];
    const bool finished = done < INF && nw >= end;
    const bool idle = nw >= INF;
    const bool live = !(finished || idle || err[l] != 0) &&
                      (!(flags & FLAG_HORIZON) || nw < horizon[l]);
    if (live && steps[l] < maxs) {
      alive = true;
      least = min(least, steps[l]);
    }
  }
  // an alive lane is active under lim iff its step count is below lim
  const bool any_alive = __syncthreads_or(alive);
  bool any_active = __syncthreads_or(least < lim);
  while (!any_active && any_alive && rung < W - 1) {
    ++rung;
    lim = min(ladder[rung], maxs);
    any_active = __syncthreads_or(least < lim);
  }
  if (t == 0) {
    ctl[CTL_LIM] = lim;
    ctl[CTL_RUNG] = rung;
    ctl[CTL_ALIVE] = any_alive;
    ctl[CTL_COND] = any_active;
    if (in_body) ++iters[0];
    if (handle) cudaGraphSetConditional(handle, any_active ? 1u : 0u);
  }
}

// the kernel's address, for the graph nodes step_loop.cu builds
extern "C" void* fantoch_loop_ctl_kernel() { return (void*)loop_ctl_kernel; }

// one block of at most 1024 threads, a multiple of 32
extern "C" unsigned fantoch_loop_ctl_threads(int L) {
  const int n = ((L + 31) / 32) * 32;
  return (unsigned)(n < 32 ? 32 : (n > 1024 ? 1024 : n));
}

extern "C" int fantoch_loop_ctl(const void* done_time, const void* now,
                                const void* err, const void* steps,
                                const void* extra, const void* horizon,
                                const void* ladder, void* ctl, void* iters,
                                int L, int flags, int in_body, void* stream) {
  loop_ctl_kernel<<<1, fantoch_loop_ctl_threads(L), 0,
                    (cudaStream_t)stream>>>(
      (const int*)done_time, (const int*)now, (const int*)err,
      (const int*)steps, (const int*)extra, (const int*)horizon,
      (const int*)ladder, (int*)ctl, (int*)iters, L, flags, in_body,
      (cudaGraphConditionalHandle)0);
  return (int)cudaGetLastError();
}
