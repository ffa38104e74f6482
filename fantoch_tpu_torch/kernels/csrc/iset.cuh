// Interval sets on the device: the add side of fantoch_tpu/engine/iset.py
// (iset_add_range :29, iset_add :68) and its membership side
// (iset_contains :72, iset_contains_gathered :92), under the names of the
// port's plain twin (fantoch_tpu_torch/engine/iset.py).
//
// A set is a frontier (all of 1..=frontier present) and G gap slots
// gaps[2*j] = start, gaps[2*j + 1] = end above it (start == 0: free).
// One thread owns one set; the gap words live in the caller's memory and
// are updated in place.
#pragma once

namespace fantoch {

// Union start..=end into (frontier, gaps[G]); returns the overflow flag
// (the range needed a gap slot and none was free: it is dropped).
// `start` is lifted to frontier + 1; a range adjacent to the frontier
// extends it, any other goes into the first free slot; then G passes each
// absorb every gap that touches the frontier as it stood at the start of
// the pass (a pass that absorbs nothing ends the chain: no later one can).
__device__ inline bool iset_add_range(int& frontier, int* gaps, int G,
                                      int start, int end, bool enable) {
  start = max(start, frontier + 1);
  const bool do_ = enable && end >= start;
  const bool direct = do_ && start == frontier + 1;
  if (direct) frontier = max(frontier, end);
  const bool store = do_ && !direct;
  int slot = -1;
  for (int j = 0; j < G && slot < 0; ++j)
    if (gaps[2 * j] == 0) slot = j;
  const bool overflow = store && slot < 0;
  if (store && !overflow) {
    gaps[2 * slot] = start;
    gaps[2 * slot + 1] = end;
  }
  for (int pass = 0; pass < G; ++pass) {
    int reach = 0;
    bool hit = false;
    for (int j = 0; j < G; ++j) {
      const int s = gaps[2 * j];
      if (s > 0 && s <= frontier + 1) {
        reach = max(reach, gaps[2 * j + 1]);
        gaps[2 * j] = 0;
        gaps[2 * j + 1] = 0;
        hit = true;
      }
    }
    if (!hit) break;
    frontier = max(frontier, reach);
  }
  return overflow;
}

__device__ inline bool iset_add(int& frontier, int* gaps, int G, int event,
                                bool enable = true) {
  return iset_add_range(frontier, gaps, G, event, event, enable);
}

// Membership of x (0 and below are never members).
__device__ inline bool iset_contains(int frontier, const int* gaps, int G,
                                     int x) {
  if (x < 1) return false;
  if (x <= frontier) return true;
  for (int j = 0; j < G; ++j) {
    const int s = gaps[2 * j];
    if (s > 0 && s <= x && x <= gaps[2 * j + 1]) return true;
  }
  return false;
}

// Membership of x in the set of source `src`, per-source state
// front_by_src[S] and gaps_by_src[S][G][2]. `src` indexes as jnp's gather
// does: a negative one counts from the end, the result is clamped into
// range.
__device__ inline bool iset_contains_gathered(const int* front_by_src,
                                              const int* gaps_by_src, int S,
                                              int G, int src, int x) {
  src = src < 0 ? src + S : src;
  src = min(max(src, 0), S - 1);
  return iset_contains(front_by_src[src], gaps_by_src + 2 * G * src, G, x);
}

}  // namespace fantoch
