// The safety monitors' hook in the handler kernels (K4, K5, K8, K9, K10):
// the device side of fantoch_tpu/engine/monitor.py mon_exec :150, under
// the names of the port's twin (fantoch_tpu_torch/engine/monitor.py).
//
// A monitored step passes each handler kernel the three monitor planes of
// every (lane, process): the per-key order hashes [KM] and counts [KM] and
// the guard word, with the key capacity KM. KM == 0 means null planes: no
// branch, nothing written. Every monitored handler (K4, K5, K8, K9, K10)
// updates the planes in place, and records each execution through
// mon_view(...).exec at its executor's choke point.
// The hash is h * HASH_MUL + (src * 2^20 + seq + 1) in uint32_t, which
// wraps exactly as the reference's int32 arithmetic.
#pragma once

#include "common.cuh"

namespace fantoch {

constexpr unsigned HASH_MUL = 1000003u;         // engine/monitor.py
constexpr int MON_F_PREMATURE = 1, MON_F_KEYRANGE = 2;
constexpr unsigned MON_SEQ_BOUND = 1u << 20;    // engine/dims.py SEQ_BOUND

struct MonArgs {
  unsigned* hash;
  int* cnt;
  int* flags;
  int KM;
};

inline MonArgs mon_args(void* hash, void* cnt, void* flags, int KM) {
  return MonArgs{(unsigned*)hash, (int*)cnt, (int*)flags, KM};
}

// One (lane, process)'s monitor: its rows and guard word.
struct Mon {
  unsigned* hash;
  int* cnt;
  int* flags;
  int KM;

  // Record `(src, seq)` executed on `key` when `do_`. Warp- or
  // block-uniform callers pass the same arguments from every thread;
  // only `writer` touches memory.
  __device__ void exec(int key, int src, int seq, bool do_, bool premature,
                       bool writer) const {
    if (KM == 0 || !writer || !do_) return;
    const bool in_range = key >= 0 && key < KM;
    if (in_range) {
      const unsigned cmd =
          (unsigned)src * MON_SEQ_BOUND + (unsigned)seq + 1u;
      hash[key] = hash[key] * HASH_MUL + cmd;
      cnt[key] += 1;
    }
    if (premature) *flags |= MON_F_PREMATURE;
    if (!in_range) *flags |= MON_F_KEYRANGE;
  }
};

// Process g's rows, updated in place.
__device__ inline Mon mon_view(const MonArgs& a, long long g) {
  if (a.KM == 0) return Mon{nullptr, nullptr, nullptr, 0};
  return Mon{a.hash + g * a.KM, a.cnt + g * a.KM, a.flags + g, a.KM};
}

}  // namespace fantoch
