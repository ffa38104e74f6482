// The safety monitors' hook in the handler kernels (K4, K5, K8, K9, K10):
// the device side of fantoch_tpu/engine/monitor.py mon_exec :150, under
// the names of the port's twin (fantoch_tpu_torch/engine/monitor.py).
//
// A monitored step passes each handler kernel the three monitor planes of
// every (lane, process), in and out: the per-key order hashes [KM] and
// counts [KM] and the guard word, with the key capacity KM. KM == 0 means
// null planes: no copy, no branch, nothing written. The kernel copies its
// process's rows and guard word with mon_copy at its start, and records
// each execution through mon_view(...).exec at its executor's choke point.
// K4, K8, K9 and K10 update the planes in place: their out planes are their
// in planes, and they skip mon_copy.
// The hash is h * HASH_MUL + (src * 2^20 + seq + 1) in uint32_t, which
// wraps exactly as the reference's int32 arithmetic.
#pragma once

#include "common.cuh"

namespace fantoch {

constexpr unsigned HASH_MUL = 1000003u;         // engine/monitor.py
constexpr int MON_F_PREMATURE = 1, MON_F_KEYRANGE = 2;
constexpr unsigned MON_SEQ_BOUND = 1u << 20;    // engine/dims.py SEQ_BOUND

struct MonArgs {
  const unsigned* hash_in;
  const int* cnt_in;
  const int* flags_in;
  unsigned* hash_o;
  int* cnt_o;
  int* flags_o;
  int KM;
};

inline MonArgs mon_args(const void* hash_in, const void* cnt_in,
                        const void* flags_in, void* hash_o, void* cnt_o,
                        void* flags_o, int KM) {
  return MonArgs{(const unsigned*)hash_in, (const int*)cnt_in,
                 (const int*)flags_in,     (unsigned*)hash_o,
                 (int*)cnt_o,              (int*)flags_o,
                 KM};
}

// One (lane, process)'s monitor: its output rows and guard word.
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

// Copy process g's rows and guard word to the output planes (threads t
// of nt, strided); the caller synchronises before a writer reads them.
// Done at the kernel's start, so no register holds monitor state through
// the kernel: the choke point takes a view (mon_view) where it records.
__device__ inline void mon_copy(const MonArgs& a, long long g, int t,
                                int nt) {
  if (a.KM == 0) return;
  const long long o = g * a.KM;
  for (int i = t; i < a.KM; i += nt) {
    a.hash_o[o + i] = a.hash_in[o + i];
    a.cnt_o[o + i] = a.cnt_in[o + i];
  }
  if (t == 0) a.flags_o[g] = a.flags_in[g];
}

// Process g's output rows (after mon_copy).
__device__ inline Mon mon_view(const MonArgs& a, long long g) {
  if (a.KM == 0) return Mon{nullptr, nullptr, nullptr, 0};
  return Mon{a.hash_o + g * a.KM, a.cnt_o + g * a.KM, a.flags_o + g, a.KM};
}

}  // namespace fantoch
