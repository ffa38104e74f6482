// Lock-free atomic key clocks + sharded concurrent key map.
//
// Native analog of the reference's concurrency showpiece:
// `AtomicKeyClocks` (fantoch_ps/src/protocol/common/table/clocks/keys/
// atomic.rs:13-90 — per-key AtomicU64 clocks with a two-round bump that
// equalizes every key of a command at the highest clock, emitting the
// vacated ranges as votes) backed by a `SharedMap`-style concurrent map
// (fantoch/src/shared.rs:18-112 — here open-addressing with CAS-claimed
// slots, lock-free for the fixed-universe workloads the sequencer
// benchmark uses).
//
// Exposed through a C ABI for ctypes (no pybind11 in this toolchain):
//   kc_new / kc_free
//   kc_proposal   one command's two-round bump; returns the proposal
//                 clock and per-key vote ranges
//   kc_detached   bump keys up to a floor, collecting vacated ranges
//   kc_clock      read one key's clock
//   kc_stress     spawn OS threads hammering kc_proposal and verify the
//                 algebraic postcondition the reference's concurrency
//                 tests assert (table/clocks/keys/mod.rs:70-338): the
//                 union of all emitted votes per key is exactly the
//                 gap-free set 1..=final_clock, with no duplicates.
//
// Build: fantoch_tpu_torch/native/keyclocks.py, at first use, with
// g++ -O2 -std=c++17 -shared -fPIC -pthread into fantoch_tpu_torch/_build/.

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

namespace {

struct KeyClocks {
    uint64_t cap;    // power of two
    uint64_t mask;
    // open addressing: slot i holds key+1 (0 = empty) and its clock
    std::vector<std::atomic<uint64_t>> keys;
    std::vector<std::atomic<uint64_t>> clocks;

    explicit KeyClocks(uint64_t capacity) {
        cap = 1;
        while (cap < capacity * 2) cap <<= 1;
        mask = cap - 1;
        keys = std::vector<std::atomic<uint64_t>>(cap);
        clocks = std::vector<std::atomic<uint64_t>>(cap);
        for (uint64_t i = 0; i < cap; i++) {
            keys[i].store(0, std::memory_order_relaxed);
            clocks[i].store(0, std::memory_order_relaxed);
        }
    }

    static uint64_t hash(uint64_t k) {
        // splitmix64 finalizer
        k += 0x9e3779b97f4a7c15ull;
        k = (k ^ (k >> 30)) * 0xbf58476d1ce4e5b9ull;
        k = (k ^ (k >> 27)) * 0x94d049bb133111ebull;
        return k ^ (k >> 31);
    }

    // find-or-insert; lock-free (shared.rs get_or_insert semantics)
    int64_t slot(uint64_t key) {
        uint64_t i = hash(key) & mask;
        for (uint64_t probes = 0; probes <= mask; probes++, i = (i + 1) & mask) {
            uint64_t cur = keys[i].load(std::memory_order_acquire);
            if (cur == key + 1) return (int64_t)i;
            if (cur == 0) {
                uint64_t expected = 0;
                if (keys[i].compare_exchange_strong(
                        expected, key + 1, std::memory_order_acq_rel))
                    return (int64_t)i;
                if (expected == key + 1) return (int64_t)i;
                // claimed by another key; keep probing
            }
        }
        return -1;  // table full
    }
};

struct Range {
    uint64_t key, start, end;
};

// atomic.rs bump: lift the clock to max(cur + 1, min_clock); the caller
// owns the vacated range (cur, next].
inline void bump(KeyClocks* kc, int64_t s, uint64_t min_clock,
                 uint64_t key, std::vector<Range>& out) {
    uint64_t cur = kc->clocks[s].load(std::memory_order_relaxed);
    for (;;) {
        uint64_t next = cur + 1 > min_clock ? cur + 1 : min_clock;
        if (kc->clocks[s].compare_exchange_weak(
                cur, next, std::memory_order_acq_rel)) {
            out.push_back({key, cur + 1, next});
            return;
        }
        // cur reloaded by the failed CAS
    }
}

// atomic.rs bump_up_to: lift to `target` only if below; the vacated
// range (cur, target] is ours, or nothing if already past it.
inline void bump_up_to(KeyClocks* kc, int64_t s, uint64_t target,
                       uint64_t key, std::vector<Range>& out) {
    uint64_t cur = kc->clocks[s].load(std::memory_order_relaxed);
    while (cur < target) {
        if (kc->clocks[s].compare_exchange_weak(
                cur, target, std::memory_order_acq_rel)) {
            out.push_back({key, cur + 1, target});
            return;
        }
    }
}

// Two-round proposal (atomic.rs:28-63): round 1 bumps every key past
// min_clock, round 2 equalizes all keys at the highest clock observed,
// so the proposal timestamp is a valid vote on every key. Returns 0
// (never a valid clock) when the table is full.
uint64_t proposal(KeyClocks* kc, const uint64_t* cmd_keys, uint64_t nk,
                  uint64_t min_clock, std::vector<Range>& out) {
    std::vector<int64_t> slots(nk);
    for (uint64_t k = 0; k < nk; k++) {
        slots[k] = kc->slot(cmd_keys[k]);
        if (slots[k] < 0) return 0;
    }
    size_t first = out.size();
    uint64_t highest = 0;
    for (uint64_t k = 0; k < nk; k++) {
        bump(kc, slots[k], min_clock, cmd_keys[k], out);
        uint64_t end = out.back().end;
        if (end > highest) highest = end;
    }
    for (uint64_t k = 0; k < nk; k++) {
        if (out[first + k].end < highest)
            bump_up_to(kc, slots[k], highest, cmd_keys[k], out);
    }
    return highest;
}

}  // namespace

extern "C" {

void* kc_new(uint64_t capacity) { return new KeyClocks(capacity); }

void kc_free(void* h) { delete static_cast<KeyClocks*>(h); }

uint64_t kc_clock(void* h, uint64_t key) {
    auto* kc = static_cast<KeyClocks*>(h);
    int64_t s = kc->slot(key);
    return s < 0 ? 0 : kc->clocks[s].load(std::memory_order_acquire);
}

// out: triples (key, start, end); returns the proposal clock, or 0 on
// overflow of out_cap (never expected: 2 ranges per key suffice).
uint64_t kc_proposal(void* h, const uint64_t* keys, uint64_t nk,
                     uint64_t min_clock, uint64_t* out, uint64_t out_cap,
                     uint64_t* out_n) {
    auto* kc = static_cast<KeyClocks*>(h);
    std::vector<Range> ranges;
    uint64_t clock = proposal(kc, keys, nk, min_clock, ranges);
    if (ranges.size() * 3 > out_cap) return 0;
    for (size_t i = 0; i < ranges.size(); i++) {
        out[3 * i] = ranges[i].key;
        out[3 * i + 1] = ranges[i].start;
        out[3 * i + 2] = ranges[i].end;
    }
    *out_n = ranges.size();
    return clock;
}

uint64_t kc_detached(void* h, const uint64_t* keys, uint64_t nk,
                     uint64_t up_to, uint64_t* out, uint64_t out_cap,
                     uint64_t* out_n) {
    auto* kc = static_cast<KeyClocks*>(h);
    std::vector<Range> ranges;
    for (uint64_t k = 0; k < nk; k++) {
        int64_t s = kc->slot(keys[k]);
        if (s < 0) return 0;
        bump_up_to(kc, s, up_to, keys[k], ranges);
    }
    if (ranges.size() * 3 > out_cap) return 0;
    for (size_t i = 0; i < ranges.size(); i++) {
        out[3 * i] = ranges[i].key;
        out[3 * i + 1] = ranges[i].start;
        out[3 * i + 2] = ranges[i].end;
    }
    *out_n = ranges.size();
    return 1;
}

// The reference's multi-threaded stress test + the sequencer_bench
// workload in one call: `threads` OS threads each run `ops` proposals
// over `keys_per_op` keys drawn uniformly from [0, key_count). Verifies
// that per-key votes across all threads are duplicate-free and exactly
// cover 1..=final_clock. Returns 1 on success, 0 on a violated
// invariant; *elapsed_ns reports the hammer's wall time.
int32_t kc_stress(void* h, uint32_t threads, uint64_t ops,
                  uint64_t key_count, uint32_t keys_per_op, uint64_t seed,
                  uint64_t* elapsed_ns) {
    auto* kc = static_cast<KeyClocks*>(h);
    *elapsed_ns = 0;
    // distinct keys per command are impossible otherwise (the
    // rejection-sampling loop below would never terminate)
    if (keys_per_op == 0 || keys_per_op > key_count) return 0;
    std::vector<std::vector<Range>> votes(threads);
    std::vector<std::thread> pool;
    auto t0 = std::chrono::steady_clock::now();
    for (uint32_t t = 0; t < threads; t++) {
        pool.emplace_back([&, t] {
            std::mt19937_64 rng(seed + t);
            std::vector<uint64_t> cmd(keys_per_op);
            auto& mine = votes[t];
            mine.reserve(ops * (keys_per_op + 1));
            for (uint64_t i = 0; i < ops; i++) {
                // distinct keys per command (commands hold a key set)
                for (uint32_t k = 0; k < keys_per_op; k++) {
                    bool dup;
                    do {
                        cmd[k] = rng() % key_count;
                        dup = false;
                        for (uint32_t j = 0; j < k; j++)
                            if (cmd[j] == cmd[k]) dup = true;
                    } while (dup);
                }
                if (proposal(kc, cmd.data(), keys_per_op, 0, mine) == 0)
                    return;  // table full: surfaces as a vote gap below
            }
        });
    }
    for (auto& th : pool) th.join();
    auto t1 = std::chrono::steady_clock::now();
    *elapsed_ns = (uint64_t)std::chrono::duration_cast<
        std::chrono::nanoseconds>(t1 - t0).count();

    // postcondition: per key, the union of all votes is the gap-free,
    // duplicate-free set 1..=clock (table/clocks/keys/mod.rs:70-338)
    std::vector<std::vector<uint8_t>> seen(key_count);
    for (uint64_t k = 0; k < key_count; k++) {
        int64_t s = kc->slot(k);
        if (s < 0) return 0;  // table full
        seen[k].assign(kc->clocks[s].load() + 1, 0);
    }
    for (auto& mine : votes)
        for (auto& r : mine) {
            if (r.key >= key_count) return 0;
            auto& sk = seen[r.key];
            for (uint64_t v = r.start; v <= r.end; v++) {
                if (v >= sk.size() || sk[v]) return 0;  // gap bound / dup
                sk[v] = 1;
            }
        }
    for (uint64_t k = 0; k < key_count; k++)
        for (size_t v = 1; v < seen[k].size(); v++)
            if (!seen[k][v]) return 0;  // gap
    return 1;
}

}  // extern "C"
