// K10 caesar_handle: Caesar's readiness gate, periodic timers, message
// handlers, predecessors executor and wait condition for every (lane,
// process) (replaces fantoch_tpu/engine/core.py run_handlers :422 and the
// ready/periodic calls :890-918 with CaesarDev.ready :239, .periodic :309
// and .handle :270 of fantoch_tpu/engine/protocols/caesar.py: the ten
// handlers :780-1282, the key clock table :348-414, the dep unions
// _agg_union :888 and _agg_broadcast :947, the GC loops :688-772, the
// hoisted _exec_scan :587 and _wait_scan :498 with _blocker_verdicts :423,
// and both sides of fantoch_tpu/engine/iset.py, in iset.cuh).
//
// One block of 256 threads per (lane, process). The reference runs the
// handler as a lax.switch under vmap, which evaluates all eleven branches
// and selects one; here the block runs only its own branch, in the
// reference's order: `ready` on the incoming state, `periodic`, `handle`
// on the state `periodic` returned (the branch, then the exec scan, then
// the wait scan, each on the previous one's state).
//
// 1. The whole block copies the process's 29 non-scalar state planes
//    (976.9 KB at the main path's shapes) to the output tensors in 16-byte
//    coalesced rows, then works on the outputs in place. The nine scalar
//    planes (clock counter, sequence, buffer counts, metrics, error word)
//    live in thread 0's registers and are stored once at the end.
// 2. Thread 0 runs the gate, the timers and the branch, serially and in
//    the reference's order: the notification drain's and MGC's loops of
//    _gc_count (each with its _kc_remove over a key row) mark freed dots
//    in a shared [N, D] byte mask, which the whole block then applies
//    (_apply_freed: pseq, status, gc_cnt and the dot's dep_seq/bb_seq
//    rows). The dep unions are streamed: a new entry takes the next
//    originally free slot, and checking it against the updated table is
//    exact, because an entry equal to an earlier entry of the message is
//    a duplicate either way.
// 3. The exec scan (B11's executor) runs on the whole block, on EVERY
//    process, as the reference's does: each committed dot's DEP dep cells
//    (live: the cell still holds the dep's sequence, and its status says
//    committed/executed; dead: the executed set, iset_contains_gathered,
//    decides both; lower clock or not), ready by AND; then a block argmin
//    of min(clk_seq, INF/(N+1) - 1) * (N+1) + clk_pid over ready dots,
//    ties to the lowest flat index as jnp.argmin. Thread 0 applies the
//    pick (a disabled scan still absorbs at it) and stages TO_CLIENT in
//    slot F - 4 and EXEC_DRAIN in F - 3, valid or not. On a monitored step
//    (KM > 0) it first records the pick on its dot's key (caesar.py
//    :640-646; monitor.cuh), with no execute-before-commit guard.
// 4. The wait scan runs on the whole block after it: each waiting dot
//    (ST_PROPOSE_END with a present blocker) takes its BB blockers'
//    verdicts, then a block argmin of src * 2^20 + pseq over actionable
//    dots picks the reply, which thread 0 stages as an MProposeAck in slot
//    F - 2 (the accept payload at flat index 0 when nothing is actionable)
//    and WAIT_DRAIN in F - 1. The reference gathers "my dot is in the
//    blocker's deps" from a relation R[q, e, p, d] built by one scatter
//    (caesar.py:449-467); the scatter normalises a negative dep source by
//    + N and drops one still out of range, so R at the blocker's (clamped
//    source, slot) and this dot (p, d) is exactly: the blocker's dep row
//    has an entry j with dseq_j > 0, -N <= dsrc_j < N, normalised dsrc_j
//    == p, dot_slot(dseq_j) == d and pseq[p, d] == dseq_j. That is read
//    here from BB dep rows per waiting dot, without the [N, D, N, D]
//    relation (engine/protocols/caesar.py _blocker_member).
// 5. The block stores both outboxes.
//
// One-hot semantics of the reference: a read at an out-of-range index
// yields 0, a write there drops; dot slots use floor modulo (seq 0 maps to
// slot D - 1); the plain gathers (the gate's MGC check, the scans' cell
// reads, the blocker's dep row, the GC drain's buffer read) index as jnp's
// (negative from the end, clamped). A word thread 0 writes is read by
// other threads only after a __syncthreads().
//
// Bound on this card: bytes. The region reads a few state words per (lane,
// process), the rows its branch touches and the scans' committed and
// waiting dots, and writes the words that change and two [F, P] outboxes
// (caesar_handle.py work). This kernel copies each process's whole state
// out of place, so it moves far more than that, but in coalesced rows.
#include <climits>
#include <cstdint>

#include "common.cuh"
#include "iset.cuh"
#include "monitor.cuh"

using namespace fantoch;

namespace {

constexpr int THREADS = 256;  // caesar_handle.py THREADS
constexpr int SUBMIT = 0, MPROPOSE = 1, MPROPOSEACK = 2, MCOMMIT = 3,
              MRETRY = 4, MRETRYACK = 5, MGC = 6, WAIT_DRAIN = 7,
              EXEC_DRAIN = 8, GC_DRAIN = 9, NUM_TYPES = 10, TO_CLIENT = 11;
constexpr int ST_PROPOSE_END = 2, ST_REJECT = 3, ST_ACCEPT = 4,
              ST_COMMIT = 5, ST_EXECUTED = 6;
constexpr int ERR_SEQ = 4, ERR_DOT = 8, ERR_CAPACITY = 16, ERR_PROTO = 32;
constexpr int SEQ_BOUND = 1 << 20;

// state planes, in caesar_handle.py STATE_KEYS order
enum Plane {
  KC_SRC, KC_SEQ, KC_CSEQ, KC_CPID, CLK_COUNTER, PSEQ, STATUS, KEY_OF,
  CLIENT_OF, CLK_SEQ, CLK_PID, DEP_SRC, DEP_SEQ, BB_SRC, BB_SEQ, OWN_SEQ,
  QA_CNT, QA_OK, QA_DONE, QA_CSEQ, QA_CPID, AG_SRC, AG_SEQ, QR_CNT, EX_FRONT,
  EX_GAPS, EB_SRC, EB_SEQ, EB_N, GB_SRC, GB_SEQ, GB_N, GB_GC, GC_CNT, M_FAST,
  M_SLOW, M_STABLE, ERR, NPLANES
};

struct Planes {
  void* p[NPLANES];
};

struct Dims {
  int L, N, D, F, P, W, C;     // engine dims
  int K, S, DEP, BB, G, EB;    // keys, key slots, deps, blockers, gaps, buf
};

// words (bytes for the bool planes) of one process in each plane
__device__ long long plane_words(int i, const Dims& d) {
  const long long N = d.N, D = d.D;
  switch (i) {
    case KC_SRC: case KC_SEQ: case KC_CSEQ: case KC_CPID:
      return (long long)d.K * d.S;
    case PSEQ: case STATUS: case KEY_OF: case CLIENT_OF: case CLK_SEQ:
    case CLK_PID: case GC_CNT: return N * D;
    case DEP_SRC: case DEP_SEQ: return N * D * d.DEP;
    case BB_SRC: case BB_SEQ: return N * D * d.BB;
    case QA_CNT: case QA_OK: case QA_DONE: case QA_CSEQ: case QA_CPID:
    case QR_CNT: return D;
    case AG_SRC: case AG_SEQ: return D * d.DEP;
    case EX_FRONT: return N;
    case EX_GAPS: return N * d.G * 2;
    case EB_SRC: case EB_SEQ: case GB_SRC: case GB_SEQ: return d.EB;
    default: return 1;  // the scalar planes
  }
}

__device__ bool is_scalar(int i) {
  return i == CLK_COUNTER || i == OWN_SEQ || i == EB_N || i == GB_N ||
         i == GB_GC || i == M_FAST || i == M_SLOW || i == M_STABLE ||
         i == ERR;
}

__device__ bool is_bool(int i) { return i == QA_OK || i == QA_DONE; }

// Copy n words with the whole block. Source and destination sit at the
// same offset from their planes' (aligned) bases, so after a short head
// both are 16-byte aligned together.
__device__ void block_copy(int* dst, const int* src, long long n) {
  const int t = threadIdx.x;
  long long head = ((16 - ((uintptr_t)dst & 15)) & 15) >> 2;
  if ((((uintptr_t)dst ^ (uintptr_t)src) & 15) != 0) head = n;  // scalar
  head = head < n ? head : n;
  for (long long i = t; i < head; i += THREADS) dst[i] = src[i];
  const long long n4 = (n - head) >> 2;
  const int4* s4 = reinterpret_cast<const int4*>(src + head);
  int4* d4 = reinterpret_cast<int4*>(dst + head);
  for (long long i = t; i < n4; i += THREADS) d4[i] = s4[i];
  for (long long i = head + (n4 << 2) + t; i < n; i += THREADS)
    dst[i] = src[i];
}

// Block argmin of (val, idx) pairs, ties to the lower idx; every thread
// calls; the result is in red_v[0], red_i[0] after the last barrier.
__device__ void block_argmin(int val, int idx, int* red_v, int* red_i) {
  const int t = threadIdx.x;
  red_v[t] = val;
  red_i[t] = idx;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (t < s) {
      const int ov = red_v[t + s], oi = red_i[t + s];
      if (ov < red_v[t] || (ov == red_v[t] && oi < red_i[t])) {
        red_v[t] = ov;
        red_i[t] = oi;
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ bool clk_lt(int as, int ap, int bs, int bp) {
  return as < bs || (as == bs && ap < bp);
}

// jnp's plain gather index: negative from the end, then clamped
__device__ __forceinline__ int clamp_index(int i, int size) {
  i = i < 0 ? i + size : i;
  return min(max(i, 0), size - 1);
}

// A staged outbox in shared memory: valid, dst, mtype [F], payload [F, P].
struct Outbox {
  int *v, *dst, *mt, *pay;
};

// One (lane, process): its output planes (the state being updated), its
// scalar planes, the lane ctx and the staged outboxes. Its member
// functions run on thread 0 only.
struct Proc {
  Dims d;
  int me;
  int *kc_src, *kc_seq, *kc_cseq, *kc_cpid, *pseq, *status, *key_of,
      *client_of, *clk_seq, *clk_pid, *dep_src, *dep_seq, *bb_src, *bb_seq,
      *qa_cnt, *qa_cseq, *qa_cpid, *ag_src, *ag_seq, *qr_cnt, *ex_front,
      *ex_gaps, *eb_src, *eb_seq, *gb_src, *gb_seq, *gc_cnt;
  bool *qa_ok, *qa_done;
  // scalar planes, in thread 0's registers
  int clk_counter, own_seq, eb_n, gb_n, gb_gc, m_fast, m_slow, m_stable,
      err;
  // lane ctx
  int n, fq_size, wq_size;
  bool wait;
  const int* attach;  // [C] of this lane
  Outbox pob, hob;
  int* words;               // [P] scratch for a payload
  int* tmp;                 // [2 EB] scratch for the GC drain's shift
  unsigned char* freed;     // [N, D] dots freed by a GC loop

  __device__ bool in(int i, int size) const { return i >= 0 && i < size; }
  __device__ int slot(int seq) const { return floor_mod(seq - 1, d.D); }
  __device__ int clk_max() const { return INF / (d.N + 1) - 1; }
  // oh_get(oh_get(a, i), j) of an [N, D] plane: 0 out of range
  __device__ int get2(const int* a, int i, int j) const {
    return in(i, d.N) && in(j, d.D) ? a[(long long)i * d.D + j] : 0;
  }
  // a payload word (oh_take: 0 out of range)
  __device__ int word(const int* pay, int k) const {
    return in(k, d.P) ? pay[k] : 0;
  }

  // -- outbox staging -------------------------------------------------
  __device__ void clear(const Outbox& ob) const {
    for (int i = 0; i < d.F; ++i) ob.v[i] = ob.dst[i] = ob.mt[i] = 0;
    for (int i = 0; i < d.F * d.P; ++i) ob.pay[i] = 0;
  }
  __device__ void clear_words() const {
    for (int j = 0; j < d.P; ++j) words[j] = 0;
  }
  // `words` to every slot s, addressed to process s, valid for s < n and
  // ok(s) (emit_broadcast fills all F slots)
  template <class Ok>
  __device__ void broadcast(const Outbox& ob, int mt, Ok ok) const {
    for (int s = 0; s < d.F; ++s) {
      ob.v[s] = s < n && ok(s);
      ob.dst[s] = s;
      ob.mt[s] = mt;
      for (int j = 0; j < d.P; ++j) ob.pay[s * d.P + j] = words[j];
    }
  }
  // emit: one slot, payload w[0..k) then zeros
  __device__ void emit(const Outbox& ob, int i, bool v, int dst, int mt,
                       const int* w, int k) const {
    ob.v[i] = v;
    ob.dst[i] = dst;
    ob.mt[i] = mt;
    for (int j = 0; j < d.P; ++j) ob.pay[i * d.P + j] = j < k ? w[j] : 0;
  }
  __device__ void emit_zero(const Outbox& ob, int i, bool v, int dst,
                            int mt) const {
    const int zero[1] = {0};
    emit(ob, i, v, dst, mt, zero, 1);
  }
  // add (a, b) at payload words (lo, lo + 1) of `w`, dropping out of range
  __device__ void pack_pair(int* w, long long lo, int a, int b) const {
    if (lo >= 0 && lo < d.P) w[lo] += a;
    if (lo + 1 >= 0 && lo + 1 < d.P) w[lo + 1] += b;
  }

  // -- key clock table (caesar.py:348-414) ----------------------------
  __device__ void kc_add(int key, int src, int seq, int cseq, int cpid,
                         bool do_) {
    if (!in(key, d.K)) return;  // a zero row: no duplicate, all free; drops
    const int row = key * d.S;
    bool dup = false;
    int free_ = -1;
    for (int s = 0; s < d.S; ++s) {
      const int c = kc_cseq[row + s];
      if (c == cseq && kc_cpid[row + s] == cpid && c > 0) dup = true;
      if (free_ < 0 && c == 0) free_ = s;
    }
    const bool overflow = do_ && free_ < 0;
    if (overflow) err |= ERR_CAPACITY;
    if (do_ && dup) err |= ERR_PROTO;
    if (do_ && !overflow && !dup) {
      kc_src[row + free_] = src;
      kc_seq[row + free_] = seq;
      kc_cseq[row + free_] = cseq;
      kc_cpid[row + free_] = cpid;
    }
  }

  __device__ void kc_remove(int key, int cseq, int cpid, bool do_) {
    int found = -1;
    if (in(key, d.K)) {
      const int row = key * d.S;
      for (int s = 0; s < d.S && found < 0; ++s)
        if (kc_cseq[row + s] == cseq && kc_cpid[row + s] == cpid &&
            kc_cseq[row + s] > 0)
          found = row + s;
    }
    if (do_ && found < 0) err |= ERR_PROTO;
    if (do_ && found >= 0)
      kc_src[found] = kc_seq[found] = kc_cseq[found] = kc_cpid[found] = 0;
  }

  // the key row's dots with a lower clock than (cseq, cpid), packed as
  // pairs after word `base` of `w`, which gets their count; returns it
  __device__ int pack_deps(int key, int cseq, int cpid, int base,
                           int* w) const {
    int nd = 0;
    if (in(key, d.K)) {
      const int row = key * d.S;
      for (int s = 0; s < d.S; ++s) {
        const int c = kc_cseq[row + s];
        if (!(c > 0 && clk_lt(c, kc_cpid[row + s], cseq, cpid))) continue;
        if (nd < d.DEP)
          pack_pair(w, base + 1 + 2LL * nd, kc_src[row + s], kc_seq[row + s]);
        ++nd;
      }
    }
    w[base] = nd;
    return nd;
  }

  // -- the reply of a decided proposal (caesar.py:528) ----------------
  __device__ void propose_reply(const Outbox& ob, int i, int wsrc, int wslot,
                                int wseq, bool accept, bool do_) {
    const bool rej = do_ && !accept;
    const int key = get2(key_of, wsrc, wslot);
    const int new_cseq = clk_counter + 1;
    if (rej && new_cseq >= INF / (d.N + 1)) err |= ERR_SEQ;
    const bool here = in(wsrc, d.N) && in(wslot, d.D);
    const long long v = (long long)wsrc * d.D + wslot;
    if (rej) {
      clk_counter = new_cseq;
      if (here) status[v] = ST_REJECT;
    }
    if (do_ && !rej && here)
      for (int b = 0; b < d.BB; ++b) bb_seq[v * d.BB + b] = 0;
    clear_words();
    words[0] = wseq;
    if (rej) {
      words[1] = new_cseq;
      words[2] = me;
      if (pack_deps(key, new_cseq, me, 4, words) > d.DEP)
        err |= ERR_CAPACITY;
    } else {
      words[1] = get2(clk_seq, wsrc, wslot);
      words[2] = get2(clk_pid, wsrc, wslot);
      words[3] = 1;
      int cnt = 0;
      if (here) {
        for (int q = 0; q < d.DEP; ++q) {
          const int s = dep_src[v * d.DEP + q], sq = dep_seq[v * d.DEP + q];
          cnt += sq > 0;
          pack_pair(words, 5 + 2LL * q, s, sq);
        }
      }
      words[4] = cnt;
    }
    emit(ob, i, do_, wsrc, MPROPOSEACK, words, d.P);
  }

  // -- GC (caesar.py:688-772) -----------------------------------------
  __device__ void gc_count(int src, int seq, bool en) {
    const int s = slot(seq);
    const bool do_ = en && seq > 0;
    const bool valid = get2(pseq, src, s) == seq;
    const int cnt = get2(gc_cnt, src, s) + 1;
    const bool full = do_ && valid && cnt == n;
    if (do_ && !valid) err |= ERR_PROTO;
    if (do_ && valid && in(src, d.N)) gc_cnt[(long long)src * d.D + s] = cnt;
    kc_remove(get2(key_of, src, s), get2(clk_seq, src, s),
              get2(clk_pid, src, s), full);
    if (full) {
      freed[src * d.D + s] = 1;
      ++m_stable;
    }
  }

  __device__ void drain_executed_notification(bool enable) {
    const int n_dots = enable ? eb_n : 0;
    for (int i = 0; i < d.EB && i < n_dots; ++i) {
      const int src = eb_src[i], seq = eb_seq[i];
      const bool overflow = gb_n >= d.EB;
      if (overflow) {
        err |= ERR_CAPACITY;
      } else {
        if (in(gb_n, d.EB)) {
          gb_src[gb_n] = src;
          gb_seq[gb_n] = seq;
        }
        ++gb_n;
      }
      gc_count(src, seq, true);
    }
    if (enable) eb_n = 0;
  }

  // -- the dep unions (caesar.py:888-963) -----------------------------
  __device__ void agg_union(int s, int base, const int* pay, bool do_) {
    if (!do_) return;
    const int Q = d.DEP;
    int* rsrc = ag_src + (long long)s * Q;
    int* rseq = ag_seq + (long long)s * Q;
    int n_free = 0;
    for (int k = 0; k < Q; ++k) n_free += rseq[k] == 0;
    const int nd = pay[base];
    int n_new = 0, fk = 0;
    for (int i = 0; i < Q && i < nd; ++i) {
      const int ds = word(pay, base + 1 + 2 * i);
      const int sq = word(pay, base + 2 + 2 * i);
      bool old = false;
      for (int k = 0; k < Q && !old; ++k)
        old = rseq[k] == sq && rsrc[k] == ds && rseq[k] > 0;
      for (int j = 0; j < i && !old; ++j)
        old = word(pay, base + 1 + 2 * j) == ds &&
              word(pay, base + 2 + 2 * j) == sq;
      if (old) continue;
      ++n_new;
      while (fk < Q && rseq[fk] != 0) ++fk;
      if (fk < Q) {
        rsrc[fk] = ds;
        rseq[fk] = sq;
        ++fk;
      }
    }
    if (n_new > n_free) err |= ERR_CAPACITY;
  }

  __device__ void agg_broadcast(int seq, int cseq, int cpid, int mt,
                                bool valid) {
    const long long row = (long long)slot(seq) * d.DEP;
    clear_words();
    words[0] = me;
    words[1] = seq;
    words[2] = cseq;
    words[3] = cpid;
    int nd = 0;
    for (int q = 0; q < d.DEP; ++q) {
      if (ag_seq[row + q] <= 0) continue;
      pack_pair(words, 5 + 2LL * nd, ag_src[row + q], ag_seq[row + q]);
      ++nd;
    }
    words[4] = nd;
    broadcast(hob, mt, [&](int) { return valid; });
  }

  // -- the handlers (caesar.py:780-1282) ------------------------------
  __device__ void submit(const int* pay) {
    const int client = pay[0], key = pay[2];
    const int seq = own_seq + 1, s = slot(seq), cseq = clk_counter + 1;
    if (seq >= SEQ_BOUND || cseq >= INF / (d.N + 1)) err |= ERR_SEQ;
    own_seq = seq;
    clk_counter = cseq;
    qa_cnt[s] = qa_cseq[s] = qa_cpid[s] = qr_cnt[s] = 0;
    qa_ok[s] = true;
    qa_done[s] = false;
    for (int q = 0; q < d.DEP; ++q)
      ag_src[(long long)s * d.DEP + q] = ag_seq[(long long)s * d.DEP + q] = 0;
    clear_words();
    words[0] = seq;
    words[1] = key;
    words[2] = client;
    words[3] = cseq;
    broadcast(hob, MPROPOSE, [](int) { return true; });
  }

  __device__ void mpropose(int src, const int* pay) {
    const int N = d.N, D = d.D;
    const int seq = pay[0], key = pay[1], client = pay[2];
    const int cseq = min(max(pay[3], 0), clk_max());
    const int cpid = min(max(src, 0), N);
    const int s = slot(seq);
    if (get2(pseq, src, s) != 0) err |= ERR_DOT;
    clk_counter = max(clk_counter, cseq);
    const bool here = in(src, N);
    const long long v = (long long)src * D + s;
    if (here) {
      pseq[v] = seq;
      key_of[v] = key;
      client_of[v] = client;
      clk_seq[v] = cseq;
      clk_pid[v] = cpid;
      status[v] = ST_PROPOSE_END;
    }
    // predecessors and blockers on the key row, compacted (the dot's own
    // registration comes after)
    int nd = 0, nb = 0;
    if (here) {
      for (int q = 0; q < d.DEP; ++q)
        dep_src[v * d.DEP + q] = dep_seq[v * d.DEP + q] = 0;
      for (int b = 0; b < d.BB; ++b)
        bb_src[v * d.BB + b] = bb_seq[v * d.BB + b] = 0;
    }
    if (in(key, d.K)) {
      const int row = key * d.S;
      for (int k = 0; k < d.S; ++k) {
        const int c = kc_cseq[row + k], p = kc_cpid[row + k];
        if (c <= 0) continue;
        if (clk_lt(c, p, cseq, cpid)) {
          if (here && nd < d.DEP) {
            dep_src[v * d.DEP + nd] = kc_src[row + k];
            dep_seq[v * d.DEP + nd] = kc_seq[row + k];
          }
          ++nd;
        } else if (clk_lt(cseq, cpid, c, p)) {
          if (here && nb < d.BB) {
            bb_src[v * d.BB + nb] = kc_src[row + k];
            bb_seq[v * d.BB + nb] = kc_seq[row + k];
          }
          ++nb;
        }
      }
    }
    if (nd > d.DEP || nb > d.BB) err |= ERR_CAPACITY;
    kc_add(key, src, seq, cseq, cpid, true);

    // this dot's blockers' verdicts, by their dep rows (caesar.py:474)
    const int my_seq = get2(pseq, src, s);
    bool any_rej = false, all_res = true;
    if (here) {
      for (int b = 0; b < d.BB; ++b) {
        const int bseq = bb_seq[v * d.BB + b];
        if (bseq <= 0) continue;  // absent: resolved
        const long long bc =
            (long long)clamp_index(bb_src[v * d.BB + b], N) * D + slot(bseq);
        const bool valid = pseq[bc] == bseq;
        if (!valid) continue;  // freed: executed everywhere, resolved
        if (status[bc] < ST_ACCEPT) {
          all_res = false;  // not safe yet: wait
          continue;
        }
        bool member = false;
        for (int j = 0; j < d.DEP && !member; ++j) {
          const int ds = dep_seq[bc * d.DEP + j];
          member = ds > 0 && dep_src[bc * d.DEP + j] == src && ds == my_seq;
        }
        if (!member) any_rej = true;
      }
    }
    const bool has_block = nb > 0;
    const bool accept_now = !has_block || (wait && all_res && !any_rej);
    const bool reject_now = has_block && (!wait || any_rej);
    propose_reply(hob, 0, src, s, seq, accept_now, accept_now || reject_now);
  }

  __device__ void mproposeack(const int* pay) {
    const int seq = pay[0];
    const int cseq = min(max(pay[1], 0), clk_max());
    const int cpid = pay[2];
    const bool ok = pay[3] > 0;
    const int s = slot(seq);
    const int st = status[me * d.D + s];
    const bool live = (st == ST_PROPOSE_END || st == ST_REJECT) && !qa_done[s];
    const bool join_hi = clk_lt(qa_cseq[s], qa_cpid[s], cseq, cpid);
    const int cnt = qa_cnt[s] + 1;
    const bool all_ok = qa_ok[s] && ok;
    if (live) {
      qa_cnt[s] = cnt;
      qa_ok[s] = all_ok;
      if (join_hi) {
        qa_cseq[s] = cseq;
        qa_cpid[s] = cpid;
      }
    }
    agg_union(s, 4, pay, live);
    const bool done =
        live && (cnt == fq_size || (!all_ok && cnt >= wq_size));
    const bool fast = done && all_ok, slow = done && !all_ok;
    qa_done[s] = qa_done[s] || done;
    m_fast += fast;
    m_slow += slow;
    agg_broadcast(seq, qa_cseq[s], qa_cpid[s], fast ? MCOMMIT : MRETRY, done);
  }

  // what MCommit and MRetry share: the final (or retry) clock and deps;
  // returns whether the dot was updated
  __device__ bool commit_or_retry(const int* pay, bool skip_self,
                                  int new_status) {
    const int dsrc = pay[0], seq = pay[1], cseq = pay[2], cpid = pay[3];
    const int s = slot(seq);
    const int st = get2(status, dsrc, s);
    const bool have = get2(pseq, dsrc, s) == seq;
    const bool do_ = have && st != ST_COMMIT && st != ST_EXECUTED;
    const int key = get2(key_of, dsrc, s);
    clk_counter = max(clk_counter, cseq);
    if (!have) err |= ERR_PROTO;
    const bool here = in(dsrc, d.N);
    const long long v = (long long)dsrc * d.D + s;
    // the message's dep list (minus a self-dep for MCommit)
    const int nd = pay[4];
    if (do_ && nd > d.DEP) err |= ERR_CAPACITY;
    if (do_ && here) {
      for (int q = 0; q < d.DEP; ++q) {
        int ds = q < nd ? word(pay, 5 + 2 * q) : 0;
        int sq = q < nd ? word(pay, 6 + 2 * q) : 0;
        if (skip_self && ds == dsrc && sq == seq) ds = sq = 0;
        dep_src[v * d.DEP + q] = ds;
        dep_seq[v * d.DEP + q] = sq;
      }
    }
    // swap the registered clock (caesar.py:1047)
    const int ncseq = min(max(cseq, 0), clk_max());
    const int ncpid = min(max(cpid, 0), d.N);
    const int ocseq = get2(clk_seq, dsrc, s), ocpid = get2(clk_pid, dsrc, s);
    const bool changed = do_ && (ocseq != ncseq || ocpid != ncpid);
    kc_remove(key, ocseq, ocpid, changed);
    kc_add(key, dsrc, get2(pseq, dsrc, s), ncseq, ncpid, changed);
    if (do_ && here) {
      clk_seq[v] = ncseq;
      clk_pid[v] = ncpid;
      status[v] = new_status;
    }
    return do_;
  }

  __device__ bool mretry(int src, const int* pay) {
    const int dsrc = pay[0], seq = pay[1], cseq = pay[2], cpid = pay[3];
    const int s = slot(seq);
    const bool do_ = commit_or_retry(pay, false, ST_ACCEPT);
    if (do_ && in(dsrc, d.N))
      for (int b = 0; b < d.BB; ++b)
        bb_seq[((long long)dsrc * d.D + s) * d.BB + b] = 0;
    // reply: my predecessors at the retry clock ∪ the message's deps
    const int Q = d.DEP;
    clear_words();
    words[0] = dsrc;
    words[1] = seq;
    const int nd = pack_deps(get2(key_of, dsrc, s), cseq, cpid, 2, words);
    const int m_nd = pay[4];
    int n_add = 0;
    for (int i = 0; i < Q && i < m_nd; ++i) {
      const int ms = word(pay, 5 + 2 * i), mq = word(pay, 6 + 2 * i);
      bool old = false;
      for (int k = 0; k < Q && k < nd && !old; ++k)
        old = word(words, 3 + 2 * k) == ms && word(words, 4 + 2 * k) == mq;
      for (int j = 0; j < i && !old; ++j)
        old = word(pay, 5 + 2 * j) == ms && word(pay, 6 + 2 * j) == mq;
      if (old) continue;
      if (nd + n_add < Q) pack_pair(words, 3 + 2LL * (nd + n_add), ms, mq);
      ++n_add;
    }
    words[2] = min(nd + n_add, Q);
    if (do_ && (nd > Q || nd + n_add > Q)) err |= ERR_CAPACITY;
    emit(hob, 0, do_, src, MRETRYACK, words, d.P);
    return do_;
  }

  __device__ void mretryack(const int* pay) {
    const int seq = pay[1], s = slot(seq);
    const bool live = status[me * d.D + s] == ST_ACCEPT;
    const int cnt = qr_cnt[s] + 1;
    if (live) qr_cnt[s] = cnt;
    agg_union(s, 2, pay, live);
    agg_broadcast(seq, clk_seq[me * d.D + s], clk_pid[me * d.D + s], MCOMMIT,
                  live && cnt == wq_size);
  }

  __device__ void mgc(const int* pay) {
    const int dpm = (d.P - 1) / 2;
    for (int i = 0; i < dpm && i < pay[0]; ++i)
      gc_count(pay[1 + 2 * i], pay[2 + 2 * i], true);
  }

  __device__ void gc_drain() {
    const int EB = d.EB, dpm = (d.P - 1) / 2;
    const int take = min(min(gb_gc, gb_n), dpm);
    clear_words();
    words[0] = take;
    for (int i = 0; i < dpm && i < take; ++i) {
      const int at = min(i, EB - 1);  // jnp's clamped gather
      pack_pair(words, 1 + 2LL * i, gb_src[at], gb_seq[at]);
    }
    // jnp.roll(x, -take) keeps the first n - take entries
    const int remaining = gb_n - take;
    for (int i = 0; i < EB; ++i) {
      tmp[i] = gb_src[i];
      tmp[EB + i] = gb_seq[i];
    }
    for (int i = 0; i < EB; ++i) {
      const int from = floor_mod(i + take, EB);
      gb_src[i] = i < remaining ? tmp[from] : 0;
      gb_seq[i] = i < remaining ? tmp[EB + from] : 0;
    }
    gb_n = remaining;
    gb_gc -= take;
    broadcast(hob, MGC, [&](int t) { return t != me && take > 0; });
    emit_zero(hob, d.N, gb_gc > 0, me, GC_DRAIN);
  }
};

}  // namespace

__global__ void __launch_bounds__(THREADS) caesar_handle_kernel(
    const Planes in, const Planes out, const bool* __restrict__ has,
    const int* __restrict__ rows, const bool* __restrict__ fire,
    const int* __restrict__ n_ctx, const int* __restrict__ fq_ctx,
    const int* __restrict__ wq_ctx, const bool* __restrict__ wait_ctx,
    const int* __restrict__ attach, bool* __restrict__ rdy_out,
    bool* __restrict__ pv, int* __restrict__ pd, int* __restrict__ pm,
    int* __restrict__ pp, bool* __restrict__ hv, int* __restrict__ hd,
    int* __restrict__ hm, int* __restrict__ hp, const MonArgs ma,
    const Dims d) {
  extern __shared__ int smem[];
  const int g = blockIdx.x;  // (lane, process)
  const int t = threadIdx.x;
  const int l = g / d.N, me = g % d.N;
  const int N = d.N, D = d.D, F = d.F, P = d.P, G = d.G, DEP = d.DEP,
            BB = d.BB;
  const int ND = N * D;

  // shared memory (caesar_handle.py smem_bytes)
  int* sp = smem;
  const Outbox pob{sp, sp + F, sp + 2 * F, sp + 3 * F};
  sp += 3 * F + F * P;
  const Outbox hob{sp, sp + F, sp + 2 * F, sp + 3 * F};
  sp += 3 * F + F * P;
  int* words = sp;
  sp += P;
  int* tmp = sp;
  sp += 2 * d.EB;
  int* ef = sp;  // executed sets: fronts [N], gaps [N][G][2]
  int* eg = sp + N;
  sp += N * (1 + 2 * G);
  int* red_v = sp;  // block argmin scratch
  int* red_i = sp + THREADS;
  sp += 2 * THREADS;
  int* misc = sp;  // [0] count, [1] branch, [2] exec on, [3] wait on
  sp += 8;
  unsigned char* freed = reinterpret_cast<unsigned char*>(sp);
  unsigned char* ready = freed + ND;    // exec scan: ready dots
  unsigned char* verdict = ready + ND;  // wait scan: 1 accept, 2 reject

  // 1. copy this process's state planes (the scalar ones go through
  // thread 0's registers)
  for (int i = 0; i < NPLANES; ++i) {
    if (is_scalar(i)) continue;
    const long long w = plane_words(i, d);
    if (is_bool(i)) {
      const bool* s = (const bool*)in.p[i] + (long long)g * w;
      bool* o = (bool*)out.p[i] + (long long)g * w;
      for (long long j = t; j < w; j += THREADS) o[j] = s[j];
    } else {
      block_copy((int*)out.p[i] + (long long)g * w,
                 (const int*)in.p[i] + (long long)g * w, w);
    }
  }
  for (int v = t; v < ND; v += THREADS) freed[v] = 0;
  mon_copy(ma, g, t, THREADS);
  __syncthreads();

  auto plane = [&](int i) {
    return (int*)out.p[i] + (long long)g * plane_words(i, d);
  };
  auto scalar = [&](int i) { return ((const int*)in.p[i])[g]; };
  Proc p{d, me,
         plane(KC_SRC), plane(KC_SEQ), plane(KC_CSEQ), plane(KC_CPID),
         plane(PSEQ), plane(STATUS), plane(KEY_OF), plane(CLIENT_OF),
         plane(CLK_SEQ), plane(CLK_PID), plane(DEP_SRC), plane(DEP_SEQ),
         plane(BB_SRC), plane(BB_SEQ), plane(QA_CNT), plane(QA_CSEQ),
         plane(QA_CPID), plane(AG_SRC), plane(AG_SEQ), plane(QR_CNT),
         plane(EX_FRONT), plane(EX_GAPS), plane(EB_SRC), plane(EB_SEQ),
         plane(GB_SRC), plane(GB_SEQ), plane(GC_CNT),
         (bool*)out.p[QA_OK] + (long long)g * D,
         (bool*)out.p[QA_DONE] + (long long)g * D,
         scalar(CLK_COUNTER), scalar(OWN_SEQ), scalar(EB_N), scalar(GB_N),
         scalar(GB_GC), scalar(M_FAST), scalar(M_SLOW), scalar(M_STABLE),
         scalar(ERR),
         n_ctx[l], fq_ctx[l], wq_ctx[l], wait_ctx[l],
         attach + (long long)l * d.C,
         pob, hob, words, tmp, freed};

  const int* row = rows + (long long)g * d.W;
  const int src = row[PSRC];
  const int* pay = row + PPAY;
  const bool* fr = fire + (long long)g * 2;

  // the freed dots' lifecycle state, cleared by the whole block
  auto apply_freed = [&]() {
    for (int v = t; v < ND; v += THREADS) {
      if (!freed[v]) continue;
      p.pseq[v] = p.status[v] = p.gc_cnt[v] = 0;
      for (int q = 0; q < DEP; ++q) p.dep_seq[(long long)v * DEP + q] = 0;
      for (int b = 0; b < BB; ++b) p.bb_seq[(long long)v * BB + b] = 0;
      freed[v] = 0;
    }
  };

  // 2a. gate and the notification timer (thread 0)
  if (t == 0) {
    int mtype = has[g] ? row[PMT] : NUM_TYPES;
    bool rdy = true;
    if (mtype == MPROPOSE) {
      rdy = p.get2(p.pseq, src, p.slot(pay[0])) == 0;
    } else if (mtype == MCOMMIT || mtype == MRETRY) {
      rdy = p.get2(p.pseq, pay[0], p.slot(pay[1])) == pay[1];
    } else if (mtype == MGC) {
      const int dpm = (P - 1) / 2;
      for (int i = 0; i < dpm && i < pay[0]; ++i) {
        const int gs = pay[1 + 2 * i], gq = pay[2 + 2 * i];
        if (p.pseq[clamp_index(gs, N) * D + p.slot(gq)] != gq) rdy = false;
      }
    }
    rdy_out[g] = rdy;
    if (!(has[g] && rdy)) mtype = NUM_TYPES;
    misc[1] = min(max(mtype, 0), NUM_TYPES);  // the switch's clip
    // periodic: the GC round's snapshot is taken before the drain
    misc[4] = p.gb_n;
    p.drain_executed_notification(fr[1]);
  }
  __syncthreads();
  apply_freed();
  __syncthreads();
  const int branch = misc[1];

  // 2b. the GC timer and the branch (thread 0)
  if (t == 0) {
    const int pre_n = misc[4];
    if (fr[0]) p.gb_gc = pre_n;
    p.clear(pob);
    p.emit_zero(pob, 0, fr[0] && pre_n > 0, me, GC_DRAIN);
    p.clear(hob);
    bool ex = false, wt = false;
    switch (branch) {
      case SUBMIT: p.submit(pay); break;
      case MPROPOSE: p.mpropose(src, pay); break;
      case MPROPOSEACK: p.mproposeack(pay); break;
      case MCOMMIT: ex = wt = p.commit_or_retry(pay, true, ST_COMMIT); break;
      case MRETRY: wt = p.mretry(src, pay); break;
      case MRETRYACK: p.mretryack(pay); break;
      case MGC: p.mgc(pay); break;
      case WAIT_DRAIN: wt = true; break;
      case EXEC_DRAIN: ex = true; break;
      case GC_DRAIN: p.gc_drain(); break;
      default: break;  // the noop
    }
    misc[0] = 0;
    misc[2] = ex;
    misc[3] = wt;
  }
  __syncthreads();
  apply_freed();  // MGC's frees
  for (int i = t; i < N * (1 + 2 * G); i += THREADS)
    ef[i] = i < N ? p.ex_front[i] : p.ex_gaps[i - N];
  __syncthreads();

  // 3. the exec scan: each committed dot's readiness, then the pick
  const int cmax = INF / (N + 1) - 1;
  int n_ready = 0, best = INT_MAX, bidx = INT_MAX;
  for (int v = t; v < ND; v += THREADS) {
    bool ok = p.status[v] == ST_COMMIT;
    const int my_cseq = p.clk_seq[v], my_cpid = p.clk_pid[v];
    for (int j = 0; j < DEP && ok; ++j) {
      const long long c = (long long)v * DEP + j;
      const int ds = p.dep_seq[c];
      if (ds == 0) continue;
      const int s = p.dep_src[c];
      const int cell = clamp_index(s, N) * D + floor_mod(ds - 1, D);
      const bool live = p.pseq[cell] == ds;
      const int st = p.status[cell];
      const bool dead = iset_contains_gathered(ef, eg, N, G, s, ds);
      const bool committed = live ? st >= ST_COMMIT : dead;
      const bool executed = live ? st == ST_EXECUTED : dead;
      const bool lower =
          clk_lt(p.clk_seq[cell], p.clk_pid[cell], my_cseq, my_cpid);
      ok = committed && (executed || !lower);
    }
    ready[v] = ok;
    n_ready += ok;
    const int packed = (int)((unsigned)min(my_cseq, cmax) * (unsigned)(N + 1) +
                             (unsigned)my_cpid);
    const int val = ok ? packed : INF;
    if (val < best || (val == best && v < bidx)) {
      best = val;
      bidx = v;
    }
  }
  atomicAdd(&misc[0], n_ready);
  block_argmin(best, bidx, red_v, red_i);
  if (t == 0) {
    const int num = misc[0];
    const int idx = red_i[0];
    const int esrc = idx / D;
    const int eseq = p.pseq[idx];
    const int client = p.client_of[idx];
    const bool do_ = misc[2] && num > 0;
    // the safety monitors: no execute-before-commit guard (caesar.py
    // :640-646 keeps none)
    mon_view(ma, g).exec(p.key_of[idx], esrc, eseq, do_, false, true);
    if (iset_add(p.ex_front[esrc], p.ex_gaps + (long long)esrc * G * 2, G,
                 eseq, do_))
      p.err |= ERR_CAPACITY;
    if (do_) {
      if (p.eb_n >= d.EB) {
        p.err |= ERR_CAPACITY;
      } else {
        if (p.eb_n >= 0) {
          p.eb_src[p.eb_n] = esrc;
          p.eb_seq[p.eb_n] = eseq;
        }
        ++p.eb_n;
      }
      p.status[idx] = ST_EXECUTED;
    }
    const int at = p.in(client, d.C) ? p.attach[client] : 0;
    p.emit_zero(hob, F - 4, do_ && at == me, N + client, TO_CLIENT);
    p.emit_zero(hob, F - 3, do_, me, EXEC_DRAIN);
    misc[0] = 0;
  }
  __syncthreads();

  // 4. the wait scan: each waiting dot's blocker verdicts, then the pick
  int n_act = 0;
  best = INT_MAX;
  bidx = INT_MAX;
  for (int v = t; v < ND; v += THREADS) {
    unsigned char vd = 0;
    bool waiting = false;
    if (p.status[v] == ST_PROPOSE_END)
      for (int b = 0; b < BB && !waiting; ++b)
        waiting = p.bb_seq[(long long)v * BB + b] > 0;
    if (waiting) {
      bool rej = false, resolved = true;
      for (int b = 0; b < BB; ++b) {
        const int bseq = p.bb_seq[(long long)v * BB + b];
        if (bseq <= 0) continue;  // absent: resolved
        const int bc = clamp_index(p.bb_src[(long long)v * BB + b], N) * D +
                       floor_mod(bseq - 1, D);
        if (p.pseq[bc] != bseq) continue;  // freed: resolved
        if (p.status[bc] < ST_ACCEPT) {
          resolved = false;  // not safe yet
          continue;
        }
        bool member = false;
        for (int j = 0; j < DEP && !member; ++j) {
          const long long c = (long long)bc * DEP + j;
          const int ds = p.dep_seq[c], s = p.dep_src[c];
          member = ds > 0 && s >= -N && s < N &&
                   (s < 0 ? s + N : s) * D + floor_mod(ds - 1, D) == v &&
                   p.pseq[v] == ds;
        }
        if (!member) rej = true;
      }
      vd = rej ? 2 : (resolved ? 1 : 0);
    }
    verdict[v] = vd;
    n_act += vd != 0;
    const int packed =
        (int)((unsigned)(v / D) * (unsigned)SEQ_BOUND + (unsigned)p.pseq[v]);
    const int val = vd ? packed : INF;
    if (val < best || (val == best && v < bidx)) {
      best = val;
      bidx = v;
    }
  }
  atomicAdd(&misc[0], n_act);
  block_argmin(best, bidx, red_v, red_i);
  if (t == 0) {
    const int num = misc[0];
    const int idx = red_i[0];
    const bool do_ = misc[3] && num > 0;
    p.propose_reply(hob, F - 2, idx / D, idx % D, p.pseq[idx],
                    verdict[idx] != 2, do_);
    p.emit_zero(hob, F - 1, do_ && num > 1, me, WAIT_DRAIN);
    ((int*)out.p[CLK_COUNTER])[g] = p.clk_counter;
    ((int*)out.p[OWN_SEQ])[g] = p.own_seq;
    ((int*)out.p[EB_N])[g] = p.eb_n;
    ((int*)out.p[GB_N])[g] = p.gb_n;
    ((int*)out.p[GB_GC])[g] = p.gb_gc;
    ((int*)out.p[M_FAST])[g] = p.m_fast;
    ((int*)out.p[M_SLOW])[g] = p.m_slow;
    ((int*)out.p[M_STABLE])[g] = p.m_stable;
    ((int*)out.p[ERR])[g] = p.err;
  }
  __syncthreads();

  // 5. store both outboxes
  const long long base = (long long)g * F;
  for (int i = t; i < F * P; i += THREADS) {
    pp[base * P + i] = pob.pay[i];
    hp[base * P + i] = hob.pay[i];
  }
  for (int i = t; i < F; i += THREADS) {
    pv[base + i] = pob.v[i] != 0;
    pd[base + i] = pob.dst[i];
    pm[base + i] = pob.mt[i];
    hv[base + i] = hob.v[i] != 0;
    hd[base + i] = hob.dst[i];
    hm[base + i] = hob.mt[i];
  }
}

extern "C" int fantoch_caesar_handle(
    const void* in_table, const void* out_table, const void* has,
    const void* rows, const void* fire, const void* n_ctx, const void* fq,
    const void* wq, const void* wait, const void* attach, void* rdy_out,
    void* pv, void* pd, void* pm, void* pp, void* hv, void* hd, void* hm,
    void* hp, const void* mh_in, const void* mc_in, const void* mf_in,
    void* mh_o, void* mc_o, void* mf_o, int L, int N, int D, int F, int P,
    int W, int C, int K, int S, int DEP, int BB, int G, int EB, int smem,
    int KM, void* stream) {
  const long long blocks = (long long)L * N;
  if (blocks == 0) return 0;
  Planes in, out;
  for (int i = 0; i < NPLANES; ++i) {
    in.p[i] = ((void* const*)in_table)[i];
    out.p[i] = ((void* const*)out_table)[i];
  }
  const Dims d{L, N, D, F, P, W, C, K, S, DEP, BB, G, EB};
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        caesar_handle_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  caesar_handle_kernel<<<(unsigned)blocks, THREADS, (size_t)smem,
                         (cudaStream_t)stream>>>(
      in, out, (const bool*)has, (const int*)rows, (const bool*)fire,
      (const int*)n_ctx, (const int*)fq, (const int*)wq, (const bool*)wait,
      (const int*)attach, (bool*)rdy_out, (bool*)pv, (int*)pd, (int*)pm,
      (int*)pp, (bool*)hv, (int*)hd, (int*)hm, (int*)hp,
      mon_args(mh_in, mc_in, mf_in, mh_o, mc_o, mf_o, KM), d);
  return (int)cudaGetLastError();
}
