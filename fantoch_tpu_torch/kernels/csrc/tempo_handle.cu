// K8 tempo_handle: Tempo's readiness gate, periodic timers and message
// handlers for every (lane, process) (replaces fantoch_tpu/engine/core.py
// run_handlers :422 and the ready/periodic calls :890-918 with
// TempoDev.ready :226, .periodic :266 and .handle :246 of
// fantoch_tpu/engine/protocols/tempo.py, the ten handlers :498-941 with
// their clock, vote and drain helpers :308-490, and the add side of
// fantoch_tpu/engine/iset.py, in iset.cuh).
//
// One block of one warp (THREADS = 32) per (lane, process). The
// reference runs the handler as a
// lax.switch under vmap, which evaluates all eleven branches and selects
// one; here each warp runs only its own branch, in the reference's order:
// `ready` on the incoming state, `periodic` at the process's event time
// (its clock bump can change the state), then `handle` on that state.
//
// In place: the warp updates its process's rows of the step's own state
// planes (and, on a monitored step, of the monitor planes), and only on
// lanes whose run predicate holds at the step's start (common.cuh RunCap;
// every lane without a cap), as the reference's vmapped while_loop keeps
// a frozen lane's state. A frozen lane's warps write rdy false and empty
// outboxes (valid false, zero words) and return. Every plane is indexed
// by g = l * N + me, so warp (l, me) reads and writes only process me's
// rows of lane l, as the reference's vmap over processes does, and no
// warp sees another's writes. Control flow is warp-uniform: every thread
// computes the same scalars, and the wide parts are shared: the GC free
// scan over the [N, D] dot slots, the key loop of the clock bump, the
// per-voter interval-set unions of MCommit (one voter per thread), the
// stability rank over N voters, the drain's argmin over the PK pending
// slots (shuffles), and first-free / first-touch searches over detached
// and pending slots (__ballot_sync, __ffs). Sequential parts run on
// thread 0: the nine in-order detached-range unions of MDetached (their
// order decides which gap slot each range takes) and the single-set
// interval adds. A word that several threads read is written by thread 0
// between two __syncwarp()s, so no thread reads it while it changes and
// every thread sees the new value. The scalar planes (error word,
// sequence, counters) live in registers and are stored once at the end.
// Outboxes are staged per warp in shared memory and stored coalesced.
// On a monitored step (KM > 0) the drain records each execution
// (protocols/tempo.py:434-453; monitor.cuh) into the monitor rows in
// place, with the execute-before-commit guard read from the GC
// committed set of the executed dot's source (iset_contains; 0 and an
// empty set for a source out of range, as oh_get).
//
// One-hot semantics of the reference: a read at an out-of-range index
// yields 0, a write there drops; dot slots use floor modulo (seq 0 maps to
// slot D - 1); MCommit's dot source is clamped to [0, N - 1] while the gate
// (`ready`) reads an out-of-range source as 0; MCommit routes voter ranges
// by one-hot sums, so duplicate voters add their starts and ends. Integer
// sums and the (src, seq) packing wrap as int32 does in the reference.
//
// Bound on this card: bytes. The region reads a few state words per
// (lane, process) and the rows its branch touches, and writes the words
// that change and two [F, P] outboxes (tempo_handle.py work). In place,
// this kernel moves about that; what is left is the branch's serial parts
// on thread 0 and the warp's latency on dependent reads.
#include "common.cuh"
#include "iset.cuh"
#include "monitor.cuh"

using namespace fantoch;

namespace {

constexpr int SUBMIT = 0, MCOLLECT = 1, MCOLLECTACK = 2, MCOMMIT = 3,
              MDETACHED = 4, MCONSENSUS = 5, MCONSENSUSACK = 6, MGC = 7,
              MDRAIN = 8, DETACH_DRAIN = 9, NUM_TYPES = 10, TO_CLIENT = 11;
constexpr int ERR_SEQ = 4, ERR_DOT = 8, ERR_CAPACITY = 16, ERR_PROTO = 32;
constexpr int SEQ_BOUND = 1 << 20;
constexpr int THREADS = 32;  // a warp a (lane, process)

// state planes, in tempo_handle.py STATE_KEYS order
enum Plane {
  CLOCKS, DET, MCC, SIS, KEY_OF, CLIENT_OF, OWN_SEQ, ACK_CNT, MAX_CLOCK,
  MAX_CNT, SLOW_ACKS, VOTES_N, VOTES_BY, VOTES_S, VOTES_E, VOTE_FRONT,
  VOTE_GAPS, PEND_CLOCK, PEND_SRC, PEND_SEQ, PEND_CLIENT, COMM_FRONT,
  COMM_GAPS, OTHERS, SEEN, PREV_STABLE, M_FAST, M_SLOW, M_STABLE, ERR,
  NPLANES
};

struct Planes {
  void* p[NPLANES];
};

struct Dims {
  int L, N, D, F, P, R, W, C;  // engine dims; R = periodic rows
  int K, PK, DS, G;            // keys, pending, detached and gap slots
  bool skip_capable;
};

// words (bytes for SEEN) of one process in each plane
__device__ long long plane_words(int i, const Dims& d) {
  const int N = d.N, D = d.D, K = d.K;
  switch (i) {
    case CLOCKS: return K;
    case DET: return (long long)K * d.DS * 2;
    case SIS: case KEY_OF: case CLIENT_OF: return (long long)N * D;
    case ACK_CNT: case MAX_CLOCK: case MAX_CNT: case SLOW_ACKS: case VOTES_N:
      return D;
    case VOTES_BY: case VOTES_S: case VOTES_E: return (long long)D * N;
    case VOTE_FRONT: return (long long)K * N;
    case VOTE_GAPS: return (long long)K * N * d.G * 2;
    case PEND_CLOCK: case PEND_SRC: case PEND_SEQ: case PEND_CLIENT:
      return (long long)K * d.PK;
    case COMM_FRONT: case SEEN: case PREV_STABLE: return N;
    case COMM_GAPS: return (long long)N * d.G * 2;
    case OTHERS: return (long long)N * N;
    default: return 1;  // the scalar planes
  }
}

// first i in [0, n) with pred(i), or -1; every thread of the warp calls
template <class Pred>
__device__ int warp_first(int n, int lane, Pred pred) {
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const unsigned m = __ballot_sync(FULL, i < n && pred(i));
    if (m) return base + __ffs(m) - 1;
  }
  return -1;
}

template <class Pred>
__device__ int warp_count(int n, int lane, Pred pred) {
  int c = 0;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    c += __popc(__ballot_sync(FULL, i < n && pred(i)));
  }
  return c;
}

__device__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1)
    v = (int)((unsigned)v + (unsigned)__shfl_xor_sync(FULL, v, o));
  return v;
}

// One (lane, process): its rows of the state planes (updated in place),
// the popped message, the lane ctx and the warp's outbox staging area.
struct Proc {
  Dims d;
  int l, me, lane;
  int *clocks, *det, *sis, *key_of, *client_of, *ack_cnt, *max_clock,
      *max_cnt, *slow_acks, *votes_n, *votes_by, *votes_s, *votes_e,
      *vote_front, *vote_gaps, *pend_clock, *pend_src, *pend_seq,
      *pend_client, *comm_front, *comm_gaps, *others, *prev_stable;
  bool* seen;
  // scalar planes, kept in registers (the same value in every thread)
  int mcc, own_seq, m_fast, m_slow, m_stable, err;
  // lane ctx
  int n, f, fq_size, wq_size, threshold;
  bool bump_mode, skip_fast_ack;
  const bool *fast_quorum, *write_quorum;  // [N, N] of this lane
  const int* attach;                        // [C] of this lane
  // outbox staging: valid, dst, mtype [F], payload [F, P], words [P]
  int *sv, *sd, *sm, *sp, *sw;
  Mon mon;  // the safety monitors' view (KM == 0: off)

  __device__ bool in(int i, int size) const { return i >= 0 && i < size; }
  __device__ int slot(int seq) const { return floor_mod(seq - 1, d.D); }

  // oh_get / oh_set: 0 out of range / the write drops
  __device__ int get(const int* a, int size, int i) const {
    return in(i, size) ? a[i] : 0;
  }
  __device__ int get2(const int* a, int rows, int cols, int i, int j) const {
    return in(i, rows) && in(j, cols) ? a[(long long)i * cols + j] : 0;
  }
  __device__ void set(int* a, int size, int i, int v) const {
    __syncwarp();  // every thread has read what thread 0 overwrites
    if (lane == 0 && in(i, size)) a[i] = v;
    __syncwarp();
  }

  // -- outbox staging -------------------------------------------------
  __device__ void ob_clear() const {
    for (int i = lane; i < d.F * d.P; i += 32) sp[i] = 0;
    for (int i = lane; i < d.F; i += 32) sv[i] = sd[i] = sm[i] = 0;
    for (int i = lane; i < d.P; i += 32) sw[i] = 0;
    __syncwarp();
  }
  // the staged words sw[0..P) (thread 0 fills them) to every slot f,
  // addressed to process f, valid for f < n and `ok(f)`
  template <class Ok>
  __device__ void ob_broadcast(int mt, Ok ok) const {
    __syncwarp();
    for (int i = lane; i < d.F * d.P; i += 32) sp[i] = sw[i % d.P];
    for (int f = lane; f < d.F; f += 32) {
      sv[f] = f < n && ok(f);
      sd[f] = f;
      sm[f] = mt;
    }
    __syncwarp();
  }
  // emit: one slot, payload w0, w1 then zeros (thread 0)
  __device__ void ob_emit(int i, bool v, int dst, int mt, int w0 = 0,
                          int w1 = 0) const {
    if (lane == 0 && i < d.F) {
      sv[i] = v;
      sd[i] = dst;
      sm[i] = mt;
      int* row = sp + i * d.P;
      for (int j = 0; j < d.P; ++j) row[j] = j == 0 ? w0 : (j == 1 ? w1 : 0);
    }
    __syncwarp();
  }
  __device__ void ob_flush(bool* v, int* dst, int* mt, int* pay) const {
    __syncwarp();
    const long long g = (long long)l * d.N + me;
    for (int i = lane; i < d.F * d.P; i += 32) pay[g * d.F * d.P + i] = sp[i];
    for (int i = lane; i < d.F; i += 32) {
      v[g * d.F + i] = sv[i] != 0;
      dst[g * d.F + i] = sd[i];
      mt[g * d.F + i] = sm[i];
    }
    __syncwarp();
  }
  __device__ void words(int i, int v) const {  // thread 0 fills sw
    if (lane == 0 && i < d.P) sw[i] = v;
  }

  // -- clock / vote helpers (tempo.py:308-392) ------------------------
  __device__ void det_add(int key, int start, int end, bool enable) {
    const int DS = d.DS;
    const bool kin = in(key, d.K);
    int* row = det + (long long)(kin ? key : 0) * DS * 2;
    const int cslot = kin ? warp_first(DS, lane, [&](int j) {
      return row[2 * j] > 0 && row[2 * j + 1] + 1 == start;
    }) : -1;
    const int fslot = kin ? warp_first(DS, lane, [&](int j) {
      return row[2 * j] == 0;
    }) : 0;
    const bool do_ = enable && end >= start;
    const bool comp = do_ && cslot >= 0;
    const bool store = do_ && cslot < 0;
    const bool overflow = store && fslot < 0;
    __syncwarp();
    if (lane == 0 && kin) {
      if (comp) row[2 * cslot + 1] = end;
      if (store && !overflow) {
        row[2 * fslot] = start;
        row[2 * fslot + 1] = end;
      }
    }
    __syncwarp();
    if (overflow) err |= ERR_CAPACITY;
  }

  __device__ void bump(int key, int up_to, bool enable) {
    const int cur = get(clocks, d.K, key);
    const bool do_ = enable && cur < up_to;
    det_add(key, cur + 1, up_to, do_);
    set(clocks, d.K, key, do_ ? up_to : cur);
  }

  // every key below min_clock takes its first free detached slot
  __device__ void detached_all(int min_clock) {
    bool overflow = false;
    for (int k = lane; k < d.K; k += 32) {
      const int c = clocks[k];
      if (c < min_clock) {
        int* row = det + (long long)k * d.DS * 2;
        int slot = -1;
        for (int j = 0; j < d.DS && slot < 0; ++j)
          if (row[2 * j] == 0) slot = j;
        if (slot < 0) {
          overflow = true;
        } else {
          row[2 * slot] = c + 1;
          row[2 * slot + 1] = min_clock;
        }
        clocks[k] = min_clock;
      }
    }
    if (__any_sync(FULL, overflow)) err |= ERR_CAPACITY;
    __syncwarp();
  }

  __device__ void vote_add(int key, int voter, int start, int end,
                           bool enable) {
    // an out-of-range (key, voter) reads an empty set and drops its write
    if (!in(key, d.K) || !in(voter, d.N)) return;
    bool overflow = false;
    __syncwarp();
    if (lane == 0) {
      const long long kv = (long long)key * d.N + voter;
      int front = vote_front[kv];
      overflow = iset_add_range(front, vote_gaps + kv * d.G * 2, d.G, start,
                                end, enable);
      vote_front[kv] = front;
    }
    if (__shfl_sync(FULL, overflow, 0)) err |= ERR_CAPACITY;
    __syncwarp();
  }

  // -- table executor (tempo.py:401-490) ------------------------------

  // the (n - threshold)-th order statistic of the key's voter frontiers,
  // ties ranked by process index (thread v holds voter v; N <= 32)
  __device__ int stable_clock(int key) const {
    const bool kin = in(key, d.K);
    auto masked = [&](int v) {
      return v < n ? (kin ? vote_front[(long long)key * d.N + v] : 0) : INF;
    };
    int mine = 0;
    if (lane < d.N) {
      const int mv = masked(lane);
      int rank = 0;
      for (int j = 0; j < d.N; ++j) {
        const int mj = masked(j);
        rank += (mj < mv || (mj == mv && j < lane)) ? 1 : 0;
      }
      mine = rank == n - threshold ? mv : 0;
    }
    return warp_sum(mine);
  }

  // execute the lowest stable pending command on `key` (clock, then
  // src * SEQ_BOUND + seq, then index): TO_CLIENT in slot 0, MDRAIN to
  // self in slot 1 when more than one is ready
  __device__ void drain(int key) {
    const int PK = d.PK;
    const bool kin = in(key, d.K);
    const long long base = (long long)(kin ? key : 0) * PK;
    const int stable = stable_clock(key);
    auto clock_at = [&](int j) { return kin ? pend_clock[base + j] : 0; };
    auto ready = [&](int j) {
      const int c = clock_at(j);
      return c > 0 && c <= stable;
    };
    const int num_ready = warp_count(PK, lane, ready);
    int cmin = INF;
    for (int j = lane; j < PK; j += 32)
      if (ready(j)) cmin = min(cmin, clock_at(j));
    cmin = warp_min(cmin);
    // argmin of (tie ? packed : INF), first index on equal values
    int best = INF, bidx = PK;
    for (int j = lane; j < PK; j += 32) {
      const bool tie = ready(j) && clock_at(j) == cmin;
      const int packed =
          !kin ? 0
               : (int)((unsigned)pend_src[base + j] * (unsigned)SEQ_BOUND +
                       (unsigned)pend_seq[base + j]);
      const int v = tie ? packed : INF;
      if (v < best || (v == best && j < bidx)) {
        best = v;
        bidx = j;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const int ob = __shfl_xor_sync(FULL, best, o);
      const int oi = __shfl_xor_sync(FULL, bidx, o);
      if (ob < best || (ob == best && oi < bidx)) {
        best = ob;
        bidx = oi;
      }
    }
    const int idx = bidx < PK ? bidx : 0;
    const bool do_ = num_ready > 0;
    const int client = kin ? pend_client[base + idx] : 0;
    if (mon.KM != 0) {
      const int e_src = kin ? pend_src[base + idx] : 0;
      const int e_seq = kin ? pend_seq[base + idx] : 0;
      const bool committed =
          in(e_src, d.N) &&
          iset_contains(comm_front[e_src], comm_gaps + e_src * d.G * 2, d.G,
                        e_seq);
      mon.exec(key, e_src, e_seq, do_, !committed, lane == 0);
    }
    __syncwarp();
    if (lane == 0 && kin && do_) pend_clock[base + idx] = 0;
    __syncwarp();
    const int at = in(client, d.C) ? attach[client] : 0;
    ob_emit(0, do_ && at == me, d.N + client, TO_CLIENT);
    ob_emit(1, do_ && num_ready > 1, me, MDRAIN, key);
  }

  __device__ void pend_insert(int key, int clock, int src, int seq,
                              int client) {
    const bool kin = in(key, d.K);
    const long long base = (long long)(kin ? key : 0) * d.PK;
    const int j = kin ? warp_first(d.PK, lane, [&](int i) {
      return pend_clock[base + i] == 0;
    }) : 0;
    if (j < 0) {
      err |= ERR_CAPACITY;
      return;
    }
    __syncwarp();
    if (lane == 0 && kin) {
      pend_clock[base + j] = clock;
      pend_src[base + j] = src;
      pend_seq[base + j] = seq;
      pend_client[base + j] = client;
    }
    __syncwarp();
  }

  // the MCommit broadcast with the dot's aggregated votes
  __device__ void commit_broadcast(int seq, int clock, int key, int client,
                                   bool valid) {
    const int s = slot(seq);
    words(0, me);
    words(1, seq);
    words(2, clock);
    words(3, key);
    words(4, client);
    words(5, votes_n[s]);
    for (int v = lane; v < d.N; v += 32) {
      const long long sv_ = (long long)s * d.N + v;
      if (6 + 3 * v + 2 < d.P) {
        sw[6 + 3 * v] = votes_by[sv_];
        sw[7 + 3 * v] = votes_s[sv_];
        sw[8 + 3 * v] = votes_e[sv_];
      }
    }
    ob_broadcast(MCOMMIT, [&](int) { return valid; });
  }

  // -- the handlers (tempo.py:498-941) --------------------------------
  __device__ void submit(const int* pay) {
    const int client = pay[0], key = pay[2];
    const int seq = own_seq + 1, s = slot(seq);
    const int cur = get(clocks, d.K, key), clock = cur + 1;
    const int own_vote = (d.skip_capable && skip_fast_ack) ? 0 : 1;
    if (seq >= SEQ_BOUND) err |= ERR_SEQ;
    own_seq = seq;
    __syncwarp();
    if (lane == 0) {
      if (in(key, d.K)) clocks[key] = clock;
      ack_cnt[s] = 0;
      max_clock[s] = 0;
      max_cnt[s] = 0;
      slow_acks[s] = 0;
      votes_n[s] = own_vote;
      votes_by[(long long)s * d.N] = me;
      votes_s[(long long)s * d.N] = cur + 1;
      votes_e[(long long)s * d.N] = clock;
    }
    words(0, seq);
    words(1, key);
    words(2, clock);
    words(3, client);
    words(4, cur + 1);
    words(5, clock);
    ob_broadcast(MCOLLECT, [](int) { return true; });
  }

  __device__ void mcollect(int src, const int* pay) {
    const int seq = pay[0], key = pay[1], rclock = pay[2], client = pay[3];
    const int s = slot(seq);
    if (get2(sis, d.N, d.D, src, s) != 0) err |= ERR_DOT;
    __syncwarp();
    if (lane == 0 && in(src, d.N)) {
      const long long i = (long long)src * d.D + s;
      sis[i] = seq;
      key_of[i] = key;
      client_of[i] = client;
    }
    __syncwarp();
    const bool in_q =
        in(src, d.N) && fast_quorum[(long long)src * d.N + me];
    const bool from_self = src == me;
    const int cur = get(clocks, d.K, key);
    const int clock = max(rclock, cur + 1);
    const bool propose = in_q && !from_self;
    set(clocks, d.K, key, propose ? clock : cur);
    const int ack_clock = from_self ? rclock : clock;
    const int vs = propose ? cur + 1 : 0, ve = propose ? clock : 0;
    const bool skipv = d.skip_capable && skip_fast_ack && in_q && !from_self;
    if (skipv) {
      // tempo.rs:442-455: the pair quorum's other member commits directly
      const int w[12] = {src, seq, clock, key, client, 2,
                         src, pay[4], pay[5], me, vs, ve};
      for (int j = 0; j < 12; ++j) words(j, w[j]);
      ob_broadcast(MCOMMIT, [](int) { return true; });
    } else {
      ob_emit(0, in_q, src, MCOLLECTACK, seq, ack_clock);
      if (lane == 0) {
        sp[2] = vs;
        sp[3] = ve;
      }
      __syncwarp();
    }
  }

  __device__ void mcollectack(int src, const int* pay) {
    const int seq = pay[0], clock = pay[1], vs = pay[2], ve = pay[3];
    const int s = slot(seq);
    const int nv = votes_n[s];
    const bool has_vote = vs > 0;
    const bool fits = has_vote && nv < d.N;
    __syncwarp();
    if (lane == 0) {
      if (fits && nv >= 0) {
        const long long i = (long long)s * d.N + nv;
        votes_by[i] = src;
        votes_s[i] = vs;
        votes_e[i] = ve;
      }
      votes_n[s] = nv + (fits ? 1 : 0);
    }
    if (has_vote && !fits) err |= ERR_CAPACITY;
    const int old_max = max_clock[s];
    const int new_max = max(old_max, clock);
    const int new_cnt =
        clock > old_max ? 1 : max_cnt[s] + (clock == old_max ? 1 : 0);
    const int cnt = ack_cnt[s] + 1;
    __syncwarp();
    if (lane == 0) {
      max_clock[s] = new_max;
      max_cnt[s] = new_cnt;
      ack_cnt[s] = cnt;
    }
    __syncwarp();
    const int key = key_of[(long long)me * d.D + s];
    bump(key, new_max, src != me);
    const bool all_acks = cnt == fq_size;
    const bool fast = all_acks && new_cnt >= f;
    const bool slow = all_acks && !fast;
    m_fast += fast ? 1 : 0;
    m_slow += slow ? 1 : 0;
    const int client = client_of[(long long)me * d.D + s];
    if (fast) {
      commit_broadcast(seq, new_max, key, client, true);
    } else {
      words(0, me);
      words(1, seq);
      words(2, new_max);
      ob_broadcast(MCONSENSUS, [&](int f_) {
        return slow && f_ < d.N && write_quorum[(long long)me * d.N + f_];
      });
    }
  }

  __device__ void mcommit(const int* pay) {
    const int dsrc = min(max(pay[0], 0), d.N - 1);
    const int seq = pay[1], clock = pay[2], key = pay[3], client = pay[4],
              nv = pay[5];
    const int s = slot(seq);
    if (sis[(long long)dsrc * d.D + s] != seq) err |= ERR_PROTO;
    if (bump_mode) mcc = max(mcc, clock);
    bump(key, clock, !bump_mode);
    // attached votes: thread v unions the ranges routed to voter v
    bool overflow = false;
    if (lane < d.N && in(key, d.K)) {
      unsigned ps_ = 0, pe_ = 0;
      bool en = false;
      for (int i = 0; i < d.N; ++i) {
        if (i < nv && pay[6 + 3 * i] == lane) {
          ps_ += (unsigned)pay[7 + 3 * i];
          pe_ += (unsigned)pay[8 + 3 * i];
          en = true;
        }
      }
      const long long kv = (long long)key * d.N + lane;
      int front = vote_front[kv];
      overflow = iset_add_range(front, vote_gaps + kv * d.G * 2, d.G,
                                (int)ps_, (int)pe_, en);
      vote_front[kv] = front;
    }
    if (__any_sync(FULL, overflow)) err |= ERR_CAPACITY;
    __syncwarp();
    pend_insert(key, clock, dsrc, seq, client);
    // GC committed clock
    bool govf = false;
    if (lane == 0) {
      int front = comm_front[dsrc];
      govf = iset_add(front, comm_gaps + (long long)dsrc * d.G * 2, d.G,
                      seq);
      comm_front[dsrc] = front;
    }
    if (__shfl_sync(FULL, govf, 0)) err |= ERR_CAPACITY;
    __syncwarp();
    drain(key);
  }

  __device__ void mdetached(int src, const int* pay) {
    const int key = pay[0], nr = pay[1];
    const int per_msg = (d.P - 2) / 2;
    for (int i = 0; i < per_msg; ++i)
      vote_add(key, src, pay[2 + 2 * i], pay[3 + 2 * i], i < nr);
    drain(key);
  }

  __device__ void mconsensus(int src, const int* pay) {
    const int dsrc = pay[0], seq = pay[1], clock = pay[2];
    const int s = slot(seq);
    const int key = get2(key_of, d.N, d.D, dsrc, s);
    const bool has_cmd = get2(sis, d.N, d.D, dsrc, s) == seq;
    bump(key, clock, has_cmd);
    ob_emit(0, true, src, MCONSENSUSACK, dsrc, seq);
  }

  __device__ void mconsensusack(const int* pay) {
    const int seq = pay[1], s = slot(seq);
    const int cnt = slow_acks[s] + 1;
    const bool chosen = cnt == wq_size;
    __syncwarp();
    if (lane == 0) slow_acks[s] = cnt;
    __syncwarp();
    const int key = key_of[(long long)me * d.D + s];
    const int client = client_of[(long long)me * d.D + s];
    commit_broadcast(seq, max_clock[s], key, client, chosen);
  }

  __device__ void mgc(int src, const int* pay) {
    const int N = d.N;
    if (in(src, N)) {
      for (int j = lane; j < N; j += 32) {
        const long long i = (long long)src * N + j;
        others[i] = max(others[i], pay[j]);
      }
      if (lane == 0) seen[src] = true;
    }
    __syncwarp();
    auto other = [&](int j) { return j < n && j != me; };
    const bool ready = warp_count(N, lane, [&](int j) {
      return !(seen[j] || !other(j));
    }) == 0;
    // thread c: column c's stable value and its GC delta
    int delta = 0;
    for (int c = lane; c < N; c += 32) {
      int mn = INF;
      for (int j = 0; j < N; ++j)
        if (other(j)) mn = min(mn, others[(long long)j * N + c]);
      int stable = min(comm_front[c], mn);
      stable = (ready && c < n) ? stable : 0;
      delta += max(stable - prev_stable[c], 0);
      prev_stable[c] = max(prev_stable[c], stable);
    }
    m_stable += warp_sum(delta);
    __syncwarp();
    for (long long i = lane; i < (long long)N * d.D; i += 32) {
      const int v = sis[i];
      if (v > 0 && v <= prev_stable[i / d.D]) sis[i] = 0;
    }
    __syncwarp();
  }

  __device__ void detach_drain() {
    const int DS = d.DS;
    const int per_msg = (d.P - 2) / 2;
    const int first = warp_first(d.K * DS, lane, [&](int i) {
      return det[2 * (long long)i] > 0;
    });
    const bool any_key = first >= 0;
    const int key = any_key ? first / DS : 0;
    int* row = det + (long long)key * DS * 2;
    words(0, key);
    __syncwarp();
    // thread 0 packs the first per_msg occupied ranges in slot order
    if (lane == 0) {
      int taken = 0;
      for (int j = 0; j < DS; ++j) {
        if (row[2 * j] > 0 && taken < per_msg) {
          sw[2 + 2 * taken] = row[2 * j];
          sw[3 + 2 * taken] = row[2 * j + 1];
          row[2 * j] = 0;
          row[2 * j + 1] = 0;
          ++taken;
        }
      }
      sw[1] = taken;
    }
    __syncwarp();
    const bool more = warp_first(d.K * DS, lane, [&](int i) {
      return det[2 * (long long)i] > 0;
    }) >= 0;
    ob_broadcast(MDETACHED, [&](int) { return any_key; });
    if (d.N < d.F) ob_emit(d.N, any_key && more, me, DETACH_DRAIN);
  }
};

}  // namespace

__global__ void __launch_bounds__(THREADS) tempo_handle_kernel(
    const Planes st, const RunCap cap, const bool* __restrict__ has,
    const int* __restrict__ rows, const bool* __restrict__ fire,
    const int* __restrict__ now_in, const int* __restrict__ n_ctx,
    const int* __restrict__ f_ctx, const bool* __restrict__ fq,
    const bool* __restrict__ wq, const int* __restrict__ fq_size,
    const int* __restrict__ wq_size, const int* __restrict__ threshold,
    const bool* __restrict__ bump_mode, const bool* __restrict__ skip_ack,
    const int* __restrict__ attach, bool* __restrict__ rdy_out,
    bool* __restrict__ pv, int* __restrict__ pd, int* __restrict__ pm,
    int* __restrict__ pp, bool* __restrict__ hv, int* __restrict__ hd,
    int* __restrict__ hm, int* __restrict__ hp, const MonArgs ma,
    const Dims d) {
  extern __shared__ int smem[];
  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  const int l = g / d.N, me = g % d.N;

  if (!cap.runs(l)) {  // frozen: the state stays, the outboxes are empty
    const long long fb = (long long)g * d.F;
    if (lane == 0) rdy_out[g] = false;
    for (long long i = lane; i < (long long)d.F * d.P; i += 32)
      pp[fb * d.P + i] = hp[fb * d.P + i] = 0;
    for (int i = lane; i < d.F; i += 32) {
      pv[fb + i] = hv[fb + i] = false;
      pd[fb + i] = pm[fb + i] = hd[fb + i] = hm[fb + i] = 0;
    }
    return;
  }

  // this process's rows of the state planes, updated in place (the
  // scalar ones go through registers and are written at the end)
  auto plane = [&](int i) {
    return (int*)st.p[i] + (long long)g * plane_words(i, d);
  };
  auto scalar = [&](int i) { return ((const int*)st.p[i])[g]; };
  int* stg = smem;
  Proc p{d, l, me, lane,
         plane(CLOCKS), plane(DET), plane(SIS), plane(KEY_OF),
         plane(CLIENT_OF), plane(ACK_CNT), plane(MAX_CLOCK), plane(MAX_CNT),
         plane(SLOW_ACKS), plane(VOTES_N), plane(VOTES_BY), plane(VOTES_S),
         plane(VOTES_E), plane(VOTE_FRONT), plane(VOTE_GAPS),
         plane(PEND_CLOCK), plane(PEND_SRC), plane(PEND_SEQ),
         plane(PEND_CLIENT), plane(COMM_FRONT), plane(COMM_GAPS),
         plane(OTHERS), plane(PREV_STABLE),
         (bool*)st.p[SEEN] + (long long)g * d.N,
         scalar(MCC), scalar(OWN_SEQ), scalar(M_FAST), scalar(M_SLOW),
         scalar(M_STABLE), scalar(ERR),
         n_ctx[l], f_ctx[l], fq_size[l], wq_size[l], threshold[l],
         bump_mode[l], skip_ack[l],
         fq + (long long)l * d.N * d.N, wq + (long long)l * d.N * d.N,
         attach + (long long)l * d.C,
         stg, stg + d.F, stg + 2 * d.F, stg + 3 * d.F,
         stg + 3 * d.F + d.F * d.P,
         mon_view(ma, g)};

  const int* row = rows + (long long)g * d.W;
  const int src = row[PSRC];
  const int* pay = row + PPAY;

  // readiness gate: MCollect needs a free dot slot; MCommit/MConsensus
  // the MCollect payload (the source is not clamped here)
  int mtype = has[g] ? row[PMT] : NUM_TYPES;
  bool rdy = true;
  if (mtype == MCOLLECT)
    rdy = p.get2(p.sis, d.N, d.D, src, p.slot(pay[0])) == 0;
  else if (mtype == MCOMMIT || mtype == MCONSENSUS)
    rdy = p.get2(p.sis, d.N, d.D, pay[0], p.slot(pay[1])) == pay[1];
  if (!(has[g] && rdy)) mtype = NUM_TYPES;
  const int branch = min(max(mtype, 0), NUM_TYPES);  // the switch's clip

  // periodic: GC frontier broadcast to all-but-me, the real-time clock
  // bump (micros saturate at INF), the detached-send kick-off in slot N
  const bool* fr = fire + (long long)g * d.R;
  p.ob_clear();
  for (int j = lane; j < d.N && j < d.P; j += 32) p.sw[j] = p.comm_front[j];
  p.ob_broadcast(MGC, [&](int f_) { return f_ != me && fr[0]; });
  if (fr[1]) {
    const int now = now_in[g];
    const int micros = now >= INF / 1000 ? INF : now * 1000;
    p.detached_all(max(p.mcc, micros));
  }
  const bool has_det = warp_first(d.K * d.DS, lane, [&](int i) {
    return p.det[2 * (long long)i] > 0;
  }) >= 0;
  if (d.N < d.F) p.ob_emit(d.N, fr[2] && has_det, me, DETACH_DRAIN);
  p.ob_flush(pv, pd, pm, pp);

  // the handler of this process's message only
  p.ob_clear();
  switch (branch) {
    case SUBMIT: p.submit(pay); break;
    case MCOLLECT: p.mcollect(src, pay); break;
    case MCOLLECTACK: p.mcollectack(src, pay); break;
    case MCOMMIT: p.mcommit(pay); break;
    case MDETACHED: p.mdetached(src, pay); break;
    case MCONSENSUS: p.mconsensus(src, pay); break;
    case MCONSENSUSACK: p.mconsensusack(pay); break;
    case MGC: p.mgc(src, pay); break;
    case MDRAIN: p.drain(pay[0]); break;
    case DETACH_DRAIN: p.detach_drain(); break;
    default: break;
  }
  p.ob_flush(hv, hd, hm, hp);

  if (lane == 0) {
    rdy_out[g] = rdy;
    ((int*)st.p[MCC])[g] = p.mcc;
    ((int*)st.p[OWN_SEQ])[g] = p.own_seq;
    ((int*)st.p[M_FAST])[g] = p.m_fast;
    ((int*)st.p[M_SLOW])[g] = p.m_slow;
    ((int*)st.p[M_STABLE])[g] = p.m_stable;
    ((int*)st.p[ERR])[g] = p.err;
  }
}

extern "C" int fantoch_tempo_handle(
    const void* state_table, const void* cap_tab, const void* has,
    const void* rows, const void* fire, const void* now, const void* n_ctx,
    const void* f_ctx, const void* fq, const void* wq, const void* fq_size,
    const void* wq_size, const void* threshold, const void* bump_mode,
    const void* skip_ack, const void* attach, void* rdy_out, void* pv,
    void* pd, void* pm, void* pp, void* hv, void* hd, void* hm, void* hp,
    void* mon_hash, void* mon_cnt, void* mon_flags, int L, int N, int D,
    int F, int P, int R, int W, int C, int K, int PK, int DS, int G,
    int skip_capable, int KM, int flags, void* stream) {
  const long long warps = (long long)L * N;
  if (warps == 0) return 0;
  Planes st;
  for (int i = 0; i < NPLANES; ++i)
    st.p[i] = ((void* const*)state_table)[i];
  const Dims d{L, N, D, F, P, R, W, C, K, PK, DS, G, skip_capable != 0};
  const size_t smem = (size_t)(3 * F + F * P + P) * sizeof(int);
  tempo_handle_kernel<<<(unsigned)warps, THREADS, smem,
                        (cudaStream_t)stream>>>(
      st, run_cap((const void* const*)cap_tab, flags), (const bool*)has,
      (const int*)rows, (const bool*)fire, (const int*)now,
      (const int*)n_ctx, (const int*)f_ctx, (const bool*)fq, (const bool*)wq,
      (const int*)fq_size, (const int*)wq_size, (const int*)threshold,
      (const bool*)bump_mode, (const bool*)skip_ack, (const int*)attach,
      (bool*)rdy_out, (bool*)pv, (int*)pd, (int*)pm, (int*)pp, (bool*)hv,
      (int*)hd, (int*)hm, (int*)hp,
      mon_args(mon_hash, mon_cnt, mon_flags, KM),
      d);
  return (int)cudaGetLastError();
}
