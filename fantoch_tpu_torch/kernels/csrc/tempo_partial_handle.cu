// K11 tempo_partial_handle: Tempo's partial-replication readiness gate,
// periodic timers and message handlers for every (lane, process)
// (replaces fantoch_tpu/engine/core.py run_handlers :422 and the
// ready/periodic calls :890-918 with TempoPartialDev.ready :198,
// .periodic :242 and .handle :217 of
// fantoch_tpu/engine/protocols/tempo_partial.py: the fifteen handlers
// :441-1211, the shard helpers :279-430, the per-shard table executor
// _p_drain :1115, _p_execute :1091, _stable_clock_p :785, _pend_insert_p
// :820 and _vote_add_p :808, the StableAtShard buffering _p_stableat
// :1211, and the add side of fantoch_tpu/engine/iset.py, in iset.cuh).
//
// One block of one warp (THREADS = 32) per (lane, process): thread 0's
// serial branch sets the kernel's time, and thread 0's registers are
// allotted to every thread of its block, so the smallest block fits the
// most (lane, process) blocks on an SM at once. The reference runs the
// handler as a lax.switch under vmap, which evaluates all sixteen branches
// and selects one; here the block runs only its own branch, in the
// reference's order: `ready` on the incoming state, `periodic` at the
// process's event time (its clock bump can change the state), then
// `handle` on the state `periodic` returned.
//
// 1. In place: the block updates its process's rows of the step's own
//    state planes, and only on lanes whose run predicate holds at the
//    step's start (common.cuh RunCap; every lane without a cap), as the
//    reference's vmapped while_loop keeps a frozen lane's state. A frozen
//    lane's blocks write rdy false and empty outboxes (valid false, zero
//    words) and exit. Block (l, p) reads and writes only process p's rows
//    of lane l, so no block sees another's writes. The six scalar planes
//    (max commit clock, sequence, metrics, error word) live in thread 0's
//    registers and are stored once at the end.
// 2. Thread 0 runs the gate, the three timers and the branch, serially
//    and in the reference's order, staging both outboxes in shared memory
//    exactly as the twin's emits leave them (a shard broadcast fills all
//    F slots, addressed to base + slot, and later emits overwrite single
//    slots). A disabled path still computes what its invalid slots carry.
// 3. MGC's free scan over the [N, D] dot words runs on the whole block,
//    after thread 0 has raised the stable clocks.
// 4. The block stores both outboxes.
//
// One-hot semantics of the reference: a read at an out-of-range index
// yields 0, a write there drops; dot slots use floor modulo (seq 0 maps to
// slot D - 1); MCommit's dot source is clamped to [0, N - 1] while the gate
// reads an out-of-range source as 0; MCommit routes voter ranges by one-hot
// sums, so duplicate voters add their starts and ends; a command's table
// column is clamped to the last. Integer sums and the (src, seq) packing
// wrap as int32 does in the reference.
//
// Bound on this card: bytes. The region reads a few state words per (lane,
// process) and the rows its branch touches, and writes the words that
// change and two [F, P] outboxes (tempo_partial_handle.py work). In place,
// this kernel moves about that; what is left is thread 0's serial branch
// (the drains and the executor walk their tables one word at a time).
#include "common.cuh"
#include "iset.cuh"

using namespace fantoch;

namespace {

constexpr int THREADS = 32;  // tempo_partial_handle.py THREADS
// tempo_partial_handle.py MAX_SHARDS, MAX_KEYS_PER_CMD
constexpr int MAXS = 8, MAXKPC = 8;
constexpr int SUBMIT = 0, MCOLLECT = 1, MCOLLECTACK = 2, MCOMMIT = 3,
              MDETACHED = 4, MCONSENSUS = 5, MCONSENSUSACK = 6, MGC = 7,
              MDRAIN = 8, DETACH_DRAIN = 9, MFWDSUBMIT = 10, MBUMP = 11,
              MSHARDCOMMIT = 12, MSHARDAGG = 13, STABLEAT = 14,
              NUM_TYPES = 15, TO_CLIENT = 16;
constexpr int ERR_SEQ = 4, ERR_DOT = 8, ERR_CAPACITY = 16, ERR_PROTO = 32;
constexpr int SEQ_BOUND = 1 << 20;

// state planes, in tempo_partial_handle.py STATE_KEYS order
enum Plane {
  CLOCKS, DET, MCC, SIS, CLIENT_OF, CSEQ_OF, OWN_SEQ, ACK_CNT, MAX_CLOCK,
  MAX_CNT, SLOW_ACKS, VOTES_N, VOTES_BY, VOTES_S, VOTES_E, SHAG_CNT,
  SHAG_MAX, MBUMP_BUF, VOTE_FRONT, VOTE_GAPS, PEND_CLOCK, PEND_SRC, PEND_SEQ,
  PEND_CLIENT, PEND_CSEQ, PEND_KMASK, PEND_MISSING, PEND_PHASE, STABLE_CNT,
  STABLE_CNT_SEQ, BUF_CNT, BUF_SEQ, COMM_FRONT, COMM_GAPS, OTHERS, SEEN,
  PREV_STABLE, M_FAST, M_SLOW, M_STABLE, ERR, NPLANES
};

struct Planes {
  void* p[NPLANES];
};

struct Dims {
  int L, N, D, F, P, W, C;      // engine dims
  int K, PK, DS, G, KPC, S, T1;  // keys, pending, detached, gaps, table
};

// words (bytes for SEEN) of one process in each plane
__device__ long long plane_words(int i, const Dims& d) {
  const long long N = d.N, D = d.D, K = d.K;
  switch (i) {
    case CLOCKS: return K;
    case DET: return K * d.DS * 2;
    case SIS: case CLIENT_OF: case CSEQ_OF: case ACK_CNT: case MAX_CLOCK:
    case MAX_CNT: case SLOW_ACKS: case VOTES_N: case MBUMP_BUF: return N * D;
    case VOTES_BY: return N * D * N;
    case VOTES_S: case VOTES_E: return N * D * d.KPC * N;
    case SHAG_CNT: case SHAG_MAX: return D;
    case VOTE_FRONT: return K * N;
    case VOTE_GAPS: return K * N * d.G * 2;
    case PEND_CLOCK: case PEND_SRC: case PEND_SEQ: case PEND_CLIENT:
    case PEND_CSEQ: case PEND_KMASK: case PEND_MISSING: case PEND_PHASE:
      return K * d.PK;
    case STABLE_CNT: case STABLE_CNT_SEQ: return d.C;
    case BUF_CNT: case BUF_SEQ: return K * d.C;
    case COMM_FRONT: case SEEN: case PREV_STABLE: return N;
    case COMM_GAPS: return N * d.G * 2;
    case OTHERS: return N * N;
    default: return 1;  // the scalar planes
  }
}

// A staged outbox in shared memory: valid, dst, mtype [F], payload [F, P].
struct Outbox {
  int *v, *dst, *mt, *pay;
};

// One (lane, process): its rows of the state planes (updated in place),
// its scalar planes, the lane ctx and the staged outboxes. Its member
// functions run on thread 0 only.
struct Proc {
  Dims d;
  int me;
  int *clocks, *det, *sis, *client_of, *cseq_of, *ack_cnt, *max_clock,
      *max_cnt, *slow_acks, *votes_n, *votes_by, *votes_s, *votes_e,
      *shag_cnt, *shag_max, *mbump_buf, *vote_front, *vote_gaps,
      *pend_clock, *pend_src, *pend_seq, *pend_client, *pend_cseq,
      *pend_kmask, *pend_missing, *pend_phase, *stable_cnt,
      *stable_cnt_seq, *buf_cnt, *buf_seq, *comm_front, *comm_gaps, *others,
      *prev_stable;
  bool* seen;
  // scalar planes, in thread 0's registers
  int mcc, own_seq, m_fast, m_slow, m_stable, err;
  // lane ctx
  int n, f, fq_size, wq_size, threshold;
  bool bump_mode;
  const bool *fast_quorum, *write_quorum;  // [N, N] of this lane
  const int *shard_of, *closest;           // [N], [N, S]
  const int *attach_s, *cmd_kmask, *cmd_skey;  // [C, S], [C, T1], [C, T1, S, KPC]
  int s_me, base;
  Outbox pob, hob;
  int* words;  // [P] scratch for a payload

  __device__ bool in(int i, int size) const { return i >= 0 && i < size; }
  __device__ int slot(int seq) const { return floor_mod(seq - 1, d.D); }
  __device__ int get(const int* a, int size, int i) const {
    return in(i, size) ? a[i] : 0;
  }
  // oh_get(oh_get(a, i), j) of an [N, D] plane: 0 out of range
  __device__ bool cell(int i, int j) const {
    return in(i, d.N) && in(j, d.D);
  }
  __device__ long long at(int i, int j) const {
    return (long long)i * d.D + j;
  }
  __device__ int get2(const int* a, int i, int j) const {
    return cell(i, j) ? a[at(i, j)] : 0;
  }
  __device__ void set2(int* a, int i, int j, int v) const {
    if (cell(i, j)) a[at(i, j)] = v;
  }
  __device__ int closest_to(int s) const {
    return closest[(long long)me * d.S + s];
  }

  // -- outbox staging -------------------------------------------------
  __device__ void clear(const Outbox& ob) const {
    for (int i = 0; i < d.F; ++i) ob.v[i] = ob.dst[i] = ob.mt[i] = 0;
    for (int i = 0; i < d.F * d.P; ++i) ob.pay[i] = 0;
  }
  __device__ void clear_words() const {
    for (int j = 0; j < d.P; ++j) words[j] = 0;
  }
  // `words` to every slot s, addressed to process base + s, valid for
  // s < n and ok(s) (emit_broadcast fills all F slots)
  template <class Ok>
  __device__ void broadcast(const Outbox& ob, int mt, Ok ok) const {
    for (int s = 0; s < d.F; ++s) {
      ob.v[s] = s < n && ok(s);
      ob.dst[s] = base + s;
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
  __device__ void emit1(const Outbox& ob, int i, bool v, int dst, int mt,
                        int w0) const {
    const int w[1] = {w0};
    emit(ob, i, v, dst, mt, w, 1);
  }

  // -- the command tables (_cmd_tables, _my_keys) ---------------------
  __device__ void command(int client, int cseq, int& kmask,
                          int* skey) const {
    const int j = min(cseq, d.T1 - 1);
    const bool ok = in(client, d.C) && in(j, d.T1);
    const long long row = (long long)client * d.T1 + j;
    kmask = ok ? cmd_kmask[row] : 0;
    for (int i = 0; i < d.S * d.KPC; ++i)
      skey[i] = ok ? cmd_skey[row * d.S * d.KPC + i] : 0;
  }
  __device__ void my_keys(const int* skey, int* keys) const {
    for (int k = 0; k < d.KPC; ++k)
      keys[k] = in(s_me, d.S) ? skey[s_me * d.KPC + k] : 0;
  }
  __device__ int popcount(int kmask) const {
    int c = 0;
    for (int s = 0; s < d.S; ++s) c += (kmask >> s) & 1;
    return c;
  }

  // -- clock / vote helpers -------------------------------------------
  __device__ void det_add(int key, int start, int end, bool enable) {
    const bool kin = in(key, d.K);
    int* row = det + (long long)(kin ? key : 0) * d.DS * 2;
    int cslot = -1, fslot = -1;
    if (kin) {
      for (int j = 0; j < d.DS; ++j) {
        if (cslot < 0 && row[2 * j] > 0 && row[2 * j + 1] + 1 == start)
          cslot = j;
        if (fslot < 0 && row[2 * j] == 0) fslot = j;
      }
    } else {
      fslot = 0;  // a zero row: every slot free
    }
    const bool do_ = enable && end >= start;
    const bool comp = do_ && cslot >= 0;
    const bool store = do_ && cslot < 0;
    const bool overflow = store && fslot < 0;
    if (kin && comp) row[2 * cslot + 1] = end;
    if (kin && store && !overflow) {
      row[2 * fslot] = start;
      row[2 * fslot + 1] = end;
    }
    if (overflow) err |= ERR_CAPACITY;
  }

  __device__ void bump(int key, int up_to, bool enable) {
    const int cur = get(clocks, d.K, key);
    const bool do_ = enable && cur < up_to;
    det_add(key, cur + 1, up_to, do_);
    if (in(key, d.K)) clocks[key] = do_ ? up_to : cur;
  }

  __device__ void detached_keys(const int* keys, int up_to, bool enable) {
    for (int k = 0; k < d.KPC; ++k)
      bump(keys[k] >= 0 ? keys[k] : -1, up_to, enable && keys[k] >= 0);
  }

  // every key below min_clock takes its first free detached slot
  __device__ void detached_all(int min_clock) {
    for (int k = 0; k < d.K; ++k) {
      const int c = clocks[k];
      if (c >= min_clock) continue;
      int* row = det + (long long)k * d.DS * 2;
      int slot_ = -1;
      for (int j = 0; j < d.DS && slot_ < 0; ++j)
        if (row[2 * j] == 0) slot_ = j;
      if (slot_ < 0) {
        err |= ERR_CAPACITY;
      } else {
        row[2 * slot_] = c + 1;
        row[2 * slot_ + 1] = min_clock;
      }
      clocks[k] = min_clock;
    }
  }

  // key_clocks.proposal over the local keys: the clock and each key's
  // vacated range; the keys' clocks move only with `apply`
  __device__ int proposal(const int* keys, int min_clock, bool apply,
                          int* vs, int* ve) {
    int cur[MAXKPC];
    int mx = 0;
    for (int k = 0; k < d.KPC; ++k) {
      cur[k] = keys[k] >= 0 ? get(clocks, d.K, keys[k]) : 0;
      mx = max(mx, cur[k]);
    }
    const int clock = max(min_clock, mx + 1);
    for (int k = 0; k < d.KPC; ++k) {
      const bool up = keys[k] >= 0 && cur[k] < clock;
      vs[k] = up ? cur[k] + 1 : 0;
      ve[k] = up ? clock : 0;
      if (apply && keys[k] >= 0 && in(keys[k], d.K)) clocks[keys[k]] = clock;
    }
    return clock;
  }

  __device__ void vote_add(int key, int voter, int start, int end,
                           bool enable) {
    if (!in(key, d.K) || !in(voter, d.N)) return;  // reads empty, drops
    const long long kv = (long long)key * d.N + voter;
    if (iset_add_range(vote_front[kv], vote_gaps + kv * d.G * 2, d.G, start,
                       end, enable))
      err |= ERR_CAPACITY;
  }

  // -- the votes of a dot ---------------------------------------------
  __device__ long long vrow(int dsrc, int s) const {
    return ((long long)dsrc * d.D + s);
  }
  __device__ void set_votes(int dsrc, int s, int idx, int by, const int* vs,
                            const int* ve) {
    if (!cell(dsrc, s) || !in(idx, d.N)) return;
    const long long r = vrow(dsrc, s);
    votes_by[r * d.N + idx] = by;
    for (int k = 0; k < d.KPC; ++k) {
      votes_s[(r * d.KPC + k) * d.N + idx] = vs[k];
      votes_e[(r * d.KPC + k) * d.N + idx] = ve[k];
    }
  }

  // -- submit / forward / collect -------------------------------------
  __device__ void start(int dsrc, int dseq, int client, int cseq,
                        bool forward) {
    int kmask, skey[MAXS * MAXKPC], keys[MAXKPC], vs[MAXKPC], ve[MAXKPC];
    command(client, cseq, kmask, skey);
    my_keys(skey, keys);
    const int s = slot(dseq);
    const int clock = proposal(keys, 0, true, vs, ve);
    set2(ack_cnt, dsrc, s, 0);
    set2(max_clock, dsrc, s, 0);
    set2(max_cnt, dsrc, s, 0);
    set2(slow_acks, dsrc, s, 0);
    set2(votes_n, dsrc, s, 1);
    set_votes(dsrc, s, 0, me, vs, ve);
    clear_words();
    words[0] = dsrc;
    words[1] = dseq;
    words[2] = client;
    words[3] = cseq;
    words[4] = clock;
    broadcast(hob, MCOLLECT, [](int) { return true; });
    if (forward) {
      shag_cnt[s] = 0;
      shag_max[s] = 0;
      const int w[4] = {dsrc, dseq, client, cseq};
      for (int sh = 0; sh < d.S; ++sh)
        emit(hob, d.N + sh, ((kmask >> sh) & 1) && sh != s_me,
             closest_to(sh), MFWDSUBMIT, w, 4);
    }
  }

  __device__ void mcollect(int coord, const int* pay) {
    const int dsrc = pay[0], dseq = pay[1], client = pay[2], cseq = pay[3],
              rclock = pay[4];
    const int s = slot(dseq);
    if (get2(sis, dsrc, s) != 0) err |= ERR_DOT;
    set2(sis, dsrc, s, dseq);
    set2(client_of, dsrc, s, client);
    set2(cseq_of, dsrc, s, cseq);
    const bool in_q =
        in(coord, d.N) && fast_quorum[(long long)coord * d.N + me];
    const bool from_self = coord == me;
    int kmask, skey[MAXS * MAXKPC], keys[MAXKPC], vs[MAXKPC], ve[MAXKPC];
    command(client, cseq, kmask, skey);
    my_keys(skey, keys);
    const bool propose = in_q && !from_self;
    const int pclock = proposal(keys, rclock, propose, vs, ve);
    const int clock = from_self ? rclock : pclock;
    for (int k = 0; k < d.KPC; ++k) {
      vs[k] = propose ? vs[k] : 0;
      ve[k] = propose ? ve[k] : 0;
    }
    // a buffered MBump applies after the proposal
    const int bump_to = get2(mbump_buf, dsrc, s);
    detached_keys(keys, bump_to, in_q && bump_to > 0);
    set2(mbump_buf, dsrc, s, 0);
    int w[3 + 2 * MAXKPC] = {dsrc, dseq, clock};
    for (int k = 0; k < d.KPC; ++k) {
      w[3 + 2 * k] = vs[k];
      w[4 + 2 * k] = ve[k];
    }
    emit(hob, 0, in_q, coord, MCOLLECTACK, w, 3 + 2 * d.KPC);
    for (int sh = 0; sh < d.S; ++sh)
      emit(hob, 1 + sh, in_q && ((kmask >> sh) & 1) && sh != s_me,
           closest_to(sh), MBUMP, w, 3);
  }

  __device__ void mbump(const int* pay) {
    const int dsrc = pay[0], dseq = pay[1], clock = pay[2];
    const int s = slot(dseq);
    const bool have = get2(sis, dsrc, s) == dseq;
    int kmask, skey[MAXS * MAXKPC], keys[MAXKPC];
    command(get2(client_of, dsrc, s), get2(cseq_of, dsrc, s), kmask, skey);
    my_keys(skey, keys);
    detached_keys(keys, clock, have);
    const int buffered = max(get2(mbump_buf, dsrc, s), clock);
    set2(mbump_buf, dsrc, s, have ? 0 : buffered);
  }

  // -- collect-ack / commit paths -------------------------------------
  __device__ void commit_broadcast(int dsrc, int dseq, int clock, int client,
                                   int cseq, bool valid) {
    const int s = slot(dseq);
    const bool c = cell(dsrc, s);
    const long long r = vrow(dsrc, s);
    clear_words();
    words[0] = dsrc;
    words[1] = dseq;
    words[2] = clock;
    words[3] = client;
    words[4] = cseq;
    words[5] = get2(votes_n, dsrc, s);
    for (int v = 0; v < d.N; ++v) {
      words[6 + v] = c ? votes_by[r * d.N + v] : 0;
      for (int k = 0; k < d.KPC; ++k) {
        const long long i = (r * d.KPC + k) * d.N + v;
        words[6 + d.N + 2 * (k * d.N + v)] = c ? votes_s[i] : 0;
        words[7 + d.N + 2 * (k * d.N + v)] = c ? votes_e[i] : 0;
      }
    }
    broadcast(hob, MCOMMIT, [&](int) { return valid; });
  }

  // partial.rs:37-101: commit in this shard, or MShardCommit to the owner
  __device__ void commit_actions(int dsrc, int dseq, int clock, int client,
                                 int cseq, int kmask, bool valid) {
    if (popcount(kmask) == 1) {
      commit_broadcast(dsrc, dseq, clock, client, cseq, valid);
    } else {
      clear(hob);
      const int w[3] = {dsrc, dseq, clock};
      emit(hob, 0, valid, dsrc, MSHARDCOMMIT, w, 3);
    }
  }

  __device__ void mcollectack(int src, const int* pay) {
    const int dsrc = pay[0], dseq = pay[1], clock = pay[2];
    int vs[MAXKPC], ve[MAXKPC];
    bool has_vote = false;
    for (int k = 0; k < d.KPC; ++k) {
      vs[k] = pay[3 + 2 * k];
      ve[k] = pay[4 + 2 * k];
      has_vote = has_vote || vs[k] > 0;
    }
    const int s = slot(dseq);
    const int nv = get2(votes_n, dsrc, s);
    const bool fits = has_vote && nv < d.N;
    set_votes(dsrc, s, fits ? nv : d.N, src, vs, ve);
    set2(votes_n, dsrc, s, nv + (fits ? 1 : 0));
    if (has_vote && !fits) err |= ERR_CAPACITY;
    const int old_max = get2(max_clock, dsrc, s);
    const int new_max = max(old_max, clock);
    const int new_cnt = clock > old_max
        ? 1 : get2(max_cnt, dsrc, s) + (clock == old_max ? 1 : 0);
    const int cnt = get2(ack_cnt, dsrc, s) + 1;
    set2(max_clock, dsrc, s, new_max);
    set2(max_cnt, dsrc, s, new_cnt);
    set2(ack_cnt, dsrc, s, cnt);
    const int client = get2(client_of, dsrc, s);
    const int cseq = get2(cseq_of, dsrc, s);
    int kmask, skey[MAXS * MAXKPC], keys[MAXKPC];
    command(client, cseq, kmask, skey);
    my_keys(skey, keys);
    detached_keys(keys, new_max, src != me);
    const bool all_acks = cnt == fq_size;
    const bool fast = all_acks && new_cnt >= f;
    const bool slow = all_acks && !fast;
    m_fast += fast ? 1 : 0;
    m_slow += slow ? 1 : 0;
    if (fast) {
      commit_actions(dsrc, dseq, new_max, client, cseq, kmask, true);
    } else {
      clear_words();
      words[0] = dsrc;
      words[1] = dseq;
      words[2] = new_max;
      const bool* wq = write_quorum + (long long)me * d.N;
      broadcast(hob, MCONSENSUS, [&](int f_) {
        return slow && wq[min(max(base + f_, 0), d.N - 1)];
      });
    }
  }

  __device__ void mshardcommit(const int* pay) {
    const int dsrc = pay[0], dseq = pay[1], clock = pay[2];
    const int s = slot(dseq);
    if (dsrc != me) err |= ERR_PROTO;
    const int smax = max(shag_max[s], clock);
    const int scnt = shag_cnt[s] + 1;
    shag_max[s] = smax;
    shag_cnt[s] = scnt;
    int kmask, skey[MAXS * MAXKPC];
    command(get2(client_of, me, s), get2(cseq_of, me, s), kmask, skey);
    const bool done = scnt == popcount(kmask);
    const int w[3] = {dsrc, dseq, smax};
    emit(hob, 0, done, me, MSHARDAGG, w, 3);
    for (int sh = 0; sh < d.S; ++sh)
      emit(hob, 1 + sh, done && ((kmask >> sh) & 1) && sh != s_me,
           closest_to(sh), MSHARDAGG, w, 3);
  }

  // -- commit receiver + table executor -------------------------------
  __device__ int stable_clock(int key) const {
    const bool kin = in(key, d.K);
    auto masked = [&](int v) {
      return shard_of[v] == s_me
          ? (kin ? vote_front[(long long)key * d.N + v] : 0) : INF;
    };
    const int k = n - threshold;
    int sum = 0;
    for (int v = 0; v < d.N; ++v) {
      const int mv = masked(v);
      int rank = 0;
      for (int j = 0; j < d.N; ++j) {
        const int mj = masked(j);
        rank += (mj < mv || (mj == mv && j < v)) ? 1 : 0;
      }
      if (rank == k) sum = (int)((unsigned)sum + (unsigned)mv);
    }
    return sum;
  }

  __device__ void pend_insert(int key, int clock, int src, int seq,
                              int client, int cseq, int kmask, int missing,
                              bool enable) {
    const bool kin = in(key, d.K);
    const long long b = (long long)(kin ? key : 0) * d.PK;
    int j = kin ? -1 : 0;  // a zero row: every slot free
    for (int i = 0; kin && i < d.PK && j < 0; ++i)
      if (pend_clock[b + i] == 0) j = i;
    const bool overflow = enable && j < 0;
    if (overflow) err |= ERR_CAPACITY;
    if (!enable || overflow || !kin) return;
    pend_clock[b + j] = clock;
    pend_src[b + j] = src;
    pend_seq[b + j] = seq;
    pend_client[b + j] = client;
    pend_cseq[b + j] = cseq;
    pend_kmask[b + j] = kmask;
    pend_missing[b + j] = missing;
    pend_phase[b + j] = 1;
  }

  __device__ void mcommit(const int* pay) {
    const int N = d.N;
    const int dsrc = min(max(pay[0], 0), N - 1);
    const int dseq = pay[1], clock = pay[2], client = pay[3], cseq = pay[4],
              nv = pay[5];
    const int s = slot(dseq);
    if (get2(sis, dsrc, s) != dseq) err |= ERR_PROTO;
    int kmask, skey[MAXS * MAXKPC], keys[MAXKPC];
    command(client, cseq, kmask, skey);
    my_keys(skey, keys);
    const int nsh = popcount(kmask);
    if (bump_mode) mcc = max(mcc, clock);
    detached_keys(keys, clock, !bump_mode);
    // attached votes: voter v unions the ranges routed to it
    for (int k = 0; k < d.KPC; ++k) {
      const int key = keys[k];
      if (in(key, d.K)) {
        for (int v = 0; v < N; ++v) {
          unsigned ps_ = 0, pe_ = 0;
          bool en = false;
          for (int i = 0; i < N; ++i) {
            if (i < nv && pay[6 + i] == v) {
              ps_ += (unsigned)pay[6 + N + 2 * (k * N + i)];
              pe_ += (unsigned)pay[7 + N + 2 * (k * N + i)];
              en = true;
            }
          }
          en = en && (int)ps_ > 0;
          const long long kv = (long long)key * N + v;
          if (iset_add_range(vote_front[kv], vote_gaps + kv * d.G * 2, d.G,
                             (int)ps_, (int)pe_, en))
            err |= ERR_CAPACITY;
        }
      }
      pend_insert(key, clock, dsrc, dseq, client, cseq, kmask, nsh,
                  key >= 0);
    }
    // GC: only my shard's dots feed the committed clock
    const bool my_dot = shard_of[dsrc] == s_me;
    if (iset_add(comm_front[dsrc], comm_gaps + (long long)dsrc * d.G * 2,
                 d.G, dseq, my_dot))
      err |= ERR_CAPACITY;
    set2(sis, dsrc, s, my_dot ? dseq : 0);
    for (int k = 0; k < d.KPC; ++k)
      emit1(hob, k, keys[k] >= 0, me, MDRAIN, keys[k]);
  }

  __device__ void mconsensus(int src, const int* pay) {
    const int dsrc = pay[0], dseq = pay[1], clock = pay[2];
    const int s = slot(dseq);
    const bool has_cmd = get2(sis, dsrc, s) == dseq;
    int kmask, skey[MAXS * MAXKPC], keys[MAXKPC];
    command(get2(client_of, dsrc, s), get2(cseq_of, dsrc, s), kmask, skey);
    my_keys(skey, keys);
    detached_keys(keys, clock, has_cmd);
    const int w[2] = {dsrc, dseq};
    emit(hob, 0, true, src, MCONSENSUSACK, w, 2);
  }

  __device__ void mconsensusack(const int* pay) {
    const int dsrc = pay[0], dseq = pay[1];
    const int s = slot(dseq);
    const int cnt = get2(slow_acks, dsrc, s) + 1;
    set2(slow_acks, dsrc, s, cnt);
    const int client = get2(client_of, dsrc, s);
    const int cseq = get2(cseq_of, dsrc, s);
    int kmask, skey[MAXS * MAXKPC];
    command(client, cseq, kmask, skey);
    commit_actions(dsrc, dseq, get2(max_clock, dsrc, s), client, cseq, kmask,
                   cnt == wq_size);
  }

  // frontier join and stable clocks; the block frees the dot words after
  __device__ void mgc(int src, const int* pay) {
    const int N = d.N;
    if (in(src, N)) {
      for (int j = 0; j < N; ++j) {
        const long long i = (long long)src * N + j;
        others[i] = max(others[i], pay[j]);
      }
      seen[src] = true;
    }
    auto other = [&](int j) { return shard_of[j] == s_me && j != me; };
    bool ready = true;
    for (int j = 0; j < N; ++j) ready = ready && (seen[j] || !other(j));
    unsigned delta = 0;
    for (int c = 0; c < N; ++c) {
      int mn = INF;
      for (int j = 0; j < N; ++j)
        if (other(j)) mn = min(mn, others[(long long)j * N + c]);
      int stable = min(comm_front[c], mn);
      stable = (ready && shard_of[c] == s_me) ? stable : 0;
      delta += (unsigned)max(stable - prev_stable[c], 0);
      prev_stable[c] = max(prev_stable[c], stable);
    }
    m_stable = (int)((unsigned)m_stable + delta);
  }

  __device__ void detach_drain() {
    const int per_msg = (d.P - 2) / 2;
    int key = 0;
    bool any_key = false;
    for (int i = 0; i < d.K * d.DS && !any_key; ++i)
      if (det[2 * (long long)i] > 0) {
        any_key = true;
        key = i / d.DS;
      }
    int* row = det + (long long)key * d.DS * 2;
    clear_words();
    words[0] = key;
    int taken = 0;
    for (int j = 0; j < d.DS; ++j) {
      if (row[2 * j] > 0 && taken < per_msg) {
        words[2 + 2 * taken] = row[2 * j];
        words[3 + 2 * taken] = row[2 * j + 1];
        row[2 * j] = 0;
        row[2 * j + 1] = 0;
        ++taken;
      }
    }
    words[1] = taken;
    bool more = false;
    for (int i = 0; i < d.K * d.DS && !more; ++i)
      more = det[2 * (long long)i] > 0;
    broadcast(hob, MDETACHED, [&](int) { return any_key; });
    emit1(hob, d.N, any_key && more, me, DETACH_DRAIN, 0);
  }

  // -- the per-key pending queue --------------------------------------
  // the lowest (clock, src * SEQ_BOUND + seq) entry of `key` among
  // `elig(j)`, first index on ties, 0 when none is
  template <class Elig>
  __device__ int queue_head(int key, Elig elig) const {
    const bool kin = in(key, d.K);
    const long long b = (long long)(kin ? key : 0) * d.PK;
    int cmin = INF;
    for (int j = 0; j < d.PK; ++j)
      if (elig(j)) cmin = min(cmin, kin ? pend_clock[b + j] : 0);
    int best = INF, idx = 0;
    for (int j = 0; j < d.PK; ++j) {
      const int c = kin ? pend_clock[b + j] : 0;
      const int packed =
          kin ? (int)((unsigned)pend_src[b + j] * (unsigned)SEQ_BOUND +
                      (unsigned)pend_seq[b + j])
              : 0;
      const int v = (elig(j) && c == cmin) ? packed : INF;
      if (v < best) {
        best = v;
        idx = j;
      }
    }
    return idx;
  }
  __device__ int pend(const int* a, int key, int j) const {
    return in(key, d.K) && in(j, d.PK) ? a[(long long)key * d.PK + j] : 0;
  }
  __device__ void pend_set(int* a, int key, int j, int v) const {
    if (in(key, d.K) && in(j, d.PK)) a[(long long)key * d.PK + j] = v;
  }
  __device__ int kc(const int* a, int key, int client) const {
    return in(key, d.K) && in(client, d.C)
        ? a[(long long)key * d.C + client] : 0;
  }
  __device__ void kc_set(int* a, int key, int client, int v) const {
    if (in(key, d.K) && in(client, d.C)) a[(long long)key * d.C + client] = v;
  }

  // execute the entry: the key's result part to the client when I am its
  // connected process of my shard, free the slot
  __device__ void execute(int key, int idx, int client, bool enable) {
    // take2 reads 0 out of range, so process 0 counts as connected then
    const int att = in(client, d.C) && in(s_me, d.S)
        ? attach_s[(long long)client * d.S + s_me] : 0;
    const bool connected = att == me;
    emit1(hob, 0, enable && connected, d.N + client, TO_CLIENT, 0);
    if (enable) {
      pend_set(pend_clock, key, idx, 0);
      pend_set(pend_phase, key, idx, 0);
    }
  }

  __device__ void drain(int key) {
    const int stable = stable_clock(key);
    auto elig = [&](int j) {
      const int ph = pend(pend_phase, key, j);
      const int c = pend(pend_clock, key, j);
      return (ph == 1 && c > 0 && c <= stable) || ph == 2;
    };
    int n_el = 0;
    for (int j = 0; j < d.PK; ++j) n_el += elig(j) ? 1 : 0;
    const int idx = queue_head(key, elig);
    const bool proceed =
        n_el > 0 && pend(pend_phase, key, idx) != 2 && key >= 0;
    const int client = pend(pend_client, key, idx);
    const int cseq = pend(pend_cseq, key, idx);
    const int kmask = pend(pend_kmask, key, idx);
    const int missing0 = pend(pend_missing, key, idx);
    int kmask_c, skey[MAXS * MAXKPC], keys[MAXKPC];
    command(client, cseq, kmask_c, skey);
    my_keys(skey, keys);
    int nloc = 0;
    for (int k = 0; k < d.KPC; ++k) nloc += keys[k] >= 0 ? 1 : 0;
    const bool single = popcount(kmask) == 1 && nloc == 1;
    // rifl_to_stable_count, for commands with more than one local key
    const int prev = get(stable_cnt_seq, d.C, client) == cseq
        ? get(stable_cnt, d.C, client) : 0;
    const int cnt = prev + 1;
    const bool counted = proceed && !single && nloc > 1;
    const bool do_mark = (nloc > 1 ? cnt == nloc : true) && proceed &&
                         !single;
    if (counted && in(client, d.C)) {
      stable_cnt[client] = do_mark ? 0 : cnt;
      stable_cnt_seq[client] = cseq;
    }
    // apply and clear the buffered StableAtShard count of this rifl
    const int bcnt = kc(buf_seq, key, client) == cseq
        ? kc(buf_cnt, key, client) : 0;
    if (proceed && !single) kc_set(buf_cnt, key, client, 0);
    const int missing = missing0 - (do_mark ? 1 : 0) - bcnt;
    // StableAtShard to the command's other keys: local ones to myself,
    // remote ones through the closest process of their shard
    int slot_i = 2;
    for (int sh = 0; sh < d.S; ++sh) {
      const int dst = sh == s_me ? me : closest_to(sh);
      for (int k = 0; k < d.KPC; ++k) {
        const int kk = skey[sh * d.KPC + k];
        const int w[3] = {kk, client, cseq};
        emit(hob, slot_i, do_mark && kk >= 0 && kk != key, dst, STABLEAT, w,
             3);
        ++slot_i;
      }
    }
    const bool exec = proceed && (single || missing <= 0);
    if (proceed && !exec) {
      pend_set(pend_phase, key, idx, 2);
      pend_set(pend_missing, key, idx, missing);
    }
    execute(key, idx, client, exec);
    emit1(hob, 1, exec && n_el > 1, me, MDRAIN, key);
  }

  __device__ void stableat(const int* pay) {
    const int key = pay[0], client = pay[1], cseq = pay[2];
    auto parked = [&](int j) {
      return pend(pend_phase, key, j) == 2 && pend(pend_clock, key, j) > 0;
    };
    bool any_parked = false;
    for (int j = 0; j < d.PK; ++j) any_parked = any_parked || parked(j);
    const int idx = queue_head(key, parked);
    const bool match = any_parked && pend(pend_client, key, idx) == client &&
                       pend(pend_cseq, key, idx) == cseq;
    const int missing = pend(pend_missing, key, idx) - 1;
    if (match) pend_set(pend_missing, key, idx, missing);
    const bool exec = match && missing <= 0;
    execute(key, idx, client, exec);
    emit1(hob, 1, exec, me, MDRAIN, key);
    // no parked head for this rifl yet: buffer
    const int old = kc(buf_seq, key, client) == cseq
        ? kc(buf_cnt, key, client) : 0;
    if (!match && key >= 0) {
      kc_set(buf_cnt, key, client, old + 1);
      kc_set(buf_seq, key, client, cseq);
    }
  }
};

}  // namespace

__global__ void __launch_bounds__(THREADS) tempo_partial_handle_kernel(
    const Planes st, const RunCap cap, const bool* __restrict__ has,
    const int* __restrict__ rows, const bool* __restrict__ fire,
    const int* __restrict__ now_in, const int* __restrict__ n_ctx,
    const int* __restrict__ f_ctx, const bool* __restrict__ fq,
    const bool* __restrict__ wq, const int* __restrict__ fq_size,
    const int* __restrict__ wq_size, const int* __restrict__ threshold,
    const bool* __restrict__ bump_mode, const int* __restrict__ shard_of,
    const int* __restrict__ closest, const int* __restrict__ attach_s,
    const int* __restrict__ cmd_kmask, const int* __restrict__ cmd_skey,
    bool* __restrict__ rdy_out, bool* __restrict__ pv, int* __restrict__ pd,
    int* __restrict__ pm, int* __restrict__ pp, bool* __restrict__ hv,
    int* __restrict__ hd, int* __restrict__ hm, int* __restrict__ hp,
    const Dims d) {
  extern __shared__ int smem[];
  const int g = blockIdx.x;  // (lane, process)
  const int t = threadIdx.x;
  const int l = g / d.N, me = g % d.N;
  const int N = d.N, D = d.D, F = d.F, P = d.P;
  const long long base = (long long)g * F;

  if (!cap.runs(l)) {  // frozen: the state stays, the outboxes are empty
    if (t == 0) rdy_out[g] = false;
    for (int i = t; i < F * P; i += THREADS)
      pp[base * P + i] = hp[base * P + i] = 0;
    for (int i = t; i < F; i += THREADS) {
      pv[base + i] = hv[base + i] = false;
      pd[base + i] = pm[base + i] = hd[base + i] = hm[base + i] = 0;
    }
    return;
  }

  // shared memory: both staged outboxes, a payload, a flag word
  int* sp = smem;
  const Outbox pob{sp, sp + F, sp + 2 * F, sp + 3 * F};
  sp += 3 * F + F * P;
  const Outbox hob{sp, sp + F, sp + 2 * F, sp + 3 * F};
  sp += 3 * F + F * P;
  int* words = sp;
  sp += P;
  int* misc = sp;  // [0] MGC's free scan on

  auto plane = [&](int i) {
    return (int*)st.p[i] + (long long)g * plane_words(i, d);
  };
  auto scalar = [&](int i) { return ((const int*)st.p[i])[g]; };
  const long long lN = (long long)l * N;

  // 2. gate, timers and the branch (thread 0)
  if (t == 0) {
    const int s_me = shard_of[lN + me];
    Proc p{d, me,
           plane(CLOCKS), plane(DET), plane(SIS), plane(CLIENT_OF),
           plane(CSEQ_OF), plane(ACK_CNT), plane(MAX_CLOCK), plane(MAX_CNT),
           plane(SLOW_ACKS), plane(VOTES_N), plane(VOTES_BY), plane(VOTES_S),
           plane(VOTES_E), plane(SHAG_CNT), plane(SHAG_MAX),
           plane(MBUMP_BUF), plane(VOTE_FRONT), plane(VOTE_GAPS),
           plane(PEND_CLOCK), plane(PEND_SRC), plane(PEND_SEQ),
           plane(PEND_CLIENT), plane(PEND_CSEQ), plane(PEND_KMASK),
           plane(PEND_MISSING), plane(PEND_PHASE), plane(STABLE_CNT),
           plane(STABLE_CNT_SEQ), plane(BUF_CNT), plane(BUF_SEQ),
           plane(COMM_FRONT), plane(COMM_GAPS), plane(OTHERS),
           plane(PREV_STABLE), (bool*)st.p[SEEN] + (long long)g * N,
           scalar(MCC), scalar(OWN_SEQ), scalar(M_FAST), scalar(M_SLOW),
           scalar(M_STABLE), scalar(ERR),
           n_ctx[l], f_ctx[l], fq_size[l], wq_size[l], threshold[l],
           bump_mode[l],
           fq + lN * N, wq + lN * N, shard_of + lN,
           closest + lN * d.S, attach_s + (long long)l * d.C * d.S,
           cmd_kmask + (long long)l * d.C * d.T1,
           cmd_skey + (long long)l * d.C * d.T1 * d.S * d.KPC,
           s_me, s_me * n_ctx[l], pob, hob, words};

    const int* row = rows + (long long)g * d.W;
    const int src = row[PSRC];
    const int* pay = row + PPAY;

    // readiness gate: MCollect needs a free dot slot; MCommit,
    // MConsensus, MShardAgg and MShardCommit the MCollect payload (the
    // source is not clamped here)
    int mtype = has[g] ? row[PMT] : NUM_TYPES;
    const int cell = p.get2(p.sis, pay[0], p.slot(pay[1]));
    bool rdy = true;
    if (mtype == MCOLLECT)
      rdy = cell == 0;
    else if (mtype == MCOMMIT || mtype == MCONSENSUS || mtype == MSHARDAGG ||
             mtype == MSHARDCOMMIT)
      rdy = cell == pay[1];
    rdy_out[g] = rdy;
    if (!(has[g] && rdy)) mtype = NUM_TYPES;
    const int branch = min(max(mtype, 0), NUM_TYPES);  // the switch's clip

    // periodic: the GC frontier to the rest of my shard, the real-time
    // clock bump (micros saturate at INF), the detached-send kick-off
    const bool* fr = fire + (long long)g * 3;
    p.clear_words();
    for (int j = 0; j < N && j < P; ++j) words[j] = p.comm_front[j];
    p.broadcast(pob, MGC, [&](int f_) {
      return fr[0] && p.base + f_ != me;
    });
    if (fr[1]) {
      const int now = now_in[g];
      const int micros = now >= INF / 1000 ? INF : now * 1000;
      p.detached_all(max(p.mcc, micros));
    }
    bool has_det = false;
    for (long long i = 0; i < (long long)d.K * d.DS && !has_det; ++i)
      has_det = p.det[2 * i] > 0;
    p.emit1(pob, N, fr[2] && has_det, me, DETACH_DRAIN, 0);

    // the handler of this process's message only
    p.clear(hob);
    switch (branch) {
      case SUBMIT: {
        const int dseq = p.own_seq + 1;
        p.own_seq = dseq;
        if (dseq >= SEQ_BOUND) p.err |= ERR_SEQ;
        p.start(me, dseq, pay[0], pay[1], true);
        break;
      }
      case MCOLLECT: p.mcollect(src, pay); break;
      case MCOLLECTACK: p.mcollectack(src, pay); break;
      case MCOMMIT: p.mcommit(pay); break;
      case MDETACHED: {
        const int per_msg = (P - 2) / 2;
        for (int i = 0; i < per_msg; ++i)
          p.vote_add(pay[0], src, pay[2 + 2 * i], pay[3 + 2 * i],
                     i < pay[1]);
        p.drain(pay[0]);
        break;
      }
      case MCONSENSUS: p.mconsensus(src, pay); break;
      case MCONSENSUSACK: p.mconsensusack(pay); break;
      case MGC: p.mgc(src, pay); break;
      case MDRAIN: p.drain(pay[0]); break;
      case DETACH_DRAIN: p.detach_drain(); break;
      case MFWDSUBMIT: p.start(pay[0], pay[1], pay[2], pay[3], false); break;
      case MBUMP: p.mbump(pay); break;
      case MSHARDCOMMIT: p.mshardcommit(pay); break;
      case MSHARDAGG: {
        const int s = p.slot(pay[1]);
        p.commit_broadcast(pay[0], pay[1], pay[2],
                           p.get2(p.client_of, pay[0], s),
                           p.get2(p.cseq_of, pay[0], s), true);
        break;
      }
      case STABLEAT: p.stableat(pay); break;
      default: break;  // the noop
    }
    misc[0] = branch == MGC;
    ((int*)st.p[MCC])[g] = p.mcc;
    ((int*)st.p[OWN_SEQ])[g] = p.own_seq;
    ((int*)st.p[M_FAST])[g] = p.m_fast;
    ((int*)st.p[M_SLOW])[g] = p.m_slow;
    ((int*)st.p[M_STABLE])[g] = p.m_stable;
    ((int*)st.p[ERR])[g] = p.err;
  }
  __syncthreads();

  // 3. MGC: free the dot slots up to the raised stable clocks
  if (misc[0]) {
    int* sis = plane(SIS);
    const int* prev = plane(PREV_STABLE);
    for (long long i = t; i < (long long)N * D; i += THREADS) {
      const int v = sis[i];
      if (v > 0 && v <= prev[i / D]) sis[i] = 0;
    }
  }

  // 4. store both outboxes
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

extern "C" int fantoch_tempo_partial_handle(
    const void* state_table, const void* cap_tab, const void* has,
    const void* rows, const void* fire, const void* now, const void* n_ctx,
    const void* f_ctx, const void* fq, const void* wq, const void* fq_size,
    const void* wq_size, const void* threshold, const void* bump_mode,
    const void* shard_of, const void* closest, const void* attach_s,
    const void* cmd_kmask, const void* cmd_skey, void* rdy_out, void* pv,
    void* pd, void* pm, void* pp, void* hv, void* hd, void* hm, void* hp,
    int L, int N, int D, int F, int P, int W, int C, int K, int PK, int DS,
    int G, int KPC, int S, int T1, int flags, void* stream) {
  const long long blocks = (long long)L * N;
  if (blocks == 0) return 0;
  if (S > MAXS || KPC > MAXKPC || 3 + 2 * KPC > P)
    return (int)cudaErrorInvalidValue;
  Planes st;
  for (int i = 0; i < NPLANES; ++i)
    st.p[i] = ((void* const*)state_table)[i];
  const Dims d{L, N, D, F, P, W, C, K, PK, DS, G, KPC, S, T1};
  const size_t smem = (size_t)(2 * (3 * F + F * P) + P + 4) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        tempo_partial_handle_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  tempo_partial_handle_kernel<<<(unsigned)blocks, THREADS, smem,
                                (cudaStream_t)stream>>>(
      st, run_cap((const void* const*)cap_tab, flags), (const bool*)has,
      (const int*)rows, (const bool*)fire,
      (const int*)now, (const int*)n_ctx, (const int*)f_ctx, (const bool*)fq,
      (const bool*)wq, (const int*)fq_size, (const int*)wq_size,
      (const int*)threshold, (const bool*)bump_mode, (const int*)shard_of,
      (const int*)closest, (const int*)attach_s, (const int*)cmd_kmask,
      (const int*)cmd_skey, (bool*)rdy_out, (bool*)pv, (int*)pd, (int*)pm,
      (int*)pp, (bool*)hv, (int*)hd, (int*)hm, (int*)hp, d);
  return (int)cudaGetLastError();
}
