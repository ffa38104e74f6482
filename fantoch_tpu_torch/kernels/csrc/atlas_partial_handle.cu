// K12 atlas_partial_handle: Atlas's partial-replication readiness gate,
// periodic timers and message handlers for every (lane, process)
// (replaces fantoch_tpu/engine/core.py run_handlers :422 and the
// ready/periodic calls :890-918 with AtlasPartialDev.ready :219, .periodic
// :260 and .handle :236 of fantoch_tpu/engine/protocols/graphdep_partial.py:
// the fourteen handlers :447-1129, the dep-table helpers _dep_row_add :284,
// _pack_deps :306, _take_deps :329, _g_own_deps :345, _g_bump_latest :366
// and _g_start :386, the commit paths _g_commit_actions :627 and
// _g_commit_broadcast :671, the graph drain _g_drain :858 with its
// missing-dep request, the answers _g_answer :1012, the cleanup tick
// _g_cleanup :1107, and both sides of fantoch_tpu/engine/iset.py, in
// iset.cuh).
//
// One block of 256 threads per (lane, process). The reference runs the
// handler as a lax.switch under vmap, which evaluates all fifteen branches
// and selects one; here the block runs only its own branch, in the
// reference's order: `ready` on the incoming state, `periodic`, then
// `handle` on the state `periodic` returned. The graph drain is not
// hoisted: it runs only for a process whose branch calls it (MCommit,
// MDrain, GReply, GReplyExec), as only the chosen branch's outputs count.
//
// 1. The block works on its process's rows of the state planes in place,
//    on the lanes whose run predicate holds at the step's start
//    (common.cuh RunCap; every lane without a cap). A frozen lane's blocks
//    write rdy false and empty outboxes and return before the gate and any
//    shared-memory staging, touching none of its state. Each block reads
//    and writes only its own (lane, process) rows, and every step below
//    reads what it needs before anything of the block writes it (the
//    answers of 2b each free only their own entry; the branch runs after
//    the barrier that ends 2b; 4d scans before 4e executes the pick), so
//    no copy is needed. The five scalar planes (sequence, metrics, error
//    word) live in thread 0's registers and are stored once at the end.
// 2. Thread 0 runs the gate and stages the GC broadcast; then thread b of
//    the first B answers buffered request b for the cleanup tick (each
//    answer writes its own periodic slot N + 1 + b and frees its own
//    entry, and reads nothing another one writes), while the block clears
//    the handler outbox; then thread 0 runs the branch, staging the
//    handler outbox exactly as the twin's emits leave it (a shard
//    broadcast fills all F slots, addressed to base + slot, and later
//    emits overwrite single slots). A disabled path still computes what
//    its invalid slots carry.
// 3. MGC's free scan over the [N, D] dot words runs on the whole block.
// 4. The drain runs on the whole block:
//    a. each committed vertex's flags: ok (starts as committed) and
//       "every dep is absent or executed" (iset_contains_gathered on the
//       dep's source's executed set, cached in shared memory);
//    b. the greatest fixed point, relaxed in place until a pass in which
//       no thread changed anything (__syncthreads_or), as K9's: the
//       operator is monotone and starts from the top, so in-place updates
//       reach the reference's Jacobi fixed point;
//    c. a block argmin of src * 2^20 + seq (int32, wrapping) over the
//       ready vertices, or the ok ones when none is ready, ties to the
//       lowest index as jnp.argmin;
//    d. the missing-dep scan over every (vertex, dep) entry, on the state
//       before the pick executes (its vertex no longer counts as
//       committed): a block count and a block argmin of the clipped
//       src * 2^20 + seq over the missing entries, INF elsewhere;
//    e. thread 0 executes the pick, stages the client parts in slots
//       0..KPC-1, the request in slot KPC and MDRAIN in slot KPC + 1.
// 5. The block stores both outboxes.
//
// One-hot semantics of the reference: a read at an out-of-range index
// yields 0, a write there drops; dot slots use floor modulo (seq 0 maps to
// slot D - 1); the drain's gathers by dep source (executed set, vertex
// cell, request marker) index as jnp's plain gathers: negative from the
// end, clamped; a command's table column is clamped to the last. Integer
// sums and the (src, seq) packings wrap as int32 does in the reference.
//
// Bound on this card: bytes. The region reads a few state words per (lane,
// process), the rows its branch touches and, for a draining process, its
// committed vertices' dep rows, and writes the words that change and two
// [F, P] outboxes (atlas_partial_handle.py work). The drain's flag pass
// and its relaxation read every committed vertex's dep rows, which is most
// of what this kernel moves.
#include <climits>

#include "common.cuh"
#include "iset.cuh"

using namespace fantoch;

namespace {

constexpr int THREADS = 256;  // atlas_partial_handle.py THREADS
// atlas_partial_handle.py MAX_SHARDS, MAX_KEYS_PER_CMD
constexpr int MAXS = 8, MAXKPC = 8;
constexpr int SUBMIT = 0, MCOLLECT = 1, MCOLLECTACK = 2, MCOMMIT = 3,
              MCONSENSUS = 4, MCONSENSUSACK = 5, MGC = 6, MDRAIN = 7,
              MFWDSUBMIT = 8, MSHARDCOMMIT = 9, MSHARDAGG = 10, GREQ = 11,
              GREPLY = 12, GREPLYEXEC = 13, NUM_TYPES = 14, TO_CLIENT = 15;
constexpr int ERR_SEQ = 4, ERR_DOT = 8, ERR_CAPACITY = 16, ERR_PROTO = 32;
constexpr int SEQ_BOUND = 1 << 20;

// state planes, in atlas_partial_handle.py STATE_KEYS order
enum Plane {
  LATEST_SRC, LATEST_SEQ, LATEST_KM, SIS, CLIENT_OF, CSEQ_OF, OWN_SEQ,
  ACK_CNT, SLOW_ACKS, QD_SRC, QD_SEQ, QD_KM, QD_CNT, SH_CNT, SH_SRC, SH_SEQ,
  SH_KM, VX_COMMITTED, VX_SEQ, VX_CLIENT, VX_CSEQ, VX_ND, VX_DEP_SRC,
  VX_DEP_SEQ, VX_DEP_KM, REQ_SEQ, BREQ_FROM, BREQ_SRC, BREQ_SEQ, EXEC_FRONT,
  EXEC_GAPS, COMM_FRONT, COMM_GAPS, OTHERS, SEEN, PREV_STABLE, M_FAST,
  M_SLOW, M_STABLE, ERR, NPLANES
};

struct Planes {
  void* p[NPLANES];
};

struct Dims {
  int L, N, D, F, P, W, C;             // engine dims
  int K, G, KPC, S, T1, Q, QS, B;      // keys, gaps, tables, dep slots
};

// words (bytes for the bool planes) of one process in each plane
__device__ long long plane_words(int i, const Dims& d) {
  const long long N = d.N, D = d.D;
  switch (i) {
    case LATEST_SRC: case LATEST_SEQ: case LATEST_KM: return d.K;
    case SIS: case CLIENT_OF: case CSEQ_OF: case ACK_CNT: case SLOW_ACKS:
    case VX_COMMITTED: case VX_SEQ: case VX_CLIENT: case VX_CSEQ: case VX_ND:
    case REQ_SEQ: return N * D;
    case QD_SRC: case QD_SEQ: case QD_KM: case QD_CNT: return N * D * d.Q;
    case SH_CNT: return D;
    case SH_SRC: case SH_SEQ: case SH_KM: return D * d.QS;
    case VX_DEP_SRC: case VX_DEP_SEQ: case VX_DEP_KM: return N * D * d.QS;
    case BREQ_FROM: case BREQ_SRC: case BREQ_SEQ: return d.B;
    case EXEC_FRONT: case COMM_FRONT: case SEEN: case PREV_STABLE: return N;
    case EXEC_GAPS: case COMM_GAPS: return N * d.G * 2;
    case OTHERS: return N * N;
    default: return 1;  // the scalar planes
  }
}

// A staged outbox in shared memory: valid, dst, mtype [F], payload [F, P].
struct Outbox {
  int *v, *dst, *mt, *pay;
};

// One (lane, process): its rows of the state planes (updated in place),
// its scalar planes, the lane ctx and the staged outboxes. The handlers run
// on thread 0, an answer of the cleanup tick on the thread of its entry.
struct Proc {
  Dims d;
  int me;
  int *latest_src, *latest_seq, *latest_km, *sis, *client_of, *cseq_of,
      *ack_cnt, *slow_acks, *qd_src, *qd_seq, *qd_km, *qd_cnt, *sh_cnt,
      *sh_src, *sh_seq, *sh_km, *vx_seq, *vx_client, *vx_cseq, *vx_nd,
      *vx_dep_src, *vx_dep_seq, *vx_dep_km, *req_seq, *breq_from, *breq_src,
      *breq_seq, *exec_front, *exec_gaps, *comm_front, *comm_gaps, *others,
      *prev_stable;
  bool *vx_committed, *seen;
  // scalar planes, in thread 0's registers
  int own_seq, m_fast, m_slow, m_stable, err;
  // lane ctx
  int n, f, expected_acks, fp_mode;
  bool ack_self;
  const bool *fast_quorum, *write_quorum;      // [N, N] of this lane
  const int *shard_of, *closest;               // [N], [N, S]
  const int *attach_s, *cmd_kmask, *cmd_skey;  // [C, S], [C, T1], [C, T1, S, KPC]
  int s_me, base;
  Outbox pob, hob;
  int* words;  // [P] scratch for a payload
  int* zero_q;  // [4 * Q] zeros: the report row of a dot out of range

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
    return in(s, d.S) ? closest[(long long)me * d.S + s] : 0;
  }
  __device__ int shard(int p) const { return in(p, d.N) ? shard_of[p] : 0; }
  // a payload word: 0 out of range (oh_take)
  __device__ int word(const int* pay, int i) const {
    return in(i, d.P) ? pay[i] : 0;
  }

  // -- outbox staging -------------------------------------------------
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

  // -- dep-set helpers ------------------------------------------------
  // merge one dep into a table row (cnt may be null): the first match
  // counts one more, else the first free entry takes it; a full row
  // drops it and returns true
  __device__ bool dep_row_add(int* src, int* seq, int* km, int* cnt,
                              int len, int dsrc, int dseq, int dkm) const {
    const bool do_ = dseq > 0;
    int found = -1, free_ = -1;
    for (int q = 0; q < len; ++q) {
      if (found < 0 && seq[q] == dseq && src[q] == dsrc) found = q;
      if (free_ < 0 && seq[q] == 0) free_ = q;
    }
    const bool overflow = do_ && found < 0 && free_ < 0;
    if (do_ && !overflow) {
      const int w = found >= 0 ? found : free_;
      src[w] = dsrc;
      seq[w] = dseq;
      km[w] = dkm;
      if (cnt) cnt[w] = found >= 0 ? cnt[w] + 1 : 1;
    }
    return overflow;
  }
  // pack the present (seq > 0) triples of a row into `out` from word lo
  // (the payload's tail stays as it is); returns their count
  __device__ int pack(int* out, int lo, const int* src, const int* seq,
                      const int* km, int len) const {
    int nd = 0;
    for (int q = 0; q < len; ++q) {
      if (seq[q] <= 0) continue;
      const int w = lo + 3 * nd;
      if (w < d.P) out[w] = src[q];
      if (w + 1 < d.P) out[w + 1] = seq[q];
      if (w + 2 < d.P) out[w + 2] = km[q];
      ++nd;
    }
    return nd;
  }
  // the i-th dep triple a payload carries from word lo (0 at or past nd)
  __device__ void take(const int* pay, int lo, int nd, int i, int& src,
                       int& seq, int& km) const {
    const bool en = i < nd;
    src = en ? word(pay, lo + 3 * i) : 0;
    seq = en ? word(pay, lo + 3 * i + 1) : 0;
    km = en ? word(pay, lo + 3 * i + 2) : 0;
  }
  // this shard's latest dep per command key, duplicates and empties
  // dropped
  __device__ void own_deps(const int* keys, int* src, int* seq,
                           int* km) const {
    for (int k = 0; k < d.KPC; ++k) {
      const bool valid = keys[k] >= 0;
      src[k] = valid ? get(latest_src, d.K, keys[k]) : 0;
      seq[k] = valid ? get(latest_seq, d.K, keys[k]) : 0;
      km[k] = valid ? get(latest_km, d.K, keys[k]) : 0;
    }
    bool keep[MAXKPC];
    for (int i = 0; i < d.KPC; ++i) {
      keep[i] = seq[i] > 0;
      for (int j = 0; j < i; ++j)
        if (src[i] == src[j] && seq[i] == seq[j]) keep[i] = false;
    }
    for (int i = 0; i < d.KPC; ++i) {
      src[i] = keep[i] ? src[i] : 0;
      seq[i] = keep[i] ? seq[i] : 0;
      km[i] = keep[i] ? km[i] : 0;
    }
  }
  __device__ void bump_latest(const int* keys, int dsrc, int dseq,
                              int kmask) const {
    for (int k = 0; k < d.KPC; ++k) {
      if (keys[k] < 0 || keys[k] >= d.K) continue;
      latest_src[keys[k]] = dsrc;
      latest_seq[keys[k]] = dseq;
      latest_km[keys[k]] = kmask;
    }
  }

  // -- submit / forward / collect -------------------------------------
  __device__ void start(int dsrc, int dseq, int client, int cseq,
                        bool forward) {
    int kmask, skey[MAXS * MAXKPC], keys[MAXKPC];
    int osrc[MAXKPC], oseq[MAXKPC], okm[MAXKPC];
    command(client, cseq, kmask, skey);
    my_keys(skey, keys);
    const int s = slot(dseq);
    own_deps(keys, osrc, oseq, okm);
    bump_latest(keys, dsrc, dseq, kmask);
    set2(ack_cnt, dsrc, s, 0);
    set2(slow_acks, dsrc, s, 0);
    if (cell(dsrc, s)) {
      const long long r = at(dsrc, s) * d.Q;
      for (int q = 0; q < d.Q; ++q)
        qd_src[r + q] = qd_seq[r + q] = qd_km[r + q] = qd_cnt[r + q] = 0;
    }
    clear_words();
    words[0] = dsrc;
    words[1] = dseq;
    words[2] = client;
    words[3] = cseq;
    words[4] = pack(words, 5, osrc, oseq, okm, d.KPC);
    broadcast(hob, MCOLLECT, [](int) { return true; });
    if (forward) {
      sh_cnt[s] = 0;
      for (int q = 0; q < d.QS; ++q)
        sh_src[s * d.QS + q] = sh_seq[s * d.QS + q] = sh_km[s * d.QS + q] = 0;
      const int w[4] = {dsrc, dseq, client, cseq};
      for (int sh = 0; sh < d.S; ++sh)
        emit(hob, d.N + sh, ((kmask >> sh) & 1) && sh != s_me,
             closest_to(sh), MFWDSUBMIT, w, 4);
    }
  }

  __device__ void mcollect(int coord, const int* pay) {
    const int dsrc = pay[0], dseq = pay[1], client = pay[2], cseq = pay[3],
              cnd = pay[4];
    const int s = slot(dseq);
    if (get2(sis, dsrc, s) != 0 || get2(vx_seq, dsrc, s) != 0)
      err |= ERR_DOT;
    set2(sis, dsrc, s, dseq);
    set2(client_of, dsrc, s, client);
    set2(cseq_of, dsrc, s, cseq);
    const bool in_q =
        in(coord, d.N) && fast_quorum[(long long)coord * d.N + me];
    const bool from_self = coord == me;
    const bool member = in_q && !from_self;
    int kmask, skey[MAXS * MAXKPC], keys[MAXKPC];
    command(client, cseq, kmask, skey);
    my_keys(skey, keys);
    int csrc[MAXKPC], cseq_[MAXKPC], ckm[MAXKPC];
    for (int i = 0; i < d.KPC; ++i) take(pay, 5, cnd, i, csrc[i], cseq_[i],
                                         ckm[i]);
    int osrc[MAXKPC], oseq[MAXKPC], okm[MAXKPC];
    own_deps(keys, osrc, oseq, okm);
    if (member) bump_latest(keys, dsrc, dseq, kmask);
    // the report: a member's own deps, then the coordinator's not among
    // them; the self-collect the coordinator's deps
    int asrc[2 * MAXKPC], aseq[2 * MAXKPC], akm[2 * MAXKPC];
    for (int i = 0; i < d.KPC; ++i) {
      bool keep = cseq_[i] > 0;
      for (int j = 0; j < d.KPC; ++j)
        if (csrc[i] == osrc[j] && cseq_[i] == oseq[j] && oseq[j] > 0)
          keep = false;
      asrc[i] = member ? osrc[i] : csrc[i];
      aseq[i] = member ? oseq[i] : cseq_[i];
      akm[i] = member ? okm[i] : ckm[i];
      asrc[d.KPC + i] = member && keep ? csrc[i] : 0;
      aseq[d.KPC + i] = member && keep ? cseq_[i] : 0;
      akm[d.KPC + i] = member && keep ? ckm[i] : 0;
    }
    clear_words();
    words[0] = dsrc;
    words[1] = dseq;
    words[2] = pack(words, 3, asrc, aseq, akm, 2 * d.KPC);
    emit(hob, 0, in_q && (ack_self || !from_self), coord, MCOLLECTACK, words,
         d.P);
  }

  // -- collect-ack / commit paths -------------------------------------
  // MCommit inside my shard with the dep rows (src, seq, km) of length len
  __device__ void commit_broadcast(int dsrc, int dseq, int client, int cseq,
                                   const int* src, const int* seq,
                                   const int* km, int len, bool valid) {
    clear_words();
    words[0] = dsrc;
    words[1] = dseq;
    words[2] = client;
    words[3] = cseq;
    words[4] = pack(words, 5, src, seq, km, len);
    broadcast(hob, MCOMMIT, [&](int) { return valid; });
  }

  // the dot's report rows (the zero row out of range)
  __device__ void qd_rows(int dsrc, int s, int*& src, int*& seq, int*& km,
                          int*& cnt) const {
    if (cell(dsrc, s)) {
      const long long r = at(dsrc, s) * d.Q;
      src = qd_src + r;
      seq = qd_seq + r;
      km = qd_km + r;
      cnt = qd_cnt + r;
    } else {
      src = zero_q;
      seq = zero_q + d.Q;
      km = zero_q + 2 * d.Q;
      cnt = zero_q + 3 * d.Q;
    }
  }

  // partial.rs:37-101: commit in this shard, or MShardCommit to the owner
  __device__ void commit_actions(int dsrc, int dseq, int client, int cseq,
                                 int kmask, bool valid) {
    int *src, *seq, *km, *cnt;
    qd_rows(dsrc, slot(dseq), src, seq, km, cnt);
    if (popcount(kmask) == 1) {
      commit_broadcast(dsrc, dseq, client, cseq, src, seq, km, d.Q, valid);
    } else {
      clear_words();
      words[0] = dsrc;
      words[1] = dseq;
      words[2] = pack(words, 3, src, seq, km, d.Q);
      emit(hob, 0, valid, dsrc, MSHARDCOMMIT, words, d.P);
    }
  }

  __device__ void mcollectack(const int* pay) {
    const int dsrc = pay[0], dseq = pay[1], nd = pay[2];
    const int s = slot(dseq);
    int *src, *seq, *km, *cnt;
    qd_rows(dsrc, s, src, seq, km, cnt);
    bool overflow = false;
    for (int i = 0; i < 2 * d.KPC; ++i) {
      int rs, rq, rk;
      take(pay, 3, nd, i, rs, rq, rk);
      overflow |= dep_row_add(src, seq, km, cnt, d.Q, rs, rq, rk);
    }
    if (overflow) err |= ERR_CAPACITY;
    const int acks = get2(ack_cnt, dsrc, s) + 1;
    set2(ack_cnt, dsrc, s, acks);
    const bool all_acks = acks == expected_acks;
    const int threshold = fp_mode == 0 ? f : expected_acks;
    bool fp_ok = true;
    for (int q = 0; q < d.Q; ++q)
      if (seq[q] > 0 && cnt[q] < threshold) fp_ok = false;
    // the rows of a dot out of range read back as zeros
    if (!cell(dsrc, s))
      for (int q = 0; q < 4 * d.Q; ++q) zero_q[q] = 0;
    const bool fast = all_acks && fp_ok;
    const bool slow = all_acks && !fast;
    m_fast += fast ? 1 : 0;
    m_slow += slow ? 1 : 0;
    const int client = get2(client_of, dsrc, s);
    const int cseq = get2(cseq_of, dsrc, s);
    int kmask, skey[MAXS * MAXKPC];
    command(client, cseq, kmask, skey);
    if (fast) {
      commit_actions(dsrc, dseq, client, cseq, kmask, true);
    } else {
      clear_words();
      words[0] = dsrc;
      words[1] = dseq;
      const bool* wq = write_quorum + (long long)me * d.N;
      broadcast(hob, MCONSENSUS, [&](int f_) {
        return slow && wq[min(max(base + f_, 0), d.N - 1)];
      });
    }
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
    commit_actions(dsrc, dseq, client, cseq, kmask, cnt == f + 1);
  }

  // partial.rs:103-142 at the dot owner: union the shard's deps into the
  // slot's row; once every touched shard reported, the union to me and
  // the closest process of every other touched shard
  __device__ void mshardcommit(const int* pay) {
    const int dsrc = pay[0], dseq = pay[1], nd = pay[2];
    const int s = slot(dseq);
    if (dsrc != me) err |= ERR_PROTO;
    int* src = sh_src + (long long)s * d.QS;
    int* seq = sh_seq + (long long)s * d.QS;
    int* km = sh_km + (long long)s * d.QS;
    bool overflow = false;
    for (int i = 0; i < d.Q; ++i) {
      int rs, rq, rk;
      take(pay, 3, nd, i, rs, rq, rk);
      overflow |= dep_row_add(src, seq, km, nullptr, d.QS, rs, rq, rk);
    }
    if (overflow) err |= ERR_CAPACITY;
    const int scnt = sh_cnt[s] + 1;
    sh_cnt[s] = scnt;
    int kmask, skey[MAXS * MAXKPC];
    command(get2(client_of, me, s), get2(cseq_of, me, s), kmask, skey);
    const bool done = scnt == popcount(kmask);
    clear_words();
    words[0] = dsrc;
    words[1] = dseq;
    words[2] = pack(words, 3, src, seq, km, d.QS);
    emit(hob, 0, done, me, MSHARDAGG, words, d.P);
    for (int sh = 0; sh < d.S; ++sh)
      emit(hob, 1 + sh, done && ((kmask >> sh) & 1) && sh != s_me,
           closest_to(sh), MSHARDAGG, words, d.P);
  }

  // partial.rs:144-167: the final MCommit inside my shard with the union
  // the payload carries from word 3
  __device__ void mshardagg(const int* pay) {
    const int dsrc = pay[0], dseq = pay[1], nd = pay[2];
    const int s = slot(dseq);
    clear_words();
    words[0] = dsrc;
    words[1] = dseq;
    words[2] = get2(client_of, dsrc, s);
    words[3] = get2(cseq_of, dsrc, s);
    int cnt = 0;
    for (int i = 0; i < d.QS; ++i) {
      int rs, rq, rk;
      take(pay, 3, nd, i, rs, rq, rk);
      if (rq <= 0) continue;
      const int w = 5 + 3 * cnt;
      if (w < d.P) words[w] = rs;
      if (w + 1 < d.P) words[w + 1] = rq;
      if (w + 2 < d.P) words[w + 2] = rk;
      ++cnt;
    }
    words[4] = cnt;
    broadcast(hob, MCOMMIT, [](int) { return true; });
  }

  // install a vertex (committed, seq, client, cseq, nd and the dep triples
  // from word 5 of `pay`) at (dsrc, s) where `do_` holds
  __device__ void install(const int* pay, int dsrc, int s, bool do_) {
    if (!do_ || !cell(dsrc, s)) return;
    const long long v = at(dsrc, s);
    const int nd = pay[4];
    vx_committed[v] = true;
    vx_seq[v] = pay[1];
    vx_client[v] = pay[2];
    vx_cseq[v] = pay[3];
    vx_nd[v] = nd;
    for (int q = 0; q < d.QS; ++q) {
      int rs, rq, rk;
      take(pay, 5, nd, q, rs, rq, rk);
      vx_dep_src[v * d.QS + q] = rs;
      vx_dep_seq[v * d.QS + q] = rq;
      vx_dep_km[v * d.QS + q] = rk;
    }
  }

  // atlas.rs:393-464 up to the drain: the vertex, the GC committed clock
  // (my shard's dots), the payload slot of a foreign dot freed
  __device__ void mcommit(const int* pay) {
    const int dsrc = pay[0], dseq = pay[1];
    const int s = slot(dseq);
    const bool have = get2(sis, dsrc, s) == dseq;
    const bool already = get2(vx_seq, dsrc, s) == dseq;
    const bool do_ = have && !already;
    if (!have) err |= ERR_PROTO;
    install(pay, dsrc, s, do_);
    const bool my_dot = shard(dsrc) == s_me;
    if (in(dsrc, d.N) &&
        iset_add(comm_front[dsrc], comm_gaps + (long long)dsrc * d.G * 2,
                 d.G, dseq, do_ && my_dot))
      err |= ERR_CAPACITY;
    set2(sis, dsrc, s, my_dot ? dseq : 0);
  }

  // mod.rs:395-398 up to the drain: install the remote vertex unless a
  // live vertex of another sequence holds its slot (ERR_DOT)
  __device__ void greply(const int* pay) {
    const int dsrc = pay[0], dseq = pay[1];
    const int s = slot(dseq);
    const int c = get2(vx_seq, dsrc, s);
    const bool already = c == dseq;
    const bool dirty = c != 0 && !already;
    if (dirty) err |= ERR_DOT;
    install(pay, dsrc, s, !already && !dirty);
  }

  // mod.rs:399-407 up to the drain: mark the remote dot executed
  __device__ void greplyexec(const int* pay) {
    const int dsrc = pay[0], dseq = pay[1];
    if (in(dsrc, d.N) &&
        iset_add(exec_front[dsrc], exec_gaps + (long long)dsrc * d.G * 2,
                 d.G, dseq, true))
      err |= ERR_CAPACITY;
  }

  // GREPLY (the committed vertex, not yet executed) or GREPLYEXEC (an
  // executed marker) for one requested dot, written into slot i of ob
  // either way; returns whether it was answered
  __device__ bool answer(const Outbox& ob, int i, int from_shard, int dsrc,
                         int dseq, bool enable) const {
    const int s = slot(dseq);
    const bool c = cell(dsrc, s);
    const bool pending =
        get2(vx_seq, dsrc, s) == dseq && c && vx_committed[at(dsrc, s)];
    const bool executed =
        in(dsrc, d.N) &&
        iset_contains(exec_front[dsrc], exec_gaps + (long long)dsrc * d.G * 2,
                      d.G, dseq);
    const bool answered = enable && dseq > 0 && (pending || executed);
    int* w = ob.pay + i * d.P;
    for (int j = 0; j < d.P; ++j) w[j] = 0;
    w[0] = dsrc;
    w[1] = dseq;
    if (pending) {
      const long long v = at(dsrc, s);
      w[2] = vx_client[v];
      w[3] = vx_cseq[v];
      w[4] = vx_nd[v];
      pack(w, 5, vx_dep_src + v * d.QS, vx_dep_seq + v * d.QS,
           vx_dep_km + v * d.QS, d.QS);
    }
    ob.v[i] = answered;
    ob.dst[i] = closest_to(from_shard);
    ob.mt[i] = pending ? GREPLY : GREPLYEXEC;
    return answered;
  }

  // mod.rs:372-393 at the responder: answer in slot 0, or buffer the
  // request (once per requesting shard) for the cleanup tick
  __device__ void greq(int src, const int* pay) {
    const int dsrc = pay[0], dseq = pay[1];
    const int from_shard = shard(src);
    const bool answered = answer(hob, 0, from_shard, dsrc, dseq, true);
    bool dup = false;
    int free_ = -1;
    for (int b = 0; b < d.B; ++b) {
      if (breq_from[b] == from_shard && breq_src[b] == dsrc &&
          breq_seq[b] == dseq)
        dup = true;
      if (free_ < 0 && breq_from[b] < 0) free_ = b;
    }
    const bool store = !answered && !dup;
    if (store && free_ < 0) err |= ERR_CAPACITY;
    if (store && free_ >= 0) {
      breq_from[free_] = from_shard;
      breq_src[free_] = dsrc;
      breq_seq[free_] = dseq;
    }
  }

  // committed-clock GC within my shard, up to the free scan (the block
  // runs it)
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
};

// the drain's per-vertex flags
constexpr unsigned char OK = 1, STATIC = 2;

// a block argmin of (value, index) pairs, ties to the lowest index; every
// thread passes its own best pair and gets the block's in rv[0], ri[0]
__device__ void block_argmin(int best, int bidx, int* rv, int* ri) {
  const int t = threadIdx.x;
  rv[t] = best;
  ri[t] = bidx;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (t < s) {
      const int ov = rv[t + s], oi = ri[t + s];
      if (ov < rv[t] || (ov == rv[t] && oi < ri[t])) {
        rv[t] = ov;
        ri[t] = oi;
      }
    }
    __syncthreads();
  }
}

}  // namespace

__global__ void __launch_bounds__(THREADS) atlas_partial_handle_kernel(
    const Planes st, const RunCap cap, const bool* __restrict__ has,
    const int* __restrict__ rows, const bool* __restrict__ fire,
    const int* __restrict__ n_ctx, const int* __restrict__ f_ctx,
    const int* __restrict__ expected, const int* __restrict__ fp_mode,
    const bool* __restrict__ ack_self, const bool* __restrict__ fq,
    const bool* __restrict__ wq, const int* __restrict__ shard_of,
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
  const int N = d.N, D = d.D, F = d.F, P = d.P, G = d.G, QS = d.QS;
  const int ND = N * D;

  if (!cap.runs(l)) {  // frozen: the state stays, the outboxes are empty
    const long long fb = (long long)g * F;
    if (t == 0) rdy_out[g] = false;
    for (long long i = t; i < (long long)F * P; i += THREADS)
      pp[fb * P + i] = hp[fb * P + i] = 0;
    for (int i = t; i < F; i += THREADS) {
      pv[fb + i] = hv[fb + i] = false;
      pd[fb + i] = pm[fb + i] = hd[fb + i] = hm[fb + i] = 0;
    }
    return;
  }

  // shared memory (atlas_partial_handle.py smem_bytes)
  int* sp = smem;
  const Outbox pob{sp, sp + F, sp + 2 * F, sp + 3 * F};
  sp += 3 * F + F * P;
  const Outbox hob{sp, sp + F, sp + 2 * F, sp + 3 * F};
  sp += 3 * F + F * P;
  int* words = sp;
  sp += P;
  int* ef = sp;  // executed sets: fronts [N], gaps [N][G][2]
  int* eg = sp + N;
  sp += N * (1 + 2 * G);
  int* red_v = sp;  // block argmin scratch
  int* red_i = sp + THREADS;
  sp += 2 * THREADS;
  // [0] ok count, [1] branch, [2] drain on, [3] missing count
  int* misc = sp;
  sp += 8;
  int* zero_q = sp;
  sp += 4 * d.Q;
  unsigned char* flags = reinterpret_cast<unsigned char*>(sp);

  // 1. this process's rows of the state planes, updated in place (the
  // scalar ones go through thread 0's registers and are stored at the
  // end, after every thread has read them here)
  for (int i = t; i < 4 * d.Q; i += THREADS) zero_q[i] = 0;
  __syncthreads();

  auto plane = [&](int i) {
    return (int*)st.p[i] + (long long)g * plane_words(i, d);
  };
  auto scalar = [&](int i) { return ((const int*)st.p[i])[g]; };
  const long long lN = (long long)l * N;
  const int s_me = shard_of[lN + me];
  Proc p{d, me,
         plane(LATEST_SRC), plane(LATEST_SEQ), plane(LATEST_KM), plane(SIS),
         plane(CLIENT_OF), plane(CSEQ_OF), plane(ACK_CNT), plane(SLOW_ACKS),
         plane(QD_SRC), plane(QD_SEQ), plane(QD_KM), plane(QD_CNT),
         plane(SH_CNT), plane(SH_SRC), plane(SH_SEQ), plane(SH_KM),
         plane(VX_SEQ), plane(VX_CLIENT), plane(VX_CSEQ), plane(VX_ND),
         plane(VX_DEP_SRC), plane(VX_DEP_SEQ), plane(VX_DEP_KM),
         plane(REQ_SEQ), plane(BREQ_FROM), plane(BREQ_SRC), plane(BREQ_SEQ),
         plane(EXEC_FRONT), plane(EXEC_GAPS), plane(COMM_FRONT),
         plane(COMM_GAPS), plane(OTHERS), plane(PREV_STABLE),
         (bool*)st.p[VX_COMMITTED] + (long long)g * ND,
         (bool*)st.p[SEEN] + (long long)g * N,
         scalar(OWN_SEQ), scalar(M_FAST), scalar(M_SLOW), scalar(M_STABLE),
         scalar(ERR),
         n_ctx[l], f_ctx[l], expected[l], fp_mode[l], ack_self[l],
         fq + lN * N, wq + lN * N, shard_of + lN, closest + lN * d.S,
         attach_s + (long long)l * d.C * d.S,
         cmd_kmask + (long long)l * d.C * d.T1,
         cmd_skey + (long long)l * d.C * d.T1 * d.S * d.KPC,
         s_me, s_me * n_ctx[l], pob, hob, words, zero_q};

  const int* row = rows + (long long)g * d.W;
  const int src = row[PSRC];
  const int* pay = row + PPAY;
  const bool* fr = fire + (long long)g * 2;

  // 2a. the gate and the GC broadcast (thread 0)
  if (t == 0) {
    // readiness gate: MCollect needs a free dot slot (payload and vertex
    // store); MCommit, MShardCommit and MShardAgg the MCollect payload
    int mtype = has[g] ? row[PMT] : NUM_TYPES;
    const int s = p.slot(pay[1]);
    const int cell = p.get2(p.sis, pay[0], s);
    bool rdy = true;
    if (mtype == MCOLLECT)
      rdy = cell == 0 && p.get2(p.vx_seq, pay[0], s) == 0;
    else if (mtype == MCOMMIT || mtype == MSHARDCOMMIT || mtype == MSHARDAGG)
      rdy = cell == pay[1];
    rdy_out[g] = rdy;
    if (!(has[g] && rdy)) mtype = NUM_TYPES;
    misc[1] = min(max(mtype, 0), NUM_TYPES);  // the switch's clip
    misc[2] = 0;
    misc[0] = misc[3] = 0;
    // periodic row 0: the GC frontier to the rest of my shard
    p.clear_words();
    for (int j = 0; j < N && j < P; ++j) words[j] = p.comm_front[j];
    p.broadcast(pob, MGC, [&](int f_) { return fr[0] && p.base + f_ != me; });
  }
  __syncthreads();
  const int branch = misc[1];

  // 2b. periodic row 1, the cleanup tick: thread b answers buffered
  // request b into slot N + 1 + b (written whether or not the tick fires)
  // and frees it when answered; the block clears the handler outbox
  if (t < d.B) {
    const int from = p.breq_from[t];
    if (p.answer(pob, N + 1 + t, from, p.breq_src[t], p.breq_seq[t],
                 fr[1] && from >= 0))
      p.breq_from[t] = -1;
  }
  for (int i = t; i < F * P; i += THREADS) hob.pay[i] = 0;
  for (int i = t; i < F; i += THREADS) hob.v[i] = hob.dst[i] = hob.mt[i] = 0;
  __syncthreads();

  // 2c. the handler of this process's message (thread 0)
  if (t == 0) {
    switch (branch) {
      case SUBMIT: {
        const int dseq = p.own_seq + 1;
        p.own_seq = dseq;
        if (dseq >= SEQ_BOUND) p.err |= ERR_SEQ;
        p.start(me, dseq, pay[0], pay[1], true);
        break;
      }
      case MCOLLECT: p.mcollect(src, pay); break;
      case MCOLLECTACK: p.mcollectack(pay); break;
      case MCOMMIT: p.mcommit(pay); break;
      case MCONSENSUS: {
        p.emit(hob, 0, true, src, MCONSENSUSACK, pay, 2);
        break;
      }
      case MCONSENSUSACK: p.mconsensusack(pay); break;
      case MGC: p.mgc(src, pay); break;
      case MFWDSUBMIT: p.start(pay[0], pay[1], pay[2], pay[3], false); break;
      case MSHARDCOMMIT: p.mshardcommit(pay); break;
      case MSHARDAGG: p.mshardagg(pay); break;
      case GREQ: p.greq(src, pay); break;
      case GREPLY: p.greply(pay); break;
      case GREPLYEXEC: p.greplyexec(pay); break;
      default: break;  // MDRAIN and the noop
    }
    misc[2] = branch == MCOMMIT || branch == MDRAIN || branch == GREPLY ||
              branch == GREPLYEXEC;
  }
  __syncthreads();

  // 3. MGC: free the dot slots up to the raised stable clocks
  if (branch == MGC) {
    for (int i = t; i < ND; i += THREADS) {
      const int v = p.sis[i];
      if (v > 0 && v <= p.prev_stable[i / D]) p.sis[i] = 0;
    }
  }

  // 4. the graph drain
  if (misc[2]) {
    // a: the executed sets, then each committed vertex's flags
    for (int i = t; i < N * (1 + 2 * G); i += THREADS)
      ef[i] = i < N ? p.exec_front[i] : p.exec_gaps[i - N];
    __syncthreads();
    for (int v = t; v < ND; v += THREADS) {
      unsigned char fl = 0;
      if (p.vx_committed[v]) {
        fl = OK | STATIC;
        for (int q = 0; q < QS; ++q) {
          const long long c = (long long)v * QS + q;
          const int ds = p.vx_dep_seq[c];
          if (ds != 0 &&
              !iset_contains_gathered(ef, eg, N, G, p.vx_dep_src[c], ds)) {
            fl = OK;
            break;
          }
        }
      }
      flags[v] = fl;
    }
    __syncthreads();

    // b: the greatest fixed point, in place
    while (true) {
      int changed = 0;
      for (int v = t; v < ND; v += THREADS) {
        if (!(flags[v] & OK)) continue;
        for (int q = 0; q < QS; ++q) {
          const long long c = (long long)v * QS + q;
          const int ds = p.vx_dep_seq[c];
          if (ds == 0) continue;
          int s = p.vx_dep_src[c];
          if (iset_contains_gathered(ef, eg, N, G, s, ds)) continue;
          s = s < 0 ? s + N : s;
          s = min(max(s, 0), N - 1);
          const int cell = s * D + floor_mod(ds - 1, D);
          if (p.vx_seq[cell] == ds && (flags[cell] & OK)) continue;
          flags[v] &= ~OK;
          changed = 1;
          break;
        }
      }
      if (!__syncthreads_or(changed)) break;
    }

    // c: the pick: the lowest src * 2^20 + seq over the ready vertices,
    // or over the ok ones when none is ready; ties to the lowest index
    int n_ok = 0, any_ready = 0;
    for (int v = t; v < ND; v += THREADS) {
      n_ok += flags[v] & OK;
      any_ready |= (flags[v] & (OK | STATIC)) == (OK | STATIC);
    }
    atomicAdd(&misc[0], n_ok);
    const bool ready_mode = __syncthreads_or(any_ready);
    int best = INT_MAX, bidx = INT_MAX;
    for (int v = t; v < ND; v += THREADS) {
      const bool sel = ready_mode
          ? (flags[v] & (OK | STATIC)) == (OK | STATIC)
          : (flags[v] & OK) != 0;
      const int packed = (int)((unsigned)(v / D) * (unsigned)SEQ_BOUND +
                               (unsigned)p.vx_seq[v]);
      const int val = sel ? packed : INF;
      if (val < best || bidx == INT_MAX) {
        best = val;
        bidx = v;
      }
    }
    block_argmin(best, bidx, red_v, red_i);
    const int num_ok = misc[0];
    const int pick = red_i[0];
    const int executed = num_ok > 0 ? pick : -1;
    __syncthreads();  // every thread has read the pick

    // d: the missing deps of the vertices still committed after the pick
    // executes, on the state before it does
    int n_missing = 0;
    best = INT_MAX;
    bidx = INT_MAX;
    for (long long e = t; e < (long long)ND * QS; e += THREADS) {
      const int v = (int)(e / QS);
      int val = INF;
      if (p.vx_committed[v] && v != executed) {
        const int ds = p.vx_dep_seq[e];
        const int s = p.vx_dep_src[e];
        if (ds > 0 && !iset_contains_gathered(ef, eg, N, G, s, ds)) {
          int sc = s < 0 ? s + N : s;
          sc = min(max(sc, 0), N - 1);
          const int cell = sc * D + floor_mod(ds - 1, D);
          const bool touches = ((p.vx_dep_km[e] >> s_me) & 1) == 1;
          if (p.vx_seq[cell] != ds && !touches && p.req_seq[cell] != ds) {
            ++n_missing;
            val = (int)((unsigned)min(max(s, 0), N) * (unsigned)SEQ_BOUND +
                        (unsigned)ds);
          }
        }
      }
      if (val < best || bidx == INT_MAX) {
        best = val;
        bidx = (int)e;
      }
    }
    atomicAdd(&misc[3], n_missing);
    block_argmin(best, bidx, red_v, red_i);

    // e: execute the pick, request the missing dep, chain (thread 0)
    if (t == 0) {
      const int esrc = pick / D;
      const int eseq = p.vx_seq[pick];
      const int client = p.vx_client[pick];
      const int cseq = p.vx_cseq[pick];
      const bool do_ = num_ok > 0;
      if (iset_add(p.exec_front[esrc], p.exec_gaps + (long long)esrc * G * 2,
                   G, eseq, do_))
        p.err |= ERR_CAPACITY;
      if (do_) {
        p.vx_committed[pick] = false;
        p.vx_seq[pick] = 0;
      }
      // one result part per local key to the client, from its connected
      // process of my shard
      int kmask, skey[MAXS * MAXKPC], keys[MAXKPC];
      p.command(client, cseq, kmask, skey);
      p.my_keys(skey, keys);
      const int att = p.in(client, d.C) && p.in(s_me, d.S)
          ? p.attach_s[(long long)client * d.S + s_me] : 0;
      const bool connected = att == me;
      for (int k = 0; k < d.KPC; ++k)
        p.emit1(hob, k, do_ && connected && keys[k] >= 0, N + client,
                TO_CLIENT, 0);
      const int missing = misc[3];
      const bool any_missing = missing > 0;
      const long long m = red_i[0];
      const int r_src = p.vx_dep_src[m], r_seq = p.vx_dep_seq[m];
      if (any_missing) p.set2(p.req_seq, r_src, p.slot(r_seq), r_seq);
      const int w[2] = {r_src, r_seq};
      p.emit(hob, d.KPC, any_missing, p.closest_to(p.shard(r_src)), GREQ, w,
             2);
      p.emit1(hob, d.KPC + 1,
              (do_ && num_ok > 1) || (any_missing && missing > 1), me,
              MDRAIN, 0);
    }
  }

  if (t == 0) {
    ((int*)st.p[OWN_SEQ])[g] = p.own_seq;
    ((int*)st.p[M_FAST])[g] = p.m_fast;
    ((int*)st.p[M_SLOW])[g] = p.m_slow;
    ((int*)st.p[M_STABLE])[g] = p.m_stable;
    ((int*)st.p[ERR])[g] = p.err;
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

extern "C" int fantoch_atlas_partial_handle(
    const void* state_table, const void* cap_tab, const void* has,
    const void* rows, const void* fire, const void* n_ctx, const void* f_ctx,
    const void* expected, const void* fp_mode, const void* ack_self,
    const void* fq, const void* wq, const void* shard_of, const void* closest,
    const void* attach_s, const void* cmd_kmask, const void* cmd_skey,
    void* rdy_out, void* pv, void* pd, void* pm, void* pp, void* hv, void* hd,
    void* hm, void* hp, int L, int N, int D, int F, int P, int W, int C,
    int K, int G, int KPC, int S, int T1, int Q, int QS, int B, int smem,
    int flags, void* stream) {
  const long long blocks = (long long)L * N;
  if (blocks == 0) return 0;
  if (S > MAXS || KPC > MAXKPC || B > THREADS || F < N + B + 2 ||
      F < KPC + 3 || P < 5 + 3 * QS)
    return (int)cudaErrorInvalidValue;
  Planes st;
  for (int i = 0; i < NPLANES; ++i)
    st.p[i] = ((void* const*)state_table)[i];
  const Dims d{L, N, D, F, P, W, C, K, G, KPC, S, T1, Q, QS, B};
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        atlas_partial_handle_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  atlas_partial_handle_kernel<<<(unsigned)blocks, THREADS, (size_t)smem,
                                (cudaStream_t)stream>>>(
      st, run_cap((const void* const*)cap_tab, flags), (const bool*)has,
      (const int*)rows, (const bool*)fire,
      (const int*)n_ctx, (const int*)f_ctx, (const int*)expected,
      (const int*)fp_mode, (const bool*)ack_self, (const bool*)fq,
      (const bool*)wq, (const int*)shard_of, (const int*)closest,
      (const int*)attach_s, (const int*)cmd_kmask, (const int*)cmd_skey,
      (bool*)rdy_out, (bool*)pv, (int*)pd, (int*)pm, (int*)pp, (bool*)hv,
      (int*)hd, (int*)hm, (int*)hp, d);
  return (int)cudaGetLastError();
}
