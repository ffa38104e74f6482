// K9 graphdep_handle: Atlas's and EPaxos's readiness gate, periodic timer,
// message handlers and graph-executor drain for every (lane, process)
// (replaces fantoch_tpu/engine/core.py run_handlers :422 and the
// ready/periodic calls :890-918 with _DepDev.ready :215, .periodic :265
// and .handle :236 of fantoch_tpu/engine/protocols/graphdep.py: the eight
// handlers :471-728, _qd_add :316, _commit_broadcast :344, the hoisted
// drain _drain :374, and both sides of fantoch_tpu/engine/iset.py, in
// iset.cuh). One kernel serves both protocols: the lane ctx carries the
// fast-path mode, whether the coordinator acks itself, the expected ack
// count and the quorum masks.
//
// One block of 128 threads per (lane, process). The reference runs the
// handler as a lax.switch under vmap, which evaluates all nine branches
// and selects one; here the block runs only its own branch, in the
// reference's order: `ready` on the incoming state, `periodic`, `handle`
// on the state `periodic` returned, then the hoisted drain on the
// branch's outputs.
//
// 1. The whole block copies the process's 24 non-scalar state planes
//    (117.6 KB at the main path's shapes) to the output tensors in
//    16-byte coalesced rows, then works on the outputs in place. The
//    scalar planes (sequence, counters, error word) live in thread 0's
//    registers and are stored once at the end.
// 2. Thread 0 runs the gate, the GC timer and the branch: a few dozen
//    words each, staged outboxes in shared memory. MGC's free scan over
//    the [N, D] dot words runs on the whole block after a barrier.
// 3. The drain runs on the whole block, on EVERY process, as the
//    reference's does (a disabled drain still writes its two outbox
//    slots, invalid, with the pick's client as TO_CLIENT's destination,
//    and still runs the executed set's absorption passes at the pick):
//    a. each committed vertex's flags: ok (starts as committed) and
//       "every dep is absent or executed" (the executed test is
//       iset_contains_gathered on the dep's source's executed set,
//       cached in shared memory);
//    b. the greatest fixed point: each thread relaxes its vertices in
//       place (a dep passes if it is absent, executed, or its vertex
//       cell still holds its sequence and is ok) until a pass in which
//       no thread changed anything (__syncthreads_or). Updating ok in
//       place (Gauss-Seidel) reaches the same fixed point as the
//       reference's Jacobi while_loop: the operator is monotone and
//       starts from the top, so every value ok takes stays above the
//       greatest fixed point, and a pass that changes nothing read only
//       final values, so it stands on a fixed point;
//    c. a block argmin of src * 2^20 + seq (int32, wrapping) over the
//       ready vertices, or the ok ones when none is ready, ties to the
//       lowest flat index as jnp.argmin;
//    d. thread 0 adds the pick to its source's executed set, clears the
//       vertex when enabled, and stages TO_CLIENT in slot F - 2 and
//       MDRAIN in slot F - 1; on a monitored step (KM > 0) it first
//       records the pick on its vertex's key (protocols/graphdep.py
//       :415-433; monitor.cuh), the execute-before-commit guard read from
//       the GC committed set of the pick's source.
// 4. The block stores both outboxes.
//
// One-hot semantics of the reference: a read at an out-of-range index
// yields 0, a write there drops; dot slots use floor modulo (seq 0 maps
// to slot D - 1); the drain's gathers by dep source index as jnp's plain
// gathers (negative from the end, clamped). A word thread 0 writes is read
// by other threads only after a __syncthreads().
//
// Bound on this card: bytes. The region reads a few state words per
// (lane, process), the rows its branch touches and the drain's committed
// vertices, and writes the words that change and two [F, P] outboxes
// (graphdep_handle.py work). This kernel copies each process's whole
// state out of place, so it moves far more than that, but in coalesced
// rows.
#include <climits>
#include <cstdint>

#include "common.cuh"
#include "iset.cuh"
#include "monitor.cuh"

using namespace fantoch;

namespace {

constexpr int THREADS = 128;  // graphdep_handle.py THREADS
constexpr int SUBMIT = 0, MCOLLECT = 1, MCOLLECTACK = 2, MCOMMIT = 3,
              MCONSENSUS = 4, MCONSENSUSACK = 5, MGC = 6, MDRAIN = 7,
              NUM_TYPES = 8, TO_CLIENT = 9;
constexpr int ERR_SEQ = 4, ERR_DOT = 8, ERR_CAPACITY = 16, ERR_PROTO = 32;
constexpr int SEQ_BOUND = 1 << 20;

// state planes, in graphdep_handle.py STATE_KEYS order
enum Plane {
  LATEST_SRC, LATEST_SEQ, SIS, KEY_OF, CLIENT_OF, OWN_SEQ, ACK_CNT, QD_SRC,
  QD_SEQ, QD_CNT, SLOW_ACKS, VX_COMMITTED, VX_SEQ, VX_KEY, VX_CLIENT, VX_ND,
  VX_DEP_SRC, VX_DEP_SEQ, EXEC_FRONT, EXEC_GAPS, COMM_FRONT, COMM_GAPS,
  OTHERS, SEEN, PREV_STABLE, M_FAST, M_SLOW, M_STABLE, ERR, NPLANES
};

struct Planes {
  void* p[NPLANES];
};

struct Dims {
  int L, N, D, F, P, R, W, C;  // engine dims; R = periodic rows
  int K, Q, G;                 // keys, dep slots, gap slots
};

// words (bytes for the bool planes) of one process in each plane
__device__ long long plane_words(int i, const Dims& d) {
  const long long N = d.N, D = d.D;
  switch (i) {
    case LATEST_SRC: case LATEST_SEQ: return d.K;
    case SIS: case KEY_OF: case CLIENT_OF: case VX_COMMITTED: case VX_SEQ:
    case VX_KEY: case VX_CLIENT: case VX_ND: return N * D;
    case ACK_CNT: case SLOW_ACKS: return D;
    case QD_SRC: case QD_SEQ: case QD_CNT: return D * d.Q;
    case VX_DEP_SRC: case VX_DEP_SEQ: return N * D * d.Q;
    case EXEC_FRONT: case COMM_FRONT: case SEEN: case PREV_STABLE: return N;
    case EXEC_GAPS: case COMM_GAPS: return N * d.G * 2;
    case OTHERS: return N * N;
    default: return 1;  // the scalar planes
  }
}

__device__ bool is_scalar(int i) {
  return i == OWN_SEQ || i == M_FAST || i == M_SLOW || i == M_STABLE ||
         i == ERR;
}

__device__ bool is_bool(int i) { return i == VX_COMMITTED || i == SEEN; }

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
  int *latest_src, *latest_seq, *sis, *key_of, *client_of, *ack_cnt,
      *qd_src, *qd_seq, *qd_cnt, *slow_acks, *vx_seq, *vx_key, *vx_client,
      *vx_nd, *vx_dep_src, *vx_dep_seq, *exec_front, *exec_gaps, *comm_front,
      *comm_gaps, *others, *prev_stable;
  bool *vx_committed, *seen;
  // scalar planes, in thread 0's registers
  int own_seq, m_fast, m_slow, m_stable, err;
  // lane ctx
  int n, f, expected_acks, fp_mode;
  bool ack_self;
  const bool *fast_quorum, *write_quorum;  // [N, N] of this lane
  const int* attach;                        // [C] of this lane
  Outbox pob, hob;
  int* words;  // [P] scratch for a broadcast's payload

  __device__ bool in(int i, int size) const { return i >= 0 && i < size; }
  __device__ int slot(int seq) const { return floor_mod(seq - 1, d.D); }
  // oh_get: 0 out of range
  __device__ int get(const int* a, int size, int i) const {
    return in(i, size) ? a[i] : 0;
  }
  __device__ int get2(const int* a, int rows, int cols, int i, int j) const {
    return in(i, rows) && in(j, cols) ? a[(long long)i * cols + j] : 0;
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

  // -- helpers (graphdep.py:316-366) ----------------------------------

  // merge one reported dep into the dot's count table: the first match
  // counts one more, else the first free entry takes it; no free entry
  // drops it and raises ERR_CAPACITY
  __device__ void qd_add(int s, int dsrc, int dseq) {
    const int row = s * d.Q;
    const bool do_ = dseq > 0;
    int found = -1, free_ = -1;
    for (int q = 0; q < d.Q; ++q) {
      if (found < 0 && qd_seq[row + q] == dseq && qd_src[row + q] == dsrc)
        found = q;
      if (free_ < 0 && qd_seq[row + q] == 0) free_ = q;
    }
    const bool overflow = do_ && found < 0 && free_ < 0;
    if (overflow) err |= ERR_CAPACITY;
    if (!do_ || overflow) return;
    const int w = found >= 0 ? found : free_;
    qd_src[row + w] = dsrc;
    qd_seq[row + w] = dseq;
    qd_cnt[row + w] = found >= 0 ? qd_cnt[row + w] + 1 : 1;
  }

  // MCommit to all with the dot's dep union, the present deps packed to
  // the front as (src, seq) pairs from word 5
  __device__ void commit_broadcast(int seq, int key, int client,
                                   bool valid) {
    const int row = slot(seq) * d.Q;
    clear_words();
    words[0] = me;
    words[1] = seq;
    words[2] = key;
    words[3] = client;
    int nd = 0;
    for (int q = 0; q < d.Q; ++q) {
      if (qd_seq[row + q] <= 0) continue;
      const int lo = 5 + 2 * min(nd, d.P);
      if (lo < d.P) words[lo] += qd_src[row + q];
      if (lo + 1 < d.P) words[lo + 1] += qd_seq[row + q];
      ++nd;
    }
    words[4] = nd;
    broadcast(hob, MCOMMIT, [&](int) { return valid; });
  }

  // -- the handlers (graphdep.py:471-728) ------------------------------
  __device__ void submit(const int* pay) {
    const int client = pay[0], key = pay[2];
    const int seq = own_seq + 1, s = slot(seq);
    const int prev_src = get(latest_src, d.K, key);
    const int prev_seq = get(latest_seq, d.K, key);
    if (seq >= SEQ_BOUND) err |= ERR_SEQ;
    own_seq = seq;
    if (in(key, d.K)) {
      latest_src[key] = me;
      latest_seq[key] = seq;
    }
    ack_cnt[s] = 0;
    slow_acks[s] = 0;
    for (int q = 0; q < d.Q; ++q)
      qd_src[s * d.Q + q] = qd_seq[s * d.Q + q] = qd_cnt[s * d.Q + q] = 0;
    clear_words();
    words[0] = seq;
    words[1] = key;
    words[2] = client;
    words[3] = prev_src;
    words[4] = prev_seq;
    broadcast(hob, MCOLLECT, [](int) { return true; });
  }

  __device__ void mcollect(int src, const int* pay) {
    const int seq = pay[0], key = pay[1], client = pay[2], cdsrc = pay[3],
              cdseq = pay[4];
    const int s = slot(seq);
    if (get2(sis, d.N, d.D, src, s) != 0 ||
        get2(vx_seq, d.N, d.D, src, s) != 0)
      err |= ERR_DOT;
    if (in(src, d.N)) {
      const long long i = (long long)src * d.D + s;
      sis[i] = seq;
      key_of[i] = key;
      client_of[i] = client;
    }
    const bool in_q = in(src, d.N) && fast_quorum[src * d.N + me];
    const bool from_self = src == me;
    const bool member = in_q && !from_self;
    const int d1src = member ? get(latest_src, d.K, key) : cdsrc;
    const int d1seq = member ? get(latest_seq, d.K, key) : cdseq;
    // the second dep is the coordinator's, dropped when equal to mine
    const bool keep = member && !(d1src == cdsrc && d1seq == cdseq);
    if (member && in(key, d.K)) {
      latest_src[key] = src;
      latest_seq[key] = seq;
    }
    const int w[5] = {seq, d1src, d1seq, keep ? cdsrc : 0, keep ? cdseq : 0};
    emit(hob, 0, in_q && (ack_self || !from_self), src, MCOLLECTACK, w, 5);
  }

  __device__ void mcollectack(const int* pay) {
    const int seq = pay[0], s = slot(seq);
    qd_add(s, pay[1], pay[2]);
    qd_add(s, pay[3], pay[4]);
    const int cnt = ack_cnt[s] + 1;
    ack_cnt[s] = cnt;
    const bool all_acks = cnt == expected_acks;
    // Atlas: every dep seen >= f times; EPaxos: every dep seen by all
    const int threshold = fp_mode == 0 ? f : expected_acks;
    bool fp_ok = true;
    for (int q = 0; q < d.Q; ++q)
      if (qd_seq[s * d.Q + q] > 0 && qd_cnt[s * d.Q + q] < threshold)
        fp_ok = false;
    const bool fast = all_acks && fp_ok;
    const bool slow = all_acks && !fast;
    m_fast += fast ? 1 : 0;
    m_slow += slow ? 1 : 0;
    const int key = key_of[me * d.D + s];
    const int client = client_of[me * d.D + s];
    if (fast) {
      commit_broadcast(seq, key, client, true);
    } else {
      // the consensus broadcast's rows, valid only on the slow path and
      // for the write quorum (kept, invalid, when neither path is taken)
      clear_words();
      words[0] = me;
      words[1] = seq;
      broadcast(hob, MCONSENSUS, [&](int t) {
        return slow && t < d.N && write_quorum[me * d.N + t];
      });
    }
  }

  __device__ void mcommit(const int* pay) {
    const int dsrc = pay[0], seq = pay[1], key = pay[2], client = pay[3],
              nd = pay[4];
    const int s = slot(seq);
    const bool have = get2(sis, d.N, d.D, dsrc, s) == seq;
    const bool already = get2(vx_seq, d.N, d.D, dsrc, s) == seq;
    const bool do_ = have && !already;
    if (!have) err |= ERR_PROTO;
    if (!in(dsrc, d.N)) return;  // writes drop; its set reads empty
    const long long v = (long long)dsrc * d.D + s;
    if (do_) {
      vx_committed[v] = true;
      vx_seq[v] = seq;
      vx_key[v] = key;
      vx_client[v] = client;
      vx_nd[v] = nd;
      for (int q = 0; q < d.Q; ++q) {
        const bool en = q < nd;
        vx_dep_src[v * d.Q + q] = en ? pay[5 + 2 * q] : 0;
        vx_dep_seq[v * d.Q + q] = en ? pay[6 + 2 * q] : 0;
      }
    }
    // the GC committed clock (a disabled add still absorbs)
    if (iset_add(comm_front[dsrc], comm_gaps + (long long)dsrc * d.G * 2,
                 d.G, seq, do_))
      err |= ERR_CAPACITY;
  }

  __device__ void mconsensus(int src, const int* pay) {
    emit(hob, 0, true, src, MCONSENSUSACK, pay, 2);
  }

  __device__ void mconsensusack(const int* pay) {
    const int seq = pay[1], s = slot(seq);
    const int cnt = slow_acks[s] + 1;
    slow_acks[s] = cnt;
    commit_broadcast(seq, key_of[me * d.D + s], client_of[me * d.D + s],
                     cnt == f + 1);
  }

  // committed-clock GC, up to the free scan (the block runs it)
  __device__ void mgc(int src, const int* pay) {
    const int N = d.N;
    if (in(src, N)) {
      for (int j = 0; j < N; ++j)
        others[src * N + j] = max(others[src * N + j], pay[j]);
      seen[src] = true;
    }
    auto other = [&](int j) { return j < n && j != me; };
    bool ready = true;
    for (int j = 0; j < N; ++j)
      if (!seen[j] && other(j)) ready = false;
    unsigned delta = 0;
    for (int c = 0; c < N; ++c) {
      int mn = INF;
      for (int j = 0; j < N; ++j)
        if (other(j)) mn = min(mn, others[j * N + c]);
      const int stable = (ready && c < n) ? min(comm_front[c], mn) : 0;
      delta += (unsigned)max(stable - prev_stable[c], 0);
      prev_stable[c] = max(prev_stable[c], stable);
    }
    m_stable = (int)((unsigned)m_stable + delta);
  }
};

// the drain's per-vertex flags
constexpr unsigned char OK = 1, STATIC = 2;

}  // namespace

__global__ void __launch_bounds__(THREADS) graphdep_handle_kernel(
    const Planes in, const Planes out, const bool* __restrict__ has,
    const int* __restrict__ rows, const bool* __restrict__ fire,
    const int* __restrict__ n_ctx, const int* __restrict__ f_ctx,
    const bool* __restrict__ fq, const bool* __restrict__ wq,
    const int* __restrict__ expected, const int* __restrict__ fp_mode,
    const bool* __restrict__ ack_self, const int* __restrict__ attach,
    bool* __restrict__ rdy_out, bool* __restrict__ pv, int* __restrict__ pd,
    int* __restrict__ pm, int* __restrict__ pp, bool* __restrict__ hv,
    int* __restrict__ hd, int* __restrict__ hm, int* __restrict__ hp,
    const MonArgs ma, const Dims d) {
  extern __shared__ int smem[];
  const int g = blockIdx.x;  // (lane, process)
  const int t = threadIdx.x;
  const int l = g / d.N, me = g % d.N;
  const int N = d.N, D = d.D, F = d.F, P = d.P, Q = d.Q, G = d.G;
  const int ND = N * D;

  // shared memory (graphdep_handle.py smem_bytes)
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
  int* misc = sp;  // [0] ok count, [1] enable, [2] any ready
  sp += 8;
  unsigned char* flags = reinterpret_cast<unsigned char*>(sp);

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
  mon_copy(ma, g, t, THREADS);
  __syncthreads();

  auto plane = [&](int i) {
    return (int*)out.p[i] + (long long)g * plane_words(i, d);
  };
  auto scalar = [&](int i) { return ((const int*)in.p[i])[g]; };
  Proc p{d, me,
         plane(LATEST_SRC), plane(LATEST_SEQ), plane(SIS), plane(KEY_OF),
         plane(CLIENT_OF), plane(ACK_CNT), plane(QD_SRC), plane(QD_SEQ),
         plane(QD_CNT), plane(SLOW_ACKS), plane(VX_SEQ), plane(VX_KEY),
         plane(VX_CLIENT), plane(VX_ND), plane(VX_DEP_SRC), plane(VX_DEP_SEQ),
         plane(EXEC_FRONT), plane(EXEC_GAPS), plane(COMM_FRONT),
         plane(COMM_GAPS), plane(OTHERS), plane(PREV_STABLE),
         (bool*)out.p[VX_COMMITTED] + (long long)g * ND,
         (bool*)out.p[SEEN] + (long long)g * N,
         scalar(OWN_SEQ), scalar(M_FAST), scalar(M_SLOW), scalar(M_STABLE),
         scalar(ERR),
         n_ctx[l], f_ctx[l], expected[l], fp_mode[l], ack_self[l],
         fq + (long long)l * N * N, wq + (long long)l * N * N,
         attach + (long long)l * d.C,
         pob, hob, words};

  const int* row = rows + (long long)g * d.W;
  const int src = row[PSRC];
  const int* pay = row + PPAY;
  int mtype = has[g] ? row[PMT] : NUM_TYPES;

  // 2. gate, GC timer and branch (thread 0)
  if (t == 0) {
    // readiness gate: MCollect needs a free dot slot (payload and vertex
    // store); MCommit the MCollect payload (sources are not clamped)
    bool rdy = true;
    if (mtype == MCOLLECT) {
      const int s = p.slot(pay[0]);
      rdy = p.get2(p.sis, N, D, src, s) == 0 &&
            p.get2(p.vx_seq, N, D, src, s) == 0;
    } else if (mtype == MCOMMIT) {
      rdy = p.get2(p.sis, N, D, pay[0], p.slot(pay[1])) == pay[1];
    }
    rdy_out[g] = rdy;
    if (!(has[g] && rdy)) mtype = NUM_TYPES;
    const int branch = min(max(mtype, 0), NUM_TYPES);  // the switch's clip

    // periodic: the GC frontier broadcast to all but me
    const bool* fr = fire + (long long)g * d.R;
    p.clear_words();
    for (int j = 0; j < N && j < P; ++j) words[j] = p.comm_front[j];
    p.broadcast(pob, MGC, [&](int s) { return s != me && fr[0]; });

    p.clear(hob);
    switch (branch) {
      case SUBMIT: p.submit(pay); break;
      case MCOLLECT: p.mcollect(src, pay); break;
      case MCOLLECTACK: p.mcollectack(pay); break;
      case MCOMMIT: p.mcommit(pay); break;
      case MCONSENSUS: p.mconsensus(src, pay); break;
      case MCONSENSUSACK: p.mconsensusack(pay); break;
      case MGC: p.mgc(src, pay); break;
      default: break;  // MDRAIN and the noop: the drain only
    }
    misc[0] = 0;
    misc[1] = branch;
  }
  __syncthreads();
  const int branch = misc[1];

  // MGC's free scan over the [N, D] dot words, at the new stable clocks
  if (branch == MGC) {
    for (int i = t; i < ND; i += THREADS) {
      const int v = p.sis[i];
      if (v > 0 && v <= p.prev_stable[i / D]) p.sis[i] = 0;
    }
  }

  // 3. the drain, on every process. a: the executed sets, then each
  // committed vertex's flags
  for (int i = t; i < N * (1 + 2 * G); i += THREADS)
    ef[i] = i < N ? p.exec_front[i] : p.exec_gaps[i - N];
  __syncthreads();
  for (int v = t; v < ND; v += THREADS) {
    unsigned char fl = 0;
    if (p.vx_committed[v]) {
      fl = OK | STATIC;
      for (int q = 0; q < Q; ++q) {
        const int ds = p.vx_dep_seq[(long long)v * Q + q];
        if (ds != 0 && !iset_contains_gathered(
                           ef, eg, N, G, p.vx_dep_src[(long long)v * Q + q],
                           ds)) {
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
      for (int q = 0; q < Q; ++q) {
        const long long c = (long long)v * Q + q;
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

  // c: the pick: the lowest src * 2^20 + seq over the ready vertices, or
  // over the ok ones when none is ready; ties to the lowest index
  int n_ok = 0, any_ready = 0;
  for (int v = t; v < ND; v += THREADS) {
    n_ok += flags[v] & OK;
    any_ready |= (flags[v] & (OK | STATIC)) == (OK | STATIC);
  }
  atomicAdd(&misc[0], n_ok);
  const bool ready_mode = __syncthreads_or(any_ready);
  int best = INT_MAX, bidx = INT_MAX;
  for (int v = t; v < ND; v += THREADS) {
    const bool sel = ready_mode ? (flags[v] & (OK | STATIC)) == (OK | STATIC)
                                : (flags[v] & OK) != 0;
    const int packed =
        (int)((unsigned)(v / D) * (unsigned)SEQ_BOUND + (unsigned)p.vx_seq[v]);
    const int val = sel ? packed : INF;
    if (val < best || (val == best && v < bidx)) {
      best = val;
      bidx = v;
    }
  }
  red_v[t] = best;
  red_i[t] = bidx;
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

  // d: execute the pick (thread 0)
  if (t == 0) {
    const int num_ok = misc[0];
    const int idx = red_i[0];
    const int esrc = idx / D;
    const int eseq = p.vx_seq[idx];
    const int client = p.vx_client[idx];
    const bool do_ = (branch == MCOMMIT || branch == MDRAIN) && num_ok > 0;
    if (ma.KM != 0)
      mon_view(ma, g).exec(
          p.vx_key[idx], esrc, eseq, do_,
          !iset_contains(p.comm_front[esrc],
                         p.comm_gaps + (long long)esrc * G * 2, G, eseq),
          true);
    if (iset_add(p.exec_front[esrc], p.exec_gaps + (long long)esrc * G * 2,
                 G, eseq, do_))
      p.err |= ERR_CAPACITY;
    if (do_) {
      p.vx_committed[idx] = false;
      p.vx_seq[idx] = 0;
    }
    const int zero[1] = {0};
    const int at = p.in(client, d.C) ? p.attach[client] : 0;
    p.emit(hob, F - 2, do_ && at == me, N + client, TO_CLIENT, zero, 1);
    p.emit(hob, F - 1, do_ && num_ok > 1, me, MDRAIN, zero, 1);
    ((int*)out.p[OWN_SEQ])[g] = p.own_seq;
    ((int*)out.p[M_FAST])[g] = p.m_fast;
    ((int*)out.p[M_SLOW])[g] = p.m_slow;
    ((int*)out.p[M_STABLE])[g] = p.m_stable;
    ((int*)out.p[ERR])[g] = p.err;
  }
  __syncthreads();

  // 4. store both outboxes
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

extern "C" int fantoch_graphdep_handle(
    const void* in_table, const void* out_table, const void* has,
    const void* rows, const void* fire, const void* n_ctx, const void* f_ctx,
    const void* fq, const void* wq, const void* expected,
    const void* fp_mode, const void* ack_self, const void* attach,
    void* rdy_out, void* pv, void* pd, void* pm, void* pp, void* hv,
    void* hd, void* hm, void* hp, const void* mh_in, const void* mc_in,
    const void* mf_in, void* mh_o, void* mc_o, void* mf_o, int L, int N,
    int D, int F, int P, int R, int W, int C, int K, int Q, int G, int smem,
    int KM, void* stream) {
  const long long blocks = (long long)L * N;
  if (blocks == 0) return 0;
  Planes in, out;
  for (int i = 0; i < NPLANES; ++i) {
    in.p[i] = ((void* const*)in_table)[i];
    out.p[i] = ((void* const*)out_table)[i];
  }
  const Dims d{L, N, D, F, P, R, W, C, K, Q, G};
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        graphdep_handle_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  graphdep_handle_kernel<<<(unsigned)blocks, THREADS, (size_t)smem,
                           (cudaStream_t)stream>>>(
      in, out, (const bool*)has, (const int*)rows, (const bool*)fire,
      (const int*)n_ctx, (const int*)f_ctx, (const bool*)fq,
      (const bool*)wq, (const int*)expected, (const int*)fp_mode,
      (const bool*)ack_self, (const int*)attach, (bool*)rdy_out, (bool*)pv,
      (int*)pd, (int*)pm, (int*)pp, (bool*)hv, (int*)hd, (int*)hm, (int*)hp,
      mon_args(mh_in, mc_in, mf_in, mh_o, mc_o, mf_o, KM), d);
  return (int)cudaGetLastError();
}
