// K4 basic_handle: Basic's readiness gate, periodic timer and message
// handler for every (lane, process) (replaces fantoch_tpu/engine/core.py
// run_handlers :422 and the ready/periodic calls :890-918 with
// BasicDev.ready/handle/periodic, protocols/basic.py:119-320).
//
// One warp per (lane, process), WARPS warps a block. The reference runs
// the handler as a lax.switch under vmap, which evaluates every branch and
// selects one; here each warp runs only its own branch, in the reference's
// order: `ready` on the incoming state, `periodic` (which leaves the state
// as it is) and `handle` on that state.
//
// 1. In place: the warp updates its process's rows of the step's own state
//    planes (and monitor planes), and only on lanes whose run predicate
//    holds at the step's start (common.cuh RunCap; every lane without a
//    cap), as the reference's vmapped while_loop keeps a frozen lane's
//    state. A frozen lane's warps write rdy false and empty outboxes
//    (valid false, zero words) and exit. Warp (l, p) reads and writes only
//    process p's rows of lane l, so no warp sees another's writes.
// 2. The warp stores the periodic outbox (the GC frontier broadcast) from
//    the incoming frontier, one slot per thread, before any write.
// 3. Lane 0 runs the gate, the GC timer and the branch, serially and in
//    the reference's order, and leaves the handler outbox as a short
//    description in shared memory (a broadcast, or rows 0 and 1). MGC's
//    frontier join and stable clocks (N x N) run on lane 0 too.
// 4. After a __syncwarp, MGC's free sweep over the [N, D] dot slots runs
//    across the warp's 32 threads in coalesced rows, SWEEP rows loaded
//    before any is tested (the loads overlap), and the warp stores
//    the handler outbox, one slot per thread (empty rows: valid 0, dst 0,
//    mtype 0, payload 0).
//
// Every one-hot read of the reference (oh_get) reads 0 for an out-of-range
// index and every one-hot write (oh_set) drops it. On a monitored step
// (KM > 0) each commit apply records its dot on monitor key 0
// (protocols/basic.py:176-180; monitor.cuh), count-only: Basic checks no
// cross-process order.
//
// Bound on this card: bytes. The region reads a few state words per
// (lane, process), and the [N, D] dot slots only where a GC message is
// handled, and writes the words that change and two [F, P] outboxes
// (basic_handle.py work). In place, this kernel moves about that; what is
// left is lane 0's short serial branch.
#include "common.cuh"
#include "monitor.cuh"

using namespace fantoch;

namespace {

constexpr int WARPS = 4;  // warps a block, one a (lane, process)
constexpr int SWEEP = 8;  // rows of MGC's free sweep in flight a thread
constexpr int SUBMIT = 0, MSTORE = 1, MSTOREACK = 2, MCOMMIT = 3, MGC = 4,
              NUM_TYPES = 5, TO_CLIENT = 6;
constexpr int ERR_DOT = 8, ERR_PROTO = 32;

// state planes, in basic_handle.py STATE_KEYS order
enum Plane { SIS, BC, CC, ACKS, COF, OWN, OF, SEEN, PREV, FAST, STAB, ERR,
             NPLANES };

struct Planes {
  void* p[NPLANES];
};

// The handler outbox as lane 0 leaves it: a broadcast of (mt, w0, w1) to
// every slot f < n when ok, or rows 0 and 1 (payload w0), the other slots
// empty; and whether MGC's free sweep runs.
struct HOut {
  int bc, mt, w0, w1, ok;
  int v[2], dst[2], rmt[2], rw[2];
  int gc;
};

}  // namespace

__global__ void __launch_bounds__(WARPS * 32) basic_handle_kernel(
    const Planes st, const RunCap cap, const bool* __restrict__ has,
    const int* __restrict__ rows, const bool* __restrict__ fire,
    const int* __restrict__ n_ctx, const bool* __restrict__ quorum,
    const int* __restrict__ q_size, bool* __restrict__ rdy_out,
    bool* __restrict__ pv, int* __restrict__ pd, int* __restrict__ pm,
    int* __restrict__ pp, bool* __restrict__ hv, int* __restrict__ hd,
    int* __restrict__ hm, int* __restrict__ hp, const MonArgs ma, int L,
    int N, int D, int F, int P, int R, int W) {
  __shared__ HOut s_out[WARPS];
  const int t = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (g >= (long long)L * N) return;  // the whole warp
  const int l = (int)(g / N), me = (int)(g % N);
  const long long ob = g * F;  // this process's first outbox slot

  if (!cap.runs(l)) {  // frozen: the state stays, the outboxes are empty
    if (t == 0) rdy_out[g] = false;
    for (int i = t; i < F * P; i += 32) pp[ob * P + i] = hp[ob * P + i] = 0;
    for (int f = t; f < F; f += 32) {
      pv[ob + f] = hv[ob + f] = false;
      pd[ob + f] = pm[ob + f] = hd[ob + f] = hm[ob + f] = 0;
    }
    return;
  }

  int* sis = (int*)st.p[SIS] + g * N * D;
  bool* bc = (bool*)st.p[BC] + g * N * D;
  int* cc = (int*)st.p[CC] + g * N;
  int* prev = (int*)st.p[PREV] + g * N;
  const int n = n_ctx[l];

  // 2. periodic GC: broadcast my committed frontier to all-but-me
  const bool fire0 = fire[g * R];
  for (int f = t; f < F; f += 32) {
    pv[ob + f] = f < n && f != me && fire0;
    pd[ob + f] = f;
    pm[ob + f] = MGC;
  }
  for (int i = t; i < F * P; i += 32) {
    const int j = i % P;
    pp[ob * P + i] = j < N ? cc[j] : 0;
  }
  __syncwarp();  // the frontier is read before lane 0 moves it

  // 3. the gate and the branch (lane 0)
  HOut& ho = s_out[threadIdx.x >> 5];
  if (t == 0) {
    int* acks = (int*)st.p[ACKS] + g * D;
    int* cof = (int*)st.p[COF] + g * D;
    int* of = (int*)st.p[OF] + g * N * N;
    bool* seen = (bool*)st.p[SEEN] + g * N;
    int* own_p = (int*)st.p[OWN] + g;
    int* fast_p = (int*)st.p[FAST] + g;
    int* stab_p = (int*)st.p[STAB] + g;
    int* err_p = (int*)st.p[ERR] + g;
    int own = *own_p, fast = *fast_p, stab = *stab_p, err = *err_p;
    const Mon mon = mon_view(ma, g);

    auto in_n = [&](int s) { return s >= 0 && s < N; };
    auto get_sis = [&](int s, int d) {
      return in_n(s) ? sis[s * D + d] : 0;
    };
    auto get_bc = [&](int s, int d) {
      return in_n(s) ? bc[s * D + d] : false;
    };
    auto get_cc = [&](int s) { return in_n(s) ? cc[s] : 0; };

    const int* row = rows + g * W;
    const int src = row[PSRC];
    const int* pay = row + PPAY;
    int mtype = has[g] ? row[PMT] : NUM_TYPES;

    // readiness gate: MStore needs a free dot slot; commits apply in
    // per-source order
    bool rdy = true;
    if (mtype == MSTORE)
      rdy = get_sis(src, floor_mod(pay[0] - 1, D)) == 0;
    else if (mtype == MCOMMIT)
      rdy = pay[1] == get_cc(pay[0]) + 1;
    rdy_out[g] = rdy;
    if (!(has[g] && rdy)) mtype = NUM_TYPES;

    ho.bc = ho.gc = 0;
    for (int i = 0; i < 2; ++i)
      ho.v[i] = ho.dst[i] = ho.rmt[i] = ho.rw[i] = 0;
    auto set_row = [&](int i, bool v, int d, int mt, int w0) {
      ho.v[i] = v;
      ho.dst[i] = d;
      ho.rmt[i] = mt;
      ho.rw[i] = w0;
    };
    auto set_bc = [&](int mt, int w0, int w1, bool ok) {
      ho.bc = 1;
      ho.mt = mt;
      ho.w0 = w0;
      ho.w1 = w1;
      ho.ok = ok;
    };
    // commit (s, seq) if `done`; the coordinator reports to its client
    auto apply_commit = [&](int s, int seq, bool done, int ob_slot) {
      mon.exec(0, s, seq, done, false, true);
      const int cur = get_cc(s);
      if (done && seq != cur + 1) err |= ERR_PROTO;
      if (in_n(s)) cc[s] = cur + (done ? 1 : 0);
      const int client = cof[floor_mod(seq - 1, D)];
      set_row(ob_slot, done && me == s, N + client, TO_CLIENT, seq);
    };

    switch (min(max(mtype, 0), NUM_TYPES)) {  // the switch's clip
      case SUBMIT: {  // next dot, MStore to all (basic.rs:113-129)
        const int seq = own + 1, slot = floor_mod(seq - 1, D);
        own = seq;
        cof[slot] = pay[0];
        acks[slot] = 0;
        set_bc(MSTORE, seq, pay[2], true);
        break;
      }
      case MSTORE: {  // store, ack if in the quorum, apply a buffered commit
        const int seq = pay[0], slot = floor_mod(seq - 1, D);
        if (get_sis(src, slot) != 0) err |= ERR_DOT;
        if (in_n(src)) sis[src * D + slot] = seq;
        const bool member =
            in_n(src) && quorum[((long long)l * N + src) * N + me];
        set_row(0, member, src, MSTOREACK, seq);
        apply_commit(src, seq, get_bc(src, slot), 1);
        if (in_n(src)) bc[src * D + slot] = false;
        break;
      }
      case MSTOREACK: {  // on exactly f+1 acks, commit everywhere
        const int seq = pay[0], slot = floor_mod(seq - 1, D);
        const int cnt = acks[slot] + 1;
        const bool reached = cnt == q_size[l];
        acks[slot] = cnt;
        fast += reached ? 1 : 0;
        set_bc(MCOMMIT, me, seq, reached);
        break;
      }
      case MCOMMIT: {  // apply if the payload arrived, else buffer
        const int dsrc = pay[0], seq = pay[1], slot = floor_mod(seq - 1, D);
        const bool have = get_sis(dsrc, slot) == seq;
        apply_commit(dsrc, seq, have, 0);
        if (in_n(dsrc)) bc[dsrc * D + slot] = get_bc(dsrc, slot) || !have;
        break;
      }
      case MGC: {  // join the frontier, advance the stable clock; the
                   // warp frees the slots below
        if (in_n(src)) {
          for (int k = 0; k < N; ++k)
            of[src * N + k] = max(of[src * N + k], pay[k]);
          seen[src] = true;
        }
        bool ready = true;
        for (int j = 0; j < N; ++j)
          if (j < n && j != me && !seen[j]) ready = false;
        for (int k = 0; k < N; ++k) {
          int mn = INF;
          for (int j = 0; j < N; ++j)
            if (j < n && j != me) mn = min(mn, of[j * N + k]);
          const int stable = (ready && k < n) ? min(cc[k], mn) : 0;
          stab += max(stable - prev[k], 0);
          prev[k] = max(prev[k], stable);
        }
        ho.gc = 1;
        break;
      }
      default:
        break;
    }
    *own_p = own;
    *fast_p = fast;
    *stab_p = stab;
    *err_p = err;
  }
  __syncwarp();  // lane 0's state words and outbox description

  // 4. MGC: free the dot slots up to the raised stable clocks, SWEEP
  // coalesced rows of 32 words loaded before any is tested
  if (ho.gc) {
    const int ND = N * D;
    for (int b = 0; b < ND; b += 32 * SWEEP) {
      int v[SWEEP];
#pragma unroll
      for (int u = 0; u < SWEEP; ++u) {
        const int i = b + 32 * u + t;
        v[u] = i < ND ? sis[i] : 0;
      }
#pragma unroll
      for (int u = 0; u < SWEEP; ++u) {
        const int i = b + 32 * u + t;
        if (v[u] > 0 && v[u] <= prev[i / D]) {
          sis[i] = 0;
          bc[i] = false;
        }
      }
    }
  }
  // the handler outbox, one slot per thread
  for (int f = t; f < F; f += 32) {
    if (ho.bc) {
      hv[ob + f] = f < n && ho.ok;
      hd[ob + f] = f;
      hm[ob + f] = ho.mt;
    } else {
      const int r = f < 2 ? f : -1;
      hv[ob + f] = r >= 0 && ho.v[r];
      hd[ob + f] = r >= 0 ? ho.dst[r] : 0;
      hm[ob + f] = r >= 0 ? ho.rmt[r] : 0;
    }
  }
  for (int i = t; i < F * P; i += 32) {
    const int f = i / P, j = i % P;
    int w = 0;
    if (ho.bc)
      w = j == 0 ? ho.w0 : (j == 1 ? ho.w1 : 0);
    else if (f < 2 && j == 0)
      w = ho.rw[f];
    hp[ob * P + i] = w;
  }
}

extern "C" int fantoch_basic_handle(
    const void* state_table, const void* cap_tab, const void* has,
    const void* rows, const void* fire, const void* n_ctx,
    const void* quorum, const void* q_size, void* rdy_out, void* pv,
    void* pd, void* pm, void* pp, void* hv, void* hd, void* hm, void* hp,
    void* mon_hash, void* mon_cnt, void* mon_flags, int L, int N, int D,
    int F, int P, int R, int W, int KM, int flags, void* stream) {
  const long long warps = (long long)L * N;
  if (warps == 0) return 0;
  Planes st;
  for (int i = 0; i < NPLANES; ++i)
    st.p[i] = ((void* const*)state_table)[i];
  const unsigned blocks = (unsigned)((warps + WARPS - 1) / WARPS);
  basic_handle_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      st, run_cap((const void* const*)cap_tab, flags), (const bool*)has,
      (const int*)rows, (const bool*)fire, (const int*)n_ctx,
      (const bool*)quorum, (const int*)q_size, (bool*)rdy_out, (bool*)pv,
      (int*)pd, (int*)pm, (int*)pp, (bool*)hv, (int*)hd, (int*)hm,
      (int*)hp,
      mon_args(mon_hash, mon_cnt, mon_flags, KM),
      L, N, D, F, P, R, W);
  return (int)cudaGetLastError();
}
