// K4 basic_handle: Basic's readiness gate, periodic timer and message
// handler for every (lane, process) (replaces fantoch_tpu/engine/core.py
// run_handlers :422 and the ready/periodic calls :890-918 with
// BasicDev.ready/handle/periodic, protocols/basic.py:119-320).
//
// One thread per (lane, process). The reference runs the handler as a
// lax.switch under vmap, which evaluates every branch and selects one;
// here each thread runs only its own branch. In the reference's order:
// `ready` on the incoming state, `periodic` (which leaves the state as it
// is) and `handle` on that state. The thread first copies its process's
// state slices to the output tensors, then updates them in place; both
// [F] outboxes are written whole (empty rows: valid 0, dst 0, mtype 0,
// payload 0). Every one-hot read of the reference (oh_get) reads 0 for an
// out-of-range index and every one-hot write (oh_set) drops it. On a
// monitored step (KM > 0) each commit apply records its dot on monitor key
// 0 (protocols/basic.py:176-180; monitor.cuh), count-only: Basic checks no
// cross-process order.
//
// Bound on this card: bytes. The region reads a few state words per
// (lane, process), and the [N, D] dot slots only where a GC message is
// handled, and writes the words that change and two [F, P] outboxes
// (basic_handle.py work). This kernel copies each process's whole state
// (dominated by the [N, D] dot-slot and buffered-commit planes) out of
// place, one thread per process, so it moves far more than that.
#include "common.cuh"
#include "monitor.cuh"

using namespace fantoch;

namespace {

constexpr int SUBMIT = 0, MSTORE = 1, MSTOREACK = 2, MCOMMIT = 3, MGC = 4,
              NUM_TYPES = 5, TO_CLIENT = 6;
constexpr int ERR_DOT = 8, ERR_PROTO = 32;

struct Outbox {
  bool* valid;
  int* dst;
  int* mtype;
  int* payload;
  int F, P;
  __device__ void row(int i, bool v, int d, int mt, int w0) const {
    valid[i] = v;
    dst[i] = d;
    mtype[i] = mt;
    payload[i * P] = w0;
    for (int j = 1; j < P; ++j) payload[i * P + j] = 0;
  }
  __device__ void broadcast(int n, int mt, int w0, int w1, bool ok) const {
    for (int f = 0; f < F; ++f) {
      valid[f] = f < n && ok;
      dst[f] = f;
      mtype[f] = mt;
      for (int j = 0; j < P; ++j)
        payload[f * P + j] = j == 0 ? w0 : (j == 1 ? w1 : 0);
    }
  }
};

}  // namespace

__global__ void basic_handle_kernel(
    // incoming per-process state
    const int* __restrict__ sis_in, const bool* __restrict__ bc_in,
    const int* __restrict__ cc_in, const int* __restrict__ acks_in,
    const int* __restrict__ cof_in, const int* __restrict__ own_in,
    const int* __restrict__ of_in, const bool* __restrict__ seen_in,
    const int* __restrict__ prev_in, const int* __restrict__ fast_in,
    const int* __restrict__ stab_in, const int* __restrict__ err_in,
    // popped message, timers, lane ctx
    const bool* __restrict__ has, const int* __restrict__ rows,
    const bool* __restrict__ fire, const int* __restrict__ n_ctx,
    const bool* __restrict__ quorum, const int* __restrict__ q_size,
    // outputs
    bool* __restrict__ rdy_out, int* __restrict__ sis_o,
    bool* __restrict__ bc_o, int* __restrict__ cc_o, int* __restrict__ acks_o,
    int* __restrict__ cof_o, int* __restrict__ own_o, int* __restrict__ of_o,
    bool* __restrict__ seen_o, int* __restrict__ prev_o,
    int* __restrict__ fast_o, int* __restrict__ stab_o,
    int* __restrict__ err_o, bool* __restrict__ pv, int* __restrict__ pd,
    int* __restrict__ pm, int* __restrict__ pp, bool* __restrict__ hv,
    int* __restrict__ hd, int* __restrict__ hm, int* __restrict__ hp,
    const MonArgs ma, int L, int N, int D, int F, int P, int R, int W) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= L * N) return;
  const int l = g / N, me = g % N;

  // copy this process's state, then update the copies in place
  const size_t oND = (size_t)g * N * D, oD = (size_t)g * D,
               oN = (size_t)g * N, oNN = (size_t)g * N * N;
  for (int i = 0; i < N * D; ++i) {
    sis_o[oND + i] = sis_in[oND + i];
    bc_o[oND + i] = bc_in[oND + i];
  }
  for (int i = 0; i < D; ++i) {
    acks_o[oD + i] = acks_in[oD + i];
    cof_o[oD + i] = cof_in[oD + i];
  }
  for (int i = 0; i < N; ++i) {
    cc_o[oN + i] = cc_in[oN + i];
    seen_o[oN + i] = seen_in[oN + i];
    prev_o[oN + i] = prev_in[oN + i];
  }
  for (int i = 0; i < N * N; ++i) of_o[oNN + i] = of_in[oNN + i];
  mon_copy(ma, g, 0, 1);
  const Mon mon = mon_view(ma, g);
  int own = own_in[g], fast = fast_in[g], stab = stab_in[g], err = err_in[g];
  int* sis = sis_o + oND;
  bool* bc = bc_o + oND;
  int* cc = cc_o + oN;
  int* acks = acks_o + oD;
  int* cof = cof_o + oD;
  int* of = of_o + oNN;
  bool* seen = seen_o + oN;
  int* prev = prev_o + oN;

  auto in_n = [&](int s) { return s >= 0 && s < N; };
  auto get_sis = [&](int s, int d) { return in_n(s) ? sis[s * D + d] : 0; };
  auto get_bc = [&](int s, int d) { return in_n(s) ? bc[s * D + d] : false; };
  auto get_cc = [&](int s) { return in_n(s) ? cc[s] : 0; };

  const int* row = rows + (size_t)g * W;
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

  const int n = n_ctx[l];
  const Outbox pob{pv + (size_t)g * F, pd + (size_t)g * F,
                   pm + (size_t)g * F, pp + (size_t)g * F * P, F, P};
  const Outbox hob{hv + (size_t)g * F, hd + (size_t)g * F,
                   hm + (size_t)g * F, hp + (size_t)g * F * P, F, P};

  // periodic GC: broadcast my committed frontier to all-but-me
  const bool fire0 = fire[(size_t)g * R];
  for (int f = 0; f < F; ++f) {
    pob.valid[f] = f < n && f != me && fire0;
    pob.dst[f] = f;
    pob.mtype[f] = MGC;
    for (int j = 0; j < P; ++j) pob.payload[f * P + j] = j < N ? cc[j] : 0;
  }

  for (int f = 0; f < F; ++f) hob.row(f, false, 0, 0, 0);
  // commit (s, seq) if `done`; the coordinator reports to its client
  auto apply_commit = [&](int s, int seq, bool done, int ob_slot) {
    mon.exec(0, s, seq, done, false, true);
    const int cur = get_cc(s);
    if (done && seq != cur + 1) err |= ERR_PROTO;
    if (in_n(s)) cc[s] = cur + (done ? 1 : 0);
    const int client = cof[floor_mod(seq - 1, D)];
    hob.row(ob_slot, done && me == s, N + client, TO_CLIENT, seq);
  };

  switch (min(max(mtype, 0), NUM_TYPES)) {  // the switch's clip
    case SUBMIT: {  // next dot, MStore to all (basic.rs:113-129)
      const int seq = own + 1, slot = floor_mod(seq - 1, D);
      own = seq;
      cof[slot] = pay[0];
      acks[slot] = 0;
      hob.broadcast(n, MSTORE, seq, pay[2], true);
      break;
    }
    case MSTORE: {  // store, ack if in the quorum, apply a buffered commit
      const int seq = pay[0], slot = floor_mod(seq - 1, D);
      if (get_sis(src, slot) != 0) err |= ERR_DOT;
      if (in_n(src)) sis[src * D + slot] = seq;
      const bool member =
          in_n(src) && quorum[((size_t)l * N + src) * N + me];
      hob.row(0, member, src, MSTOREACK, seq);
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
      hob.broadcast(n, MCOMMIT, me, seq, reached);
      break;
    }
    case MCOMMIT: {  // apply if the payload arrived, else buffer
      const int dsrc = pay[0], seq = pay[1], slot = floor_mod(seq - 1, D);
      const bool have = get_sis(dsrc, slot) == seq;
      apply_commit(dsrc, seq, have, 0);
      if (in_n(dsrc)) bc[dsrc * D + slot] = get_bc(dsrc, slot) || !have;
      break;
    }
    case MGC: {  // join the frontier, advance the stable clock, free slots
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
      for (int j = 0; j < N; ++j)
        for (int d = 0; d < D; ++d) {
          const int v = sis[j * D + d];
          if (v > 0 && v <= prev[j]) {
            sis[j * D + d] = 0;
            bc[j * D + d] = false;
          }
        }
      break;
    }
    default:
      break;
  }
  own_o[g] = own;
  fast_o[g] = fast;
  stab_o[g] = stab;
  err_o[g] = err;
}

extern "C" int fantoch_basic_handle(
    const void* sis_in, const void* bc_in, const void* cc_in,
    const void* acks_in, const void* cof_in, const void* own_in,
    const void* of_in, const void* seen_in, const void* prev_in,
    const void* fast_in, const void* stab_in, const void* err_in,
    const void* has, const void* rows, const void* fire, const void* n_ctx,
    const void* quorum, const void* q_size, void* rdy_out, void* sis_o,
    void* bc_o, void* cc_o, void* acks_o, void* cof_o, void* own_o,
    void* of_o, void* seen_o, void* prev_o, void* fast_o, void* stab_o,
    void* err_o, void* pv, void* pd, void* pm, void* pp, void* hv, void* hd,
    void* hm, void* hp, const void* mh_in, const void* mc_in,
    const void* mf_in, void* mh_o, void* mc_o, void* mf_o, int L, int N,
    int D, int F, int P, int R, int W, int KM, void* stream) {
  const int total = L * N;
  if (total == 0) return 0;
  const int threads = 128;
  basic_handle_kernel<<<(total + threads - 1) / threads, threads, 0,
                        (cudaStream_t)stream>>>(
      (const int*)sis_in, (const bool*)bc_in, (const int*)cc_in,
      (const int*)acks_in, (const int*)cof_in, (const int*)own_in,
      (const int*)of_in, (const bool*)seen_in, (const int*)prev_in,
      (const int*)fast_in, (const int*)stab_in, (const int*)err_in,
      (const bool*)has, (const int*)rows, (const bool*)fire,
      (const int*)n_ctx, (const bool*)quorum, (const int*)q_size,
      (bool*)rdy_out, (int*)sis_o, (bool*)bc_o, (int*)cc_o, (int*)acks_o,
      (int*)cof_o, (int*)own_o, (int*)of_o, (bool*)seen_o, (int*)prev_o,
      (int*)fast_o, (int*)stab_o, (int*)err_o, (bool*)pv, (int*)pd,
      (int*)pm, (int*)pp, (bool*)hv, (int*)hd, (int*)hm, (int*)hp,
      mon_args(mh_in, mc_in, mf_in, mh_o, mc_o, mf_o, KM), L, N, D, F, P, R,
      W);
  return (int)cudaGetLastError();
}
