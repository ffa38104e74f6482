// K5 fpaxos_handle: FPaxos's readiness gate, periodic timer and message
// handler for every (lane, process) (replaces fantoch_tpu/engine/core.py
// run_handlers :422 and the ready/periodic calls :890-918 with
// FPaxosDev.ready :128, .periodic :160 and .handle :143 of
// fantoch_tpu/engine/protocols/fpaxos.py).
//
// One warp per (lane, process), WARPS warps a block. The reference runs
// the handler as a lax.switch under vmap, which evaluates all seven
// branches (_submit, which also serves MFORWARD, _maccept, _maccepted,
// _mchosen, _mgc and a noop) and selects one; here each warp runs only its
// own branch, in the reference's order: `ready` on the incoming state,
// `periodic` (which leaves the state as it is) and `handle` on that state.
//
// 1. In place: the warp updates its process's rows of the step's own state
//    planes (and monitor planes), and only on lanes whose run predicate
//    holds at the step's start (common.cuh RunCap; every lane without a
//    cap), as the reference's vmapped while_loop keeps a frozen lane's
//    state. A frozen lane's warps write rdy false and empty outboxes
//    (valid false, zero words) and exit. Warp (l, p) reads and writes only
//    process p's rows of lane l, so no warp sees another's writes.
// 2. Every thread reads the words the gate and the outboxes need (the
//    acceptor entry MAccept is gated on, the frontier, MAccepted's
//    commander entry and count), before anything is written, and the warp
//    stores the full-row fills, thread f on row f: the periodic GC
//    broadcast of the incoming frontier, and the handler outbox cleared or,
//    for MAccepted, its MChosen fan-out. For MGC the warp frees the [D]
//    acceptor window up to the stable slot together (the gate read no
//    acceptor entry: only MAccept reads one).
// 3. After a __syncwarp, lane 0 runs the branch's state updates and its
//    single-slot outbox writes (the forward, the MAccept fan-out to the
//    write quorum, MAccepted's reply, the client report), which land after
//    the fills. Every one-hot read of the reference (oh_get) reads 0 for an
//    out-of-range index and every one-hot write (oh_set) drops it; dot
//    slots use floor modulo, as jnp's %. On a monitored step (KM > 0)
//    MChosen records its slot on monitor key 0 with source 0
//    (protocols/fpaxos.py:282-291; monitor.cuh), in place.
//
// Bound on this card: bytes. The region reads a few state words per
// (lane, process), and the [D] acceptor window only where a GC message
// is handled, and writes the words that change and two [F, P] outboxes
// (fpaxos_handle.py work). In place, this kernel moves about that.
#include "common.cuh"
#include "monitor.cuh"

using namespace fantoch;

namespace {

constexpr int WARPS = 4;  // warps a block, one a (lane, process)
constexpr int SUBMIT = 0, MFORWARD = 1, MACCEPT = 2, MACCEPTED = 3,
              MCHOSEN = 4, MGC = 5, NUM_TYPES = 6, TO_CLIENT = 7;
constexpr int ERR_DOT = 8, ERR_PROTO = 32;

// state planes, in fpaxos_handle.py STATE_KEYS order
enum Plane { LAST, CMD, CNT, ACC, EXEC, OC, SEEN, STAB, ERR, NPLANES };

struct Planes {
  void* p[NPLANES];
};

struct Outbox {
  bool* valid;
  int* dst;
  int* mtype;
  int* payload;
  int P;
  __device__ void row(int i, bool v, int d, int mt, int w0, int w1,
                      int w2) const {
    valid[i] = v;
    dst[i] = d;
    mtype[i] = mt;
    for (int j = 0; j < P; ++j)
      payload[i * P + j] = j == 0 ? w0 : (j == 1 ? w1 : (j == 2 ? w2 : 0));
  }
};

}  // namespace

__global__ void __launch_bounds__(WARPS * 32) fpaxos_handle_kernel(
    const Planes st, const RunCap cap, const bool* __restrict__ has,
    const int* __restrict__ rows, const bool* __restrict__ fire,
    const int* __restrict__ n_ctx, const int* __restrict__ leader_ctx,
    const bool* __restrict__ wq, const int* __restrict__ q_size,
    const int* __restrict__ attach, bool* __restrict__ rdy_out,
    bool* __restrict__ pv, int* __restrict__ pd, int* __restrict__ pm,
    int* __restrict__ pp, bool* __restrict__ hv, int* __restrict__ hd,
    int* __restrict__ hm, int* __restrict__ hp, const MonArgs ma, int L,
    int N, int D, int F, int P, int R, int W, int C) {
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

  int* cmd = (int*)st.p[CMD] + g * D;
  int* cnt = (int*)st.p[CNT] + g * D;
  int* acc = (int*)st.p[ACC] + g * D;
  int* oc = (int*)st.p[OC] + g * N;
  bool* seen = (bool*)st.p[SEEN] + g * N;
  const int* row = rows + g * W;
  const int src = row[PSRC];
  const int* pay = row + PPAY;
  const int n = n_ctx[l];
  const int exec = ((const int*)st.p[EXEC])[g];
  auto in_n = [&](int s) { return s >= 0 && s < N; };

  // 2. readiness gate: MAccept needs a free acceptor entry; MChosen
  // executes in slot order
  int mtype = has[g] ? row[PMT] : NUM_TYPES;
  bool rdy = true;
  if (mtype == MACCEPT)
    rdy = acc[floor_mod(pay[0] - 1, D)] == 0;
  else if (mtype == MCHOSEN)
    rdy = pay[0] == exec + 1;
  if (!(has[g] && rdy)) mtype = NUM_TYPES;
  const int branch = min(max(mtype, 0), NUM_TYPES);  // the switch's clip

  // MAccepted: on exactly f+1 accepts the slot is chosen (its commander
  // entry and count read here, before lane 0 writes them)
  const int ix = floor_mod(pay[0] - 1, D);
  const bool stale = branch == MACCEPTED && cmd[ix] != pay[0];
  const int acc_n = branch == MACCEPTED ? cnt[ix] + 1 : 0;
  const bool chosen =
      branch == MACCEPTED && !stale && acc_n == q_size[l];

  // the periodic GC broadcast of my executed frontier to all-but-me, and
  // the handler outbox's full-row fill: MAccepted's MChosen fan-out, or
  // empty rows
  const bool fire0 = fire[g * R];
  const bool fan = branch == MACCEPTED;
  for (int f = t; f < F; f += 32) {
    pv[ob + f] = f < n && f != me && fire0;
    pd[ob + f] = f;
    pm[ob + f] = MGC;
    hv[ob + f] = fan && chosen && f < n;
    hd[ob + f] = fan ? f : 0;
    hm[ob + f] = fan ? MCHOSEN : 0;
  }
  for (int i = t; i < F * P; i += 32) {
    const int j = i % P;
    pp[ob * P + i] = j == 0 ? exec : 0;
    hp[ob * P + i] = fan ? (j == 0 ? pay[0] : (j == 1 ? pay[1] : 0)) : 0;
  }

  // MGC: join the sender's frontier; the stable slot is the min over
  // all frontiers; the warp frees the acceptor entries up to it
  int freed = 0;
  if (branch == MGC) {
    bool ready = true;
    int mn = INF;
    for (int j = 0; j < N; ++j) {
      const bool s_j = j == src;
      const int oc_j = s_j ? max(oc[j], pay[0]) : oc[j];
      const bool seen_j = s_j || seen[j];
      const bool other = j < n && j != me;
      if (other && !seen_j) ready = false;
      if (other) mn = min(mn, oc_j);
    }
    const int stable = ready ? min(exec, mn) : 0;
    for (int d = t; d < D; d += 32) {
      const int a = acc[d];
      if (a > 0 && a <= stable) {
        acc[d] = 0;
        ++freed;
      }
    }
    for (int o = 16; o > 0; o >>= 1) freed += __shfl_xor_sync(FULL, freed, o);
  }
  __syncwarp();  // every read above before lane 0 writes; the fills land
  if (t != 0) return;

  // 3. the branch (lane 0): state updates and single-slot rows
  int* last_p = (int*)st.p[LAST] + g;
  int* exec_p = (int*)st.p[EXEC] + g;
  int* stab_p = (int*)st.p[STAB] + g;
  int* err_p = (int*)st.p[ERR] + g;
  int last = *last_p, ex = exec, err = *err_p;
  rdy_out[g] = rdy;
  const Outbox hob{hv + ob, hd + ob, hm + ob, hp + ob * P, P};
  switch (branch) {
    case SUBMIT:
    case MFORWARD: {  // forward, or take the next slot and fan out
      const int client = pay[0], key = pay[2], ld = leader_ctx[l];
      const bool lead = me == ld;
      const int slot = last + 1, sx = floor_mod(slot - 1, D);
      if (lead) {
        if (cmd[sx] != 0) err |= ERR_DOT;
        last = slot;
        cmd[sx] = slot;
        cnt[sx] = 0;
      }
      hob.row(0, !lead, ld, MFORWARD, client, 0, key);
      for (int q = 0; q < N; ++q)
        hob.row(1 + q, lead && wq[(long long)l * N + q] && q < n, q, MACCEPT,
                slot, client, key);
      break;
    }
    case MACCEPT: {  // store the slot, reply MAccepted to the sender
      const int slot = pay[0];
      if (acc[ix] != 0) err |= ERR_DOT;
      acc[ix] = slot;
      hob.row(0, true, src, MACCEPTED, slot, pay[1], 0);
      break;
    }
    case MACCEPTED: {  // count; on exactly f+1 choose and retire (the
                       // warp wrote the fan-out)
      if (stale) err |= ERR_PROTO;
      cnt[ix] = chosen ? 0 : acc_n;
      if (chosen) cmd[ix] = 0;
      break;
    }
    case MCHOSEN: {  // execute in order; the client's process reports
      const int slot = pay[0], client = pay[1];
      const bool in_order = slot == ex + 1;
      mon_view(ma, g).exec(0, 0, slot, in_order, false, true);
      if (!in_order) err |= ERR_PROTO;
      ex += in_order ? 1 : 0;
      const int at =
          (client >= 0 && client < C) ? attach[(long long)l * C + client] : 0;
      hob.row(0, in_order && at == me, N + client, TO_CLIENT, slot, 0, 0);
      break;
    }
    case MGC: {  // the warp freed the window above
      if (in_n(src)) {
        oc[src] = max(oc[src], pay[0]);
        seen[src] = true;
      }
      break;
    }
    default:
      break;
  }
  *last_p = last;
  *exec_p = ex;
  *stab_p += freed;
  *err_p = err;
}

extern "C" int fantoch_fpaxos_handle(
    const void* state_table, const void* cap_tab, const void* has,
    const void* rows, const void* fire, const void* n_ctx,
    const void* leader, const void* wq, const void* q_size,
    const void* attach, void* rdy_out, void* pv, void* pd, void* pm,
    void* pp, void* hv, void* hd, void* hm, void* hp, void* mon_hash,
    void* mon_cnt, void* mon_flags, int L, int N, int D, int F, int P,
    int R, int W, int C, int KM, int flags, void* stream) {
  const long long warps = (long long)L * N;
  if (warps == 0) return 0;
  Planes st;
  for (int i = 0; i < NPLANES; ++i)
    st.p[i] = ((void* const*)state_table)[i];
  const unsigned blocks = (unsigned)((warps + WARPS - 1) / WARPS);
  fpaxos_handle_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      st, run_cap((const void* const*)cap_tab, flags), (const bool*)has,
      (const int*)rows, (const bool*)fire, (const int*)n_ctx,
      (const int*)leader, (const bool*)wq, (const int*)q_size,
      (const int*)attach, (bool*)rdy_out, (bool*)pv, (int*)pd, (int*)pm,
      (int*)pp, (bool*)hv, (int*)hd, (int*)hm, (int*)hp,
      mon_args(mon_hash, mon_cnt, mon_flags, KM),
      L, N, D, F, P, R, W, C);
  return (int)cudaGetLastError();
}
