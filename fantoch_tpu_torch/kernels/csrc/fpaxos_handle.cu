// K5 fpaxos_handle: FPaxos's readiness gate, periodic timer and message
// handler for every (lane, process) (replaces fantoch_tpu/engine/core.py
// run_handlers :422 and the ready/periodic calls :890-918 with
// FPaxosDev.ready :128, .periodic :160 and .handle :143 of
// fantoch_tpu/engine/protocols/fpaxos.py).
//
// One warp per (lane, process). The reference runs the handler as a
// lax.switch under vmap, which evaluates all seven branches (_submit,
// which also serves MFORWARD, _maccept, _maccepted, _mchosen, _mgc and a
// noop) and selects one; here each warp runs only its own branch, in the
// reference's order: `ready` on the incoming state, `periodic` (which
// leaves the state as it is) and `handle` on that state. The warp first
// copies its process's state to the output tensors, its 32 threads on
// neighbouring words of the three [D] window planes; lane 0 then runs the
// branch and writes both [F] outboxes whole, and for MGC the warp scans
// the [D] acceptor window together. Every one-hot read of the reference
// (oh_get) reads 0 for an out-of-range index and every one-hot write
// (oh_set) drops it; dot slots use floor modulo, as jnp's %. On a
// monitored step (KM > 0) the warp copies the monitor rows with the state
// and MChosen records its slot on monitor key 0 with source 0
// (protocols/fpaxos.py:282-291; monitor.cuh).
//
// Bound on this card: bytes. The region reads a few state words per
// (lane, process), and the [D] acceptor window only where a GC message
// is handled, and writes the words that change and two [F, P] outboxes
// (fpaxos_handle.py work). This kernel copies each process's whole state
// out of place, so it moves far more than that, but in coalesced rows.
#include "common.cuh"
#include "monitor.cuh"

using namespace fantoch;

namespace {

constexpr int SUBMIT = 0, MFORWARD = 1, MACCEPT = 2, MACCEPTED = 3,
              MCHOSEN = 4, MGC = 5, NUM_TYPES = 6, TO_CLIENT = 7;
constexpr int ERR_DOT = 8, ERR_PROTO = 32;

struct Outbox {
  bool* valid;
  int* dst;
  int* mtype;
  int* payload;
  int F, P;
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

__global__ void fpaxos_handle_kernel(
    // incoming per-process state
    const int* __restrict__ last_in, const int* __restrict__ cmd_in,
    const int* __restrict__ cnt_in, const int* __restrict__ acc_in,
    const int* __restrict__ exec_in, const int* __restrict__ oc_in,
    const bool* __restrict__ seen_in, const int* __restrict__ stab_in,
    const int* __restrict__ err_in,
    // popped message, timers, lane ctx
    const bool* __restrict__ has, const int* __restrict__ rows,
    const bool* __restrict__ fire, const int* __restrict__ n_ctx,
    const int* __restrict__ leader_ctx, const bool* __restrict__ wq,
    const int* __restrict__ q_size, const int* __restrict__ attach,
    // outputs
    bool* __restrict__ rdy_out, int* __restrict__ last_o,
    int* __restrict__ cmd_o, int* __restrict__ cnt_o,
    int* __restrict__ acc_o, int* __restrict__ exec_o,
    int* __restrict__ oc_o, bool* __restrict__ seen_o,
    int* __restrict__ stab_o, int* __restrict__ err_o,
    bool* __restrict__ pv, int* __restrict__ pd, int* __restrict__ pm,
    int* __restrict__ pp, bool* __restrict__ hv, int* __restrict__ hd,
    int* __restrict__ hm, int* __restrict__ hp, const MonArgs ma, int L,
    int N, int D, int F, int P, int R, int W, int C) {
  const int g = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (g >= L * N) return;  // whole warps: blockDim is a multiple of 32
  const int l = g / N, me = g % N;

  // copy this process's state (the warp on neighbouring words)
  const size_t oD = (size_t)g * D, oN = (size_t)g * N;
  for (int i = lane; i < D; i += 32) {
    cmd_o[oD + i] = cmd_in[oD + i];
    cnt_o[oD + i] = cnt_in[oD + i];
    acc_o[oD + i] = acc_in[oD + i];
  }
  for (int i = lane; i < N; i += 32) {
    oc_o[oN + i] = oc_in[oN + i];
    seen_o[oN + i] = seen_in[oN + i];
  }
  mon_copy(ma, g, lane, 32);
  __syncwarp();

  const int* row = rows + (size_t)g * W;
  const int src = row[PSRC];
  const int* pay = row + PPAY;
  const int n = n_ctx[l];
  int exec = exec_in[g];
  auto in_n = [&](int s) { return s >= 0 && s < N; };

  // readiness gate: MAccept needs a free acceptor entry; MChosen
  // executes in slot order
  int mtype = has[g] ? row[PMT] : NUM_TYPES;
  bool rdy = true;
  if (mtype == MACCEPT)
    rdy = acc_in[oD + floor_mod(pay[0] - 1, D)] == 0;
  else if (mtype == MCHOSEN)
    rdy = pay[0] == exec + 1;
  if (!(has[g] && rdy)) mtype = NUM_TYPES;
  const int branch = min(max(mtype, 0), NUM_TYPES);  // the switch's clip

  // MGC: join the sender's frontier; the stable slot is the min over
  // all frontiers; the warp frees the acceptor entries up to it
  int freed = 0;
  if (branch == MGC) {
    bool ready = true;
    int mn = INF;
    for (int j = 0; j < N; ++j) {
      const bool s_j = j == src;
      const int oc_j = s_j ? max(oc_in[oN + j], pay[0]) : oc_in[oN + j];
      const bool seen_j = s_j || seen_in[oN + j];
      const bool other = j < n && j != me;
      if (other && !seen_j) ready = false;
      if (other) mn = min(mn, oc_j);
    }
    const int stable = ready ? min(exec, mn) : 0;
    for (int d = lane; d < D; d += 32) {
      const int a = acc_o[oD + d];
      if (a > 0 && a <= stable) {
        acc_o[oD + d] = 0;
        ++freed;
      }
    }
    for (int o = 16; o > 0; o >>= 1) freed += __shfl_xor_sync(FULL, freed, o);
  }
  if (lane != 0) return;

  rdy_out[g] = rdy;
  int last = last_in[g], stab = stab_in[g] + freed, err = err_in[g];
  int* cmd = cmd_o + oD;
  int* cnt = cnt_o + oD;
  int* acc = acc_o + oD;
  const Outbox pob{pv + (size_t)g * F, pd + (size_t)g * F,
                   pm + (size_t)g * F, pp + (size_t)g * F * P, F, P};
  const Outbox hob{hv + (size_t)g * F, hd + (size_t)g * F,
                   hm + (size_t)g * F, hp + (size_t)g * F * P, F, P};

  // periodic GC: broadcast my executed frontier to all-but-me
  const bool fire0 = fire[(size_t)g * R];
  for (int f = 0; f < F; ++f)
    pob.row(f, f < n && f != me && fire0, f, MGC, exec, 0, 0);

  for (int f = 0; f < F; ++f) hob.row(f, false, 0, 0, 0, 0, 0);
  switch (branch) {
    case SUBMIT:
    case MFORWARD: {  // forward, or take the next slot and fan out
      const int client = pay[0], key = pay[2], ld = leader_ctx[l];
      const bool lead = me == ld;
      const int slot = last + 1, ix = floor_mod(slot - 1, D);
      if (lead) {
        if (cmd[ix] != 0) err |= ERR_DOT;
        last = slot;
        cmd[ix] = slot;
        cnt[ix] = 0;
      }
      hob.row(0, !lead, ld, MFORWARD, client, 0, key);
      for (int q = 0; q < N; ++q)
        hob.row(1 + q, lead && wq[(size_t)l * N + q] && q < n, q, MACCEPT,
                slot, client, key);
      break;
    }
    case MACCEPT: {  // store the slot, reply MAccepted to the sender
      const int slot = pay[0], ix = floor_mod(slot - 1, D);
      if (acc[ix] != 0) err |= ERR_DOT;
      acc[ix] = slot;
      hob.row(0, true, src, MACCEPTED, slot, pay[1], 0);
      break;
    }
    case MACCEPTED: {  // count; on exactly f+1 choose and retire
      const int slot = pay[0], ix = floor_mod(slot - 1, D);
      const bool stale = cmd[ix] != slot;
      const int c = cnt[ix] + 1;
      const bool chosen = !stale && c == q_size[l];
      if (stale) err |= ERR_PROTO;
      cnt[ix] = chosen ? 0 : c;
      if (chosen) cmd[ix] = 0;
      for (int f = 0; f < F; ++f)
        hob.row(f, f < n && chosen, f, MCHOSEN, slot, pay[1], 0);
      break;
    }
    case MCHOSEN: {  // execute in order; the client's process reports
      const int slot = pay[0], client = pay[1];
      const bool in_order = slot == exec + 1;
      mon_view(ma, g).exec(0, 0, slot, in_order, false, true);
      if (!in_order) err |= ERR_PROTO;
      exec += in_order ? 1 : 0;
      const int at =
          (client >= 0 && client < C) ? attach[(size_t)l * C + client] : 0;
      hob.row(0, in_order && at == me, N + client, TO_CLIENT, slot, 0, 0);
      break;
    }
    case MGC: {  // the warp freed the window above
      if (in_n(src)) {
        oc_o[oN + src] = max(oc_in[oN + src], pay[0]);
        seen_o[oN + src] = true;
      }
      break;
    }
    default:
      break;
  }
  last_o[g] = last;
  exec_o[g] = exec;
  stab_o[g] = stab;
  err_o[g] = err;
}

extern "C" int fantoch_fpaxos_handle(
    const void* last_in, const void* cmd_in, const void* cnt_in,
    const void* acc_in, const void* exec_in, const void* oc_in,
    const void* seen_in, const void* stab_in, const void* err_in,
    const void* has, const void* rows, const void* fire, const void* n_ctx,
    const void* leader, const void* wq, const void* q_size,
    const void* attach, void* rdy_out, void* last_o, void* cmd_o,
    void* cnt_o, void* acc_o, void* exec_o, void* oc_o, void* seen_o,
    void* stab_o, void* err_o, void* pv, void* pd, void* pm, void* pp,
    void* hv, void* hd, void* hm, void* hp, const void* mh_in,
    const void* mc_in, const void* mf_in, void* mh_o, void* mc_o,
    void* mf_o, int L, int N, int D, int F, int P, int R, int W, int C,
    int KM, void* stream) {
  const long long warps = (long long)L * N;
  if (warps == 0) return 0;
  const int threads = 128;  // four (lane, process) warps per block
  const int blocks = (int)((warps * 32 + threads - 1) / threads);
  fpaxos_handle_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)last_in, (const int*)cmd_in, (const int*)cnt_in,
      (const int*)acc_in, (const int*)exec_in, (const int*)oc_in,
      (const bool*)seen_in, (const int*)stab_in, (const int*)err_in,
      (const bool*)has, (const int*)rows, (const bool*)fire,
      (const int*)n_ctx, (const int*)leader, (const bool*)wq,
      (const int*)q_size, (const int*)attach, (bool*)rdy_out, (int*)last_o,
      (int*)cmd_o, (int*)cnt_o, (int*)acc_o, (int*)exec_o, (int*)oc_o,
      (bool*)seen_o, (int*)stab_o, (int*)err_o, (bool*)pv, (int*)pd,
      (int*)pm, (int*)pp, (bool*)hv, (int*)hd, (int*)hm, (int*)hp,
      mon_args(mh_in, mc_in, mf_in, mh_o, mc_o, mf_o, KM), L, N, D, F, P, R,
      W, C);
  return (int)cudaGetLastError();
}
