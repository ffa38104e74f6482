// K6 emit_rewrite: a step's emission tail (replaces
// fantoch_tpu/engine/core.py _lane_step section 4 :941 with
// merge_emissions :399, section 5 :1042 on the closed-loop branch with
// emitter_times :252, the fault plan's wire faults and the reorder draws,
// and the termination bookkeeping of section 7 :1494-1563 with
// fold_health :215 and fold_count :244).
//
// One block per lane. The lane's E = N * (2F + 1) emission rows of the
// merged wire batch [periodic F | handler F | requeue 1] per process are
// walked in block-stride loops, so E is bounded by shared memory only. In
// four phases separated by block barriers:
//   1. each row reads its outbox slot (a handler's delay and src are -1;
//      the requeue row's are 1 and the popped sender) and, for a
//      TO_CLIENT row, its client and the result's arrival time (under
//      FLAG_HORIZON only a result before the horizon is delivered);
//   2. each client folds its rows: arrivals, the latest arrival, the last
//      row, completion (all of the command's key parts under partial
//      replication, core.py:1177-1182), the next issue, start time;
//   3. each row decides whether it completes its client and issues the
//      next SUBMIT (the key table gives its key; partial replication sends
//      it to the target shard's connected process, core.py:1273-1279),
//      rewrites destination, type, sender, delay (FLAG_WINDOWS: the link
//      window by send time, a partition loses the row) and priority,
//      records the latency (histogram, latency log, lat_sum/lat_count by
//      atomics) and writes its pool row but for the arrival and the key;
//   4. each row counts the earlier counted rows of its emitter to the same
//      destination (the channel rank) and takes its channel key, then
//      (FLAG_JITTER) multiplies a wire row's delay by its threefry draw,
//      (FLAG_DROPS) draws its loss verdict, and writes its arrival, key
//      and whether it lands; pair_cnt (counted before loss), the periodic
//      timers and the lane scalars are folded, with ERR_UNAVAIL under
//      FLAG_CRASH and the lost count under the wire flags; under
//      FLAG_MONITOR the safety monitors' step fold (engine/monitor.py
//      step_viol :199): the OR of the processes' new guard bits goes into
//      the lane's violation word, and the first violating step, steps + 1,
//      into its violation step.
// Under FLAG_REORDER every hop's delay is scaled by its row of the step's
// uniform [0, 10) draws (row 0 the TO_CLIENT return, 1 the next SUBMIT, 2
// the process send): int -> float32, a float32 product rounded to
// nearest, truncated toward zero, never contracted into a multiply-add.
// Without a flag the kernel runs the fault-free code. Per-row state that
// a later phase reads lives in shared memory (two flag bytes and three
// words a row); phase 3 parks a row's send time and delay in its pool
// row's arrival and key words for phase 4.
//
// Clients are clamped for every table read (the reference's gathers
// clamp), while the one-hot client masks use the raw index. The
// histogram, latency log and latency sums are copied first, then updated.
//
// Bound on this card: bytes. The region reads the outboxes' valid rows
// and a few hundred bytes of per-lane planes, and writes the rows that
// land and the words that change (emit_rewrite.py work). This kernel
// copies the [RR, H] histogram and the latency log out of place and
// writes every row, so it moves several times that.
#include <algorithm>

#include "threefry.cuh"

using namespace fantoch;

namespace {

constexpr int ERR_STUCK = 64;
constexpr int ERR_UNAVAIL = 128;
constexpr int REQUEUE_LIMIT = 1 << 13;
constexpr int MAX_WINDOWS = 8;      // engine/faults.py MAX_WINDOWS
constexpr int DROP_DENOM = 10000;   // engine/faults.py DROP_DENOM
// engine/faults.py flag bits
constexpr int FLAG_CRASH = 1, FLAG_WINDOWS = 2, FLAG_DROPS = 4,
              FLAG_HORIZON = 8, FLAG_JITTER = 16, FLAG_REORDER = 32,
              FLAG_MONITOR = 64;
// engine/monitor.py guard bits and violation bits
constexpr int MON_F_PREMATURE = 1, MON_F_KEYRANGE = 2;
constexpr int VIOL_PREMATURE = 8, VIOL_KEYRANGE = 16;
constexpr int WIRE_FLAGS = FLAG_WINDOWS | FLAG_DROPS | FLAG_JITTER;
// phase 3's per-row flag bits, read by phase 4: counted on its channel,
// a wire hop, lost to a window, issues the next SUBMIT, valid
constexpr unsigned char COUNTED = 1, WIRED = 2, LOST = 4, ISSUE = 8,
                        VALID = 16;

struct Args {
  // outboxes (periodic, handler)
  const bool *pv, *hv;
  const int *pd, *pm, *pp, *hd, *hm, *hp;
  // the step so far
  const bool *has, *rdy, *fire;
  const int *rows, *ep, *perr;
  // the lane state the step started from (crash-masked timers)
  const int *issued, *completed, *start_time, *parts, *part_max;
  const int *hist, *lat_sum, *lat_count, *lat_log;
  const int *pair_cnt, *next_periodic;
  const int *requeues, *max_completion, *done_time, *err, *steps;
  const int* fault_dropped;
  // lane ctx
  const int *client_delay, *delay_pp, *key_table, *cmd_budget;
  const int *client_attach, *client_region_row, *intervals;
  // partial replication (null on single-shard lanes): parts per command
  // [C, TP], target shard per command [C, TT], connected process per
  // shard [C, S]
  const int *cmd_parts, *cmd_target, *attach_s;
  // the fault plan and the reorder key: [L] words, [L, MAX_WINDOWS]
  // windows, [L, 2] keys
  const int *unavail, *horizon;
  const int *win_src, *win_dst, *win_t0, *win_t1, *win_mul, *win_ovr;
  const int *drop_num, *jitter_num;
  const unsigned *drop_key, *jitter_key, *reorder_key;
  // outputs
  int* new_rows;
  bool* valid;
  int *issued_o, *completed_o, *start_o, *parts_o, *part_max_o;
  int *hist_o, *lat_sum_o, *lat_count_o, *lat_log_o;
  int *pair_cnt_o, *next_periodic_o;
  int *requeues_o, *max_completion_o, *done_time_o, *err_o, *steps_o;
  int* fault_dropped_o;
  // the monitors' step fold (null without FLAG_MONITOR): the handlers'
  // new guard bits [L, N], the lane's violation word and step, outputs
  const int *mon_flags, *viol, *viol_step;
  int *viol_o, *viol_step_o;
  int N, F, P, C, R, RR, H, T, LOG, W, submit, S, TP, TT, flags;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// one merged emission row as the outboxes and the requeue give it
struct Row {
  int p, j;
  bool is_rq, v;
  int dst, mt, dly, srco;
  const int* pay;
};

__device__ __forceinline__ Row load_row(const Args& a, size_t lN, int e) {
  const int F = a.F, F2 = 2 * F + 1;
  Row r;
  r.p = e / F2;
  r.j = e % F2;
  r.is_rq = r.j == F2 - 1;
  const size_t g = lN + r.p;
  const int* popped = a.rows + g * a.W;
  if (r.is_rq) {
    r.v = a.has[g] && !a.rdy[g];
    r.dst = r.p;
    r.mt = r.v ? popped[PMT] : 0;
    r.dly = 1;
    r.srco = popped[PSRC];
    r.pay = popped + PPAY;
  } else {
    const bool per = r.j < F;
    const size_t k = g * F + (per ? r.j : r.j - F);
    r.v = per ? a.pv[k] : a.hv[k];
    r.dst = per ? a.pd[k] : a.hd[k];
    r.mt = per ? a.pm[k] : a.hm[k];
    r.dly = -1;
    r.srco = -1;
    r.pay = (per ? a.pp : a.hp) + k * a.P;
  }
  return r;
}

// (d * u).astype(int32) for the reorder multiplier of hop `hop`, row e
__device__ __forceinline__ int scaled(int d, unsigned k0, unsigned k1,
                                      int hop, int E, int e) {
  const unsigned fb =
      (bits_at(k0, k1, (unsigned)(hop * E + e)) >> 9) | 0x3F800000u;
  const float f = __fsub_rn(__uint_as_float(fb), 1.0f);
  const float u = fmaxf(0.0f, __fadd_rn(__fmul_rn(f, 10.0f), 0.0f));
  return __float2int_rz(__fmul_rn(__int2float_rn(d), u));
}

// fold_in(fold_in(fold_in(key, src), dst), kcnt): a wire draw's key
__device__ __forceinline__ void wire_key(const unsigned* key, int src,
                                         int dst, int kcnt, unsigned& k0,
                                         unsigned& k1) {
  k0 = key[0];
  k1 = key[1];
  fold_in(k0, k1, (unsigned)src);
  fold_in(k0, k1, (unsigned)dst);
  fold_in(k0, k1, (unsigned)kcnt);
}

}  // namespace

__global__ void emit_rewrite_kernel(const Args a) {
  extern __shared__ int smem[];
  const int N = a.N, F = a.F, P = a.P, C = a.C, W = a.W;
  const int F2 = 2 * F + 1, E = N * F2;
  const int l = blockIdx.x, t = threadIdx.x, nt = blockDim.x;
  const int flags = a.flags;
  // per row: raw client, arrival at the client, final destination
  int* s_c = smem;
  int* s_tarr = s_c + E;
  int* s_dst = s_tarr + E;
  // per client: last row, complete flag, done time, latency, completed
  int* s_last = s_dst + E;
  int* s_cmp = s_last + C;
  int* s_done = s_cmp + C;
  int* s_latc = s_done + C;
  int* s_ncomp = s_latc + C;
  // lane folds: max completion, lost rows
  int* s_lane = s_ncomp + C;
  // per row: delivered TO_CLIENT flag (phase 1), phase 3's flags
  unsigned char* s_isc = reinterpret_cast<unsigned char*>(s_lane + 2);
  unsigned char* s_flag = s_isc + E;

  const size_t lN = (size_t)l * N, lC = (size_t)l * C;
  const size_t lRR = (size_t)l * a.RR;

  // copy the histogram, the latency log and sums, updated in phase 3
  {
    const size_t nh = (size_t)a.RR * a.H, nl = (size_t)C * a.LOG;
    for (size_t i = t; i < nh; i += nt)
      a.hist_o[l * nh + i] = a.hist[l * nh + i];
    for (size_t i = t; i < nl; i += nt)
      a.lat_log_o[l * nl + i] = a.lat_log[l * nl + i];
    for (int i = t; i < a.RR; i += nt) {
      a.lat_sum_o[lRR + i] = a.lat_sum[lRR + i];
      a.lat_count_o[lRR + i] = a.lat_count[lRR + i];
    }
  }
  if (t == 0) {
    // a requeue row never completes, so 0 is always among the maxima
    s_lane[0] = max(a.max_completion[l], 0);
    s_lane[1] = 0;
  }
  // the step's reorder key: fold_in(reorder_key, steps)
  unsigned rk0 = 0, rk1 = 0;
  const bool reorder = flags & FLAG_REORDER;
  if (reorder) {
    rk0 = a.reorder_key[2 * l];
    rk1 = a.reorder_key[2 * l + 1];
    fold_in(rk0, rk1, (unsigned)a.steps[l]);
  }

  // phase 1: the merged rows and their results' arrival at the client
  for (int e = t; e < E; e += nt) {
    const Row r = load_row(a, lN, e);
    const int ep_e = a.ep[lN + r.p];
    const bool isc = r.v && r.dst >= N;
    const int c = isc ? r.dst - N : 0;
    const int cc = clampi(c, 0, C - 1);
    int d_back = a.client_delay[(lC + cc) * N + r.p];
    if (reorder) d_back = scaled(d_back, rk0, rk1, 0, E, e);
    const int t_arr = ep_e + d_back;
    s_isc[e] = isc && (!(flags & FLAG_HORIZON) || t_arr < a.horizon[l]);
    s_c[e] = c;
    s_tarr[e] = t_arr;
  }
  __syncthreads();

  // phase 2: per client
  for (int k0 = t; k0 < C; k0 += nt) {
    int arrivals = 0, pmx = 0, last = -1;
    for (int e = 0; e < E; ++e)
      if (s_isc[e] && s_c[e] == k0) {
        ++arrivals;
        pmx = max(pmx, s_tarr[e]);
        last = e;
      }
    const size_t k = lC + k0;
    const int part_max = max(a.part_max[k], pmx);
    const int parts_new = a.parts[k] + arrivals;
    // a command completes when all its key parts arrived
    const int need = a.cmd_parts
        ? a.cmd_parts[k * a.TP + min(a.issued[k], a.TP - 1)] : 1;
    const bool complete = arrivals > 0 && parts_new >= need;
    const int ncomp = a.completed[k] + (complete ? 1 : 0);
    const bool more = a.issued[k] < a.cmd_budget[k];
    const bool issue = last >= 0 && complete && more;
    a.completed_o[k] = ncomp;
    a.parts_o[k] = complete ? 0 : parts_new;
    a.part_max_o[k] = complete ? 0 : part_max;
    a.issued_o[k] = a.issued[k] + (issue ? 1 : 0);
    a.start_o[k] = (issue && part_max >= 0) ? part_max : a.start_time[k];
    s_last[k0] = last;
    s_cmp[k0] = complete;
    s_done[k0] = part_max;
    s_latc[k0] = part_max - a.start_time[k];
    s_ncomp[k0] = ncomp;
  }
  __syncthreads();

  // phase 3: completion, the next SUBMIT, the rewrite, the link windows,
  // latency records; the pool row but for its arrival and key
  for (int e = t; e < E; e += nt) {
    const Row r = load_row(a, lN, e);
    const size_t g = lN + r.p;
    const bool isc = r.v && r.dst >= N;
    const int c = isc ? r.dst - N : 0;
    const int cc = clampi(c, 0, C - 1);
    const size_t kc = lC + cc;
    const bool compl_ = isc && e == s_last[cc] && s_cmp[cc];
    const bool issue = compl_ && a.issued[kc] < a.cmd_budget[kc];
    const int next_seq = a.issued[kc] + 1;
    const int key = a.key_table[kc * a.T + min(next_seq, a.T - 1)];
    // the next SUBMIT goes to the connected process of the command's
    // target shard under partial replication
    const int attach = a.cmd_target
        ? a.attach_s[kc * a.S +
                     clampi(a.cmd_target[kc * a.TT + min(next_seq, a.TT - 1)],
                            0, a.S - 1)]
        : a.client_attach[kc];
    const int dst2 = issue ? attach : r.dst;
    const int mt2 = issue ? a.submit : r.mt;
    const int src2 = r.srco >= 0 ? r.srco : (isc ? N + c : r.p);
    const int ep_e = a.ep[g];
    const int base = issue ? s_done[cc] : ep_e;
    const bool overridden = r.dly >= 0;
    int delay;
    if (issue) {
      delay = a.client_delay[kc * N + clampi(attach, 0, N - 1)];
      if (reorder) delay = scaled(delay, rk0, rk1, 1, E, e);
    } else {
      delay = a.delay_pp[g * N + clampi(dst2, 0, N - 1)];
      if (reorder) delay = scaled(delay, rk0, rk1, 2, E, e);
    }
    if (overridden) delay = r.dly;
    const bool wired =
        r.v && !isc && !r.is_rq && !overridden && dst2 != r.p;
    bool lost = false;
    if ((flags & FLAG_WINDOWS) && wired) {
      // link windows by send time; windows of one pair never overlap,
      // so the masked sums select the active one
      const size_t lw = (size_t)l * MAX_WINDOWS;
      bool hit = false;
      int mul = 0, ovr = 0;
      for (int w = 0; w < MAX_WINDOWS; ++w)
        if (a.win_src[lw + w] == r.p && a.win_dst[lw + w] == dst2 &&
            a.win_t0[lw + w] <= ep_e && ep_e < a.win_t1[lw + w]) {
          hit = true;
          mul += a.win_mul[lw + w];
          ovr += a.win_ovr[lw + w];
        }
      if (hit) {
        mul = max(mul, 1);
        // mul > INF / delay is exactly delay * mul > INF
        int eff = mul > INF / max(delay, 1) ? INF : delay * mul;
        if (ovr >= 0) eff = ovr;
        lost = eff >= INF;
        if (!lost) delay = eff;
      }
    }
    const bool v2 = r.v && (!isc || issue);
    const bool prio = !isc && dst2 == r.p && !overridden;
    s_dst[e] = dst2;
    s_flag[e] = (v2 && !isc && !r.is_rq ? COUNTED : 0) |
                (wired ? WIRED : 0) | (lost ? LOST : 0) |
                (issue ? ISSUE : 0) | (v2 ? VALID : 0);
    if (compl_) {
      atomicMax(&s_lane[0], s_done[cc]);
      const int latency = s_latc[cc];
      const int row = a.client_region_row[kc];
      if (row >= 0 && row < a.RR) {
        atomicAdd(&a.hist_o[(lRR + row) * a.H +
                            clampi(latency, 0, a.H - 1)],
                  1);
        atomicAdd(&a.lat_sum_o[lRR + row], latency);
        atomicAdd(&a.lat_count_o[lRR + row], 1);
      }
      const int log_src = a.completed[kc];
      const int li = c * a.LOG + log_src;
      if (c < C && log_src < a.LOG && li >= 0 && li < C * a.LOG)
        a.lat_log_o[(size_t)l * C * a.LOG + li] = latency;
    }
    int* out = a.new_rows + ((size_t)l * E + e) * W;
    out[PA] = base;    // phase 4 adds the delay
    out[PKC] = delay;  // phase 4 writes the key
    out[PKS] = src2;
    out[PSRC] = src2;
    out[PDST] = dst2;
    out[PMT] = mt2;
    out[PRQ] = (r.is_rq && r.v) ? a.rows[g * W + PRQ] + 1 : 0;
    out[PPR] = prio ? 1 : 0;
    for (int w = 0; w < P; ++w)
      out[PPAY + w] = issue ? (w == 0 ? c : (w == 1 ? next_seq
                                                    : (w == 2 ? key : 0)))
                            : r.pay[w];
  }
  __syncthreads();

  // phase 4: channel ranks and keys, jitter and drops, the arrivals
  for (int e = t; e < E; e += nt) {
    const int p = e / F2, j = e % F2;
    const size_t g = lN + p;
    const int dst2 = s_dst[e], sd = clampi(dst2, 0, N - 1);
    const unsigned char fl = s_flag[e];
    int* out = a.new_rows + ((size_t)l * E + e) * W;
    int kcnt;
    if (j == F2 - 1) {
      kcnt = a.rows[g * W + PKC];  // a requeue keeps its original key
    } else if (fl & ISSUE) {
      kcnt = out[PPAY + 1];  // a rewritten SUBMIT: the submit number
    } else {
      int rank = 0;
      for (int j2 = 0; j2 < j; ++j2) {
        const int e2 = p * F2 + j2;
        if ((s_flag[e2] & COUNTED) && s_dst[e2] == dst2) ++rank;
      }
      kcnt = a.pair_cnt[g * N + sd] + rank + 1;
    }
    int delay = out[PKC];
    bool lost = fl & LOST;
    unsigned k0, k1;
    if ((flags & FLAG_JITTER) && (fl & WIRED)) {
      // the delay × a draw in [1, jitter_max]; past INF the row is lost
      wire_key(a.jitter_key + 2 * l, p, sd, kcnt, k0, k1);
      const int jm = randint(k0, k1, max(a.jitter_num[l], 1)) + 1;
      const int eff = jm > INF / max(delay, 1) ? INF : delay * jm;
      if (eff >= INF)
        lost = true;
      else
        delay = eff;
    }
    if ((flags & FLAG_DROPS) && (fl & WIRED)) {
      wire_key(a.drop_key + 2 * l, p, sd, kcnt, k0, k1);
      if (randint(k0, k1, DROP_DENOM) < a.drop_num[l]) lost = true;
    }
    const bool v2 = fl & VALID;
    if (v2 && lost) atomicAdd(&s_lane[1], 1);
    out[PA] += delay;
    out[PKC] = kcnt;
    a.valid[(size_t)l * E + e] = v2 && !lost;
  }
  for (int i = t; i < N * N; i += nt) {  // pair_cnt[p, d] += counted rows
    const int pp = i / N, d = i % N;
    int n = 0;
    for (int j2 = 0; j2 < F2; ++j2) {
      const int e2 = pp * F2 + j2;
      if ((s_flag[e2] & COUNTED) && s_dst[e2] == d) ++n;
    }
    a.pair_cnt_o[lN * N + i] = a.pair_cnt[lN * N + i] + n;
  }
  for (int i = t; i < N * a.R; i += nt) {  // fired timers re-arm
    const int pp = i / a.R, r = i % a.R;
    const size_t k = lN * a.R + i;
    a.next_periodic_o[k] = a.fire[k]
        ? a.ep[lN + pp] + a.intervals[(size_t)l * a.R + r]
        : a.next_periodic[k];
  }
  __syncthreads();
  if (t == 0) {
    bool stuck = false, all_done = true;
    int nrq = 0, perr = 0;
    for (int q = 0; q < N; ++q) {
      const bool rq = a.has[lN + q] && !a.rdy[lN + q];
      nrq += rq ? 1 : 0;
      if (rq && a.rows[(lN + q) * W + PRQ] + 1 > REQUEUE_LIMIT) stuck = true;
      perr |= a.perr[lN + q];
    }
    for (int k = 0; k < C; ++k)
      if (a.cmd_budget[lC + k] > 0 && s_ncomp[k] < a.cmd_budget[lC + k])
        all_done = false;
    const int maxc = s_lane[0];
    const int done = a.done_time[l];
    a.max_completion_o[l] = maxc;
    a.done_time_o[l] = (done == INF && all_done) ? maxc : done;
    int err = a.err[l] | (stuck ? ERR_STUCK : 0) | (perr & 0xFF);
    // crashes beyond what the protocol tolerates end the lane now
    if ((flags & FLAG_CRASH) && a.unavail[l] != 0) err |= ERR_UNAVAIL;
    a.err_o[l] = err;
    a.requeues_o[l] = a.requeues[l] + nrq;
    a.steps_o[l] = a.steps[l] + 1;
    if (flags & WIRE_FLAGS)
      a.fault_dropped_o[l] = a.fault_dropped[l] + s_lane[1];
    if (flags & FLAG_MONITOR) {
      int mf = 0;
      for (int q = 0; q < N; ++q) mf |= a.mon_flags[lN + q];
      const int viol = a.viol[l] |
                       ((mf & MON_F_PREMATURE) ? VIOL_PREMATURE : 0) |
                       ((mf & MON_F_KEYRANGE) ? VIOL_KEYRANGE : 0);
      a.viol_o[l] = viol;
      a.viol_step_o[l] = (viol != 0 && a.viol_step[l] >= INF)
                             ? a.steps[l] + 1
                             : a.viol_step[l];
    }
  }
}

// The shared memory one lane's block needs (emit_rewrite.py smem_bytes).
static size_t smem_bytes(int N, int F, int C) {
  const size_t E = (size_t)N * (2 * F + 1);
  return (3 * E + 5 * C + 2) * sizeof(int) + 2 * E;
}

extern "C" int fantoch_emit_rewrite(
    const void* pv, const void* pd, const void* pm, const void* pp,
    const void* hv, const void* hd, const void* hm, const void* hp,
    const void* has, const void* rdy, const void* rows, const void* ep,
    const void* fire, const void* perr, const void* issued,
    const void* completed, const void* start_time, const void* parts,
    const void* part_max, const void* hist, const void* lat_sum,
    const void* lat_count, const void* lat_log, const void* pair_cnt,
    const void* next_periodic, const void* requeues,
    const void* max_completion, const void* done_time, const void* err,
    const void* steps, const void* client_delay, const void* delay_pp,
    const void* key_table, const void* cmd_budget, const void* client_attach,
    const void* client_region_row, const void* intervals,
    const void* cmd_parts, const void* cmd_target, const void* attach_s,
    void* new_rows,
    void* valid, void* issued_o, void* completed_o, void* start_o,
    void* parts_o, void* part_max_o, void* hist_o, void* lat_sum_o,
    void* lat_count_o, void* lat_log_o, void* pair_cnt_o,
    void* next_periodic_o, void* requeues_o, void* max_completion_o,
    void* done_time_o, void* err_o, void* steps_o, const void* fault_dropped,
    const void* unavail, const void* horizon, const void* win_src,
    const void* win_dst, const void* win_t0, const void* win_t1,
    const void* win_mul, const void* win_ovr, const void* drop_num,
    const void* drop_key, const void* jitter_num, const void* jitter_key,
    const void* reorder_key, void* fault_dropped_o, const void* mon_flags,
    const void* viol, const void* viol_step, void* viol_o,
    void* viol_step_o, int L, int N, int F,
    int P, int C, int R, int RR, int H, int T, int LOG, int W, int submit,
    int S, int TP, int TT, int flags, void* stream) {
  if (L == 0) return 0;
  Args a;
  a.pv = (const bool*)pv;
  a.pd = (const int*)pd;
  a.pm = (const int*)pm;
  a.pp = (const int*)pp;
  a.hv = (const bool*)hv;
  a.hd = (const int*)hd;
  a.hm = (const int*)hm;
  a.hp = (const int*)hp;
  a.has = (const bool*)has;
  a.rdy = (const bool*)rdy;
  a.rows = (const int*)rows;
  a.ep = (const int*)ep;
  a.fire = (const bool*)fire;
  a.perr = (const int*)perr;
  a.issued = (const int*)issued;
  a.completed = (const int*)completed;
  a.start_time = (const int*)start_time;
  a.parts = (const int*)parts;
  a.part_max = (const int*)part_max;
  a.hist = (const int*)hist;
  a.lat_sum = (const int*)lat_sum;
  a.lat_count = (const int*)lat_count;
  a.lat_log = (const int*)lat_log;
  a.pair_cnt = (const int*)pair_cnt;
  a.next_periodic = (const int*)next_periodic;
  a.requeues = (const int*)requeues;
  a.max_completion = (const int*)max_completion;
  a.done_time = (const int*)done_time;
  a.err = (const int*)err;
  a.steps = (const int*)steps;
  a.fault_dropped = (const int*)fault_dropped;
  a.client_delay = (const int*)client_delay;
  a.delay_pp = (const int*)delay_pp;
  a.key_table = (const int*)key_table;
  a.cmd_budget = (const int*)cmd_budget;
  a.client_attach = (const int*)client_attach;
  a.client_region_row = (const int*)client_region_row;
  a.intervals = (const int*)intervals;
  a.cmd_parts = (const int*)cmd_parts;
  a.cmd_target = (const int*)cmd_target;
  a.attach_s = (const int*)attach_s;
  a.unavail = (const int*)unavail;
  a.horizon = (const int*)horizon;
  a.win_src = (const int*)win_src;
  a.win_dst = (const int*)win_dst;
  a.win_t0 = (const int*)win_t0;
  a.win_t1 = (const int*)win_t1;
  a.win_mul = (const int*)win_mul;
  a.win_ovr = (const int*)win_ovr;
  a.drop_num = (const int*)drop_num;
  a.jitter_num = (const int*)jitter_num;
  a.drop_key = (const unsigned*)drop_key;
  a.jitter_key = (const unsigned*)jitter_key;
  a.reorder_key = (const unsigned*)reorder_key;
  a.new_rows = (int*)new_rows;
  a.valid = (bool*)valid;
  a.issued_o = (int*)issued_o;
  a.completed_o = (int*)completed_o;
  a.start_o = (int*)start_o;
  a.parts_o = (int*)parts_o;
  a.part_max_o = (int*)part_max_o;
  a.hist_o = (int*)hist_o;
  a.lat_sum_o = (int*)lat_sum_o;
  a.lat_count_o = (int*)lat_count_o;
  a.lat_log_o = (int*)lat_log_o;
  a.pair_cnt_o = (int*)pair_cnt_o;
  a.next_periodic_o = (int*)next_periodic_o;
  a.requeues_o = (int*)requeues_o;
  a.max_completion_o = (int*)max_completion_o;
  a.done_time_o = (int*)done_time_o;
  a.err_o = (int*)err_o;
  a.steps_o = (int*)steps_o;
  a.fault_dropped_o = (int*)fault_dropped_o;
  a.mon_flags = (const int*)mon_flags;
  a.viol = (const int*)viol;
  a.viol_step = (const int*)viol_step;
  a.viol_o = (int*)viol_o;
  a.viol_step_o = (int*)viol_step_o;
  a.N = N;
  a.F = F;
  a.P = P;
  a.C = C;
  a.R = R;
  a.RR = RR;
  a.H = H;
  a.T = T;
  a.LOG = LOG;
  a.W = W;
  a.submit = submit;
  a.S = S;
  a.TP = TP;
  a.TT = TT;
  a.flags = flags;
  const int E = N * (2 * F + 1);
  const int need = std::min(1024, std::max({E, C, N * N, RR, N * R, 32}));
  const int threads = (need + 31) / 32 * 32;
  const size_t shm = smem_bytes(N, F, C);
  if (shm > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        emit_rewrite_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shm);
    if (rc != cudaSuccess) return (int)rc;
  }
  emit_rewrite_kernel<<<L, threads, shm, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
