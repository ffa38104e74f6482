// K6 emit_rewrite: a step's emission tail (replaces
// fantoch_tpu/engine/core.py _lane_step section 4 :941 with
// merge_emissions :399, section 5 :1042 on the closed-loop branch with
// emitter_times :252, the fault plan's wire faults and the reorder draws,
// and the termination bookkeeping of section 7 :1494-1563 with
// fold_health :215 and fold_count :244).
//
// One block per lane. The lane's E = N * F2 emission rows of the merged
// wire batch [periodic F | handler F | requeue 1] per process (F2 = 2F + 1;
// on open-loop lanes [periodic F | handler F | stage 1 | requeue 1], F2 =
// 2F + 2) are walked in block-stride loops, so E is bounded by shared
// memory only. The block updates the lane's client planes, its histogram,
// latency sums and log, its channel counts and its timers in place, on the
// lanes whose run predicate holds at the step's start (common.cuh RunCap);
// a frozen lane's block reads none of its state, writes its rows zero and
// not valid, and its [L] lane words as they were. The lane words (steps,
// error, done time, ...) stay out of place: the run cap of every kernel of
// the step reads them. In five phases separated by block barriers:
//   0. the start-of-step client words that later phases read (issued,
//      completed) and, on open-loop lanes, each process's stage (trigger 1,
//      read from the start-of-step clients) go to shared memory, so no
//      phase reads a word that another thread has already updated;
//   1. each row reads its outbox slot (a handler's delay and src are -1;
//      the requeue row's are 1 and the popped sender) and, for a
//      TO_CLIENT row, its client and the result's arrival time (under
//      FLAG_HORIZON only a result before the horizon is delivered), and
//      folds a delivered result into its client's shared counters:
//      arrivals, the latest arrival and the last row (the largest index),
//      by shared atomics;
//   2. each client finishes its fold: completion (all of the command's
//      key parts under partial replication, core.py:1177-1182), the next
//      issue, start time, written in place;
//   3. each row decides whether it completes its client and issues the
//      next SUBMIT (the key table gives its key; partial replication sends
//      it to the target shard's connected process, core.py:1273-1279),
//      rewrites destination, type, sender, delay (FLAG_WINDOWS: the link
//      window by send time, a partition loses the row) and priority,
//      records the latency (histogram, lat_sum/lat_count by atomics, the
//      latency log) and keeps its pool row's eight header words in shared
//      memory (the send time and delay in the arrival and key words);
//   4. each row counts the earlier counted rows of its emitter to the same
//      destination (the channel rank) and takes its channel key, then
//      (FLAG_JITTER) multiplies a wire row's delay by its threefry draw,
//      (FLAG_DROPS) draws its loss verdict, writes whether it lands and
//      notes where its payload comes from (the outbox slot, the popped
//      row, or the rewritten or staged SUBMIT's three words); fired
//      timers re-arm;
//   5. pair_cnt (counted before loss) grows by the step's counted rows;
//      the rows go out as the lane's E * W words in order over the whole
//      block, consecutive threads on consecutive words, each thread with
//      CHUNKS loads in flight (with one, the move was latency bound);
//      the lane scalars are folded by block reductions, with ERR_UNAVAIL under FLAG_CRASH and the lost count
//      under the wire flags; under FLAG_MONITOR the safety monitors' step
//      fold (engine/monitor.py step_viol :199): the OR of the processes'
//      new guard bits goes into the lane's violation word, and the first
//      violating step, steps + 1, into its violation step.
// Under FLAG_REORDER every hop's delay is scaled by its row of the step's
// uniform [0, 10) draws (row 0 the TO_CLIENT return, 1 the next SUBMIT, 2
// the process send): int -> float32, a float32 product rounded to
// nearest, truncated toward zero, never contracted into a multiply-add.
// Under FLAG_OPEN_LOOP the clients are open-loop (core.py:954-1041,
// :1084-1175, :1232-1256, :1291-1297, :1376-1409): each process's stage
// row carries trigger 1 (a popped SUBMIT of command s whose window admits
// q = s + 1 stages q's SUBMIT, released at max(A(q), F(q), R(s)) by a
// delay override; its key is the command's submit number and it is never
// channel counted); phase 2 attributes completions by count (several of
// one client can land in a step), fills the ring of completion times,
// decides trigger 2 (this step's completions admit the window-blocked
// command, whose SUBMIT leaves at max(A(pend), t_c, R(pend - 1))) and
// folds trigger 1 per client into issued and the monotone release clamp;
// phase 3 records one latency per delivered result row, from the arrival
// of the command its rank among the client's rows of the step closes.
// Under FLAG_THINK (closed loop) the next SUBMIT leaves after its
// command's epoch think delay (core.py:1298-1302).
// Without a flag the kernel runs the fault-free code.
//
// Clients are clamped for every table read (the reference's gathers
// clamp), while the one-hot client masks use the raw index.
//
// Bound on this card: bytes. The region reads the outboxes' valid rows
// and a few hundred bytes of per-lane planes, and writes the rows that
// land and the words that change (emit_rewrite.py work). This kernel
// writes every row of the merged batch, landing or not (their words are
// part of its result), so it moves more than that.
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
              FLAG_MONITOR = 64, FLAG_OPEN_LOOP = 128, FLAG_THINK = 256;
// engine/monitor.py guard bits and violation bits
constexpr int MON_F_PREMATURE = 1, MON_F_KEYRANGE = 2;
constexpr int VIOL_PREMATURE = 8, VIOL_KEYRANGE = 16;
constexpr int WIRE_FLAGS = FLAG_WINDOWS | FLAG_DROPS | FLAG_JITTER;
// phase 3's per-row flag bits, read by phases 4 and 5: counted on its
// channel, a wire hop, lost to a window, issues the next SUBMIT, valid
constexpr unsigned char COUNTED = 1, WIRED = 2, LOST = 4, ISSUE = 8,
                        VALID = 16;
// phase 4's note of where a row's payload comes from: the periodic or
// handler outbox, the popped row, or the SUBMIT's words
constexpr unsigned char SRC_PER = 0, SRC_HND = 1, SRC_POP = 2, SRC_SYN = 3;
// a pool row's header words (common.cuh PA .. PPR)
constexpr int HDR = PPAY;
// the words of the rows a thread of phase 5 has in flight
constexpr int CHUNKS = 4;

struct Args {
  // outboxes (periodic, handler)
  const bool *pv, *hv;
  const int *pd, *pm, *pp, *hd, *hm, *hp;
  // the step so far
  const bool *has, *rdy, *fire;
  const int *rows, *ep, *perr;
  // the lane's client, metric, channel and timer planes (the timers
  // crash-masked under FLAG_CRASH), updated in place on running lanes
  int *issued, *completed, *start_time, *parts, *part_max;
  int *hist, *lat_sum, *lat_count, *lat_log;
  int *pair_cnt, *next_periodic;
  // the lane words the step started from
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
  // outputs: the rows, whether each lands, the new lane words
  int* new_rows;
  bool* valid;
  int *requeues_o, *max_completion_o, *done_time_o, *err_o, *steps_o;
  int* fault_dropped_o;
  // the monitors' step fold (null without FLAG_MONITOR): the handlers'
  // new guard bits [L, N], the lane's violation word and step, outputs
  const int *mon_flags, *viol, *viol_step;
  int *viol_o, *viol_step_o;
  // the open-loop client (null without FLAG_OPEN_LOOP): the arrival
  // table [C, TA]; the ring of completion times [C, WD] and the release
  // clamp [C], updated in place
  const int* ol_arrival;
  int *ol_comp_t, *ol_last_rel;
  // the traffic schedule's think delay (null without FLAG_THINK): the
  // seq → epoch index [TE] and the think delay of each epoch [EP]
  const int *seq_epoch, *think;
  RunCap cap;
  int N, F, P, C, R, RR, H, T, LOG, W, submit, S, TP, TT, flags, TA, WD, TE,
      EP;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// a process's rows of the merged wire batch
__host__ __device__ __forceinline__ int rows_per_process(int F, int flags) {
  return 2 * F + ((flags & FLAG_OPEN_LOOP) ? 2 : 1);
}

// open-loop trigger 1 of process p, per process in shared memory: whether
// it stages the SUBMIT of the next command q of client sc (its popped
// SUBMIT is command q - 1 and the window admits q), q's release time, key,
// connected process and submit delay; read from the lane state the step
// started from, before phase 2 updates it
struct Stages {
  int *on, *sc, *q, *rel, *key, *attach, *dsub;
};

__device__ __forceinline__ void ol_stage(const Args& a, const Stages& s,
                                         size_t lN, size_t lC, int p) {
  const size_t g = lN + p;
  const int* popped = a.rows + g * a.W;
  const int src = popped[PSRC], sseq = popped[PPAY + 1];
  const int sc = clampi(src - a.N, 0, a.C - 1);
  const int q = (int)((unsigned)sseq + 1u);
  const size_t kc = lC + sc;
  s.sc[p] = sc;
  s.q[p] = q;
  s.on[p] = a.has[g] && a.rdy[g] && popped[PMT] == a.submit && src >= a.N &&
            sseq == a.issued[kc] && q <= a.cmd_budget[kc] &&
            a.completed[kc] + a.WD >= q;
  // the window gate: completion #(q - W) of the ring
  const int gate =
      q > a.WD ? a.ol_comp_t[kc * a.WD + (q - a.WD - 1) % a.WD] : 0;
  s.rel[p] = max(max(a.ol_arrival[kc * a.TA + clampi(q, 0, a.TA - 1)], gate),
                 a.ol_last_rel[kc]);
  const int attach = a.client_attach[kc];
  s.attach[p] = attach;
  s.dsub[p] = a.client_delay[kc * a.N + clampi(attach, 0, a.N - 1)];
  s.key[p] = a.key_table[kc * a.T + clampi(q, 0, a.T - 1)];
}

// one merged emission row's routing as the outboxes, the stage and the
// requeue give it (its payload is moved in phase 5)
struct Row {
  int p, j;
  bool is_rq, is_stage, v;
  int dst, mt, dly, srco;
};

__device__ __forceinline__ Row load_row(const Args& a, const Stages& st,
                                        size_t lN, int e) {
  const int F = a.F, F2 = rows_per_process(F, a.flags);
  Row r;
  r.p = e / F2;
  r.j = e - r.p * F2;
  r.is_rq = r.j == F2 - 1;
  r.is_stage = (a.flags & FLAG_OPEN_LOOP) && r.j == F2 - 2;
  const size_t g = lN + r.p;
  if (r.is_stage) {
    const bool on = st.on[r.p];
    r.v = on;
    r.dst = st.attach[r.p];
    r.mt = a.submit;
    // the override puts its arrival at the release time plus the
    // client's submit delay
    r.dly = on ? st.rel[r.p] + st.dsub[r.p] - a.ep[g] : 0;
    r.srco = a.N + st.sc[r.p];
  } else if (r.is_rq) {
    const int* popped = a.rows + g * a.W;
    r.v = a.has[g] && !a.rdy[g];
    r.dst = r.p;
    r.mt = r.v ? popped[PMT] : 0;
    r.dly = 1;
    r.srco = popped[PSRC];
  } else {
    const bool per = r.j < F;
    const size_t k = g * F + (per ? r.j : r.j - F);
    r.v = per ? a.pv[k] : a.hv[k];
    r.dst = per ? a.pd[k] : a.hd[k];
    r.mt = per ? a.pm[k] : a.hm[k];
    r.dly = -1;
    r.srco = -1;
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

// up to 1,024 threads a block (one per row of wide lanes): the bound keeps
// the kernel within the registers such a block may hold
__global__ void __launch_bounds__(1024) emit_rewrite_kernel(const Args a) {
  extern __shared__ int smem[];
  const int N = a.N, F = a.F, C = a.C, W = a.W;
  const int flags = a.flags;
  const int F2 = rows_per_process(F, flags), E = N * F2;
  const int l = blockIdx.x, t = threadIdx.x, nt = blockDim.x;
  const bool open = flags & FLAG_OPEN_LOOP;

  if (!a.cap.runs(l)) {
    // frozen: zero rows, none lands, the lane words as they were
    int* out = a.new_rows + (size_t)l * E * W;
    for (size_t i = t; i < (size_t)E * W; i += nt) out[i] = 0;
    for (int e = t; e < E; e += nt) a.valid[(size_t)l * E + e] = false;
    if (t == 0) {
      a.requeues_o[l] = a.requeues[l];
      a.max_completion_o[l] = a.max_completion[l];
      a.done_time_o[l] = a.done_time[l];
      a.err_o[l] = a.err[l];
      a.steps_o[l] = a.steps[l];
      if (flags & WIRE_FLAGS) a.fault_dropped_o[l] = a.fault_dropped[l];
      if (flags & FLAG_MONITOR) {
        a.viol_o[l] = a.viol[l];
        a.viol_step_o[l] = a.viol_step[l];
      }
    }
    return;
  }

  // per row: the pool row's header words, raw client, arrival at the
  // client
  int* s_hdr = smem;
  int* s_c = s_hdr + HDR * E;
  int* s_tarr = s_c + E;
  // per row: where its payload comes from (phase 4)
  int* s_src = s_tarr + E;
  // per client: the start-of-step issued and completed counts; phase 1's
  // fold (arrivals, latest arrival, last row); last row, complete flag
  // (open loop: bit 0 a result arrived, bit 1 trigger 2), done time,
  // latency (open loop: trigger 2's release time), completed
  int* s_iss0 = s_src + E;
  int* s_cmp0 = s_iss0 + C;
  int* s_arr = s_cmp0 + C;
  int* s_pmx = s_arr + C;
  int* s_last = s_pmx + C;
  int* s_cmp = s_last + C;
  int* s_done = s_cmp + C;
  int* s_latc = s_done + C;
  int* s_ncomp = s_latc + C;
  // per process: the open-loop stage
  int* s_stage = s_ncomp + C;
  const Stages stg{s_stage,         s_stage + N,     s_stage + 2 * N,
                   s_stage + 3 * N, s_stage + 4 * N, s_stage + 5 * N,
                   s_stage + 6 * N};
  // lane folds: max completion, lost rows, error bits, guard bits
  int* s_lane = s_stage + 7 * N;
  // per row: delivered TO_CLIENT flag (phase 1), phase 3's flags, the
  // payload's source (phase 4)
  unsigned char* s_isc = reinterpret_cast<unsigned char*>(s_lane + 4);
  unsigned char* s_flag = s_isc + E;
  unsigned char* s_kind = s_flag + E;

  const size_t lN = (size_t)l * N, lC = (size_t)l * C;
  const size_t lRR = (size_t)l * a.RR;

  // phase 0: the start-of-step client words and stages
  for (int k = t; k < C; k += nt) {
    s_iss0[k] = a.issued[lC + k];
    s_cmp0[k] = a.completed[lC + k];
    s_arr[k] = 0;
    s_pmx[k] = 0;
    s_last[k] = -1;
  }
  if (open)
    for (int p = t; p < N; p += nt) ol_stage(a, stg, lN, lC, p);
  if (t == 0) {
    // a requeue row never completes, so 0 is always among the maxima
    s_lane[0] = max(a.max_completion[l], 0);
    s_lane[1] = s_lane[2] = s_lane[3] = 0;
  }
  // the step's reorder key: fold_in(reorder_key, steps)
  unsigned rk0 = 0, rk1 = 0;
  const bool reorder = flags & FLAG_REORDER;
  if (reorder) {
    rk0 = a.reorder_key[2 * l];
    rk1 = a.reorder_key[2 * l + 1];
    fold_in(rk0, rk1, (unsigned)a.steps[l]);
  }
  __syncthreads();

  // phase 1: the merged rows, their results' arrival at the client, and
  // each client's fold of its delivered results
  for (int e = t; e < E; e += nt) {
    const Row r = load_row(a, stg, lN, e);
    const int ep_e = a.ep[lN + r.p];
    const bool isc = r.v && r.dst >= N;
    const int c = isc ? r.dst - N : 0;
    const int cc = clampi(c, 0, C - 1);
    int d_back = a.client_delay[(lC + cc) * N + r.p];
    if (reorder) d_back = scaled(d_back, rk0, rk1, 0, E, e);
    const int t_arr = ep_e + d_back;
    const bool done = isc && (!(flags & FLAG_HORIZON) || t_arr < a.horizon[l]);
    s_isc[e] = done;
    s_c[e] = c;
    s_tarr[e] = t_arr;
    if (done && c < C) {
      atomicAdd(&s_arr[c], 1);
      atomicMax(&s_pmx[c], t_arr);
      atomicMax(&s_last[c], e);
    }
  }
  __syncthreads();

  // phase 2: per client, in place
  for (int k0 = t; k0 < C; k0 += nt) {
    const int arrivals = s_arr[k0], pmx = s_pmx[k0], last = s_last[k0];
    const int iss0 = s_iss0[k0], kc0 = s_cmp0[k0];
    const size_t k = lC + k0;
    if (open) {
      // count-based completions at one instant t_c = pmx, their times in
      // the ring's slots (kc0 .. kc0 + arrivals - 1) mod W
      const int ncomp = kc0 + arrivals;
      for (int w = 0; w < a.WD; ++w) {
        const int slot = ((w - kc0) % a.WD + a.WD) % a.WD;
        if (slot < arrivals) a.ol_comp_t[k * a.WD + w] = pmx;
      }
      // trigger 2: the completions admit the window-blocked command
      const int pend = iss0 + 1;
      const bool trig2 = arrivals > 0 && iss0 < a.cmd_budget[k] &&
                         ncomp + a.WD >= pend && !(kc0 + a.WD >= pend);
      const int old_rel = a.ol_last_rel[k];
      const int rel2 =
          max(max(a.ol_arrival[k * a.TA + clampi(pend, 0, a.TA - 1)], pmx),
              old_rel);
      // trigger 1 folded per client: at most one SUBMIT of a client pops
      bool staged = false;
      int rel1 = 0;
      for (int q = 0; q < N; ++q)
        if (stg.on[q] && stg.sc[q] == k0) {
          staged = true;
          rel1 += stg.rel[q];
        }
      a.ol_last_rel[k] =
          max(old_rel, staged ? rel1 : (trig2 ? rel2 : old_rel));
      a.issued[k] = iss0 + (trig2 ? 1 : 0) + (staged ? 1 : 0);
      a.completed[k] = ncomp;
      s_last[k0] = last;
      s_cmp[k0] = (arrivals > 0 ? 1 : 0) | (trig2 ? 2 : 0);
      s_done[k0] = pmx;
      s_latc[k0] = rel2;
      s_ncomp[k0] = ncomp;
      continue;
    }
    const int start = a.start_time[k];
    const int part_max = max(a.part_max[k], pmx);
    const int parts_new = a.parts[k] + arrivals;
    // a command completes when all its key parts arrived
    const int need = a.cmd_parts
        ? a.cmd_parts[k * a.TP + min(iss0, a.TP - 1)] : 1;
    const bool complete = arrivals > 0 && parts_new >= need;
    const int ncomp = kc0 + (complete ? 1 : 0);
    const bool more = iss0 < a.cmd_budget[k];
    const bool issue = last >= 0 && complete && more;
    a.completed[k] = ncomp;
    a.parts[k] = complete ? 0 : parts_new;
    a.part_max[k] = complete ? 0 : part_max;
    a.issued[k] = iss0 + (issue ? 1 : 0);
    if (issue && part_max >= 0) a.start_time[k] = part_max;
    s_last[k0] = last;
    s_cmp[k0] = complete;
    s_done[k0] = part_max;
    s_latc[k0] = part_max - start;
    s_ncomp[k0] = ncomp;
  }
  __syncthreads();

  // phase 3: completion, the next SUBMIT, the rewrite, the link windows,
  // latency records; the pool row's header in shared memory
  for (int e = t; e < E; e += nt) {
    const Row r = load_row(a, stg, lN, e);
    const size_t g = lN + r.p;
    const bool isc = r.v && r.dst >= N;
    const int c = isc ? r.dst - N : 0;
    const int cc = clampi(c, 0, C - 1);
    const size_t kc = lC + cc;
    const int iss0 = s_iss0[cc];
    const bool compl_ = isc && e == s_last[cc] && (s_cmp[cc] & 1);
    const bool issue = compl_ && (open ? (s_cmp[cc] & 2) != 0
                                       : iss0 < a.cmd_budget[kc]);
    const int next_seq = iss0 + 1;
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
    // the next SUBMIT leaves at the completion (open loop: its staged
    // release time; under a schedule after its epoch's think delay)
    int base = ep_e;
    if (issue) {
      if (open) {
        base = s_latc[cc];
      } else {
        base = s_done[cc];
        if (flags & FLAG_THINK)
          base += a.think[(size_t)l * a.EP +
                          a.seq_epoch[(size_t)l * a.TE +
                                      clampi(next_seq, 0, a.TE - 1)]];
      }
    }
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
    s_flag[e] = (v2 && !isc && !r.is_rq && !r.is_stage ? COUNTED : 0) |
                (wired ? WIRED : 0) | (lost ? LOST : 0) |
                (issue ? ISSUE : 0) | (v2 ? VALID : 0);
    if (compl_) atomicMax(&s_lane[0], s_done[cc]);
    // a latency record: on the completing row (closed loop), or on every
    // delivered result row, from the arrival of the command its rank
    // among the client's rows of the step closes (open loop)
    bool rec = compl_;
    int latency = s_latc[cc], log_src = s_cmp0[cc];
    if (open) {
      rec = s_isc[e];
      if (rec) {
        int rank = 0;
        for (int e2 = 0; e2 <= e; ++e2)
          if (s_isc[e2] && s_c[e2] == c) ++rank;
        const int k_i = s_cmp0[cc] + rank;
        latency =
            s_tarr[e] - a.ol_arrival[kc * a.TA + clampi(k_i, 0, a.TA - 1)];
        log_src = k_i - 1;
      }
    }
    if (rec) {
      const int row = a.client_region_row[kc];
      if (row >= 0 && row < a.RR) {
        atomicAdd(&a.hist[(lRR + row) * a.H + clampi(latency, 0, a.H - 1)],
                  1);
        atomicAdd(&a.lat_sum[lRR + row], latency);
        atomicAdd(&a.lat_count[lRR + row], 1);
      }
      const int li = c * a.LOG + log_src;
      if (c < C && log_src >= 0 && log_src < a.LOG && li >= 0 &&
          li < C * a.LOG)
        a.lat_log[(size_t)l * C * a.LOG + li] = latency;
    }
    int* hdr = s_hdr + HDR * e;
    hdr[PA] = base;    // phase 4 adds the delay
    hdr[PKC] = delay;  // phase 4 writes the key
    hdr[PKS] = src2;
    hdr[PSRC] = src2;
    hdr[PDST] = dst2;
    hdr[PMT] = mt2;
    hdr[PRQ] = (r.is_rq && r.v) ? a.rows[g * W + PRQ] + 1 : 0;
    hdr[PPR] = prio ? 1 : 0;
  }
  __syncthreads();

  // phase 4: channel ranks and keys, jitter and drops, the arrivals
  for (int e = t; e < E; e += nt) {
    const int p = e / F2, j = e - p * F2;
    const size_t g = lN + p;
    int* hdr = s_hdr + HDR * e;
    const int dst2 = hdr[PDST], sd = clampi(dst2, 0, N - 1);
    const unsigned char fl = s_flag[e];
    int kcnt;
    if (j == F2 - 1) {
      kcnt = a.rows[g * W + PKC];  // a requeue keeps its original key
    } else if (open && j == F2 - 2) {
      kcnt = stg.q[p];  // a staged SUBMIT: the submit number
    } else if (fl & ISSUE) {
      // a rewritten SUBMIT: the submit number
      kcnt = s_iss0[clampi(s_c[e], 0, C - 1)] + 1;
    } else {
      int rank = 0;
      for (int j2 = 0; j2 < j; ++j2) {
        const int e2 = p * F2 + j2;
        if ((s_flag[e2] & COUNTED) && s_hdr[HDR * e2 + PDST] == dst2) ++rank;
      }
      kcnt = a.pair_cnt[g * N + sd] + rank + 1;
    }
    int delay = hdr[PKC];
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
    hdr[PA] += delay;
    hdr[PKC] = kcnt;
    a.valid[(size_t)l * E + e] = v2 && !lost;
    // where phase 5 reads the payload: a rewritten or staged SUBMIT's
    // three words (in s_c, s_tarr and s_src, which no later phase reads
    // for this row), else the offset of its outbox slot or popped row
    unsigned char src;
    if (fl & ISSUE) {
      const int c = s_c[e], cc = clampi(c, 0, C - 1);
      const int next_seq = s_iss0[cc] + 1;
      src = SRC_SYN;
      s_tarr[e] = next_seq;
      s_src[e] = a.key_table[(lC + cc) * a.T + min(next_seq, a.T - 1)];
    } else if (open && j == F2 - 2) {
      src = SRC_SYN;
      s_c[e] = stg.sc[p];
      s_tarr[e] = stg.q[p];
      s_src[e] = stg.key[p];
    } else if (j == F2 - 1) {
      src = SRC_POP;
      s_src[e] = p * W + PPAY;
    } else {
      src = j < F ? SRC_PER : SRC_HND;
      s_src[e] = (p * F + (j < F ? j : j - F)) * a.P;
    }
    s_kind[e] = src;
  }
  for (int i = t; i < N * a.R; i += nt) {  // fired timers re-arm
    const size_t k = lN * a.R + i;
    if (a.fire[k])
      a.next_periodic[k] =
          a.ep[lN + i / a.R] + a.intervals[(size_t)l * a.R + i % a.R];
  }
  __syncthreads();

  // phase 5: pair_cnt[p, d] += the counted rows (phase 4 read it)
  for (int i = t; i < N * N; i += nt) {
    const int pp = i / N, d = i - pp * N;
    int n = 0;
    for (int j2 = 0; j2 < F2; ++j2) {
      const int e2 = pp * F2 + j2;
      if ((s_flag[e2] & COUNTED) && s_hdr[HDR * e2 + PDST] == d) ++n;
    }
    if (n) a.pair_cnt[lN * N + i] += n;
  }
  // the rows: the lane's E * W words in order over the whole block, each
  // thread CHUNKS words in flight (the loads first, then the stores): a
  // word of the header from shared memory, of the payload from where
  // phase 4 noted it
  {
    const int* per = a.pp + lN * F * a.P;
    const int* hnd = a.hp + lN * F * a.P;
    const int* pop = a.rows + lN * W;
    int* out = a.new_rows + (size_t)l * E * W;
    const int n = E * W, de = nt / W, dw = nt - de * W;
    int e = t / W, w = t - e * W;
    for (int i = t; i < n; i += CHUNKS * nt) {
      int v[CHUNKS];
#pragma unroll
      for (int u = 0; u < CHUNKS; ++u) {
        if (i + u * nt < n) {
          const int x = w - PPAY, src = s_kind[e];
          v[u] = w < PPAY       ? s_hdr[HDR * e + w]
               : src == SRC_SYN ? (x == 0 ? s_c[e]
                                  : x == 1 ? s_tarr[e]
                                  : x == 2 ? s_src[e] : 0)
                                : (src == SRC_PER ? per
                                   : src == SRC_HND ? hnd : pop)[s_src[e] + x];
        }
        e += de;
        w += dw;
        if (w >= W) {
          w -= W;
          ++e;
        }
      }
#pragma unroll
      for (int u = 0; u < CHUNKS; ++u)
        if (i + u * nt < n) out[i + u * nt] = v[u];
    }
  }
  // the lane folds: every live client done, requeues, stuck rows, the
  // processes' error and guard bits
  bool done_part = true;
  for (int k = t; k < C; k += nt)
    if (a.cmd_budget[lC + k] > 0 && s_ncomp[k] < a.cmd_budget[lC + k])
      done_part = false;
  bool rq = false, stuck = false;
  if (t < N) {
    rq = a.has[lN + t] && !a.rdy[lN + t];
    stuck = rq && a.rows[(lN + t) * W + PRQ] + 1 > REQUEUE_LIMIT;
    atomicOr(&s_lane[2], a.perr[lN + t]);
    if (flags & FLAG_MONITOR) atomicOr(&s_lane[3], a.mon_flags[lN + t]);
  }
  const bool all_done = __syncthreads_and(done_part);
  const int nrq = __syncthreads_count(rq);
  const bool any_stuck = __syncthreads_or(stuck);
  if (t == 0) {
    const int maxc = s_lane[0];
    const int done = a.done_time[l];
    a.max_completion_o[l] = maxc;
    a.done_time_o[l] = (done == INF && all_done) ? maxc : done;
    int err = a.err[l] | (any_stuck ? ERR_STUCK : 0) | (s_lane[2] & 0xFF);
    // crashes beyond what the protocol tolerates end the lane now
    if ((flags & FLAG_CRASH) && a.unavail[l] != 0) err |= ERR_UNAVAIL;
    a.err_o[l] = err;
    a.requeues_o[l] = a.requeues[l] + nrq;
    a.steps_o[l] = a.steps[l] + 1;
    if (flags & WIRE_FLAGS)
      a.fault_dropped_o[l] = a.fault_dropped[l] + s_lane[1];
    if (flags & FLAG_MONITOR) {
      const int mf = s_lane[3];
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
static size_t smem_bytes(int N, int F, int C, int flags) {
  const size_t E = (size_t)N * rows_per_process(F, flags);
  return ((HDR + 3) * E + 9 * (size_t)C + 7 * (size_t)N + 4) * sizeof(int) +
         3 * E;
}

// Pointer arguments in this order: the outboxes (8), the step so far (6),
// the in-place planes (11), the lane words in (6), the lane ctx (7), the
// partial tables (3), the fault planes (13), the rows and valid flags (2),
// the lane words out (6), the monitor planes (5), the open-loop planes
// (3), the think tables (2), the cap table (1).
extern "C" int fantoch_emit_rewrite(
    const void* pv, const void* pd, const void* pm, const void* pp,
    const void* hv, const void* hd, const void* hm, const void* hp,
    const void* has, const void* rdy, const void* rows, const void* ep,
    const void* fire, const void* perr, void* issued, void* completed,
    void* start_time, void* parts, void* part_max, void* hist,
    void* lat_sum, void* lat_count, void* lat_log, void* pair_cnt,
    void* next_periodic, const void* requeues, const void* max_completion,
    const void* done_time, const void* err, const void* steps,
    const void* fault_dropped, const void* client_delay,
    const void* delay_pp, const void* key_table, const void* cmd_budget,
    const void* client_attach, const void* client_region_row,
    const void* intervals, const void* cmd_parts, const void* cmd_target,
    const void* attach_s, const void* unavail, const void* horizon,
    const void* win_src, const void* win_dst, const void* win_t0,
    const void* win_t1, const void* win_mul, const void* win_ovr,
    const void* drop_num, const void* drop_key, const void* jitter_num,
    const void* jitter_key, const void* reorder_key, void* new_rows,
    void* valid, void* requeues_o, void* max_completion_o,
    void* done_time_o, void* err_o, void* steps_o, void* fault_dropped_o,
    const void* mon_flags, const void* viol, const void* viol_step,
    void* viol_o, void* viol_step_o, const void* ol_arrival,
    void* ol_comp_t, void* ol_last_rel, const void* seq_epoch,
    const void* think, const void* cap_tab, int L, int N, int F, int P,
    int C, int R, int RR, int H, int T, int LOG, int W, int submit, int S,
    int TP, int TT, int flags, int TA, int WD, int TE, int EP,
    int cap_flags, void* stream) {
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
  a.issued = (int*)issued;
  a.completed = (int*)completed;
  a.start_time = (int*)start_time;
  a.parts = (int*)parts;
  a.part_max = (int*)part_max;
  a.hist = (int*)hist;
  a.lat_sum = (int*)lat_sum;
  a.lat_count = (int*)lat_count;
  a.lat_log = (int*)lat_log;
  a.pair_cnt = (int*)pair_cnt;
  a.next_periodic = (int*)next_periodic;
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
  a.drop_key = (const unsigned*)drop_key;
  a.jitter_num = (const int*)jitter_num;
  a.jitter_key = (const unsigned*)jitter_key;
  a.reorder_key = (const unsigned*)reorder_key;
  a.new_rows = (int*)new_rows;
  a.valid = (bool*)valid;
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
  a.ol_arrival = (const int*)ol_arrival;
  a.ol_comp_t = (int*)ol_comp_t;
  a.ol_last_rel = (int*)ol_last_rel;
  a.seq_epoch = (const int*)seq_epoch;
  a.think = (const int*)think;
  a.cap = run_cap((const void* const*)cap_tab, cap_flags);
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
  a.TA = TA;
  a.WD = WD;
  a.TE = TE;
  a.EP = EP;
  const int E = N * rows_per_process(F, flags);
  const int need = std::min(1024, std::max({E, C, N * N, N * R, 32}));
  const int threads = (need + 31) / 32 * 32;
  const size_t shm = smem_bytes(N, F, C, flags);
  if (shm > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        emit_rewrite_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shm);
    if (rc != cudaSuccess) return (int)rc;
  }
  emit_rewrite_kernel<<<L, threads, shm, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
