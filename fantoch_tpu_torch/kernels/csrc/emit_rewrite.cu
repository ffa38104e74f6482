// K6 emit_rewrite: a step's emission tail (replaces
// fantoch_tpu/engine/core.py _lane_step section 4 :941 with
// merge_emissions :399, section 5 :1042 on the closed-loop, fault-free,
// no-reorder branch with emitter_times :252, and the termination
// bookkeeping of section 7 :1494-1563 with fold_health :215 and
// fold_count :244).
//
// One block per lane; thread e < E = N * (2F + 1) owns emission row e of
// the merged wire batch [periodic F | handler F | requeue 1] per process.
// In four phases separated by block barriers:
//   1. each row reads its outbox slot (a handler's delay and src are -1;
//      the requeue row's are 1 and the popped sender) and, for a
//      TO_CLIENT row, its client and the result's arrival time;
//   2. thread c < C folds its client's rows: arrivals, the latest
//      arrival, the last row, completion (all of the command's key parts
//      under partial replication, core.py:1177-1182), the next issue,
//      start time;
//   3. each row decides whether it completes its client and issues the
//      next SUBMIT (the key table gives its key; partial replication sends
//      it to the target shard's connected process, core.py:1273-1279),
//      rewrites destination,
//      type, sender, delay and priority, and records the latency in the
//      histogram and the latency log;
//   4. each row counts the earlier counted rows of its emitter to the
//      same destination (the channel rank), takes its channel key and
//      writes its pool row; threads fold pair_cnt, lat_sum/lat_count, the
//      periodic timers and the lane scalars.
// Clients are clamped for every table read (the reference's gathers
// clamp), while the one-hot client masks use the raw index. The
// histogram and latency log are copied whole first, then updated.
//
// Bound on this card: bytes. The region reads the outboxes' valid rows
// and a few hundred bytes of per-lane planes, and writes the rows that
// land and the words that change (emit_rewrite.py work). This kernel
// copies the [RR, H] histogram and the latency log out of place and
// writes every row, so it moves several times that.
#include <algorithm>

#include "common.cuh"

using namespace fantoch;

namespace {

constexpr int ERR_STUCK = 64;
constexpr int REQUEUE_LIMIT = 1 << 13;

struct Args {
  // outboxes (periodic, handler)
  const bool *pv, *hv;
  const int *pd, *pm, *pp, *hd, *hm, *hp;
  // the step so far
  const bool *has, *rdy, *fire;
  const int *rows, *ep, *perr;
  // the lane state the step started from
  const int *issued, *completed, *start_time, *parts, *part_max;
  const int *hist, *lat_sum, *lat_count, *lat_log;
  const int *pair_cnt, *next_periodic;
  const int *requeues, *max_completion, *done_time, *err, *steps;
  // lane ctx
  const int *client_delay, *delay_pp, *key_table, *cmd_budget;
  const int *client_attach, *client_region_row, *intervals;
  // partial replication (null on single-shard lanes): parts per command
  // [C, TP], target shard per command [C, TT], connected process per
  // shard [C, S]
  const int *cmd_parts, *cmd_target, *attach_s;
  // outputs
  int* new_rows;
  bool* valid;
  int *issued_o, *completed_o, *start_o, *parts_o, *part_max_o;
  int *hist_o, *lat_sum_o, *lat_count_o, *lat_log_o;
  int *pair_cnt_o, *next_periodic_o;
  int *requeues_o, *max_completion_o, *done_time_o, *err_o, *steps_o;
  int N, F, P, C, R, RR, H, T, LOG, W, submit, S, TP, TT;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

}  // namespace

__global__ void emit_rewrite_kernel(const Args a) {
  extern __shared__ int smem[];
  const int N = a.N, F = a.F, P = a.P, C = a.C, W = a.W;
  const int F2 = 2 * F + 1, E = N * F2;
  const int l = blockIdx.x, t = threadIdx.x, nt = blockDim.x;
  // per row: client flag, raw client, arrival at the client, final
  // destination, counted flag, completion time, region row, latency
  int* s_isc = smem;
  int* s_c = s_isc + E;
  int* s_tarr = s_c + E;
  int* s_dst = s_tarr + E;
  int* s_cnt = s_dst + E;
  int* s_ct = s_cnt + E;
  int* s_row = s_ct + E;
  int* s_lat = s_row + E;
  // per client: last row, complete flag, done time, latency, completed
  int* s_last = s_lat + E;
  int* s_cmp = s_last + C;
  int* s_done = s_cmp + C;
  int* s_latc = s_done + C;
  int* s_ncomp = s_latc + C;

  const size_t lN = (size_t)l * N, lC = (size_t)l * C;

  // copy the histogram and the latency log, updated in phase 3
  {
    const size_t nh = (size_t)a.RR * a.H, nl = (size_t)C * a.LOG;
    for (size_t i = t; i < nh; i += nt)
      a.hist_o[l * nh + i] = a.hist[l * nh + i];
    for (size_t i = t; i < nl; i += nt)
      a.lat_log_o[l * nl + i] = a.lat_log[l * nl + i];
  }

  // phase 1: the merged row
  const bool row_t = t < E;
  const int p = row_t ? t / F2 : 0, j = row_t ? t % F2 : 0;
  const size_t g = lN + p;
  const int* popped = a.rows + g * W;
  const bool is_rq = j == F2 - 1;
  bool v = false;
  int dst = 0, mt = 0, dly = -1, srco = -1;
  const int* pay = popped + PPAY;
  int isc = 0, c = 0, cc = 0, ep_e = 0;
  if (row_t) {
    if (is_rq) {
      v = a.has[g] && !a.rdy[g];
      dst = p;
      mt = v ? popped[PMT] : 0;
      dly = 1;
      srco = popped[PSRC];
    } else {
      const bool per = j < F;
      const size_t k = g * F + (per ? j : j - F);
      v = per ? a.pv[k] : a.hv[k];
      dst = per ? a.pd[k] : a.hd[k];
      mt = per ? a.pm[k] : a.hm[k];
      pay = (per ? a.pp : a.hp) + k * P;
    }
    ep_e = a.ep[g];
    isc = v && dst >= N;
    c = isc ? dst - N : 0;
    cc = clampi(c, 0, C - 1);
    s_isc[t] = isc;
    s_c[t] = c;
    s_tarr[t] = ep_e + a.client_delay[(lC + cc) * N + p];
  }
  __syncthreads();

  // phase 2: per client
  if (t < C) {
    int arrivals = 0, pmx = 0, last = -1;
    for (int e = 0; e < E; ++e)
      if (s_isc[e] && s_c[e] == t) {
        ++arrivals;
        pmx = max(pmx, s_tarr[e]);
        last = e;
      }
    const size_t k = lC + t;
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
    s_last[t] = last;
    s_cmp[t] = complete;
    s_done[t] = part_max;
    s_latc[t] = part_max - a.start_time[k];
    s_ncomp[t] = ncomp;
  }
  __syncthreads();

  // phase 3: completion, the next SUBMIT, the rewrite, latency records
  bool v2 = false, issue = false, prio = false;
  int dst2 = 0, mt2 = 0, src2 = 0, arr = 0, next_seq = 0, key = 0;
  if (row_t) {
    const bool compl_ = isc && t == s_last[cc] && s_cmp[cc];
    const size_t kc = lC + cc;
    issue = compl_ && a.issued[kc] < a.cmd_budget[kc];
    next_seq = a.issued[kc] + 1;
    key = a.key_table[kc * a.T + min(next_seq, a.T - 1)];
    // the next SUBMIT goes to the connected process of the command's
    // target shard under partial replication
    const int attach = a.cmd_target
        ? a.attach_s[kc * a.S +
                     clampi(a.cmd_target[kc * a.TT + min(next_seq, a.TT - 1)],
                            0, a.S - 1)]
        : a.client_attach[kc];
    dst2 = issue ? attach : dst;
    mt2 = issue ? a.submit : mt;
    src2 = isc ? N + c : p;
    if (srco >= 0) src2 = srco;
    const int base = issue ? s_done[cc] : ep_e;
    const bool overridden = dly >= 0;
    int delay = issue
        ? a.client_delay[kc * N + clampi(attach, 0, N - 1)]
        : a.delay_pp[(g * N) + clampi(dst2, 0, N - 1)];
    if (overridden) delay = dly;
    v2 = v && (!isc || issue);
    arr = base + delay;
    prio = !isc && dst2 == p && !overridden;
    s_dst[t] = dst2;
    s_cnt[t] = v2 && !isc && !is_rq;
    s_ct[t] = compl_ ? s_done[cc] : 0;
    const int latency = s_latc[cc];
    const int row = compl_ ? a.client_region_row[kc] : a.RR;
    s_row[t] = row;
    s_lat[t] = latency;
    if (row >= 0 && row < a.RR)
      atomicAdd(&a.hist_o[((size_t)l * a.RR + row) * a.H +
                          clampi(latency, 0, a.H - 1)],
                1);
    const int log_src = a.completed[kc];
    const int li = c * a.LOG + log_src;
    if (compl_ && c < C && log_src < a.LOG && li >= 0 && li < C * a.LOG)
      a.lat_log_o[(size_t)l * C * a.LOG + li] = latency;
  }
  __syncthreads();

  // phase 4: channel ranks and keys, the pool rows; lane folds
  if (row_t) {
    int rank = 0;
    for (int j2 = 0; j2 < j; ++j2) {
      const int e2 = p * F2 + j2;
      if (s_cnt[e2] && s_dst[e2] == dst2) ++rank;
    }
    int kcnt = issue ? next_seq
                     : a.pair_cnt[g * N + clampi(dst2, 0, N - 1)] + rank + 1;
    int rq_arr = 0;
    if (is_rq) {
      kcnt = popped[PKC];
      rq_arr = v ? popped[PRQ] + 1 : 0;
    }
    int* out = a.new_rows + ((size_t)l * E + t) * W;
    out[PA] = arr;
    out[PKS] = src2;
    out[PKC] = kcnt;
    out[PSRC] = src2;
    out[PDST] = dst2;
    out[PMT] = mt2;
    out[PRQ] = rq_arr;
    out[PPR] = prio ? 1 : 0;
    for (int w = 0; w < P; ++w)
      out[PPAY + w] = issue ? (w == 0 ? c : (w == 1 ? next_seq
                                                    : (w == 2 ? key : 0)))
                            : pay[w];
    a.valid[(size_t)l * E + t] = v2;
  }
  if (t < N * N) {  // pair_cnt[p, d] += counted rows of p to d
    const int pp = t / N, d = t % N;
    int n = 0;
    for (int j2 = 0; j2 < F2; ++j2) {
      const int e2 = pp * F2 + j2;
      if (s_cnt[e2] && s_dst[e2] == d) ++n;
    }
    a.pair_cnt_o[lN * N + t] = a.pair_cnt[lN * N + t] + n;
  }
  if (t < a.RR) {
    int sum = 0, cnt = 0;
    for (int e = 0; e < E; ++e)
      if (s_row[e] == t) {
        sum += s_lat[e];
        ++cnt;
      }
    a.lat_sum_o[(size_t)l * a.RR + t] = a.lat_sum[(size_t)l * a.RR + t] + sum;
    a.lat_count_o[(size_t)l * a.RR + t] =
        a.lat_count[(size_t)l * a.RR + t] + cnt;
  }
  if (t < N * a.R) {  // a fired timer re-arms one interval later
    const int pp = t / a.R, r = t % a.R;
    const size_t k = lN * a.R + t;
    a.next_periodic_o[k] = a.fire[k]
        ? a.ep[lN + pp] + a.intervals[(size_t)l * a.R + r]
        : a.next_periodic[k];
  }
  if (t == 0) {
    bool stuck = false, all_done = true;
    int nrq = 0, perr = 0, maxc = a.max_completion[l];
    for (int q = 0; q < N; ++q) {
      const bool rq = a.has[lN + q] && !a.rdy[lN + q];
      nrq += rq ? 1 : 0;
      if (rq && a.rows[(lN + q) * W + PRQ] + 1 > REQUEUE_LIMIT) stuck = true;
      perr |= a.perr[lN + q];
    }
    for (int k = 0; k < C; ++k)
      if (a.cmd_budget[lC + k] > 0 && s_ncomp[k] < a.cmd_budget[lC + k])
        all_done = false;
    for (int e = 0; e < E; ++e) maxc = max(maxc, s_ct[e]);
    const int done = a.done_time[l];
    a.max_completion_o[l] = maxc;
    a.done_time_o[l] = (done == INF && all_done) ? maxc : done;
    a.err_o[l] = a.err[l] | (stuck ? ERR_STUCK : 0) | (perr & 0xFF);
    a.requeues_o[l] = a.requeues[l] + nrq;
    a.steps_o[l] = a.steps[l] + 1;
  }
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
    void* done_time_o, void* err_o, void* steps_o, int L, int N, int F,
    int P, int C, int R, int RR, int H, int T, int LOG, int W, int submit,
    int S, int TP, int TT, void* stream) {
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
  const int E = N * (2 * F + 1);
  const int need = std::max({E, C, N * N, RR, N * R, 32});
  const int threads = (need + 31) / 32 * 32;
  const size_t shm = (size_t)(8 * E + 5 * C) * sizeof(int);
  emit_rewrite_kernel<<<L, threads, shm, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
