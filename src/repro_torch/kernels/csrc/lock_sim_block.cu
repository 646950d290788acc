// lock_sim_block for Hopper: n_sub_steps fused timesteps of the batched lock
// simulator, closed-loop and open-loop variants.
//
// Replaces the Pallas TPU kernel repro/kernels/lock_sim.py:lock_sim_block
// (_block_kernel, both values of its static open_run flag); computes the same
// function as repro_torch/kernels/ref.py:lock_sim_block_ref, stage for stage.
//
// Design.  One warp owns one config row; a lane owns the simulated threads
// tid = slot * 32 + lane for slot < NS = ceil(T / 32), so T <= 128.  All
// per-thread state lives in registers across the sub-step loop, the config
// columns are loaded once, and everything is stored once at the end.  The
// row-wise operations of the reference map to warp primitives: counts and
// `cumsum - 1` ranks are __ballot_sync + __popc, `first_oh` is __ffs of a
// ballot, the ticket / random-key grants are __reduce_min_sync.  A sub-step
// with step0 + s >= limit ends the loop (the reference's passthrough mask).
//
// What bounds it.  Per launch a row moves (8 T + 9) * 4 bytes of state each
// way plus 28 context words, once for all n_sub_steps.  By a lower-bound
// count of the idle path (46 operations per simulated thread and sub-step)
// bytes and operations ask for about the same time at T = 32 and 32
// sub-steps; what a warp really issues -- ballots, hashes, the dependent
// chain of stage tests -- is several times that count, so the kernel is
// bound by operations (issue rate and the latency of the sequential chain),
// not by bytes.  Keeping the state in registers for the whole block is what
// keeps the bytes to one read and one write.
//
// Open variant (template flag OPEN, the reference's open_state): each warp
// keeps its row's request ring qbuf[QUEUE_MAX] f32 and latency histogram
// hist[LAT_NBINS] i32 in shared memory (768 B per warp), loaded once per
// launch and stored once; the binding gather `take_along_axis(qbuf, qpos)`
// is a per-lane shared-memory read.  req_t sits in registers beside rem, the
// per-config queue counters are warp-uniform registers.  It adds the 11
// open-state arrays to the bytes moved per launch and the admission /
// departure / binding stages to the work of a sub-step; the bound is still
// operations.  The closed instantiation's code is untouched by the flag.
//
// Numerics.  Built with -fmad=false and without fast-math: `rem - dt*rate`,
// `lo + u*(hi-lo)`, `now2 + wake_eff` feed `<=` tests, and a contracted FMA
// differs by one ulp from the plain version's separate multiply and add,
// which forks the trajectory.  The row registries are dispatched with
// `switch`; that equals the plain version's masked sum because every
// unselected candidate is finite.  `spin_cpu` adds n_spin * d_rate per step,
// the order-free closed form of the lane sum, as the plain version does.
// The open stages: the ring index is a floor modulo (Python's `%`), not C's
// truncating one; at most one request departs per row and step (one CS
// holder), so the row sums of its latency and bin are exact in any order;
// `occ_int` adds (qlen + busy) * dt in the plain version's order.
#include <cuda_runtime.h>
#include <math.h>

#include "lock_sim_consts.cuh"

#define FULL_MASK 0xffffffffu
#define UNROLL _Pragma("unroll")

namespace {

__device__ __constant__ unsigned kPolicyRow[N_POLICY] = {
    ROW_TAS,     ROW_TTAS, ROW_MCS,     ROW_SLEEP, ROW_ADAPTIVE,
    ROW_MUTABLE, ROW_FIFO, ROW_FISSILE, ROW_HAPAX, ROW_TTAS_BACKOFF};

struct BlockArgs {
  // state in: 8 (C, T) arrays, 8 (C,) int columns, spin_cpu
  const int* st; const float* rem; const float* wake_at; const int* slept;
  const int* spun; const unsigned* ctr; const int* ticket; const int* cpt;
  const int* sws; const int* cnt; const int* ewma; const int* wuc;
  const int* permits; const int* nticket; const int* completed;
  const int* wake_count; const float* spin_cpu;
  // state out, same order
  int* o_st; float* o_rem; float* o_wake_at; int* o_slept; int* o_spun;
  unsigned* o_ctr; int* o_ticket; int* o_cpt;
  int* o_sws; int* o_cnt; int* o_ewma; int* o_wuc; int* o_permits;
  int* o_nticket; int* o_completed; int* o_wake_count; float* o_spin_cpu;
  // context columns (step0 / limit may be null: the scalar is used)
  const int* step0; const int* limit; const float* alpha; const float* cores;
  const unsigned char* has_budget; const int* policy; const int* threads;
  const float* dt; const float* wake; const float* cs_lo; const float* cs_hi;
  const float* ncs_lo; const float* ncs_hi; const int* k; const int* sws_max;
  const float* spin_budget; const unsigned* seed; const int* oracle;
  const int* workload; const float* wl_period; const float* wl_duty;
  const float* wl_burst; const float* wl_spread; const int* tb;
  const int* fault; const float* flt_rate; const float* flt_scale;
  const float* park_cost;
  // open-loop context columns and state in / out (OPEN instantiation only)
  const int* arrival; const float* arr_rate; const int* q_cap;
  const float* slo;
  const float* req_t; const float* qbuf; const int* hist; const int* qhead;
  const int* qlen; const int* arrived; const int* shed; const int* departed;
  const int* slo_viol; const float* lat_sum; const float* occ_int;
  float* o_req_t; float* o_qbuf; int* o_hist; int* o_qhead; int* o_qlen;
  int* o_arrived; int* o_shed; int* o_departed; int* o_slo_viol;
  float* o_lat_sum; float* o_occ_int;
  int step0_s; int limit_s; int C; int T; int n_sub;
};

// -- counter RNG (ref.counter_uniform): uint32 avalanche, uniform [0, 1) ----
__device__ __forceinline__ float counter_uniform(unsigned seed, unsigned tid,
                                                 unsigned ctr) {
  unsigned x = seed ^ (tid * 0x9E3779B9u) ^ ((ctr + 1u) * 0x85EBCA6Bu);
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return __uint2float_rn(x) * 2.3283064365386963e-10f;  // 2^-32
}

// -- warp primitives over the NS slots of a row ------------------------------
template <int NS>
__device__ __forceinline__ int w_count(const bool (&m)[NS]) {
  int n = 0;
  UNROLL for (int j = 0; j < NS; ++j) n += __popc(__ballot_sync(FULL_MASK, m[j]));
  return n;
}

template <int NS>
__device__ __forceinline__ bool w_any(const bool (&m)[NS]) {
  unsigned b = 0;
  UNROLL for (int j = 0; j < NS; ++j) b |= __ballot_sync(FULL_MASK, m[j]);
  return b != 0;
}

// exclusive prefix count in tid order (`cumsum(mask) - 1` on lanes in mask)
template <int NS>
__device__ __forceinline__ void w_rank(const bool (&m)[NS], int (&r)[NS],
                                       unsigned lt) {
  int base = 0;
  UNROLL for (int j = 0; j < NS; ++j) {
    unsigned b = __ballot_sync(FULL_MASK, m[j]);
    r[j] = base + __popc(b & lt);
    base += __popc(b);
  }
}

// one-hot of the lowest tid in mask (all false when the mask is empty)
template <int NS>
__device__ __forceinline__ void w_first(const bool (&m)[NS], bool (&oh)[NS],
                                        unsigned lane) {
  bool found = false;
  UNROLL for (int j = 0; j < NS; ++j) {
    unsigned b = __ballot_sync(FULL_MASK, m[j]);
    oh[j] = !found && b != 0 && lane == (unsigned)(__ffs(b) - 1);
    found = found || b != 0;
  }
}

template <int NS>
__device__ __forceinline__ int w_min(const int (&v)[NS]) {
  int m = v[0];
  UNROLL for (int j = 1; j < NS; ++j) m = min(m, v[j]);
  return __reduce_min_sync(FULL_MASK, m);
}

// sum over the row of v on lanes in mask
template <int NS>
__device__ __forceinline__ int w_sum_where(const bool (&m)[NS],
                                           const int (&v)[NS]) {
  int s = 0;
  UNROLL for (int j = 0; j < NS; ++j) s += m[j] ? v[j] : 0;
  return __reduce_add_sync(FULL_MASK, s);
}

// sum over the row of a float that is non-zero on at most one lane: exact
__device__ __forceinline__ float w_fsum(float v) {
  UNROLL for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

// Python's `%` (floor modulo) for a positive modulus
__device__ __forceinline__ int mod_floor(int x, int q) {
  return ((x % q) + q) % q;
}

// -- workload rows (policy.WORKLOAD_ROWS via ref.workload_draw) --------------
__device__ __forceinline__ float workload_draw(float u, float lo, float hi,
                                               bool is_ncs, int workload,
                                               float gate_off, float tscale,
                                               float burst) {
  float base = lo + u * (hi - lo);
  switch (workload) {
    case WL_BURSTY:
      return is_ncs ? base * (1.0f + gate_off * (burst - 1.0f)) : base;
    case WL_HETERO:
      return base * tscale;
    case WL_JITTER:
      return is_ncs ? (0.5f * (lo + hi)) *
                          (-log1pf(-fminf(u, 0.99999994f)))  // 1 - 2^-24
                    : base;
    default:  // WL_CONSTANT
      return base;
  }
}

// -- oracle rows + A16-A17 clamp + C1/C2 correction (ref.oracle_acquire) ----
__device__ __forceinline__ void oracle_acquire(bool happened, int spun_w,
                                               int slept_w, int thc, int oracle,
                                               int k, int sws_max, unsigned row,
                                               int& sws, int& cnt, int& ewma,
                                               int& wuc) {
  if (!(happened && (row & F_WINDOWED))) return;
  if (row & F_BSCALED) spun_w = 0;
  const int late = slept_w * (1 - spun_w);
  int delta, cnt2, ewma2 = ewma;
  switch (oracle) {
    case ORACLE_PAPER: {
      int c1 = cnt + 1;
      int hitk = (c1 >= k ? 1 : 0) * (1 - late);
      delta = late * sws + hitk * (-1);
      cnt2 = (1 - late) * (1 - hitk) * c1;
    } break;
    case ORACLE_AIMD: {
      int c1 = cnt + 1;
      int hitk = (c1 >= k ? 1 : 0) * (1 - late);
      delta = late * 1 + hitk * (-(sws / 2));
      cnt2 = (1 - late) * (1 - hitk) * c1;
    } break;
    case ORACLE_FIXED:
      delta = k - sws;
      cnt2 = 0;
      break;
    default: {  // ORACLE_HISTORY
      ewma2 = ewma + ((late * EWMA_ONE - ewma) >> EWMA_SHIFT);
      int target = EWMA_ONE / (k + 1);
      int grow = ewma2 > 2 * target ? 1 : 0;
      int shrink = (2 * ewma2 < target ? 1 : 0) * (1 - grow);
      delta = grow * sws + shrink * (-1);
      cnt2 = 0;
    } break;
  }
  delta = min(max(delta, 1 - sws), sws_max - sws);
  const int sws2 = sws + delta;
  const int tmp = (delta < 0 && thc > sws2)  ? thc - sws2
                  : (delta > 0 && thc > sws) ? thc - sws
                                             : 0;
  const int sgn = (delta > 0) - (delta < 0);
  wuc += sgn * min(abs(delta), tmp);
  sws = sws2;
  cnt = cnt2;
  ewma = ewma2;
}

template <int NS, bool OPEN>
__global__ void __launch_bounds__(128) lock_sim_block_kernel(BlockArgs a) {
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (c >= a.C) return;  // the whole warp leaves together
  const unsigned lane = threadIdx.x & 31u;
  const unsigned lt = (1u << lane) - 1u;
  const int T = a.T;
  const float inf = __int_as_float(0x7f800000);

  // ---- config columns, loaded once ----------------------------------------
  const int step0 = a.step0 ? a.step0[c] : a.step0_s;
  const int limit = a.limit ? a.limit[c] : a.limit_s;
  const float alpha = a.alpha[c], cores = a.cores[c];
  const bool has_budget = a.has_budget[c] != 0;
  const unsigned row = kPolicyRow[a.policy[c]];
  const int threads = a.threads[c];
  const float dt = a.dt[c], wake = a.wake[c];
  const float cs_lo = a.cs_lo[c], cs_hi = a.cs_hi[c];
  const float ncs_lo = a.ncs_lo[c], ncs_hi = a.ncs_hi[c];
  const int k = a.k[c], sws_max = a.sws_max[c];
  const float spin_budget = a.spin_budget[c];
  const unsigned seed = a.seed[c];
  const int oracle = a.oracle[c], workload = a.workload[c];
  const float wl_period = a.wl_period[c], wl_duty = a.wl_duty[c];
  const float wl_burst = a.wl_burst[c], wl_spread = a.wl_spread[c];
  const bool tb_random = a.tb[c] > 0;
  const int fault = a.fault[c];
  const float flt_rate = a.flt_rate[c], flt_scale = a.flt_scale[c];
  const float park_cost = a.park_cost[c];

  const bool hand_f = row & F_HANDOFF, fifo_f = row & F_FIFO;
  const bool budget_f = row & F_BUDGET, w2s_f = row & F_W2S;
  const bool repark_f = row & F_REPARK, win_f = row & F_WINDOWED;
  const bool bscale_f = row & F_BSCALED, backoff_f = row & F_BACKOFF;
  const int arrive_rule = (row >> 8) & 0xF, quota_rule = (row >> 12) & 0xF;

  // ---- state in registers --------------------------------------------------
  int st[NS], slept[NS], spun[NS], tk[NS], cpt[NS];
  float rem[NS], wk[NS], req_t[NS];
  unsigned ctr[NS], tid[NS];
  bool active[NS];
  float phase_u[NS], tscale[NS];
  UNROLL for (int j = 0; j < NS; ++j) {
    tid[j] = j * 32 + lane;
    const bool valid = (int)tid[j] < T;
    const long long g = (long long)c * T + tid[j];
    // lanes past T sit in DONE, inert in every mask (never stored)
    st[j] = valid ? a.st[g] : ST_DONE;
    rem[j] = valid ? a.rem[g] : 0.0f;
    wk[j] = valid ? a.wake_at[g] : 0.0f;
    slept[j] = valid ? a.slept[g] : 0;
    spun[j] = valid ? a.spun[g] : 0;
    ctr[j] = valid ? a.ctr[g] : 0u;
    tk[j] = valid ? a.ticket[g] : NO_TICKET;
    cpt[j] = valid ? a.cpt[g] : 0;
    if constexpr (OPEN) req_t[j] = valid ? a.req_t[g] : -1.0f;
    active[j] = (int)tid[j] < threads;
    // persistent per-thread workload state (ref.workload_state)
    phase_u[j] = counter_uniform(seed ^ WL_PHASE_SALT, tid[j], 0u);
    tscale[j] = workload == WL_HETERO
                    ? powf(wl_spread,
                           2.0f * counter_uniform(seed ^ WL_SPREAD_SALT,
                                                  tid[j], 0u) - 1.0f)
                    : 1.0f;
  }
  int sws = a.sws[c], cnt = a.cnt[c], ewma = a.ewma[c], wuc = a.wuc[c];
  int permits = a.permits[c], nticket = a.nticket[c];
  int completed = a.completed[c], wake_count = a.wake_count[c];
  float spin_cpu = a.spin_cpu[c];

  const float teps = dt * 1e-3f;
  const float wake_base = wake * park_cost;

  // ---- open-loop ring and histogram in shared memory, counters in registers
  extern __shared__ float smem[];
  float* qb = nullptr;
  int* hs = nullptr;
  int arrival = AR_CLOSED, q_cap = 0;
  float arr_rate = 0.0f, slo = 0.0f, ar_phase = 0.0f;
  int qhead = 0, qlen = 0, arrived = 0, shed = 0, departed = 0, slo_viol = 0;
  float lat_sum = 0.0f, occ_int = 0.0f;
  const long long qrow = (long long)c * QUEUE_MAX;
  const long long hrow = (long long)c * LAT_NBINS;
  if constexpr (OPEN) {
    qb = smem + (threadIdx.x >> 5) * (QUEUE_MAX + LAT_NBINS);
    hs = reinterpret_cast<int*>(qb + QUEUE_MAX);
    UNROLL for (int j = 0; j < QUEUE_MAX / 32; ++j)
      qb[j * 32 + lane] = a.qbuf[qrow + j * 32 + lane];
    UNROLL for (int j = 0; j < LAT_NBINS / 32; ++j)
      hs[j * 32 + lane] = a.hist[hrow + j * 32 + lane];
    __syncwarp();
    arrival = a.arrival[c];
    arr_rate = a.arr_rate[c];
    q_cap = a.q_cap[c];
    slo = a.slo[c];
    ar_phase = counter_uniform(seed ^ AR_PHASE_SALT, 0u, 0u);
    qhead = a.qhead[c];
    qlen = a.qlen[c];
    arrived = a.arrived[c];
    shed = a.shed[c];
    departed = a.departed[c];
    slo_viol = a.slo_viol[c];
    lat_sum = a.lat_sum[c];
    occ_int = a.occ_int[c];
  }
  const bool openc = arrival != AR_CLOSED;

  for (int s = 0; s < a.n_sub; ++s) {
    const int i = step0 + s;
    if (i >= limit) break;  // remaining sub-steps are passthroughs
    const float i_f = (float)i;
    const float now2 = (i_f + 1.0f) * dt;
    const float now_teps = now2 + teps;
    const unsigned stepu = (unsigned)i;

    bool m[NS], oh[NS];
    int rk[NS];

    // ---- GPS advance (ref.lock_sim_step_ref) + fault rewind ---------------
    {
      bool run[NS], spin[NS];
      UNROLL for (int j = 0; j < NS; ++j) {
        spin[j] = st[j] == ST_SPIN;
        run[j] = spin[j] || st[j] == ST_CS || st[j] == ST_NCS;
      }
      const float n_run = (float)w_count<NS>(run);
      const float n_spin = (float)w_count<NS>(spin);
      const float rate = fminf(1.0f, cores / fmaxf(n_run, 1.0f));
      const float holder_rate = rate / (1.0f + alpha * n_spin);
      const float d_rate = dt * rate, d_hold = dt * holder_rate;
      spin_cpu = spin_cpu + n_spin * d_rate;
      unsigned win = 0u;
      if (fault == FAULT_PREEMPT || fault == FAULT_OVERSUB)
        win = (unsigned)(int)floorf((i_f * dt) / flt_scale);
      UNROLL for (int j = 0; j < NS; ++j) {
        const bool is_cs = st[j] == ST_CS, is_ncs = st[j] == ST_NCS;
        if (is_cs) rem[j] = rem[j] - d_hold;
        else if (is_ncs) rem[j] = rem[j] - d_rate;
        else if (spin[j] && has_budget) rem[j] = rem[j] - d_rate;
        if ((fault == FAULT_PREEMPT || fault == FAULT_OVERSUB) &&
            (is_cs || is_ncs)) {
          const float prog = is_cs ? d_hold : d_rate;
          const float gate_u =
              counter_uniform(seed ^ FLT_GATE_SALT, tid[j], win);
          const float scale = fault == FAULT_PREEMPT
                                  ? 1.0f - (gate_u < flt_rate ? 1.0f : 0.0f)
                                  : 1.0f - flt_rate * gate_u;
          const float giveback = prog * (1.0f - scale);
          if (giveback > 0.0f) rem[j] = rem[j] + giveback;
        }
      }
    }

    // ---- per-step per-thread context --------------------------------------
    float wake_due[NS], gate_off[NS];
    UNROLL for (int j = 0; j < NS; ++j) {
      float wake_eff = wake_base;
      if (fault == FAULT_LOSTWAKE || fault == FAULT_JITTER) {
        const float w1 = counter_uniform(seed ^ FLT_WAKE_SALT, tid[j], stepu);
        if (w1 < flt_rate) {
          if (fault == FAULT_LOSTWAKE) {
            wake_eff = wake_base + (flt_scale - wake_base);
          } else {
            const float w2 =
                counter_uniform(seed ^ FLT_MAG_SALT, tid[j], stepu);
            wake_eff = wake_base + flt_scale * w2;
          }
        }
      }
      wake_due[j] = now2 + wake_eff;
      gate_off[j] = 0.0f;
      if (workload == WL_BURSTY) {
        const float pos = fmodf(now2 / wl_period + phase_u[j], 1.0f);
        gate_off[j] = pos >= wl_duty ? 1.0f : 0.0f;
      }
    }

#define BUDGET_EFF() \
  (spin_budget * (bscale_f ? (float)sws * park_cost : 1.0f))

    // ---- open-loop admission (first: a request admitted at step i is in the
    // system for steps i..j-1 when it departs at step j) --------------------
    if constexpr (OPEN) {
      const float gate_on =
          1.0f - (fmodf(now2 / wl_period + ar_phase, 1.0f) >= wl_duty ? 1.0f
                                                                       : 0.0f);
      float rate;
      switch (arrival) {
        case AR_POISSON:
          rate = arr_rate * 1.0f;
          break;
        case AR_BURSTY:
          rate = arr_rate * (1.0f + gate_on * (wl_burst - 1.0f));
          break;
        default:  // AR_CLOSED
          rate = arr_rate * 0.0f;
      }
      // Bernoulli-rounded count: floor(rate*dt) plus a trial on the rest
      const float m = rate * dt;
      const float mf = floorf(m);
      const float u_arr = counter_uniform(seed ^ AR_SALT, 0u, stepu);
      const int n_arr = (int)(mf + (u_arr < m - mf ? 1.0f : 0.0f));
      const int n_adm = min(n_arr, q_cap - qlen);  // bounded queue: shed
      if (n_adm > 0) {
        const int tail = qhead + qlen;
        UNROLL for (int j = 0; j < QUEUE_MAX / 32; ++j) {
          const int qi = j * 32 + (int)lane;
          if (mod_floor(qi - tail, QUEUE_MAX) < n_adm) qb[qi] = now2;
        }
        __syncwarp();
      }
      qlen += n_adm;
      arrived += n_arr;
      shed += n_arr - n_adm;
    }

// CS / NCS duration draw on the lanes of a mask; bumps their counters
#define DRAW_INTO(mask, lo, hi, is_ncs, new_st)                             \
  UNROLL for (int j = 0; j < NS; ++j) if (mask[j]) {                        \
    const float u = counter_uniform(seed, tid[j], ctr[j]);                  \
    rem[j] = workload_draw(u, lo, hi, is_ncs, workload, gate_off[j],        \
                           tscale[j], wl_burst);                            \
    ctr[j] = ctr[j] + 1u;                                                   \
    st[j] = new_st;                                                         \
  }

// ref.park: park the lanes of a mask, absorbing banked permits
#define PARK(mask)                                                          \
  {                                                                         \
    w_rank<NS>(mask, rk, lt);                                               \
    bool grant[NS];                                                         \
    UNROLL for (int j = 0; j < NS; ++j) grant[j] = mask[j] && rk[j] < permits; \
    const int n_grant = w_count<NS>(grant);                                 \
    UNROLL for (int j = 0; j < NS; ++j) {                                   \
      if (grant[j]) { st[j] = ST_WAKING; wk[j] = wake_due[j]; }             \
      else if (mask[j]) st[j] = ST_SLEEP;                                   \
      if (mask[j]) { slept[j] = 1; rem[j] = inf; }                          \
    }                                                                       \
    permits -= n_grant;                                                     \
    wake_count += n_grant;                                                  \
  }

#define THC_OF(out)                                                         \
  {                                                                         \
    bool in_[NS];                                                           \
    UNROLL for (int j = 0; j < NS; ++j)                                     \
      in_[j] = active[j] && st[j] >= ST_CS && st[j] <= ST_WAKING;           \
    out = w_count<NS>(in_);                                                 \
  }

#define HOLDER_FREE(out)                                                    \
  {                                                                         \
    bool cs_[NS];                                                           \
    UNROLL for (int j = 0; j < NS; ++j) cs_[j] = st[j] == ST_CS;            \
    out = !w_any<NS>(cs_);                                                  \
  }

    // ---- spin-budget exhaustion -> sleep ----------------------------------
    if (budget_f) {
      UNROLL for (int j = 0; j < NS; ++j)
        m[j] = st[j] == ST_SPIN && rem[j] <= REM_EPS;
      PARK(m)
    }

    // ---- wake completions ---------------------------------------------------
    {
      bool due[NS];
      UNROLL for (int j = 0; j < NS; ++j)
        due[j] = st[j] == ST_WAKING && wk[j] <= now_teps;
      if (w_any<NS>(due)) {
        bool holder_free;
        HOLDER_FREE(holder_free)
        if (fifo_f) {
          int wkey[NS];
          UNROLL for (int j = 0; j < NS; ++j)
            wkey[j] = due[j] ? tk[j] : NO_TICKET;
          const int mn = w_min<NS>(wkey);
          UNROLL for (int j = 0; j < NS; ++j) m[j] = due[j] && wkey[j] == mn;
          w_first<NS>(m, oh, lane);
        } else {
          w_first<NS>(due, oh, lane);
        }
        UNROLL for (int j = 0; j < NS; ++j) oh[j] = oh[j] && holder_free;
        const bool anyA = w_any<NS>(oh);
        const int spun_w = w_sum_where<NS>(oh, spun);
        const int slept_w = w_sum_where<NS>(oh, slept);
        DRAW_INTO(oh, cs_lo, cs_hi, false, ST_CS)
        int thc;
        THC_OF(thc)
        oracle_acquire(anyA, spun_w, slept_w, thc, oracle, k, sws_max, row,
                       sws, cnt, ewma, wuc);
        // losers: woken into the spinning window, or barged and parked again
        UNROLL for (int j = 0; j < NS; ++j) {
          const bool loser = due[j] && !oh[j];
          if (loser && w2s_f) {
            st[j] = ST_SPIN;
            spun[j] = 1;
            rem[j] = budget_f ? BUDGET_EFF() : inf;
          }
          m[j] = loser && repark_f;
        }
        if (repark_f) PARK(m)
      }
    }

    // ---- CS completion / release -------------------------------------------
    {
      bool done[NS];
      UNROLL for (int j = 0; j < NS; ++j)
        done[j] = st[j] == ST_CS && rem[j] <= REM_EPS;
      const bool rel = w_any<NS>(done);
      if (rel) {
        completed += 1;
        UNROLL for (int j = 0; j < NS; ++j) cpt[j] += done[j] ? 1 : 0;
        int thc_pre;
        THC_OF(thc_pre)
        const bool do_latch = win_f;
        const int r_wuc = (do_latch && wuc >= 0) ? wuc : -1;
        if (do_latch) wuc = wuc >= 0 ? 0 : wuc + 1;
        DRAW_INTO(done, ncs_lo, ncs_hi, true, ST_NCS)
        // open-loop departure: the request leaves, its latency lands in the
        // histogram and the counters, and its slot frees (DONE)
        if constexpr (OPEN) {
          if (openc) {
            float lsum = 0.0f;
            int bsum = 0;
            bool viol[NS];
            UNROLL for (int j = 0; j < NS; ++j) {
              viol[j] = false;
              if (done[j]) {
                const float latv = now2 - req_t[j];
                float b = floorf(log2f(fmaxf(latv, 1e-30f) / LAT_BIN0) *
                                 (float)LAT_BINS_PER_OCTAVE);
                b = fminf(fmaxf(b, 0.0f), (float)(LAT_NBINS - 1));
                bsum += (int)b;
                lsum += latv;
                viol[j] = latv > slo;
                st[j] = ST_DONE;
                rem[j] = inf;
                req_t[j] = -1.0f;
              }
            }
            const int dep_bin = __reduce_add_sync(FULL_MASK, bsum);
            const float lat = w_fsum(lsum);
            if (lane == 0 && dep_bin < LAT_NBINS) hs[dep_bin] += 1;
            lat_sum = lat_sum + lat;
            departed += 1;
            slo_viol += w_count<NS>(viol);
          }
        }
        // handoff: ticket order on FIFO rows, else thread id or a seeded
        // random key; equal keys fall back to the lowest id
        bool spinners[NS];
        UNROLL for (int j = 0; j < NS; ++j) spinners[j] = st[j] == ST_SPIN;
        const bool can_handoff = hand_f && w_any<NS>(spinners);
        if (can_handoff) {
          int key[NS];
          UNROLL for (int j = 0; j < NS; ++j) {
            int kj = (int)tid[j];
            if (fifo_f) kj = tk[j];
            else if (tb_random)
              kj = (int)(counter_uniform(seed ^ TB_SALT, tid[j], stepu) *
                         8388608.0f);
            key[j] = spinners[j] ? kj : NO_TICKET;
          }
          const int mn = w_min<NS>(key);
          UNROLL for (int j = 0; j < NS; ++j)
            m[j] = spinners[j] && key[j] == mn;
          w_first<NS>(m, oh, lane);
          const int spun_w = w_sum_where<NS>(oh, spun);
          const int slept_w = w_sum_where<NS>(oh, slept);
          DRAW_INTO(oh, cs_lo, cs_hi, false, ST_CS)
          oracle_acquire(true, spun_w, slept_w, thc_pre - 1, oracle, k,
                         sws_max, row, sws, cnt, ewma, wuc);
        }
        // wake quota by discipline rule
        bool parked[NS], sleepers[NS];
        UNROLL for (int j = 0; j < NS; ++j) {
          sleepers[j] = st[j] == ST_SLEEP;
          parked[j] = sleepers[j] || st[j] == ST_WAKING;
        }
        const int n_parked = w_count<NS>(parked);
        int quota = 0;
        switch (quota_rule) {
          case QUOTA_WAKE_ONE:
            quota = n_parked > 0 ? 1 : 0;
            break;
          case QUOTA_WAKE_ONE_NO_HANDOFF:
            quota = (n_parked > 0 ? 1 : 0) * (1 - (can_handoff ? 1 : 0));
            break;
          case QUOTA_MUTABLE:
            quota = (r_wuc >= 0 ? 1 : 0) * (r_wuc + (thc_pre > sws ? 1 : 0));
            break;
          default:
            quota = 0;
        }
        bool sel[NS];
        if (fifo_f) {
          int skey[NS];
          UNROLL for (int j = 0; j < NS; ++j)
            skey[j] = sleepers[j] ? tk[j] : NO_TICKET;
          const int mn = w_min<NS>(skey);
          UNROLL for (int j = 0; j < NS; ++j)
            m[j] = sleepers[j] && skey[j] == mn;
          w_first<NS>(m, sel, lane);
          UNROLL for (int j = 0; j < NS; ++j) sel[j] = sel[j] && quota > 0;
        } else {
          w_rank<NS>(sleepers, rk, lt);
          UNROLL for (int j = 0; j < NS; ++j)
            sel[j] = sleepers[j] && rk[j] < quota;
        }
        const int n_sel = w_count<NS>(sel);
        UNROLL for (int j = 0; j < NS; ++j) if (sel[j]) {
          st[j] = ST_WAKING;
          wk[j] = wake_due[j];
        }
        wake_count += n_sel;
        permits += quota - n_sel;  // park-free permits are banked
      }
    }

    // ---- ttas_backoff polls --------------------------------------------------
    float bo_u[NS];
    if (backoff_f) {
      bool poll[NS];
      UNROLL for (int j = 0; j < NS; ++j) {
        bo_u[j] = counter_uniform(seed ^ BO_SALT, tid[j], stepu);
        poll[j] = st[j] == ST_SPIN && wk[j] <= now_teps;
      }
      bool holder_free;
      HOLDER_FREE(holder_free)
      w_first<NS>(poll, oh, lane);
      UNROLL for (int j = 0; j < NS; ++j) oh[j] = oh[j] && holder_free;
      DRAW_INTO(oh, cs_lo, cs_hi, false, ST_CS)
      UNROLL for (int j = 0; j < NS; ++j) if (poll[j] && !oh[j]) {
        tk[j] = (int)((unsigned)tk[j] + 1u);  // wraps like the int32 tensor
        const float bo_exp = exp2f((float)min(tk[j], BO_CAP));
        wk[j] = now2 + spin_budget * bo_exp * bo_u[j];
      }
    }

    // ---- arrivals (NCS finished) --------------------------------------------
    {
      bool arr[NS];
      UNROLL for (int j = 0; j < NS; ++j)
        arr[j] = st[j] == ST_NCS && rem[j] <= REM_EPS && active[j];
      if (w_any<NS>(arr)) {
        int thc_base;
        THC_OF(thc_base)
        w_rank<NS>(arr, rk, lt);
        bool holder_free;
        HOLDER_FREE(holder_free)
        bool sleeps[NS], nonsleep[NS];
        UNROLL for (int j = 0; j < NS; ++j) {
          if (arr[j]) { slept[j] = 0; spun[j] = 0; }
          const int thc_pre_i = thc_base + rk[j];
          bool sl;
          switch (arrive_rule) {
            case ARRIVE_SLEEP_LOCK:
              sl = !(rk[j] == 0 && holder_free);
              break;
            case ARRIVE_WINDOW:
              sl = thc_pre_i >= sws;
              break;
            case ARRIVE_FIFO_PARK:
              sl = !(thc_pre_i == 0 && holder_free);
              break;
            default:
              sl = false;
          }
          sleeps[j] = arr[j] && sl;
          nonsleep[j] = arr[j] && !sl;
        }
        w_first<NS>(nonsleep, oh, lane);
        UNROLL for (int j = 0; j < NS; ++j) oh[j] = oh[j] && holder_free;
        const bool anyC = w_any<NS>(oh);
        // arrivals have just cleared their slept / spun flags
        DRAW_INTO(oh, cs_lo, cs_hi, false, ST_CS)
        oracle_acquire(anyC, 0, 0, thc_base + 1, oracle, k, sws_max, row, sws,
                       cnt, ewma, wuc);
        bool joiners[NS];
        UNROLL for (int j = 0; j < NS; ++j) {
          m[j] = nonsleep[j] && !oh[j];  // to_spinC
          if (m[j]) {
            st[j] = ST_SPIN;
            spun[j] = 1;
            rem[j] = budget_f ? BUDGET_EFF() : inf;
          }
          joiners[j] = m[j] || (sleeps[j] && fifo_f);
        }
        w_rank<NS>(joiners, rk, lt);
        const int n_join = w_count<NS>(joiners);
        UNROLL for (int j = 0; j < NS; ++j) {
          if (joiners[j]) tk[j] = nticket + rk[j];
          if (m[j] && backoff_f) {  // first re-poll within one base delay
            tk[j] = 0;
            wk[j] = now2 + spin_budget * bo_u[j];
          }
        }
        nticket += n_join;
        PARK(sleeps)
      }
    }

    // ---- retire tickets ------------------------------------------------------
    UNROLL for (int j = 0; j < NS; ++j) {
      const bool queued =
          st[j] == ST_SPIN ||
          (fifo_f && (st[j] == ST_SLEEP || st[j] == ST_WAKING));
      if (!queued) tk[j] = NO_TICKET;
    }

    // ---- open-loop binding: queued requests claim free slots in queue
    // order; then the occupancy integral accumulates, last ---------------
    if constexpr (OPEN) {
      if (openc) {
        bool freem[NS];
        UNROLL for (int j = 0; j < NS; ++j)
          freem[j] = active[j] && st[j] == ST_DONE;
        w_rank<NS>(freem, rk, lt);
        const int n_bind = min(qlen, w_count<NS>(freem));
        if (n_bind > 0) {
          bool bindm[NS];
          float rt[NS];
          UNROLL for (int j = 0; j < NS; ++j) {
            bindm[j] = freem[j] && rk[j] < n_bind;
            rt[j] = bindm[j] ? qb[mod_floor(qhead + rk[j], QUEUE_MAX)] : 0.0f;
          }
          __syncwarp();  // reads land before the next admission writes
          DRAW_INTO(bindm, ncs_lo, ncs_hi, true, ST_NCS)
          UNROLL for (int j = 0; j < NS; ++j) if (bindm[j]) {
            req_t[j] = rt[j];
            slept[j] = 0;
            spun[j] = 0;
          }
          qhead = mod_floor(qhead + n_bind, QUEUE_MAX);
          qlen -= n_bind;
        }
      }
      bool busy[NS];
      UNROLL for (int j = 0; j < NS; ++j)
        busy[j] = active[j] && req_t[j] >= 0.0f;
      occ_int = occ_int + (float)(qlen + w_count<NS>(busy)) * dt;
    }
  }

  // ---- one store ---------------------------------------------------------------
  UNROLL for (int j = 0; j < NS; ++j) {
    if ((int)tid[j] < T) {
      const long long g = (long long)c * T + tid[j];
      a.o_st[g] = st[j];
      a.o_rem[g] = rem[j];
      a.o_wake_at[g] = wk[j];
      a.o_slept[g] = slept[j];
      a.o_spun[g] = spun[j];
      a.o_ctr[g] = ctr[j];
      a.o_ticket[g] = tk[j];
      a.o_cpt[g] = cpt[j];
      if constexpr (OPEN) a.o_req_t[g] = req_t[j];
    }
  }
  if constexpr (OPEN) {
    __syncwarp();
    UNROLL for (int j = 0; j < QUEUE_MAX / 32; ++j)
      a.o_qbuf[qrow + j * 32 + lane] = qb[j * 32 + lane];
    UNROLL for (int j = 0; j < LAT_NBINS / 32; ++j)
      a.o_hist[hrow + j * 32 + lane] = hs[j * 32 + lane];
    if (lane == 0) {
      a.o_qhead[c] = qhead;
      a.o_qlen[c] = qlen;
      a.o_arrived[c] = arrived;
      a.o_shed[c] = shed;
      a.o_departed[c] = departed;
      a.o_slo_viol[c] = slo_viol;
      a.o_lat_sum[c] = lat_sum;
      a.o_occ_int[c] = occ_int;
    }
  }
  if (lane == 0) {
    a.o_sws[c] = sws;
    a.o_cnt[c] = cnt;
    a.o_ewma[c] = ewma;
    a.o_wuc[c] = wuc;
    a.o_permits[c] = permits;
    a.o_nticket[c] = nticket;
    a.o_completed[c] = completed;
    a.o_wake_count[c] = wake_count;
    a.o_spin_cpu[c] = spin_cpu;
  }
}

}  // namespace

template <bool OPEN>
void launch_variant(const BlockArgs& a, cudaStream_t s) {
  const int warps_per_block = 4;
  const dim3 block(32 * warps_per_block);
  const dim3 grid((a.C + warps_per_block - 1) / warps_per_block);
  const size_t shmem =
      OPEN ? warps_per_block * (QUEUE_MAX + LAT_NBINS) * sizeof(float) : 0;
  if (a.T <= 32) lock_sim_block_kernel<1, OPEN><<<grid, block, shmem, s>>>(a);
  else if (a.T <= 64) lock_sim_block_kernel<2, OPEN><<<grid, block, shmem, s>>>(a);
  else lock_sim_block_kernel<4, OPEN><<<grid, block, shmem, s>>>(a);
}

// Plain C entry point (loaded with ctypes).  `state_in` / `state_out` hold
// the 17 state pointers in canonical order, followed by the 11 OPEN_STATE
// pointers when `open_run` is non-zero; `ctx` holds the 32 context pointers
// in BlockArgs order (ctx[0] / ctx[1], step0 / limit, may be null: the
// scalars are used).  Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() (or cudaErrorInvalidValue for an unsupported
// T).
extern "C" int lock_sim_block_launch(void* const* state_in,
                                     void* const* state_out, void* const* ctx,
                                     int step0_s, int limit_s, int C, int T,
                                     int n_sub, int open_run, void* stream) {
  if (C <= 0 || T <= 0 || T > MAX_T) return (int)cudaErrorInvalidValue;
  BlockArgs a{};
  a.st = (const int*)state_in[0];
  a.rem = (const float*)state_in[1];
  a.wake_at = (const float*)state_in[2];
  a.slept = (const int*)state_in[3];
  a.spun = (const int*)state_in[4];
  a.ctr = (const unsigned*)state_in[5];
  a.ticket = (const int*)state_in[6];
  a.cpt = (const int*)state_in[7];
  a.sws = (const int*)state_in[8];
  a.cnt = (const int*)state_in[9];
  a.ewma = (const int*)state_in[10];
  a.wuc = (const int*)state_in[11];
  a.permits = (const int*)state_in[12];
  a.nticket = (const int*)state_in[13];
  a.completed = (const int*)state_in[14];
  a.wake_count = (const int*)state_in[15];
  a.spin_cpu = (const float*)state_in[16];
  a.o_st = (int*)state_out[0];
  a.o_rem = (float*)state_out[1];
  a.o_wake_at = (float*)state_out[2];
  a.o_slept = (int*)state_out[3];
  a.o_spun = (int*)state_out[4];
  a.o_ctr = (unsigned*)state_out[5];
  a.o_ticket = (int*)state_out[6];
  a.o_cpt = (int*)state_out[7];
  a.o_sws = (int*)state_out[8];
  a.o_cnt = (int*)state_out[9];
  a.o_ewma = (int*)state_out[10];
  a.o_wuc = (int*)state_out[11];
  a.o_permits = (int*)state_out[12];
  a.o_nticket = (int*)state_out[13];
  a.o_completed = (int*)state_out[14];
  a.o_wake_count = (int*)state_out[15];
  a.o_spin_cpu = (float*)state_out[16];
  a.step0 = (const int*)ctx[0];
  a.limit = (const int*)ctx[1];
  a.alpha = (const float*)ctx[2];
  a.cores = (const float*)ctx[3];
  a.has_budget = (const unsigned char*)ctx[4];
  a.policy = (const int*)ctx[5];
  a.threads = (const int*)ctx[6];
  a.dt = (const float*)ctx[7];
  a.wake = (const float*)ctx[8];
  a.cs_lo = (const float*)ctx[9];
  a.cs_hi = (const float*)ctx[10];
  a.ncs_lo = (const float*)ctx[11];
  a.ncs_hi = (const float*)ctx[12];
  a.k = (const int*)ctx[13];
  a.sws_max = (const int*)ctx[14];
  a.spin_budget = (const float*)ctx[15];
  a.seed = (const unsigned*)ctx[16];
  a.oracle = (const int*)ctx[17];
  a.workload = (const int*)ctx[18];
  a.wl_period = (const float*)ctx[19];
  a.wl_duty = (const float*)ctx[20];
  a.wl_burst = (const float*)ctx[21];
  a.wl_spread = (const float*)ctx[22];
  a.tb = (const int*)ctx[23];
  a.fault = (const int*)ctx[24];
  a.flt_rate = (const float*)ctx[25];
  a.flt_scale = (const float*)ctx[26];
  a.park_cost = (const float*)ctx[27];
  a.arrival = (const int*)ctx[28];
  a.arr_rate = (const float*)ctx[29];
  a.q_cap = (const int*)ctx[30];
  a.slo = (const float*)ctx[31];
  if (open_run) {
    a.req_t = (const float*)state_in[17];
    a.qbuf = (const float*)state_in[18];
    a.hist = (const int*)state_in[19];
    a.qhead = (const int*)state_in[20];
    a.qlen = (const int*)state_in[21];
    a.arrived = (const int*)state_in[22];
    a.shed = (const int*)state_in[23];
    a.departed = (const int*)state_in[24];
    a.slo_viol = (const int*)state_in[25];
    a.lat_sum = (const float*)state_in[26];
    a.occ_int = (const float*)state_in[27];
    a.o_req_t = (float*)state_out[17];
    a.o_qbuf = (float*)state_out[18];
    a.o_hist = (int*)state_out[19];
    a.o_qhead = (int*)state_out[20];
    a.o_qlen = (int*)state_out[21];
    a.o_arrived = (int*)state_out[22];
    a.o_shed = (int*)state_out[23];
    a.o_departed = (int*)state_out[24];
    a.o_slo_viol = (int*)state_out[25];
    a.o_lat_sum = (float*)state_out[26];
    a.o_occ_int = (float*)state_out[27];
  }
  a.step0_s = step0_s;
  a.limit_s = limit_s;
  a.C = C;
  a.T = T;
  a.n_sub = n_sub;

  cudaStream_t s = (cudaStream_t)stream;
  if (open_run) launch_variant<true>(a, s);
  else launch_variant<false>(a, s);
  return (int)cudaGetLastError();
}
