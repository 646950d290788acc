// The stages of one timestep of the batched lock simulator, as device
// functions that the Hopper kernels share.
//
// lock_sim_block.cu runs them n_sub_steps times per launch with the state in
// registers; lock_sim_step.cu (the GPS advance alone), lock_transitions_step.cu
// (one transition stage) and oracle_step.cu (the oracle rows) run one of them
// per launch.  Every function is __forceinline__, so each kernel compiles the
// same code as if the stage were written out in its body.
//
// Layout.  One warp owns one config row; a lane owns the simulated threads
// tid = slot * 32 + lane for slot < NS = ceil(T / 32), so T <= 128.  The
// row-wise operations of the reference map to warp primitives: counts and
// `cumsum - 1` ranks are __ballot_sync + __popc, `first_oh` is __ffs of a
// ballot, the ticket / random-key grants are __reduce_min_sync.  Lanes past T
// sit in DONE, inert in every mask, and are never stored.
//
// Numerics.  Built with -fmad=false and without fast-math: `rem - dt*rate`,
// `lo + u*(hi-lo)`, `now2 + wake_eff` feed `<=` tests, and a contracted FMA
// differs by one ulp from the plain version's separate multiply and add,
// which forks the trajectory.  The row registries are dispatched with
// `switch`; that equals the plain version's masked sum because every
// unselected candidate is finite.  Integer division is Python's floor
// division wherever the reference writes `//`.  The open stages: the ring
// index is a floor modulo (Python's `%`), not C's truncating one; at most one
// request departs per row and step (one CS holder), so the row sums of its
// latency and bin are exact in any order; `occ_int` adds (qlen + busy) * dt
// in the plain version's order.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "lock_sim_consts.cuh"

#define FULL_MASK 0xffffffffu
#define UNROLL _Pragma("unroll")

namespace {

__device__ __constant__ unsigned kPolicyRow[N_POLICY] = {
    ROW_TAS,     ROW_TTAS, ROW_MCS,     ROW_SLEEP, ROW_ADAPTIVE,
    ROW_MUTABLE, ROW_FIFO, ROW_FISSILE, ROW_HAPAX, ROW_TTAS_BACKOFF};

// Operands of the block kernel (K1) and the transition kernel (K3).  K3 leaves
// spin_cpu, step0, limit, alpha, cores and has_budget null and reads now2 /
// stepi instead (a column when the pointer is set, stride 0 for a 0-d tensor,
// else the scalar).
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
  // the transition kernel's step: now2 f32 and stepi i32
  const float* now2; const int* stepi; int now2_stride; int stepi_stride;
  float now2_s; int stepi_s;
};

// The 27 context pointers from policy to slo, in BlockArgs order (the
// block context minus step0, limit, alpha, cores and has_budget).
__host__ inline void set_transition_context(BlockArgs& a, void* const* ctx) {
  a.policy = (const int*)ctx[0];
  a.threads = (const int*)ctx[1];
  a.dt = (const float*)ctx[2];
  a.wake = (const float*)ctx[3];
  a.cs_lo = (const float*)ctx[4];
  a.cs_hi = (const float*)ctx[5];
  a.ncs_lo = (const float*)ctx[6];
  a.ncs_hi = (const float*)ctx[7];
  a.k = (const int*)ctx[8];
  a.sws_max = (const int*)ctx[9];
  a.spin_budget = (const float*)ctx[10];
  a.seed = (const unsigned*)ctx[11];
  a.oracle = (const int*)ctx[12];
  a.workload = (const int*)ctx[13];
  a.wl_period = (const float*)ctx[14];
  a.wl_duty = (const float*)ctx[15];
  a.wl_burst = (const float*)ctx[16];
  a.wl_spread = (const float*)ctx[17];
  a.tb = (const int*)ctx[18];
  a.fault = (const int*)ctx[19];
  a.flt_rate = (const float*)ctx[20];
  a.flt_scale = (const float*)ctx[21];
  a.park_cost = (const float*)ctx[22];
  a.arrival = (const int*)ctx[23];
  a.arr_rate = (const float*)ctx[24];
  a.q_cap = (const int*)ctx[25];
  a.slo = (const float*)ctx[26];
}

// The 16 transition-state pointers (8 (C, T) arrays, 8 (C,) columns) in and
// out, then the 11 OPEN_STATE pointers at `open` when it is not negative.
__host__ inline void set_transition_state(BlockArgs& a, void* const* in,
                                          void* const* out, int open) {
  a.st = (const int*)in[0];
  a.rem = (const float*)in[1];
  a.wake_at = (const float*)in[2];
  a.slept = (const int*)in[3];
  a.spun = (const int*)in[4];
  a.ctr = (const unsigned*)in[5];
  a.ticket = (const int*)in[6];
  a.cpt = (const int*)in[7];
  a.sws = (const int*)in[8];
  a.cnt = (const int*)in[9];
  a.ewma = (const int*)in[10];
  a.wuc = (const int*)in[11];
  a.permits = (const int*)in[12];
  a.nticket = (const int*)in[13];
  a.completed = (const int*)in[14];
  a.wake_count = (const int*)in[15];
  a.o_st = (int*)out[0];
  a.o_rem = (float*)out[1];
  a.o_wake_at = (float*)out[2];
  a.o_slept = (int*)out[3];
  a.o_spun = (int*)out[4];
  a.o_ctr = (unsigned*)out[5];
  a.o_ticket = (int*)out[6];
  a.o_cpt = (int*)out[7];
  a.o_sws = (int*)out[8];
  a.o_cnt = (int*)out[9];
  a.o_ewma = (int*)out[10];
  a.o_wuc = (int*)out[11];
  a.o_permits = (int*)out[12];
  a.o_nticket = (int*)out[13];
  a.o_completed = (int*)out[14];
  a.o_wake_count = (int*)out[15];
  if (open < 0) return;
  a.req_t = (const float*)in[open + 0];
  a.qbuf = (const float*)in[open + 1];
  a.hist = (const int*)in[open + 2];
  a.qhead = (const int*)in[open + 3];
  a.qlen = (const int*)in[open + 4];
  a.arrived = (const int*)in[open + 5];
  a.shed = (const int*)in[open + 6];
  a.departed = (const int*)in[open + 7];
  a.slo_viol = (const int*)in[open + 8];
  a.lat_sum = (const float*)in[open + 9];
  a.occ_int = (const float*)in[open + 10];
  a.o_req_t = (float*)out[open + 0];
  a.o_qbuf = (float*)out[open + 1];
  a.o_hist = (int*)out[open + 2];
  a.o_qhead = (int*)out[open + 3];
  a.o_qlen = (int*)out[open + 4];
  a.o_arrived = (int*)out[open + 5];
  a.o_shed = (int*)out[open + 6];
  a.o_departed = (int*)out[open + 7];
  a.o_slo_viol = (int*)out[open + 8];
  a.o_lat_sum = (float*)out[open + 9];
  a.o_occ_int = (float*)out[open + 10];
}

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

// The lane's index and the mask of the lanes below it, read from their
// special registers where they are used, so that no register holds them
// across the sub-step loop
__device__ __forceinline__ unsigned lane_id() {
  unsigned v;
  asm volatile("mov.u32 %0, %%laneid;" : "=r"(v));
  return v;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned v;
  asm volatile("mov.u32 %0, %%lanemask_lt;" : "=r"(v));
  return v;
}

// exclusive prefix count in tid order (`cumsum(mask) - 1` on lanes in
// mask); returns the count of the mask
template <int NS>
__device__ __forceinline__ int w_rank(const bool (&m)[NS], int (&r)[NS]) {
  const unsigned lt = lanemask_lt();
  int base = 0;
  UNROLL for (int j = 0; j < NS; ++j) {
    unsigned b = __ballot_sync(FULL_MASK, m[j]);
    r[j] = base + __popc(b & lt);
    base += __popc(b);
  }
  return base;
}

// one-hot of the lowest tid in mask (all false when the mask is empty)
template <int NS>
__device__ __forceinline__ void w_first(const bool (&m)[NS], bool (&oh)[NS]) {
  const unsigned lane = lane_id();
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

// fmodf(x, 1.0f) for every finite x, without fmodf's reduction loop: x -
// truncf(x) is the fractional part exactly (for |x| >= 1 the two share an
// exponent within a factor of two, so the difference is exact; for |x| >=
// 2^23 both are integers and it is 0), and copysignf gives a zero result
// x's sign, as fmodf does.  For x >= 0 it is also Python's x % 1.0.
__device__ __forceinline__ float frac1(float x) {
  return copysignf(x - truncf(x), x);
}

// Python's `%` (floor modulo) for a positive modulus
__device__ __forceinline__ int mod_floor(int x, int q) {
  return ((x % q) + q) % q;
}

// Python's `//` (floor division) for a non-zero divisor
__device__ __forceinline__ int div_floor(int x, int q) {
  const int d = x / q;
  return (x % q != 0 && ((x < 0) != (q < 0))) ? d - 1 : d;
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

// -- the oracle rows (policy.ORACLE_ROWS selected by id, ref.oracle_update_ref)
// One observation of family `oracle` with the A16-A17 clamp applied to
// delta, in the reference's arithmetic (floor division, arithmetic shift).
// An id outside the registry takes the HISTORY arm: the wrappers reject such
// ids before a launch.
__device__ __forceinline__ void oracle_rows(int oracle, int spun, int slept,
                                            int sws, int cnt, int ewma, int k,
                                            int sws_max, int& delta, int& cnt2,
                                            int& ewma2) {
  const int late = slept * (1 - spun);
  ewma2 = ewma;
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
      delta = late * 1 + hitk * (-(sws >> 1));  // sws // 2
      cnt2 = (1 - late) * (1 - hitk) * c1;
    } break;
    case ORACLE_FIXED:
      delta = k - sws;
      cnt2 = 0;
      break;
    default: {  // ORACLE_HISTORY
      ewma2 = ewma + ((late * EWMA_ONE - ewma) >> EWMA_SHIFT);
      int target = div_floor(EWMA_ONE, k + 1);
      int grow = ewma2 > 2 * target ? 1 : 0;
      int shrink = (2 * ewma2 < target ? 1 : 0) * (1 - grow);
      delta = grow * sws + shrink * (-1);
      cnt2 = 0;
    } break;
  }
  delta = min(max(delta, 1 - sws), sws_max - sws);
}

// -- oracle rows + C1/C2 correction at an acquisition (ref.oracle_acquire) --
__device__ __forceinline__ void oracle_acquire(bool happened, int spun_w,
                                               int slept_w, int thc, int oracle,
                                               int k, int sws_max, unsigned row,
                                               int& sws, int& cnt, int& ewma,
                                               int& wuc) {
  if (!(happened && (row & F_WINDOWED))) return;
  if (row & F_BSCALED) spun_w = 0;
  int delta, cnt2, ewma2;
  oracle_rows(oracle, spun_w, slept_w, sws, cnt, ewma, k, sws_max, delta,
              cnt2, ewma2);
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

// -- GPS advance without the fault rewind (ref.lock_sim_step_ref) -----------
// Advances rem in place and returns the row's spin burn n_spin * d_rate, the
// order-free closed form of the reference's lane sum.  The block kernel
// writes the same arithmetic out with the fault rewind interleaved slot by
// slot, as it always has: a shared form (a per-slot hook, or a second loop
// for the rewind) moved its register counts by one to five.
template <int NS>
__device__ __forceinline__ float gps_advance(const int (&st)[NS],
                                             float (&rem)[NS], float alpha,
                                             float cores, float dt,
                                             bool has_budget) {
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
  const float burn = n_spin * d_rate;
  UNROLL for (int j = 0; j < NS; ++j) {
    if (st[j] == ST_CS) rem[j] = rem[j] - d_hold;
    else if (st[j] == ST_NCS) rem[j] = rem[j] - d_rate;
    else if (spin[j] && has_budget) rem[j] = rem[j] - d_rate;
  }
  return burn;
}

// -- the row's transition state ----------------------------------------------
// Per-lane state, held in registers (req_t only in the open variant).
template <int NS>
struct Lanes {
  int st[NS], slept[NS], spun[NS], tk[NS], cpt[NS];
  float rem[NS], wk[NS], req_t[NS];
  unsigned ctr[NS];
  // fixed per launch: thread id and active (tid < threads); the persistent
  // per-thread workload state sits in the row's slot (RowSlot)
  unsigned tid[NS];
  bool active[NS];
};

// The config row's columns, loaded once, and its derived constants.
struct RowCtx {
  unsigned row;
  int threads;
  float dt, wake, cs_lo, cs_hi, ncs_lo, ncs_hi;
  int k, sws_max;
  float spin_budget;
  unsigned seed;
  int oracle, workload;
  float wl_period, wl_duty, wl_burst, wl_spread;
  bool tb_random;
  int fault;
  float flt_rate, flt_scale, park_cost;
  // the discipline row's capability flags and rules
  bool hand_f, fifo_f, budget_f, w2s_f, repark_f, win_f, bscale_f, backoff_f;
  int arrive_rule, quota_rule;
  float teps, wake_base;
  // open loop (AR_CLOSED and zeros in the closed variant); the admission's
  // floor(rate * dt) and its remainder, per value of the burst gate
  // (ar_mf[g], ar_fr[g] for gate_on = g)
  int arrival, q_cap;
  float slo, ar_phase;
  float ar_mf0, ar_fr0, ar_mf1, ar_fr1;
  bool openc;
  // the block kernel's GPS columns (zeros in the transition kernel)
  float alpha, cores;
};

// The config row's (C,) state that only the lane stages touch (departed,
// slo_viol and lat_sum: zeros in the closed variant).  The kernels keep it in
// the warp's slot of shared memory beside the row context.
struct RowState {
  int sws, cnt, ewma, wuc, permits, nticket, completed, wake_count;
  int qhead, arrived, shed, departed, slo_viol;
  float lat_sum;
};

// The open row's queue length and occupancy integral, which every step
// moves: in registers (zeros in the closed variant).
struct Queue {
  int qlen;
  float occ_int;
};

// The arrival row's instantaneous rate (policy.arrival_rate_at) at burst gate
// gate_on (0 or 1)
__device__ __forceinline__ float arrival_rate(int arrival, float arr_rate,
                                              float gate_on, float burst) {
  switch (arrival) {
    case AR_POISSON:
      return arr_rate * 1.0f;
    case AR_BURSTY:
      return arr_rate * (1.0f + gate_on * (burst - 1.0f));
    default:  // AR_CLOSED
      return arr_rate * 0.0f;
  }
}

// The row's closed-loop columns and the discipline row's flags; load_open
// adds the open-loop columns, derive_row_ctx the derived constants.
__device__ __forceinline__ RowCtx load_row_ctx(const BlockArgs& a, int c) {
  RowCtx r;
  r.row = kPolicyRow[a.policy[c]];
  r.threads = a.threads[c];
  r.dt = a.dt[c];
  r.wake = a.wake[c];
  r.cs_lo = a.cs_lo[c];
  r.cs_hi = a.cs_hi[c];
  r.ncs_lo = a.ncs_lo[c];
  r.ncs_hi = a.ncs_hi[c];
  r.k = a.k[c];
  r.sws_max = a.sws_max[c];
  r.spin_budget = a.spin_budget[c];
  r.seed = a.seed[c];
  r.oracle = a.oracle[c];
  r.workload = a.workload[c];
  r.wl_period = a.wl_period[c];
  r.wl_duty = a.wl_duty[c];
  r.wl_burst = a.wl_burst[c];
  r.wl_spread = a.wl_spread[c];
  r.tb_random = a.tb[c] > 0;
  r.fault = a.fault[c];
  r.flt_rate = a.flt_rate[c];
  r.flt_scale = a.flt_scale[c];
  r.park_cost = a.park_cost[c];
  r.hand_f = r.row & F_HANDOFF;
  r.fifo_f = r.row & F_FIFO;
  r.budget_f = r.row & F_BUDGET;
  r.w2s_f = r.row & F_W2S;
  r.repark_f = r.row & F_REPARK;
  r.win_f = r.row & F_WINDOWED;
  r.bscale_f = r.row & F_BSCALED;
  r.backoff_f = r.row & F_BACKOFF;
  r.arrive_rule = (r.row >> 8) & 0xF;
  r.quota_rule = (r.row >> 12) & 0xF;
  r.arrival = AR_CLOSED;
  r.q_cap = 0;
  r.slo = 0.0f;
  r.ar_phase = 0.0f;
  r.ar_mf0 = r.ar_fr0 = r.ar_mf1 = r.ar_fr1 = 0.0f;
  r.openc = false;
  r.alpha = r.cores = 0.0f;
  return r;
}

// Load the row's lanes (and derive their fixed per-launch values).
template <int NS, bool OPEN>
__device__ __forceinline__ void load_lanes(const BlockArgs& a, int c, int T,
                                           unsigned lane, const RowCtx& r,
                                           Lanes<NS>& L, float* phase_u,
                                           float* tscale) {
  UNROLL for (int j = 0; j < NS; ++j) {
    L.tid[j] = j * 32 + lane;
    const bool valid = (int)L.tid[j] < T;
    const long long g = (long long)c * T + L.tid[j];
    // lanes past T sit in DONE, inert in every mask (never stored)
    L.st[j] = valid ? a.st[g] : ST_DONE;
    L.rem[j] = valid ? a.rem[g] : 0.0f;
    L.wk[j] = valid ? a.wake_at[g] : 0.0f;
    L.slept[j] = valid ? a.slept[g] : 0;
    L.spun[j] = valid ? a.spun[g] : 0;
    L.ctr[j] = valid ? a.ctr[g] : 0u;
    L.tk[j] = valid ? a.ticket[g] : NO_TICKET;
    L.cpt[j] = valid ? a.cpt[g] : 0;
    if constexpr (OPEN) L.req_t[j] = valid ? a.req_t[g] : -1.0f;
    L.active[j] = (int)L.tid[j] < r.threads;
    // persistent per-thread workload state (ref.workload_state)
    phase_u[L.tid[j]] = counter_uniform(r.seed ^ WL_PHASE_SALT, L.tid[j], 0u);
    tscale[L.tid[j]] = r.workload == WL_HETERO
                      ? powf(r.wl_spread,
                             2.0f * counter_uniform(r.seed ^ WL_SPREAD_SALT,
                                                    L.tid[j], 0u) -
                                 1.0f)
                      : 1.0f;
  }
}

__device__ __forceinline__ RowState load_row_state(const BlockArgs& a, int c) {
  RowState s;
  s.sws = a.sws[c];
  s.cnt = a.cnt[c];
  s.ewma = a.ewma[c];
  s.wuc = a.wuc[c];
  s.permits = a.permits[c];
  s.nticket = a.nticket[c];
  s.completed = a.completed[c];
  s.wake_count = a.wake_count[c];
  s.qhead = s.arrived = s.shed = s.departed = s.slo_viol = 0;
  s.lat_sum = 0.0f;
  return s;
}

// The warp's slot of shared memory: the row context and state, copied in by
// lane 0 once the row is loaded, and each thread's persistent workload state
// (ref.workload_state), written by its lane.  The stages reach the slot
// through a volatile reference, field by field where they use it, so that
// none of it sits in every lane's registers for the whole launch.  Every
// lane writes a state field with the same value, and reads back its own
// write.
template <int NS>
struct RowSlot {
  RowCtx ctx;
  RowState st;
  float phase_u[32 * NS], tscale[32 * NS];
  int arr[32];  // the block kernel's arrivals of 32 sub-steps, one a lane
};

template <int NS>
__device__ __forceinline__ volatile RowSlot<NS>& publish_row(
    RowSlot<NS>* slot, const RowCtx& r, const RowState& s, unsigned lane) {
  if (lane == 0) {
    slot->ctx = r;
    slot->st = s;
  }
  __syncwarp();
  return *slot;
}

// The row's derived constants, set after its state is loaded (the order the
// block kernel has always had; an earlier one changes its register counts).
__device__ __forceinline__ void derive_row_ctx(RowCtx& r) {
  r.teps = r.dt * 1e-3f;
  r.wake_base = r.wake * r.park_cost;
}

// The open variant's row: its request ring qbuf[QUEUE_MAX] f32 and latency
// histogram hist[LAT_NBINS] i32 into the warp's slice of shared memory, its
// open-loop columns and its counters.
__device__ __forceinline__ void load_open(const BlockArgs& a, int c,
                                          unsigned lane, float* qb, int* hs,
                                          RowCtx& r, RowState& s, Queue& q) {
  const long long qrow = (long long)c * QUEUE_MAX;
  const long long hrow = (long long)c * LAT_NBINS;
  UNROLL for (int j = 0; j < QUEUE_MAX / 32; ++j)
    qb[j * 32 + lane] = a.qbuf[qrow + j * 32 + lane];
  UNROLL for (int j = 0; j < LAT_NBINS / 32; ++j)
    hs[j * 32 + lane] = a.hist[hrow + j * 32 + lane];
  __syncwarp();
  r.arrival = a.arrival[c];
  r.q_cap = a.q_cap[c];
  r.slo = a.slo[c];
  r.ar_phase = counter_uniform(r.seed ^ AR_PHASE_SALT, 0u, 0u);
  r.openc = r.arrival != AR_CLOSED;
  // rate * dt takes two values, one per gate: split each once per launch
  const float arr_rate = a.arr_rate[c];
  const float m0 = arrival_rate(r.arrival, arr_rate, 0.0f, r.wl_burst) * r.dt;
  const float m1 = arrival_rate(r.arrival, arr_rate, 1.0f, r.wl_burst) * r.dt;
  r.ar_mf0 = floorf(m0);
  r.ar_fr0 = m0 - r.ar_mf0;
  r.ar_mf1 = floorf(m1);
  r.ar_fr1 = m1 - r.ar_mf1;
  s.qhead = a.qhead[c];
  q.qlen = a.qlen[c];
  s.arrived = a.arrived[c];
  s.shed = a.shed[c];
  q.occ_int = a.occ_int[c];
  s.departed = a.departed[c];
  s.slo_viol = a.slo_viol[c];
  s.lat_sum = a.lat_sum[c];
}

// Store the lanes, then (OPEN) the ring, histogram and open counters, then
// the row state and (CPU, the block kernel) spin_cpu.
template <int NS, bool OPEN, bool CPU = false>
__device__ __forceinline__ void store_row(const BlockArgs& a, int c, int T,
                                          unsigned lane, const Lanes<NS>& L,
                                          const volatile RowState& s,
                                          const Queue& q, const float* qb,
                                          const int* hs,
                                          float spin_cpu = 0.0f) {
  UNROLL for (int j = 0; j < NS; ++j) {
    if ((int)L.tid[j] < T) {
      const long long g = (long long)c * T + L.tid[j];
      a.o_st[g] = L.st[j];
      a.o_rem[g] = L.rem[j];
      a.o_wake_at[g] = L.wk[j];
      a.o_slept[g] = L.slept[j];
      a.o_spun[g] = L.spun[j];
      a.o_ctr[g] = L.ctr[j];
      a.o_ticket[g] = L.tk[j];
      a.o_cpt[g] = L.cpt[j];
      if constexpr (OPEN) a.o_req_t[g] = L.req_t[j];
    }
  }
  if constexpr (OPEN) {
    const long long qrow = (long long)c * QUEUE_MAX;
    const long long hrow = (long long)c * LAT_NBINS;
    __syncwarp();
    UNROLL for (int j = 0; j < QUEUE_MAX / 32; ++j)
      a.o_qbuf[qrow + j * 32 + lane] = qb[j * 32 + lane];
    UNROLL for (int j = 0; j < LAT_NBINS / 32; ++j)
      a.o_hist[hrow + j * 32 + lane] = hs[j * 32 + lane];
    if (lane == 0) {
      a.o_qhead[c] = s.qhead;
      a.o_qlen[c] = q.qlen;
      a.o_arrived[c] = s.arrived;
      a.o_shed[c] = s.shed;
      a.o_departed[c] = s.departed;
      a.o_slo_viol[c] = s.slo_viol;
      a.o_lat_sum[c] = s.lat_sum;
      a.o_occ_int[c] = q.occ_int;
    }
  }
  if (lane == 0) {
    a.o_sws[c] = s.sws;
    a.o_cnt[c] = s.cnt;
    a.o_ewma[c] = s.ewma;
    a.o_wuc[c] = s.wuc;
    a.o_permits[c] = s.permits;
    a.o_nticket[c] = s.nticket;
    a.o_completed[c] = s.completed;
    a.o_wake_count[c] = s.wake_count;
    if constexpr (CPU) a.o_spin_cpu[c] = spin_cpu;
  }
}


// -- one transition stage (ref.lock_transitions_ref) ----------------------------
// Stages, in the order the event-driven DES resolves a timestep: [open-loop
// admission] -> budget exhaustion -> wake completions -> CS release/handoff
// [+ open-loop departure] -> backoff polls -> arrivals -> ticket retire
// [-> open-loop binding + occupancy].  `now2` is the step's end time,
// `now_teps` now2 + teps (the wake test's tolerance) and `stepu` the step's
// index, the counter of the per-step RNG streams.
//
// The five lane stages from budget exhaustion to arrivals each fire on a mask
// of the row's lanes; while all five masks are empty none of them changes
// anything, so one ballot (any_event) decides whether event_stages runs at
// all.  The block kernel's sub-step is mostly such a step.

// Does any lane of the row meet one of the five lane stages' tests?
template <int NS>
__device__ __forceinline__ bool any_event(unsigned row, const Lanes<NS>& L,
                                          float now_teps) {
  bool ev[NS];
  UNROLL for (int j = 0; j < NS; ++j) {
    const int st = L.st[j];
    const bool rem_due = L.rem[j] <= REM_EPS;  // budget, release, arrival
    const bool wk_due = L.wk[j] <= now_teps;   // wake, backoff poll
    ev[j] = (rem_due && (st == ST_CS || (st == ST_NCS && L.active[j]) ||
                         (st == ST_SPIN && (row & F_BUDGET)))) ||
            (wk_due &&
             (st == ST_WAKING || (st == ST_SPIN && (row & F_BACKOFF))));
  }
  return w_any<NS>(ev);
}

// The open row's arrivals at step stepu (time now2): floor(rate * dt) plus a
// Bernoulli trial on the remainder.  rate * dt is split once per launch
// (RowCtx.ar_mf*, ar_fr*), so only the burst gate, read on bursty rows, and
// the trial's hash depend on the step.
__device__ __forceinline__ int arrivals_at(const volatile RowCtx& r,
                                           float now2, unsigned stepu) {
  bool on = false;
  if (r.arrival == AR_BURSTY)
    on = !(frac1(now2 / r.wl_period + r.ar_phase) >= r.wl_duty);
  const float mf = on ? r.ar_mf1 : r.ar_mf0;
  const float fr = on ? r.ar_fr1 : r.ar_fr0;
  const float u = counter_uniform(r.seed ^ AR_SALT, 0u, stepu);
  return (int)(mf + (u < fr ? 1.0f : 0.0f));
}

// The open-loop admission of n_arr arrivals (first in the step: a request
// admitted at step i is in the system for steps i..j-1 when it departs at
// step j); the queue bound sheds the rest.  Returns the count admitted; the
// caller counts n_arr into `arrived` and the rest into `shed`.
__device__ __forceinline__ int admit(int q_cap, int qhead, Queue& q,
                                     float* qb, int n_arr, float now2,
                                     unsigned lane) {
  const int n_adm = min(n_arr, q_cap - q.qlen);
  if (n_adm > 0) {
    const int tail = qhead + q.qlen;
    UNROLL for (int j = 0; j < QUEUE_MAX / 32; ++j) {
      const int qi = j * 32 + (int)lane;
      if (mod_floor(qi - tail, QUEUE_MAX) < n_adm) qb[qi] = now2;
    }
    __syncwarp();
  }
  q.qlen += n_adm;
  return n_adm;
}

// A parked thread's wake time (now2 + the fault row's wake delay)
__device__ __forceinline__ float wake_due_of(const volatile RowCtx& r,
                                             unsigned tid, float now2,
                                             unsigned stepu) {
  float wake_eff = r.wake_base;
  if (r.fault == FAULT_LOSTWAKE || r.fault == FAULT_JITTER) {
    const float w1 = counter_uniform(r.seed ^ FLT_WAKE_SALT, tid, stepu);
    if (w1 < r.flt_rate) {
      if (r.fault == FAULT_LOSTWAKE) {
        wake_eff = r.wake_base + (r.flt_scale - r.wake_base);
      } else {
        const float w2 = counter_uniform(r.seed ^ FLT_MAG_SALT, tid, stepu);
        wake_eff = r.wake_base + r.flt_scale * w2;
      }
    }
  }
  return now2 + wake_eff;
}

// The five lane stages, from budget exhaustion to arrivals.
template <int NS, bool OPEN>
__device__ __forceinline__ void event_stages(volatile RowSlot<NS>& S,
                                             Lanes<NS>& L, int* hs,
                                             float now2, float now_teps,
                                             unsigned stepu) {
  const float inf = __int_as_float(0x7f800000);
  int(&st)[NS] = L.st;
  int(&slept)[NS] = L.slept;
  int(&spun)[NS] = L.spun;
  int(&tk)[NS] = L.tk;
  int(&cpt)[NS] = L.cpt;
  float(&rem)[NS] = L.rem;
  float(&wk)[NS] = L.wk;
  float(&req_t)[NS] = L.req_t;
  unsigned(&ctr)[NS] = L.ctr;
  const unsigned(&tid)[NS] = L.tid;
  const bool(&active)[NS] = L.active;
  const volatile RowCtx& r = S.ctx;
  volatile RowState& rs = S.st;
  volatile int& sws = rs.sws;
  volatile int& wuc = rs.wuc;
  volatile int& permits = rs.permits;
  volatile int& nticket = rs.nticket;
  volatile int& completed = rs.completed;
  volatile int& wake_count = rs.wake_count;
  volatile int& departed = rs.departed;
  volatile int& slo_viol = rs.slo_viol;
  volatile float& lat_sum = rs.lat_sum;
  bool m[NS], oh[NS];
  int rk[NS];
  // The row's counters are read and written by every lane at once, each
  // writing the same value: the warp stays converged through the stages
  // (every branch below the per-lane ones is warp-uniform).
  __syncwarp();

// oracle_acquire on the row's counters in shared memory
#define ORACLE_ACQUIRE(happened, spun_w, slept_w, thc)                      \
  {                                                                         \
    int sws_ = rs.sws, cnt_ = rs.cnt, ewma_ = rs.ewma, wuc_ = rs.wuc;       \
    oracle_acquire(happened, spun_w, slept_w, thc, r.oracle, r.k,           \
                   r.sws_max, r.row, sws_, cnt_, ewma_, wuc_);              \
    rs.sws = sws_;                                                          \
    rs.cnt = cnt_;                                                          \
    rs.ewma = ewma_;                                                        \
    rs.wuc = wuc_;                                                          \
  }

#define BUDGET_EFF() \
  (r.spin_budget * (r.bscale_f ? (float)sws * r.park_cost : 1.0f))

// CS / NCS duration draw on the lanes of a mask; bumps their counters.  An
// NCS draw on a bursty row reads the thread's OFF gate at now2.
#define DRAW_INTO(mask, lo, hi, is_ncs, new_st)                             \
  UNROLL for (int j = 0; j < NS; ++j) if (mask[j]) {                        \
    const float u = counter_uniform(r.seed, tid[j], ctr[j]);                \
    float gate_off = 0.0f;                                                  \
    if ((is_ncs) && r.workload == WL_BURSTY)                                \
      gate_off = frac1(now2 / r.wl_period + S.phase_u[tid[j]]) >= r.wl_duty \
                     ? 1.0f : 0.0f;                                         \
    rem[j] = workload_draw(u, lo, hi, is_ncs, r.workload, gate_off,         \
                           S.tscale[tid[j]], r.wl_burst);                   \
    ctr[j] = ctr[j] + 1u;                                                   \
    st[j] = new_st;                                                         \
  }

// ref.park: park the lanes of a mask, absorbing banked permits.  The
// lanes ranked below `permits` are granted: min(count, permits) of them, or
// none when permits <= 0.  An empty mask changes nothing.
#define PARK(mask)                                                          \
  {                                                                         \
    const int n_mask = w_rank<NS>(mask, rk);                            \
    if (n_mask > 0) {                                                       \
      const int held = permits;                                             \
      UNROLL for (int j = 0; j < NS; ++j) {                                 \
        if (mask[j] && rk[j] < held) {                                      \
          st[j] = ST_WAKING;                                                \
          wk[j] = wake_due_of(r, tid[j], now2, stepu);                      \
        } else if (mask[j]) st[j] = ST_SLEEP;                               \
        if (mask[j]) { slept[j] = 1; rem[j] = inf; }                        \
      }                                                                     \
      const int n_grant = max(0, min(n_mask, held));                        \
      permits = held - n_grant;                                             \
      wake_count += n_grant;                                                \
    }                                                                       \
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

  // ---- spin-budget exhaustion -> sleep ------------------------------------
  if (r.budget_f) {
    UNROLL for (int j = 0; j < NS; ++j)
      m[j] = st[j] == ST_SPIN && rem[j] <= REM_EPS;
    PARK(m)
  }

  // ---- wake completions -------------------------------------------------------
  {
    bool due[NS];
    UNROLL for (int j = 0; j < NS; ++j)
      due[j] = st[j] == ST_WAKING && wk[j] <= now_teps;
    if (w_any<NS>(due)) {
      bool holder_free;
      HOLDER_FREE(holder_free)
      if (r.fifo_f) {
        int wkey[NS];
        UNROLL for (int j = 0; j < NS; ++j)
          wkey[j] = due[j] ? tk[j] : NO_TICKET;
        const int mn = w_min<NS>(wkey);
        UNROLL for (int j = 0; j < NS; ++j) m[j] = due[j] && wkey[j] == mn;
        w_first<NS>(m, oh);
      } else {
        w_first<NS>(due, oh);
      }
      UNROLL for (int j = 0; j < NS; ++j) oh[j] = oh[j] && holder_free;
      const bool anyA = w_any<NS>(oh);
      const int spun_w = w_sum_where<NS>(oh, spun);
      const int slept_w = w_sum_where<NS>(oh, slept);
      DRAW_INTO(oh, r.cs_lo, r.cs_hi, false, ST_CS)
      int thc;
      THC_OF(thc)
      ORACLE_ACQUIRE(anyA, spun_w, slept_w, thc)
      // losers: woken into the spinning window, or barged and parked again
      UNROLL for (int j = 0; j < NS; ++j) {
        const bool loser = due[j] && !oh[j];
        if (loser && r.w2s_f) {
          st[j] = ST_SPIN;
          spun[j] = 1;
          rem[j] = r.budget_f ? BUDGET_EFF() : inf;
        }
        m[j] = loser && r.repark_f;
      }
      if (r.repark_f) PARK(m)
    }
  }

  // ---- CS completion / release ---------------------------------------------
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
      const bool do_latch = r.win_f;
      const int r_wuc = (do_latch && wuc >= 0) ? wuc : -1;
      if (do_latch) wuc = wuc >= 0 ? 0 : wuc + 1;
      DRAW_INTO(done, r.ncs_lo, r.ncs_hi, true, ST_NCS)
      // open-loop departure: the request leaves, its latency lands in the
      // histogram and the counters, and its slot frees (DONE)
      if constexpr (OPEN) {
        if (r.openc) {
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
              viol[j] = latv > r.slo;
              st[j] = ST_DONE;
              rem[j] = inf;
              req_t[j] = -1.0f;
            }
          }
          const int dep_bin = __reduce_add_sync(FULL_MASK, bsum);
          const float lat = w_fsum(lsum);
          if (lane_id() == 0 && dep_bin < LAT_NBINS) hs[dep_bin] += 1;
          lat_sum = lat_sum + lat;
          departed += 1;
          slo_viol += w_count<NS>(viol);
        }
      }
      // handoff: ticket order on FIFO rows, else thread id or a seeded
      // random key; equal keys fall back to the lowest id
      bool spinners[NS];
      UNROLL for (int j = 0; j < NS; ++j) spinners[j] = st[j] == ST_SPIN;
      const bool can_handoff = r.hand_f && w_any<NS>(spinners);
      if (can_handoff) {
        if (r.fifo_f || r.tb_random) {
          int key[NS];
          UNROLL for (int j = 0; j < NS; ++j) {
            const int kj =
                r.fifo_f ? tk[j]
                         : (int)(counter_uniform(r.seed ^ TB_SALT, tid[j],
                                                 stepu) *
                                 8388608.0f);
            key[j] = spinners[j] ? kj : NO_TICKET;
          }
          const int mn = w_min<NS>(key);
          UNROLL for (int j = 0; j < NS; ++j)
            m[j] = spinners[j] && key[j] == mn;
          w_first<NS>(m, oh);
        } else {  // key = tid: the lowest spinner
          w_first<NS>(spinners, oh);
        }
        const int spun_w = w_sum_where<NS>(oh, spun);
        const int slept_w = w_sum_where<NS>(oh, slept);
        DRAW_INTO(oh, r.cs_lo, r.cs_hi, false, ST_CS)
        ORACLE_ACQUIRE(true, spun_w, slept_w, thc_pre - 1)
      }
      // wake quota by discipline rule
      bool parked[NS], sleepers[NS];
      UNROLL for (int j = 0; j < NS; ++j) {
        sleepers[j] = st[j] == ST_SLEEP;
        parked[j] = sleepers[j] || st[j] == ST_WAKING;
      }
      const int n_parked = w_count<NS>(parked);
      int quota = 0;
      switch (r.quota_rule) {
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
      int n_sel;
      if (r.fifo_f) {
        int skey[NS];
        UNROLL for (int j = 0; j < NS; ++j)
          skey[j] = sleepers[j] ? tk[j] : NO_TICKET;
        const int mn = w_min<NS>(skey);
        UNROLL for (int j = 0; j < NS; ++j)
          m[j] = sleepers[j] && skey[j] == mn;
        w_first<NS>(m, sel);
        UNROLL for (int j = 0; j < NS; ++j) sel[j] = sel[j] && quota > 0;
        n_sel = w_count<NS>(sel);
      } else {  // the quota lowest sleepers
        const int n_sleep = w_rank<NS>(sleepers, rk);
        UNROLL for (int j = 0; j < NS; ++j)
          sel[j] = sleepers[j] && rk[j] < quota;
        n_sel = max(0, min(n_sleep, quota));
      }
      UNROLL for (int j = 0; j < NS; ++j) if (sel[j]) {
        st[j] = ST_WAKING;
        wk[j] = wake_due_of(r, tid[j], now2, stepu);
      }
      wake_count += n_sel;
      permits += quota - n_sel;  // park-free permits are banked
    }
  }

  // ---- ttas_backoff polls ------------------------------------------------------
  float bo_u[NS];
  if (r.backoff_f) {
    bool poll[NS];
    UNROLL for (int j = 0; j < NS; ++j) {
      bo_u[j] = counter_uniform(r.seed ^ BO_SALT, tid[j], stepu);
      poll[j] = st[j] == ST_SPIN && wk[j] <= now_teps;
    }
    bool holder_free;
    HOLDER_FREE(holder_free)
    w_first<NS>(poll, oh);
    UNROLL for (int j = 0; j < NS; ++j) oh[j] = oh[j] && holder_free;
    DRAW_INTO(oh, r.cs_lo, r.cs_hi, false, ST_CS)
    UNROLL for (int j = 0; j < NS; ++j) if (poll[j] && !oh[j]) {
      tk[j] = (int)((unsigned)tk[j] + 1u);  // wraps like the int32 tensor
      const float bo_exp = exp2f((float)min(tk[j], BO_CAP));
      wk[j] = now2 + r.spin_budget * bo_exp * bo_u[j];
    }
  }

  // ---- arrivals (NCS finished) ------------------------------------------------
  {
    bool arr[NS];
    UNROLL for (int j = 0; j < NS; ++j)
      arr[j] = st[j] == ST_NCS && rem[j] <= REM_EPS && active[j];
    if (w_any<NS>(arr)) {
      int thc_base;
      THC_OF(thc_base)
      w_rank<NS>(arr, rk);
      bool holder_free;
      HOLDER_FREE(holder_free)
      bool sleeps[NS], nonsleep[NS];
      UNROLL for (int j = 0; j < NS; ++j) {
        if (arr[j]) { slept[j] = 0; spun[j] = 0; }
        const int thc_pre_i = thc_base + rk[j];
        bool sl;
        switch (r.arrive_rule) {
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
      w_first<NS>(nonsleep, oh);
      UNROLL for (int j = 0; j < NS; ++j) oh[j] = oh[j] && holder_free;
      const bool anyC = w_any<NS>(oh);
      // arrivals have just cleared their slept / spun flags
      DRAW_INTO(oh, r.cs_lo, r.cs_hi, false, ST_CS)
      ORACLE_ACQUIRE(anyC, 0, 0, thc_base + 1)
      bool joiners[NS];
      UNROLL for (int j = 0; j < NS; ++j) {
        m[j] = nonsleep[j] && !oh[j];  // to_spinC
        if (m[j]) {
          st[j] = ST_SPIN;
          spun[j] = 1;
          rem[j] = r.budget_f ? BUDGET_EFF() : inf;
        }
        joiners[j] = m[j] || (sleeps[j] && r.fifo_f);
      }
      const int n_join = w_rank<NS>(joiners, rk);
      UNROLL for (int j = 0; j < NS; ++j) {
        if (joiners[j]) tk[j] = nticket + rk[j];
        if (m[j] && r.backoff_f) {  // first re-poll within one base delay
          tk[j] = 0;
          wk[j] = now2 + r.spin_budget * bo_u[j];
        }
      }
      nticket += n_join;
      PARK(sleeps)
    }
  }

  __syncwarp();

#undef ORACLE_ACQUIRE
#undef BUDGET_EFF
#undef PARK
#undef THC_OF
#undef HOLDER_FREE
}

// ---- retire tickets: only queued threads hold one -------------------------
template <int NS>
__device__ __forceinline__ void retire(unsigned row, Lanes<NS>& L) {
  UNROLL for (int j = 0; j < NS; ++j) {
    const int st = L.st[j];
    const bool queued = st == ST_SPIN || ((row & F_FIFO) &&
                                          (st == ST_SLEEP || st == ST_WAKING));
    if (!queued) L.tk[j] = NO_TICKET;
  }
}

// The open row's free slots (active, DONE) and busy slots (active, holding a
// request).
template <int NS>
__device__ __forceinline__ int count_free(const Lanes<NS>& L) {
  bool f[NS];
  UNROLL for (int j = 0; j < NS; ++j) f[j] = L.active[j] && L.st[j] == ST_DONE;
  return w_count<NS>(f);
}

template <int NS>
__device__ __forceinline__ int count_busy(const Lanes<NS>& L) {
  bool b[NS];
  UNROLL for (int j = 0; j < NS; ++j) b[j] = L.active[j] && L.req_t[j] >= 0.0f;
  return w_count<NS>(b);
}

// ---- open-loop binding: the n_bind = min(qlen, n_free) oldest queued
// requests claim the lowest free slots; returns n_bind ------------------------
template <int NS>
__device__ __forceinline__ int bind(volatile RowSlot<NS>& S, Queue& q,
                                    Lanes<NS>& L, const float* qb, int n_free,
                                    float now2) {
  const int n_bind = min(q.qlen, n_free);
  if (n_bind <= 0) return 0;
  int(&st)[NS] = L.st;
  float(&rem)[NS] = L.rem;
  unsigned(&ctr)[NS] = L.ctr;
  const unsigned(&tid)[NS] = L.tid;
  const volatile RowCtx& r = S.ctx;
  bool freem[NS], bindm[NS];
  int rk[NS];
  float rt[NS];
  UNROLL for (int j = 0; j < NS; ++j)
    freem[j] = L.active[j] && st[j] == ST_DONE;
  w_rank<NS>(freem, rk);
  UNROLL for (int j = 0; j < NS; ++j) {
    bindm[j] = freem[j] && rk[j] < n_bind;
    rt[j] = bindm[j] ? qb[mod_floor(S.st.qhead + rk[j], QUEUE_MAX)] : 0.0f;
  }
  __syncwarp();  // reads land before the next admission writes
  DRAW_INTO(bindm, r.ncs_lo, r.ncs_hi, true, ST_NCS)
  UNROLL for (int j = 0; j < NS; ++j) if (bindm[j]) {
    L.req_t[j] = rt[j];
    L.slept[j] = 0;
    L.spun[j] = 0;
  }
  S.st.qhead = mod_floor(S.st.qhead + n_bind, QUEUE_MAX);
  q.qlen -= n_bind;
  return n_bind;
}

#undef DRAW_INTO

// The occupancy integral, last in the step: (qlen + busy slots) * dt
__device__ __forceinline__ void occupy(float dt, Queue& q, int n_busy) {
  q.occ_int = q.occ_int + (float)(q.qlen + n_busy) * dt;
}

// One whole transition stage (lock_transitions_step.cu; the block kernel runs
// the same pieces with its row counts carried between sub-steps).
template <int NS, bool OPEN>
__device__ __forceinline__ void transition_step(volatile RowSlot<NS>& S,
                                                Queue& q, Lanes<NS>& L,
                                                float* qb, int* hs, float now2,
                                                float now_teps, unsigned stepu,
                                                unsigned lane) {
  const volatile RowCtx& r = S.ctx;
  const unsigned row = r.row;
  if constexpr (OPEN) {
    const int n_arr = arrivals_at(r, now2, stepu);
    const int n_adm = admit(r.q_cap, S.st.qhead, q, qb, n_arr, now2, lane);
    S.st.arrived += n_arr;
    S.st.shed += n_arr - n_adm;
  }
  if (any_event<NS>(row, L, now_teps))
    event_stages<NS, OPEN>(S, L, hs, now2, now_teps, stepu);
  retire<NS>(row, L);
  if constexpr (OPEN) {
    if (r.openc) bind<NS>(S, q, L, qb, count_free<NS>(L), now2);
    occupy(r.dt, q, count_busy<NS>(L));
  }
}

}  // namespace
