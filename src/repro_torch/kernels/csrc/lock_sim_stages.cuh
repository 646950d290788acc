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
  // fixed per launch: thread id, active (tid < threads), and the persistent
  // per-thread workload state (ref.workload_state)
  unsigned tid[NS];
  bool active[NS];
  float phase_u[NS], tscale[NS];
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
  // open loop (AR_CLOSED and zeros in the closed variant)
  int arrival, q_cap;
  float arr_rate, slo, ar_phase;
  bool openc;
};

// The config row's (C,) state, in registers; the open counters in the open
// variant only.
struct RowState {
  int sws, cnt, ewma, wuc, permits, nticket, completed, wake_count;
  int qhead, qlen, arrived, shed, departed, slo_viol;
  float lat_sum, occ_int;
};

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
  r.arr_rate = 0.0f;
  r.slo = 0.0f;
  r.ar_phase = 0.0f;
  r.openc = false;
  return r;
}

// Load the row's lanes (and derive their fixed per-launch values).
template <int NS, bool OPEN>
__device__ __forceinline__ void load_lanes(const BlockArgs& a, int c, int T,
                                           unsigned lane, const RowCtx& r,
                                           Lanes<NS>& L) {
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
    L.phase_u[j] = counter_uniform(r.seed ^ WL_PHASE_SALT, L.tid[j], 0u);
    L.tscale[j] = r.workload == WL_HETERO
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
  s.qhead = s.qlen = s.arrived = s.shed = s.departed = s.slo_viol = 0;
  s.lat_sum = s.occ_int = 0.0f;
  return s;
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
                                          RowCtx& r, RowState& s) {
  const long long qrow = (long long)c * QUEUE_MAX;
  const long long hrow = (long long)c * LAT_NBINS;
  UNROLL for (int j = 0; j < QUEUE_MAX / 32; ++j)
    qb[j * 32 + lane] = a.qbuf[qrow + j * 32 + lane];
  UNROLL for (int j = 0; j < LAT_NBINS / 32; ++j)
    hs[j * 32 + lane] = a.hist[hrow + j * 32 + lane];
  __syncwarp();
  r.arrival = a.arrival[c];
  r.arr_rate = a.arr_rate[c];
  r.q_cap = a.q_cap[c];
  r.slo = a.slo[c];
  r.ar_phase = counter_uniform(r.seed ^ AR_PHASE_SALT, 0u, 0u);
  r.openc = r.arrival != AR_CLOSED;
  s.qhead = a.qhead[c];
  s.qlen = a.qlen[c];
  s.arrived = a.arrived[c];
  s.shed = a.shed[c];
  s.departed = a.departed[c];
  s.slo_viol = a.slo_viol[c];
  s.lat_sum = a.lat_sum[c];
  s.occ_int = a.occ_int[c];
}

// Store the lanes, then (OPEN) the ring, histogram and open counters, then
// the row state and (CPU, the block kernel) spin_cpu.
template <int NS, bool OPEN, bool CPU = false>
__device__ __forceinline__ void store_row(const BlockArgs& a, int c, int T,
                                          unsigned lane, const Lanes<NS>& L,
                                          const RowState& s, const float* qb,
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
      a.o_qlen[c] = s.qlen;
      a.o_arrived[c] = s.arrived;
      a.o_shed[c] = s.shed;
      a.o_departed[c] = s.departed;
      a.o_slo_viol[c] = s.slo_viol;
      a.o_lat_sum[c] = s.lat_sum;
      a.o_occ_int[c] = s.occ_int;
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
template <int NS, bool OPEN>
__device__ __forceinline__ void transition_step(const RowCtx& r, RowState& rs,
                                                Lanes<NS>& L, float* qb,
                                                int* hs, float now2,
                                                float now_teps, unsigned stepu,
                                                unsigned lane, unsigned lt) {
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
  const float(&phase_u)[NS] = L.phase_u;
  const float(&tscale)[NS] = L.tscale;
  int& sws = rs.sws;
  int& cnt = rs.cnt;
  int& ewma = rs.ewma;
  int& wuc = rs.wuc;
  int& permits = rs.permits;
  int& nticket = rs.nticket;
  int& completed = rs.completed;
  int& wake_count = rs.wake_count;
  int& qhead = rs.qhead;
  int& qlen = rs.qlen;
  int& arrived = rs.arrived;
  int& shed = rs.shed;
  int& departed = rs.departed;
  int& slo_viol = rs.slo_viol;
  float& lat_sum = rs.lat_sum;
  float& occ_int = rs.occ_int;
  const unsigned row = r.row;
  const float dt = r.dt, cs_lo = r.cs_lo, cs_hi = r.cs_hi;
  const float ncs_lo = r.ncs_lo, ncs_hi = r.ncs_hi;
  const int k = r.k, sws_max = r.sws_max;
  const float spin_budget = r.spin_budget;
  const unsigned seed = r.seed;
  const int oracle = r.oracle, workload = r.workload;
  const float wl_period = r.wl_period, wl_duty = r.wl_duty;
  const float wl_burst = r.wl_burst;
  const bool tb_random = r.tb_random;
  const int fault = r.fault;
  const float flt_rate = r.flt_rate, flt_scale = r.flt_scale;
  const float park_cost = r.park_cost, wake_base = r.wake_base;
  const int arrival = r.arrival, q_cap = r.q_cap;
  const float arr_rate = r.arr_rate, slo = r.slo, ar_phase = r.ar_phase;
  const bool openc = r.openc;
  const bool hand_f = r.hand_f, fifo_f = r.fifo_f;
  const bool budget_f = r.budget_f, w2s_f = r.w2s_f;
  const bool repark_f = r.repark_f, win_f = r.win_f;
  const bool bscale_f = r.bscale_f, backoff_f = r.backoff_f;
  const int arrive_rule = r.arrive_rule, quota_rule = r.quota_rule;

  bool m[NS], oh[NS];
  int rk[NS];

  // ---- per-step per-thread context ------------------------------------------
  float wake_due[NS], gate_off[NS];
  UNROLL for (int j = 0; j < NS; ++j) {
    float wake_eff = wake_base;
    if (fault == FAULT_LOSTWAKE || fault == FAULT_JITTER) {
      const float w1 = counter_uniform(seed ^ FLT_WAKE_SALT, tid[j], stepu);
      if (w1 < flt_rate) {
        if (fault == FAULT_LOSTWAKE) {
          wake_eff = wake_base + (flt_scale - wake_base);
        } else {
          const float w2 = counter_uniform(seed ^ FLT_MAG_SALT, tid[j], stepu);
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
  // system for steps i..j-1 when it departs at step j) ------------------------
  if constexpr (OPEN) {
    const float gate_on =
        1.0f -
        (fmodf(now2 / wl_period + ar_phase, 1.0f) >= wl_duty ? 1.0f : 0.0f);
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

  // ---- spin-budget exhaustion -> sleep ------------------------------------
  if (budget_f) {
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

  // ---- ttas_backoff polls ------------------------------------------------------
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

  // ---- arrivals (NCS finished) ------------------------------------------------
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

  // ---- retire tickets ------------------------------------------------------------
  UNROLL for (int j = 0; j < NS; ++j) {
    const bool queued =
        st[j] == ST_SPIN ||
        (fifo_f && (st[j] == ST_SLEEP || st[j] == ST_WAKING));
    if (!queued) tk[j] = NO_TICKET;
  }

  // ---- open-loop binding: queued requests claim free slots in queue
  // order; then the occupancy integral accumulates, last ---------------------
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

#undef BUDGET_EFF
#undef DRAW_INTO
#undef PARK
#undef THC_OF
#undef HOLDER_FREE
}

}  // namespace
