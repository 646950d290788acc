// lock_sim_block for Hopper: n_sub_steps fused timesteps of the batched lock
// simulator, closed-loop and open-loop variants.
//
// Replaces the Pallas TPU kernel repro/kernels/lock_sim.py:lock_sim_block
// (_block_kernel, both values of its static open_run flag); computes the same
// function as repro_torch/kernels/ref.py:lock_sim_block_ref, stage for stage.
//
// Design.  One warp owns one config row (layout and numerics: the header of
// lock_sim_stages.cuh).  The per-thread state lives in registers across the
// sub-step loop; the row's context and the counters only the lane stages
// touch live in the warp's slot of shared memory (RowSlot), read where they
// are used; everything is loaded once and stored once.  Each sub-step is the
// GPS advance, the fault rewind and one transition stage: the pieces of
// transition_step (lock_sim_stages.cuh), which lock_transitions_step.cu
// launches once per step; the advance is the arithmetic of gps_advance
// (lock_sim_step.cu), written out here with the rewind interleaved slot by
// slot.  Most sub-steps are quiet -- no lane meets a lane stage's test, no
// request enters the ring, none binds -- and take one ballot and one branch:
// the rates of the advance and the open row's free and busy counts carry over
// until a lane changes state, and the open row's arrivals, which depend on
// the step alone, are drawn 32 sub-steps at a time, one per lane.  A sub-step
// with step0 + s >= limit ends the loop (the reference's passthrough mask).
//
// What bounds it.  Per launch a row moves (8 T + 9) * 4 bytes of state each
// way plus 28 context words, once for all n_sub_steps: 0.0438 ms at
// 65 536 x 32, less than the idle sub-steps' operations take at the card's
// 128 f32 lane operations a clock and SM (0.053 ms, the bound, PERF.md); the
// open variant is bound by its bytes (0.122 ms at 100 080 x 32).  The card measured the
// kernel latency-bound, not issue-bound (chip_smoke.py's rows_per_sm_ms):
// the time grows 1.14x from 4 warps an SM to 24, so one warp's chain of
// dependent ballots, shuffles and branches sets the pace, and what helps is
// a shorter chain per sub-step and more warps in flight -- which the slot
// buys by taking the row context out of every lane's registers.  At the
// open kernel's limit of 32 warps the time bends up a further 25 %: issue
// slots and shared loads begin to bind there (PERF.md).
//
// Open variant (template flag OPEN, the reference's open_state): each warp
// keeps its row's request ring qbuf[QUEUE_MAX] f32 and latency histogram
// hist[LAT_NBINS] i32 in shared memory (768 B per warp), loaded once per
// launch and stored once; the binding gather `take_along_axis(qbuf, qpos)`
// is a per-lane shared-memory read.  req_t sits in registers beside rem, the
// queue length and occupancy integral in warp-uniform registers.  It adds the 11
// open-state arrays to the bytes moved per launch and the admission /
// departure / binding stages to the work of a sub-step.
#include "lock_sim_consts.cuh"
#include "lock_sim_stages.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

// Blocks of kWarpsPerBlock warps each instantiation must fit on an SM: the
// most it holds without a spill (65 536 registers an SM, ptxas -v).  The open
// kernel at one slot a lane is held to 8 (64 registers), where it runs
// fastest; the others where ptxas puts them unasked.  A bound of 1 is not
// "unasked": it lets ptxas spend more registers than with none.
constexpr int min_blocks(int ns, bool open) {
  return ns == 1 ? (open ? 8 : 9) : ns == 2 ? (open ? 5 : 7) : (open ? 4 : 5);
}

// Row flags the sub-step loop reads, beside the discipline row's bits
// (0-15) in one register
constexpr unsigned kHasBudget = 1u << 16;
constexpr unsigned kOpenRow = 1u << 17;
constexpr unsigned kWindowedFault = 1u << 18;

template <int NS, bool OPEN>
__global__ void __launch_bounds__(32 * kWarpsPerBlock, min_blocks(NS, OPEN))
    lock_sim_block_kernel(BlockArgs a) {
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (c >= a.C) return;  // the whole warp leaves together
  const unsigned lane = threadIdx.x & 31u;
  const int T = a.T;

  // ---- config columns and state, loaded once -----------------------------
  const int step0 = a.step0 ? a.step0[c] : a.step0_s;
  const int limit = a.limit ? a.limit[c] : a.limit_s;
  __shared__ RowSlot<NS> slots[kWarpsPerBlock];
  RowSlot<NS>* const my_slot = &slots[threadIdx.x >> 5];
  RowCtx r0 = load_row_ctx(a, c);
  r0.alpha = a.alpha[c];
  r0.cores = a.cores[c];
  Lanes<NS> L;
  load_lanes<NS, OPEN>(a, c, T, lane, r0, L, my_slot->phase_u,
                       my_slot->tscale);
  RowState rs0 = load_row_state(a, c);
  Queue q{};
  float spin_cpu = a.spin_cpu[c];
  derive_row_ctx(r0);

  // ---- open-loop ring and histogram in shared memory ---------------------
  extern __shared__ float smem[];
  float* qb = nullptr;
  int* hs = nullptr;
  if constexpr (OPEN) {
    qb = smem + (threadIdx.x >> 5) * (QUEUE_MAX + LAT_NBINS);
    hs = reinterpret_cast<int*>(qb + QUEUE_MAX);
    load_open(a, c, lane, qb, hs, r0, rs0, q);
  }
  // The row context and state move to the warp's slot of shared memory;
  // the values every sub-step reads stay in registers.
  volatile RowSlot<NS>& slot = publish_row<NS>(my_slot, r0, rs0, lane);
  const volatile RowCtx& r = slot.ctx;
  volatile RowState& rs = slot.st;
  const float dt = r0.dt;
  const unsigned flags = r0.row | (a.has_budget[c] ? kHasBudget : 0u) |
                         (r0.openc ? kOpenRow : 0u) |
                         (r0.fault == FAULT_PREEMPT || r0.fault == FAULT_OVERSUB
                              ? kWindowedFault
                              : 0u);
  const int q_cap = r0.q_cap;

  // Carried between sub-steps: the advance's rates and the open row's free
  // and busy counts.  Only the lane stages (event_stages) and the binding
  // change a lane's state; until one of them runs, all stay as they were.
  float d_rate = 0.0f, d_hold = 0.0f, burn = 0.0f;
  int n_free = 0, n_busy = 0;
  bool stale = true;
  // The open row's arrivals depend on the step alone: they are drawn 32
  // sub-steps at a time, lane l drawing sub-step s0 + l's into the slot,
  // where that sub-step reads it.  `arrived` and `shed` take each chunk at
  // once: every arrival is admitted or shed and qlen' = qlen + admitted -
  // bound, so shed' = shed + qlen + arrived - bound - qlen'.
  if constexpr (OPEN) {
    n_free = count_free<NS>(L);
    n_busy = count_busy<NS>(L);
    rs.shed += q.qlen;
  }
  const int n_steps = (int)max(0LL, min((long long)a.n_sub,
                                        (long long)limit - step0));

  for (int s = 0; s < n_steps; ++s) {  // past limit: passthroughs
    const int i = step0 + s;
    if constexpr (OPEN) {
      if ((s & 31) == 0) {
        const int l = (int)lane_id(), il = i + l;
        const int n =
            s + l < n_steps
                ? arrivals_at(r, ((float)il + 1.0f) * dt, (unsigned)il)
                : 0;
        __syncwarp();  // the last chunk's reads are done
        slot.arr[l] = n;
        __syncwarp();
        const int chunk = __reduce_add_sync(FULL_MASK, n);
        rs.arrived += chunk;
        rs.shed += chunk;
      }
    }
    const float i_f = (float)i;
    const float now2 = (i_f + 1.0f) * dt;
    const float now_teps = now2 + dt * 1e-3f;  // now2 + RowCtx.teps

    // ---- GPS advance (ref.lock_sim_step_ref; gps_advance without the
    // rewind) + fault rewind (ref.fault_rewind, from the same pre-step st),
    // slot by slot ---------------------------------------------------------
    {
      const int(&st)[NS] = L.st;
      float(&rem)[NS] = L.rem;
      if (stale) {
        bool run[NS], spin[NS];
        UNROLL for (int j = 0; j < NS; ++j) {
          spin[j] = st[j] == ST_SPIN;
          run[j] = spin[j] || st[j] == ST_CS || st[j] == ST_NCS;
        }
        const float n_run = (float)w_count<NS>(run);
        const float n_spin = (float)w_count<NS>(spin);
        const float rate = fminf(1.0f, r.cores / fmaxf(n_run, 1.0f));
        const float holder_rate = rate / (1.0f + r.alpha * n_spin);
        d_rate = dt * rate;
        d_hold = dt * holder_rate;
        burn = n_spin * d_rate;
      }
      spin_cpu = spin_cpu + burn;
      unsigned win = 0u;
      if (flags & kWindowedFault)
        win = (unsigned)(int)floorf((i_f * dt) / r.flt_scale);
      UNROLL for (int j = 0; j < NS; ++j) {
        const bool is_cs = st[j] == ST_CS, is_ncs = st[j] == ST_NCS;
        if (is_cs) rem[j] = rem[j] - d_hold;
        else if (is_ncs) rem[j] = rem[j] - d_rate;
        else if (st[j] == ST_SPIN && (flags & kHasBudget))
          rem[j] = rem[j] - d_rate;
        if ((flags & kWindowedFault) && (is_cs || is_ncs)) {
          const float prog = is_cs ? d_hold : d_rate;
          const float gate_u =
              counter_uniform(r.seed ^ FLT_GATE_SALT, L.tid[j], win);
          const float scale = r.fault == FAULT_PREEMPT
                                  ? 1.0f - (gate_u < r.flt_rate ? 1.0f : 0.0f)
                                  : 1.0f - r.flt_rate * gate_u;
          const float giveback = prog * (1.0f - scale);
          if (giveback > 0.0f) rem[j] = rem[j] + giveback;
        }
      }
    }

    // ---- the transition stage: transition_step, with the counts carried.
    // A quiet sub-step -- no lane meets a lane stage's test, no request
    // enters the ring, none binds -- only moves the row counters and
    // retires tickets, behind one branch.
    const bool ev = any_event<NS>(flags, L, now_teps);
    int n_arr = 0, n_adm = 0;
    bool quiet = !ev;
    if constexpr (OPEN) {
      n_arr = slot.arr[s & 31];
      n_adm = min(n_arr, q_cap - q.qlen);
      quiet = quiet && n_adm <= 0 &&
              !((flags & kOpenRow) && min(q.qlen + n_adm, n_free) > 0);
    }
    if (quiet) {
      retire<NS>(flags, L);
      if constexpr (OPEN) {
        q.qlen += n_adm;  // admit() without a request to write
        occupy(dt, q, n_busy);
      }
      stale = false;
      continue;
    }
    const unsigned stepu = (unsigned)i;
    if constexpr (OPEN)
      admit(q_cap, rs.qhead, q, qb, n_arr, now2, lane_id());
    if (ev)
      event_stages<NS, OPEN>(slot, L, hs, now2, now_teps, stepu);
    retire<NS>(flags, L);
    stale = ev;
    if constexpr (OPEN) {
      if (ev) n_free = count_free<NS>(L);
      const int n_bind =
          (flags & kOpenRow) ? bind<NS>(slot, q, L, qb, n_free, now2) : 0;
      if (n_bind > 0) {
        n_free -= n_bind;
        rs.shed -= n_bind;
        stale = true;
      }
      if (stale) n_busy = count_busy<NS>(L);
      occupy(dt, q, n_busy);
    }
  }

  // ---- one store ---------------------------------------------------------
  if constexpr (OPEN) rs.shed -= q.qlen;
  store_row<NS, OPEN, true>(a, c, T, lane_id(), L, rs, q, qb, hs, spin_cpu);
}

}  // namespace

constexpr size_t block_shmem(bool open) {
  return open ? kWarpsPerBlock * (QUEUE_MAX + LAT_NBINS) * sizeof(float) : 0;
}

template <bool OPEN>
void launch_variant(const BlockArgs& a, cudaStream_t s) {
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((a.C + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const size_t shmem = block_shmem(OPEN);
  if (a.T <= 32) lock_sim_block_kernel<1, OPEN><<<grid, block, shmem, s>>>(a);
  else if (a.T <= 64) lock_sim_block_kernel<2, OPEN><<<grid, block, shmem, s>>>(a);
  else lock_sim_block_kernel<4, OPEN><<<grid, block, shmem, s>>>(a);
}

template <int NS, bool OPEN>
int resident_blocks(int* out) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, lock_sim_block_kernel<NS, OPEN>, 32 * kWarpsPerBlock,
      block_shmem(OPEN));
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
  set_transition_state(a, state_in, state_out, open_run ? 17 : -1);
  a.spin_cpu = (const float*)state_in[16];
  a.o_spin_cpu = (float*)state_out[16];
  a.step0 = (const int*)ctx[0];
  a.limit = (const int*)ctx[1];
  a.alpha = (const float*)ctx[2];
  a.cores = (const float*)ctx[3];
  a.has_budget = (const unsigned char*)ctx[4];
  set_transition_context(a, ctx + 5);
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

// Blocks of each instantiation resident on one SM at the launch's block size
// and shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor): out[0..2]
// closed at NS = 1, 2, 4, out[3..5] open at NS = 1, 2, 4, out[6] the warps a
// block holds.  Returns the first CUDA error, or 0.
extern "C" int lock_sim_block_occupancy(int* out) {
  int err = resident_blocks<1, false>(out + 0);
  if (!err) err = resident_blocks<2, false>(out + 1);
  if (!err) err = resident_blocks<4, false>(out + 2);
  if (!err) err = resident_blocks<1, true>(out + 3);
  if (!err) err = resident_blocks<2, true>(out + 4);
  if (!err) err = resident_blocks<4, true>(out + 5);
  out[6] = kWarpsPerBlock;
  return err;
}
