// lock_sim_block for Hopper: n_sub_steps fused timesteps of the batched lock
// simulator, closed-loop and open-loop variants.
//
// Replaces the Pallas TPU kernel repro/kernels/lock_sim.py:lock_sim_block
// (_block_kernel, both values of its static open_run flag); computes the same
// function as repro_torch/kernels/ref.py:lock_sim_block_ref, stage for stage.
//
// Design.  One warp owns one config row (layout and numerics: the header of
// lock_sim_stages.cuh).  All per-thread state lives in registers across the
// sub-step loop, the config columns are loaded once, and everything is stored
// once at the end.  Each sub-step is the GPS advance, the fault rewind and one
// transition stage: the stage is transition_step of lock_sim_stages.cuh, which
// lock_transitions_step.cu launches once per step; the advance is the
// arithmetic of gps_advance (lock_sim_step.cu), written out here with the
// rewind interleaved slot by slot.  A sub-step with
// step0 + s >= limit ends the loop (the reference's passthrough mask).
//
// What bounds it.  Per launch a row moves (8 T + 9) * 4 bytes of state each
// way plus 28 context words, once for all n_sub_steps; a lower-bound count of
// the idle path (46 operations per active thread and sub-step) asks for less
// time than those bytes at T = 32 and 32 sub-steps, so the bound is the bytes
// term (0.0438 ms at 65 536 x 32, PERF.md).  The kernel runs well above it:
// what a warp really issues -- ballots, hashes, the dependent chain of stage
// tests -- is several times that count.  Keeping the state in registers for
// the whole block is what keeps the bytes to one read and one write.
//
// Open variant (template flag OPEN, the reference's open_state): each warp
// keeps its row's request ring qbuf[QUEUE_MAX] f32 and latency histogram
// hist[LAT_NBINS] i32 in shared memory (768 B per warp), loaded once per
// launch and stored once; the binding gather `take_along_axis(qbuf, qpos)`
// is a per-lane shared-memory read.  req_t sits in registers beside rem, the
// per-config queue counters are warp-uniform registers.  It adds the 11
// open-state arrays to the bytes moved per launch and the admission /
// departure / binding stages to the work of a sub-step; the bound is still
// the bytes term (0.122 ms at 100 080 x 32).  The closed instantiation's code
// is untouched by the flag.
#include "lock_sim_consts.cuh"
#include "lock_sim_stages.cuh"

namespace {

template <int NS, bool OPEN>
__global__ void __launch_bounds__(128) lock_sim_block_kernel(BlockArgs a) {
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (c >= a.C) return;  // the whole warp leaves together
  const unsigned lane = threadIdx.x & 31u;
  const unsigned lt = (1u << lane) - 1u;
  const int T = a.T;

  // ---- config columns and state, loaded once -----------------------------
  const int step0 = a.step0 ? a.step0[c] : a.step0_s;
  const int limit = a.limit ? a.limit[c] : a.limit_s;
  const float alpha = a.alpha[c], cores = a.cores[c];
  const bool has_budget = a.has_budget[c] != 0;
  RowCtx r = load_row_ctx(a, c);
  Lanes<NS> L;
  load_lanes<NS, OPEN>(a, c, T, lane, r, L);
  RowState rs = load_row_state(a, c);
  float spin_cpu = a.spin_cpu[c];
  derive_row_ctx(r);

  // ---- open-loop ring and histogram in shared memory ---------------------
  extern __shared__ float smem[];
  float* qb = nullptr;
  int* hs = nullptr;
  if constexpr (OPEN) {
    qb = smem + (threadIdx.x >> 5) * (QUEUE_MAX + LAT_NBINS);
    hs = reinterpret_cast<int*>(qb + QUEUE_MAX);
    load_open(a, c, lane, qb, hs, r, rs);
  }
  const float dt = r.dt;
  const int fault = r.fault;

  for (int s = 0; s < a.n_sub; ++s) {
    const int i = step0 + s;
    if (i >= limit) break;  // remaining sub-steps are passthroughs
    const float i_f = (float)i;
    const float now2 = (i_f + 1.0f) * dt;
    const float now_teps = now2 + r.teps;

    // ---- GPS advance (ref.lock_sim_step_ref; gps_advance without the
    // rewind) + fault rewind (ref.fault_rewind, from the same pre-step st),
    // slot by slot ---------------------------------------------------------
    {
      const int(&st)[NS] = L.st;
      float(&rem)[NS] = L.rem;
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
        win = (unsigned)(int)floorf((i_f * dt) / r.flt_scale);
      UNROLL for (int j = 0; j < NS; ++j) {
        const bool is_cs = st[j] == ST_CS, is_ncs = st[j] == ST_NCS;
        if (is_cs) rem[j] = rem[j] - d_hold;
        else if (is_ncs) rem[j] = rem[j] - d_rate;
        else if (spin[j] && has_budget) rem[j] = rem[j] - d_rate;
        if ((fault == FAULT_PREEMPT || fault == FAULT_OVERSUB) &&
            (is_cs || is_ncs)) {
          const float prog = is_cs ? d_hold : d_rate;
          const float gate_u =
              counter_uniform(r.seed ^ FLT_GATE_SALT, L.tid[j], win);
          const float scale = fault == FAULT_PREEMPT
                                  ? 1.0f - (gate_u < r.flt_rate ? 1.0f : 0.0f)
                                  : 1.0f - r.flt_rate * gate_u;
          const float giveback = prog * (1.0f - scale);
          if (giveback > 0.0f) rem[j] = rem[j] + giveback;
        }
      }
    }

    transition_step<NS, OPEN>(r, rs, L, qb, hs, now2, now_teps, (unsigned)i,
                              lane, lt);
  }

  // ---- one store ---------------------------------------------------------
  store_row<NS, OPEN, true>(a, c, T, lane, L, rs, qb, hs, spin_cpu);
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
