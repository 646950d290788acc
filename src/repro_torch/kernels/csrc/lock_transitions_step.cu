// lock_transitions_step for Hopper: one transition stage of the batched lock
// simulator, closed-loop and open-loop variants.
//
// Replaces the Pallas TPU kernel repro/kernels/lock_sim.py:
// lock_transitions_step (_transitions_kernel, with and without open_state);
// computes the same function as repro_torch/kernels/ref.py:
// lock_transitions_ref: budget exhaustion, wake completions, release and
// handoff, ticket grants, backoff polls, arrivals and ticket retire, and in
// the open variant admission, departure and binding.  The per-step scan
// rollout launches it once per step, after the GPS advance (lock_sim_step.cu)
// and the fault rewind.
//
// Design.  The block kernel's transition stage, run once: one warp per config
// row, lane = simulated thread, the stage itself transition_step of
// lock_sim_stages.cuh, which lock_sim_block.cu runs n_sub_steps times per
// launch.  There is no sub-step loop, so the per-thread workload state
// (phase_u, tscale) that the block kernel hoists out of its loop is derived on
// every launch.  now2 and stepi come in as a (C,) column, a 0-d tensor
// (stride 0) or a scalar.  As in the block kernel, the row context, its
// counters and the workload state sit in the warp's slot of shared memory
// (RowSlot), and the open variant keeps its row's request ring and latency
// histogram there too (768 B per warp).
//
// What bounds it.  A row reads and writes its 16 state arrays (64 T + 64
// bytes) and reads 29 context words: about 146 MB at 65 536 x 32, 0.044 ms at
// 3.35 TB/s -- the whole bound of a 32-step block kernel launch, every step.
// The operations of an idle stage are a few dozen per thread, far under
// that, so bytes bound it.
#include "lock_sim_consts.cuh"
#include "lock_sim_stages.cuh"

namespace {

template <int NS, bool OPEN>
__global__ void __launch_bounds__(128) lock_transitions_kernel(BlockArgs a) {
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (c >= a.C) return;  // the whole warp leaves together
  const unsigned lane = threadIdx.x & 31u;
  const int T = a.T;

  __shared__ RowSlot<NS> slots[4];
  RowSlot<NS>* const my_slot = &slots[threadIdx.x >> 5];
  RowCtx r = load_row_ctx(a, c);
  Lanes<NS> L;
  load_lanes<NS, OPEN>(a, c, T, lane, r, L, my_slot->phase_u,
                       my_slot->tscale);
  RowState rs = load_row_state(a, c);
  Queue q{};
  derive_row_ctx(r);
  const float now2 = a.now2 ? a.now2[c * a.now2_stride] : a.now2_s;
  const int stepi = a.stepi ? a.stepi[c * a.stepi_stride] : a.stepi_s;

  extern __shared__ float smem[];
  float* qb = nullptr;
  int* hs = nullptr;
  if constexpr (OPEN) {
    qb = smem + (threadIdx.x >> 5) * (QUEUE_MAX + LAT_NBINS);
    hs = reinterpret_cast<int*>(qb + QUEUE_MAX);
    load_open(a, c, lane, qb, hs, r, rs, q);
  }

  volatile RowSlot<NS>& slot = publish_row<NS>(my_slot, r, rs, lane);
  transition_step<NS, OPEN>(slot, q, L, qb, hs, now2, now2 + r.teps,
                            (unsigned)stepi, lane);

  store_row<NS, OPEN>(a, c, T, lane, L, slot.st, q, qb, hs);
}

template <bool OPEN>
void launch_transitions(const BlockArgs& a, cudaStream_t s) {
  const int warps_per_block = 4;
  const dim3 block(32 * warps_per_block);
  const dim3 grid((a.C + warps_per_block - 1) / warps_per_block);
  const size_t shmem =
      OPEN ? warps_per_block * (QUEUE_MAX + LAT_NBINS) * sizeof(float) : 0;
  if (a.T <= 32) lock_transitions_kernel<1, OPEN><<<grid, block, shmem, s>>>(a);
  else if (a.T <= 64) lock_transitions_kernel<2, OPEN><<<grid, block, shmem, s>>>(a);
  else lock_transitions_kernel<4, OPEN><<<grid, block, shmem, s>>>(a);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  `state_in` / `state_out` hold
// the 16 transition-state pointers in canonical order, followed by the 11
// OPEN_STATE pointers when `open_run` is non-zero; `ctx` holds the 27 context
// pointers from policy to slo in BlockArgs order.  `now2` / `stepi` are a
// column read at index c * stride (stride 0: one value for every row), or
// null for the scalars.  Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() (or cudaErrorInvalidValue for an unsupported T).
extern "C" int lock_transitions_step_launch(
    void* const* state_in, void* const* state_out, void* const* ctx,
    const void* now2, int now2_stride, float now2_s, const void* stepi,
    int stepi_stride, int stepi_s, int C, int T, int open_run, void* stream) {
  if (C <= 0 || T <= 0 || T > MAX_T) return (int)cudaErrorInvalidValue;
  BlockArgs a{};
  set_transition_state(a, state_in, state_out, open_run ? 16 : -1);
  set_transition_context(a, ctx);
  a.now2 = (const float*)now2;
  a.now2_stride = now2_stride;
  a.now2_s = now2_s;
  a.stepi = (const int*)stepi;
  a.stepi_stride = stepi_stride;
  a.stepi_s = stepi_s;
  a.C = C;
  a.T = T;

  cudaStream_t s = (cudaStream_t)stream;
  if (open_run) launch_transitions<true>(a, s);
  else launch_transitions<false>(a, s);
  return (int)cudaGetLastError();
}
