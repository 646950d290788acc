// lock_sim_step for Hopper: the GPS advance of one timestep, alone.
//
// Replaces the Pallas TPU kernel repro/kernels/lock_sim.py:lock_sim_step
// (_kernel); computes the same function as
// repro_torch/kernels/ref.py:lock_sim_step_ref: per row, n_run runnable and
// n_spin spinning threads, rate = min(1, cores / n_run), the CS holder's rate
// / (1 + alpha n_spin), rem -= the per-state decrement, and the row's spin
// burn n_spin * d_rate (the order-free closed form of the reference's lane
// sum, as in the block kernel).  The per-step scan rollout launches it once
// per step, before the fault rewind and the transition kernel.
//
// Design.  One warp per config row, lane = simulated thread (slot * 32 + lane
// for slot < NS), counts by __ballot_sync + __popc: gps_advance of
// lock_sim_stages.cuh, the block kernel's own advance.
//
// What bounds it.  A row reads st and rem (8 T bytes) and four columns, and
// writes rem' and burn (4 T + 4 bytes): 12 T + 21 bytes, against a handful of
// operations per thread, so bytes bound it (about 0.008 ms at 65 536 x 32).
// At that size a launch is near the card's launch latency.
#include "lock_sim_consts.cuh"
#include "lock_sim_stages.cuh"

namespace {

struct StepArgs {
  const int* st; const float* rem; const float* alpha; const float* cores;
  const float* dt; const unsigned char* has_budget;
  float* o_rem; float* o_burn;
  int C; int T;
};

template <int NS>
__global__ void __launch_bounds__(128) lock_sim_step_kernel(StepArgs a) {
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (c >= a.C) return;  // the whole warp leaves together
  const unsigned lane = threadIdx.x & 31u;
  const int T = a.T;
  int st[NS];
  float rem[NS];
  UNROLL for (int j = 0; j < NS; ++j) {
    const int tid = j * 32 + (int)lane;
    const long long g = (long long)c * T + tid;
    st[j] = tid < T ? a.st[g] : ST_DONE;  // lanes past T: inert
    rem[j] = tid < T ? a.rem[g] : 0.0f;
  }
  const float burn = gps_advance<NS>(st, rem, a.alpha[c], a.cores[c], a.dt[c],
                                     a.has_budget[c] != 0);
  UNROLL for (int j = 0; j < NS; ++j) {
    const int tid = j * 32 + (int)lane;
    if (tid < T) a.o_rem[(long long)c * T + tid] = rem[j];
  }
  if (lane == 0) a.o_burn[c] = burn;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  `ptrs` holds st, rem, alpha,
// cores, dt, has_budget, then the outputs rem' (C, T) and burn (C,).
// Launches on `stream`, does not synchronise, and returns cudaGetLastError()
// (or cudaErrorInvalidValue for an unsupported shape).
extern "C" int lock_sim_step_launch(void* const* ptrs, int C, int T,
                                    void* stream) {
  if (C <= 0 || T <= 0 || T > MAX_T) return (int)cudaErrorInvalidValue;
  StepArgs a{};
  a.st = (const int*)ptrs[0];
  a.rem = (const float*)ptrs[1];
  a.alpha = (const float*)ptrs[2];
  a.cores = (const float*)ptrs[3];
  a.dt = (const float*)ptrs[4];
  a.has_budget = (const unsigned char*)ptrs[5];
  a.o_rem = (float*)ptrs[6];
  a.o_burn = (float*)ptrs[7];
  a.C = C;
  a.T = T;
  const int warps_per_block = 4;
  const dim3 block(32 * warps_per_block);
  const dim3 grid((C + warps_per_block - 1) / warps_per_block);
  cudaStream_t s = (cudaStream_t)stream;
  if (T <= 32) lock_sim_step_kernel<1><<<grid, block, 0, s>>>(a);
  else if (T <= 64) lock_sim_step_kernel<2><<<grid, block, 0, s>>>(a);
  else lock_sim_step_kernel<4><<<grid, block, 0, s>>>(a);
  return (int)cudaGetLastError();
}
