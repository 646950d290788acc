// oracle_step for Hopper: one SWS-oracle observation per config, alone.
//
// Replaces the Pallas TPU kernel repro/kernels/lock_sim.py:oracle_step
// (_oracle_kernel); computes the same function as
// repro_torch/kernels/ref.py:oracle_update_ref: the ORACLE_ROWS family that
// oracle_id selects (paper EvalSWS, AIMD, fixed budget, history EWMA), with
// delta clamped to [1 - sws, sws_max - sws].  The block and transition
// kernels evaluate the same rows (oracle_rows of lock_sim_stages.cuh) inside
// their acquisitions; no rollout launches this kernel.
//
// Design.  One thread per config, int32 only.  The reference's `//` and `>>`
// are Python's floor division and arithmetic shift, which this kernel keeps
// for negative operands too (C's `/` truncates).
//
// What bounds it.  A config reads 8 and writes 3 int32 words (44 bytes)
// against a few dozen integer operations: bytes bound it (about 0.013 ms for
// 10^6 configs).
#include "lock_sim_consts.cuh"
#include "lock_sim_stages.cuh"

namespace {

struct OracleArgs {
  const int* oracle; const int* spun; const int* slept; const int* sws;
  const int* cnt; const int* ewma; const int* k; const int* sws_max;
  int* o_delta; int* o_cnt; int* o_ewma;
  int C;
};

__global__ void __launch_bounds__(256) oracle_step_kernel(OracleArgs a) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= a.C) return;
  int delta, cnt2, ewma2;
  oracle_rows(a.oracle[c], a.spun[c], a.slept[c], a.sws[c], a.cnt[c],
              a.ewma[c], a.k[c], a.sws_max[c], delta, cnt2, ewma2);
  a.o_delta[c] = delta;
  a.o_cnt[c] = cnt2;
  a.o_ewma[c] = ewma2;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  `ptrs` holds oracle_id, spun,
// slept, sws, cnt, ewma, k, sws_max (int32, (C,)), then the outputs delta,
// cnt', ewma'.  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (or cudaErrorInvalidValue for C <= 0).
extern "C" int oracle_step_launch(void* const* ptrs, int C, void* stream) {
  if (C <= 0) return (int)cudaErrorInvalidValue;
  OracleArgs a{};
  a.oracle = (const int*)ptrs[0];
  a.spun = (const int*)ptrs[1];
  a.slept = (const int*)ptrs[2];
  a.sws = (const int*)ptrs[3];
  a.cnt = (const int*)ptrs[4];
  a.ewma = (const int*)ptrs[5];
  a.k = (const int*)ptrs[6];
  a.sws_max = (const int*)ptrs[7];
  a.o_delta = (int*)ptrs[8];
  a.o_cnt = (int*)ptrs[9];
  a.o_ewma = (int*)ptrs[10];
  a.C = C;
  const int threads = 256;
  oracle_step_kernel<<<(C + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
