// mamba_scan — the Mamba selective scan on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/mamba_scan.py (mamba_scan /
// _kernel).  Per batch row b and channel c, with the state row s (N) of
// channel c starting at zero:
//
//     s   <- exp(dt_t[c] * a[c, :]) * s + (dt_t[c] * x_t[c]) * B_t
//     y_t[c] = s . C_t
//
// dt, x: (B, T, d) f32; Bm, Cm: (B, T, N) f32; a: (d, N) f32 (negative).
// Writes y (B, T, d) and the final state s_T (B, d, N), f32; s_T lets one
// pass over a prompt fill the decode cache as well.
//
// What bounds it.  The function reads dt, x (4 B T d bytes each), B, C and
// a once and writes y (4 B T d) and s_T once: at a jamba prefill layer
// (B 1, T 1024, d 16 384, N 16) about 203 MB, 0.061 ms at 3.35 TB/s.  Per
// (t, c, n) it takes one exp on the special-function units (16 a clock
// per SM): 268 M of them there, 0.064 ms, the floor.  Beside each exp a
// state takes four FP32 instructions (dt a', the input term, the update,
// its share of y), so the issue slots (128 a clock per SM) come next, and
// every state reads its B_n and C_n from shared memory each step.
//
// Design.  A channel's N states are split over L = N / 2 lanes of a warp,
// two states a lane, and a lane takes CPL neighbouring channels (1, 2 or
// 4), keeping their states and rows of a in registers for the whole
// sequence: 128 threads a block take 128 / L * CPL channels.  More lanes a
// channel put more warps on the card when d is small; more channels a lane
// read each B and C pair once for CPL channels and dt, x as one vector,
// fewer instructions a state when the card is full.  The launcher picks
// CPL (plan_split): at B 1, d 16 384 (a jamba prefill layer) 4 channels a
// lane, 256 blocks of 4 warps; at d 4096 and below 1.  The exp is one
// MUFU.EX2 on a pre-scaled a' = a * log2(e) (rounded once to f32):
// exp(dt a) = 2^(dt a'); ftz, so a result under 2^-126 is 0 where expf
// gives a subnormal (a state times it is below every tolerance held here).
//
// The sequence goes in slots of `steps` = min(chunk, T) steps: a slot
// holds the block's columns of dt and x and the steps' B and C rows,
// filled by 16-byte cp.async copies (4-byte where d is not a multiple of
// 4) issued by every thread.  Two slots: chunk i + 1's copies are issued
// before chunk i's steps run, so they land while the block computes.
// One __syncthreads a chunk, after the wait for its copies: it also
// tells every thread that the slot the next copies overwrite is free.
//
// Order of operations, fixed by N alone (so neither the split nor chunk
// changes a bit of the result): s_n = fma(s_n, 2^(dt a'_n), (dt x) B_n);
// y_t is a balanced tree over the pairs of states, pair m being
// fma(s_{2m+1}, C_{2m+1}, s_{2m} C_{2m}), pairs added (0+1), (2+3), then
// those sums, and so on.  A lane holds one pair; the lanes' pairs are
// added by a reduce-scatter over a group of L steps: at level m = 1, 2,
// ..., L/2 each lane keeps the half of its partial sums whose step has
// bit m equal to its own and adds its partner's (lane ^ m) half, so after
// log2(L) levels lane g holds y of step g of the group, with L - 1
// shuffles for L steps in place of L log2(L).  Lane g then stores it.
// Steps past T and channels past d are computed on whatever the slot
// holds and never stored.
//
// FMA contraction stays on: the kernel is held to its plain version by a
// tolerance, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_barrier.cuh"  // smem_addr, copy16_async, copy4_async, groups

namespace {

constexpr int THREADS = 128;
// Most time steps staged at once; the wrapper refuses a larger chunk.
constexpr int MAX_CHUNK = 128;
// Shared memory a block may take on the H100 (227 KB).
constexpr size_t SMEM_LIMIT = 232448;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// (N, CPL) of every instantiation: states N (N / 2 lanes a channel, two
// states a lane), channels a lane CPL.
constexpr int SPLITS[][2] = {{4, 1},  {4, 2},  {8, 1}, {8, 2},
                             {16, 1}, {16, 2}, {16, 4}};
constexpr int N_SPLITS = sizeof(SPLITS) / sizeof(SPLITS[0]);

template <int N_, int CPL_>
struct Plan {
  static constexpr int N = N_, CPL = CPL_;
  static constexpr int L = N / 2;               // lanes a channel
  static constexpr int CB = THREADS / L * CPL;  // channels a block
  static_assert(32 % L == 0, "a channel's lanes in one warp");
  // one slot: dt, x (steps, CB) and B, C (steps, N)
  __host__ __device__ static constexpr size_t slot_floats(int steps) {
    return (size_t)steps * (2 * CB + 2 * N);
  }
  __host__ __device__ static constexpr size_t smem_bytes(int steps) {
    return 2 * slot_floats(steps) * sizeof(float);
  }
};

__device__ __forceinline__ float ex2(float z) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(z));
  return r;
}

// K consecutive floats of shared memory (4 K-byte aligned, K = 1, 2, 4).
template <int K>
__device__ __forceinline__ void load_row(const float* p, float (&v)[K]) {
  if constexpr (K == 1) {
    v[0] = p[0];
  } else if constexpr (K == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
}

// Reduce-scatter of v[0..L) over the L lanes of a channel: level M (1, 2,
// ..., L/2) keeps CNT / 2 sums; lane g ends with the sum of step g.
template <int L, int M = 1, int CNT = L>
__device__ __forceinline__ float reduce_scatter(float (&v)[L], int g) {
  if constexpr (CNT == 1) {
    return v[0];
  } else {
    const bool hi = g & M;
#pragma unroll
    for (int j = 0; j < CNT / 2; ++j) {
      const float send = hi ? v[2 * j] : v[2 * j + 1];
      const float keep = hi ? v[2 * j + 1] : v[2 * j];
      v[j] = keep + __shfl_xor_sync(FULL, send, M);
    }
    return reduce_scatter<L, 2 * M, CNT / 2>(v, g);
  }
}

template <int N, int CPL>
__global__ void __launch_bounds__(THREADS)
mamba_scan_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                  const float* __restrict__ Bm, const float* __restrict__ Cm,
                  const float* __restrict__ a, float* __restrict__ y,
                  float* __restrict__ sT, int T, int d, int steps) {
  using P = Plan<N, CPL>;
  constexpr int L = P::L, CB = P::CB;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int g = tid % L;                  // the lane's states: 2 g, 2 g + 1
  const int ch = tid / L * CPL;           // its first channel in the block
  const int c0 = blockIdx.x * CB;
  const int c = c0 + ch;                  // its channels: c, ..., c + CPL - 1
  const int nc = min(CB, d - c0);         // the block's channels
  const size_t b = blockIdx.y;
  const float* dtb = dt + b * (size_t)T * d;
  const float* xb = x + b * (size_t)T * d;
  float* yb = y + b * (size_t)T * d;
  const float* Bb = Bm + b * (size_t)T * N;
  const float* Cb = Cm + b * (size_t)T * N;
  const bool vec = (d % 4) == 0;
  const size_t slot = P::slot_floats(steps);

  float A[CPL][2], s[CPL][2];
#pragma unroll
  for (int i = 0; i < CPL; ++i)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      A[i][k] = c + i < d ? a[(size_t)(c + i) * N + 2 * g + k] * LOG2E : 0.0f;
      s[i][k] = 0.0f;
    }

  // cp.async copies of steps [t0, t0 + cl) into slot `sl`
  const auto stage = [&](int t0, int cl, int sl) {
    float* sdt = smem + sl * slot;
    float* sx = sdt + steps * CB;
    float* sB = sx + steps * CB;
    float* sC = sB + steps * N;
    if (vec) {
      for (int q = tid; q < cl * (CB / 4); q += THREADS) {
        const int t = q / (CB / 4), j = 4 * (q % (CB / 4));
        if (j >= nc) continue;
        const size_t off = (size_t)(t0 + t) * d + c0 + j;
        copy16_async(smem_addr(sdt + t * CB + j), dtb + off);
        copy16_async(smem_addr(sx + t * CB + j), xb + off);
      }
    } else {
      for (int q = tid; q < cl * CB; q += THREADS) {
        const int t = q / CB, j = q % CB;
        if (j >= nc) continue;
        const size_t off = (size_t)(t0 + t) * d + c0 + j;
        copy4_async(smem_addr(sdt + t * CB + j), dtb + off);
        copy4_async(smem_addr(sx + t * CB + j), xb + off);
      }
    }
    for (int q = tid; q < cl * (N / 4); q += THREADS) {
      const size_t off = (size_t)t0 * N + 4 * q;
      copy16_async(smem_addr(sB + 4 * q), Bb + off);
      copy16_async(smem_addr(sC + 4 * q), Cb + off);
    }
  };

  // step t of the slot: update the states; o[i] is the lane's pair of
  // y_t for its channel i
  const auto step = [&](const float* sdt, const float* sx, const float* sB,
                        const float* sC, int t, float (&o)[CPL]) {
    float dtt[CPL], xt[CPL], Bv[2], Cv[2];
    load_row<CPL>(sdt + t * CB + ch, dtt);
    load_row<CPL>(sx + t * CB + ch, xt);
    load_row<2>(sB + t * N + 2 * g, Bv);
    load_row<2>(sC + t * N + 2 * g, Cv);
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const float dtx = dtt[i] * xt[i];
#pragma unroll
      for (int k = 0; k < 2; ++k)
        s[i][k] = fmaf(s[i][k], ex2(dtt[i] * A[i][k]), dtx * Bv[k]);
      o[i] = fmaf(s[i][1], Cv[1], s[i][0] * Cv[0]);
    }
  };

  // a group of L steps from t (n of them real): the reduce-scatter, and
  // lane g stores y of step t + g
  const auto group = [&](const float* sdt, const float* sx, const float* sB,
                         const float* sC, int t0, int t, int n) {
    float v[CPL][L];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      float o[CPL];
      if (j < n) {
        step(sdt, sx, sB, sC, t + j, o);
      } else {
#pragma unroll
        for (int i = 0; i < CPL; ++i) o[i] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < CPL; ++i) v[i][j] = o[i];
    }
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const float out = reduce_scatter<L>(v[i], g);
      if (c + i < d && g < n) yb[(size_t)(t0 + t + g) * d + c + i] = out;
    }
  };

  const int n_chunks = (T + steps - 1) / steps;
  if (n_chunks > 0) stage(0, min(steps, T), 0);
  copies_commit();
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * steps;
    const int cl = min(steps, T - t0);
    copies_wait_all();
    __syncthreads();   // chunk ci landed for all; chunk ci - 1's slot is free
    if (ci + 1 < n_chunks)
      stage(t0 + steps, min(steps, T - t0 - steps), (ci + 1) & 1);
    copies_commit();
    const float* sdt = smem + (ci & 1) * slot;
    const float* sx = sdt + steps * CB;
    const float* sB = sx + steps * CB;
    const float* sC = sB + steps * N;
    int t = 0;
    for (; t + L <= cl; t += L) group(sdt, sx, sB, sC, t0, t, L);
    if (t < cl) group(sdt, sx, sB, sC, t0, t, cl - t);   // a short group
  }
#pragma unroll
  for (int i = 0; i < CPL; ++i)
    if (c + i < d)
      *reinterpret_cast<float2*>(sT + (b * d + c + i) * N + 2 * g) =
          make_float2(s[i][0], s[i][1]);
}

// f(Plan<N, CPL>{}, kernel) for the instantiation; -1 for none.
template <typename F>
int with_split(int N, int CPL, F&& f) {
#define MAMBA_SPLIT(n, cpl)   \
  if (N == n && CPL == cpl)   \
    return f(Plan<n, cpl>{}, mamba_scan_kernel<n, cpl>);
  MAMBA_SPLIT(4, 1) MAMBA_SPLIT(4, 2)
  MAMBA_SPLIT(8, 1) MAMBA_SPLIT(8, 2)
  MAMBA_SPLIT(16, 1) MAMBA_SPLIT(16, 2) MAMBA_SPLIT(16, 4)
#undef MAMBA_SPLIT
  return -1;
}

// Blocks of the instantiation resident on one SM of the current device
// with slots of `steps` steps (0 where the slots exceed a block's shared
// memory), and the block's bytes.
int occupancy(int N, int CPL, int steps, int* blocks, int* bytes) {
  return with_split(N, CPL, [&](auto plan, auto kernel) {
    using P = decltype(plan);
    *bytes = (int)P::smem_bytes(steps);
    *blocks = 0;
    if ((size_t)*bytes > SMEM_LIMIT) return 0;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *bytes);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                        THREADS, *bytes);
    return (int)e;
  });
}

// The channels a lane for B rows of d channels with N states on `sms`
// SMs, among the instantiations of N whose slots of `steps` steps fit a
// block: if some split's grid exceeds the SMs and an SM holds two of its
// blocks (the busiest SMs run 8 warps or more), the one among those with
// the most channels a lane (the least work a state: B and C read once for
// more channels, dt and x as one vector); else (a grid too small to give
// an SM two blocks) the one with the most threads.  Writes the CUDA error
// of an occupancy query to *err.
int plan_split(int B, int d, int N, int steps, int sms, int* err) {
  int full = -1, small = -1;
  long long small_threads = -1;
  *err = 0;
  for (const auto& split : SPLITS) {
    if (split[0] != N) continue;
    int blocks = 0, bytes = 0;
    *err = occupancy(N, split[1], steps, &blocks, &bytes);
    if (*err) return -1;
    if (blocks == 0) continue;
    const int cb = THREADS / (N / 2) * split[1];
    const long long grid = (long long)B * ((d + cb - 1) / cb);
    if (blocks >= 2 && grid > sms && split[1] > full) full = split[1];
    if (grid * THREADS > small_threads) {
      small = split[1];
      small_threads = grid * THREADS;
    }
  }
  return full > 0 ? full : small;
}

// Launch (N, CPL) on `steps`-step slots; the CUDA error of the launch.
int launch_split(const float* dt, const float* x, const float* Bm,
                 const float* Cm, const float* a, float* y, float* sT, int B,
                 int T, int d, int N, int steps, int CPL,
                 cudaStream_t stream) {
  const int err = with_split(N, CPL, [&](auto plan, auto kernel) {
    using P = decltype(plan);
    const size_t bytes = P::smem_bytes(steps);
    if (bytes > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    // shared memory above 48 KB must be asked for (on the current device)
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((d + P::CB - 1) / P::CB, B);
    kernel<<<grid, THREADS, bytes, stream>>>(dt, x, Bm, Cm, a, y, sT, T, d,
                                             steps);
    return (int)cudaGetLastError();
  });
  return err < 0 ? (int)cudaErrorInvalidValue : err;
}

}  // namespace

// All pointers f32, contiguous and 16-byte aligned (the wrapper checks).
// N in {4, 8, 16}, 1 <= chunk <= 128, B >= 1, d >= 1, T >= 0.  Stages
// min(chunk, T) steps at a time, picks the channels a lane by plan_split
// on the current device's SMs and writes the lanes a channel and the
// channels a lane it took to split[0] and split[1].  Returns the CUDA
// error of the launch.
extern "C" int mamba_scan_launch(const void* dt, const void* x,
                                 const void* Bm, const void* Cm,
                                 const void* a, void* y, void* sT, int B,
                                 int T, int d, int N, int chunk, int* split,
                                 cudaStream_t stream) {
  if (B <= 0 || B > 65535 || d <= 0 || T < 0 || chunk < 1 ||
      chunk > MAX_CHUNK)
    return (int)cudaErrorInvalidValue;
  const int steps = T > 0 && T < chunk ? T : chunk;
  int device = 0, sms = 0;
  cudaError_t status = cudaGetDevice(&device);
  if (status == cudaSuccess)
    status = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device);
  if (status != cudaSuccess) return (int)status;
  int err = 0;
  const int cpl = plan_split(B, d, N, steps, sms, &err);
  if (err) return err;
  split[0] = N / 2;
  split[1] = cpl;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  return launch_split(f(dt), f(x), f(Bm), f(Cm), f(a), static_cast<float*>(y),
                      static_cast<float*>(sT), B, T, d, N, steps, cpl, stream);
}

// Per instantiation, in SPLITS' order, with slots of `steps` steps:
// out[0] the count, then six ints each: N, lanes a channel, channels a
// lane, blocks resident on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor; 0 where the slots exceed
// a block's shared memory), threads a block, shared-memory bytes (out
// holds 1 + 6 N_SPLITS ints).  Returns the first CUDA error, or 0.
extern "C" int mamba_scan_occupancy(int steps, int* out) {
  out[0] = N_SPLITS;
  for (int i = 0; i < N_SPLITS; ++i) {
    int* o = out + 1 + 6 * i;
    o[0] = SPLITS[i][0];
    o[1] = SPLITS[i][0] / 2;
    o[2] = SPLITS[i][1];
    o[4] = THREADS;
    const int err = occupancy(o[0], o[2], steps, o + 3, o + 5);
    if (err) return err;
  }
  return 0;
}
