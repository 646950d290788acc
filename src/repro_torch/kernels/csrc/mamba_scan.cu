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
// Design.  One thread per channel, BLOCK channels per block, one block row
// per batch row: grid (ceil(d / BLOCK), B).  Thread c keeps its state row
// s[0..N) and its row of a in registers for the whole sequence, so the
// state touches memory once, at the end (N = 16: sixteen independent FMA
// chains a step).  The sequence goes in chunks of `chunk` steps: the block
// copies the chunk's dt and x (each thread its own column, coalesced
// across the block's channels) and the chunk's B_t and C_t (contiguous,
// 16-byte vectors) into shared memory, so every load of the chunk is in
// flight at once; then each thread walks the chunk, reading B_t and C_t
// as warp-wide broadcasts.  y_t is written once per step, BLOCK
// neighbouring floats.  Channels past d and steps past T are guarded, not
// padded.  `chunk` sets only how many steps are staged at once; the
// arithmetic of a step does not depend on it, so neither does the result,
// bit for bit.
//
// What bounds it.  The function reads dt, x (4 B T d bytes each), B, C and
// a once and writes y (4 B T d) and s_T once: at a jamba prefill layer
// (B 1, T 1024, d 16 384, N 16) about 203 MB, 0.061 ms at 3.35 TB/s.  Per
// (t, c, n) it does six f32 operations and one exp: 268 M exps there,
// about 0.064 ms on the H100's special-function units (16 a clock per SM),
// so the exps, not the bytes, are the floor.  With B = 1 the card holds
// d / BLOCK = 128 blocks, one per SM: four warps an SM, each step a chain
// of N exps and FMAs per thread.
//
// expf is the accurate one (no --use_fast_math); FMA contraction stays on:
// the kernel is held to its plain version by a tolerance.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 128;
// Most steps staged at once; the wrapper refuses a larger chunk.
constexpr int MAX_CHUNK = 128;

template <int N>
constexpr size_t smem_bytes(int chunk) {
  // dt, x chunks (chunk, BLOCK) each; B, C chunks (chunk, N) each
  return (size_t)(2 * chunk * BLOCK + 2 * chunk * N) * sizeof(float);
}

template <int N>
__global__ void __launch_bounds__(BLOCK)
mamba_scan_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                  const float* __restrict__ Bm, const float* __restrict__ Cm,
                  const float* __restrict__ a, float* __restrict__ y,
                  float* __restrict__ sT, int T, int d, int chunk) {
  extern __shared__ __align__(16) float smem[];
  float* sdt = smem;                  // (chunk, BLOCK)
  float* sx = sdt + chunk * BLOCK;
  float* sB = sx + chunk * BLOCK;     // (chunk, N)
  float* sC = sB + chunk * N;

  const int j = threadIdx.x;
  const int c = blockIdx.x * BLOCK + j;
  const bool live = c < d;
  const size_t b = blockIdx.y;
  const size_t seq = b * (size_t)T * d;     // (b, 0, 0) of dt, x, y
  const size_t bc = b * (size_t)T * N;      // (b, 0, 0) of Bm, Cm

  float A[N], s[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    A[n] = live ? a[(size_t)c * N + n] : 0.0f;
    s[n] = 0.0f;
  }

  for (int t0 = 0; t0 < T; t0 += chunk) {
    const int cl = min(chunk, T - t0);
    __syncthreads();                  // the last chunk is done with smem
    if (live) {
      for (int t = 0; t < cl; ++t) {
        const size_t g = seq + (size_t)(t0 + t) * d + c;
        sdt[t * BLOCK + j] = dt[g];
        sx[t * BLOCK + j] = x[g];
      }
    }
    const float4* gB = reinterpret_cast<const float4*>(Bm + bc + (size_t)t0 * N);
    const float4* gC = reinterpret_cast<const float4*>(Cm + bc + (size_t)t0 * N);
    for (int q = j; q < cl * N / 4; q += BLOCK) {
      reinterpret_cast<float4*>(sB)[q] = gB[q];
      reinterpret_cast<float4*>(sC)[q] = gC[q];
    }
    __syncthreads();
    if (!live) continue;

    for (int t = 0; t < cl; ++t) {
      const float dtt = sdt[t * BLOCK + j];
      const float dtx = dtt * sx[t * BLOCK + j];
      const float4* Bt = reinterpret_cast<const float4*>(sB + t * N);
      const float4* Ct = reinterpret_cast<const float4*>(sC + t * N);
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 bq = Bt[q], cq = Ct[q];
        s[4 * q] = fmaf(s[4 * q], expf(dtt * A[4 * q]), dtx * bq.x);
        s[4 * q + 1] = fmaf(s[4 * q + 1], expf(dtt * A[4 * q + 1]), dtx * bq.y);
        s[4 * q + 2] = fmaf(s[4 * q + 2], expf(dtt * A[4 * q + 2]), dtx * bq.z);
        s[4 * q + 3] = fmaf(s[4 * q + 3], expf(dtt * A[4 * q + 3]), dtx * bq.w);
        a0 = fmaf(s[4 * q], cq.x, a0);
        a1 = fmaf(s[4 * q + 1], cq.y, a1);
        a2 = fmaf(s[4 * q + 2], cq.z, a2);
        a3 = fmaf(s[4 * q + 3], cq.w, a3);
      }
      y[seq + (size_t)(t0 + t) * d + c] = (a0 + a1) + (a2 + a3);
    }
  }
  if (live) {
    float4* out = reinterpret_cast<float4*>(sT + (b * d + c) * N);
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      out[q] = make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
  }
}

template <int N>
int dispatch(const float* dt, const float* x, const float* Bm,
             const float* Cm, const float* a, float* y, float* sT, int B,
             int T, int d, int chunk, cudaStream_t stream) {
  // shared memory above 48 KB must be asked for (on the current device)
  const cudaError_t e = cudaFuncSetAttribute(
      mamba_scan_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<N>(MAX_CHUNK));
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((d + BLOCK - 1) / BLOCK, B);
  mamba_scan_kernel<N><<<grid, BLOCK, smem_bytes<N>(chunk), stream>>>(
      dt, x, Bm, Cm, a, y, sT, T, d, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// All pointers f32, contiguous and 16-byte aligned (the wrapper checks).
// N in {4, 8, 16}, 1 <= chunk <= 128, B >= 1, d >= 1, T >= 0.  Returns the
// CUDA error of the launch.
extern "C" int mamba_scan_launch(const void* dt, const void* x,
                                 const void* Bm, const void* Cm,
                                 const void* a, void* y, void* sT, int B,
                                 int T, int d, int N, int chunk,
                                 cudaStream_t stream) {
  if (B <= 0 || B > 65535 || d <= 0 || T < 0 || chunk < 1 ||
      chunk > MAX_CHUNK)
    return (int)cudaErrorInvalidValue;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* fy = static_cast<float*>(y);
  float* fs = static_cast<float*>(sT);
  if (N == 16)
    return dispatch<16>(f(dt), f(x), f(Bm), f(Cm), f(a), fy, fs, B, T, d,
                        chunk, stream);
  if (N == 8)
    return dispatch<8>(f(dt), f(x), f(Bm), f(Cm), f(a), fy, fs, B, T, d,
                       chunk, stream);
  if (N == 4)
    return dispatch<4>(f(dt), f(x), f(Bm), f(Cm), f(a), fy, fs, B, T, d,
                       chunk, stream);
  return (int)cudaErrorInvalidValue;
}
