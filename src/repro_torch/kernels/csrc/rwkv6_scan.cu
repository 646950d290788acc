// rwkv6_scan — the RWKV6 (Finch) WKV recurrence on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/rwkv6_scan.py (rwkv6_scan /
// _kernel).  Per row b of B*H (one head of one sequence), with the state
// S (n x n) carried across the sequence:
//
//     y_t = r_t S + (r_t . (u * k_t)) v_t
//     S  <- diag(w_t) S + k_t^T v_t
//
// r, k, v, w: (BH, T, n) f32; u: (BH, n) f32; s0: (BH, n, n) f32 or null
// (zeros).  Writes y (BH, T, n) and S_T (BH, n, n), f32.  The recurrence
// is the exact diagonal one, step by step, as the reference's: not the
// 1/decay-normalised matrix form, which overflows f32 for small w.
//
// Design.  One block per row, n threads (n = 64, the catalog's head dim,
// or 16, the tiny one; the wrapper refuses any other).  Thread j keeps
// column j of S in n registers for the whole sequence, so S never touches
// memory between s0 and S_T.  The sequence goes in chunks of `chunk`
// steps: the block copies the chunk's r, k, v, w (contiguous in the
// (T, n) layout, 16-byte vectors) into shared memory, then each thread
// works out the bonus r_t . (u * k_t) of a few steps, then the block walks
// the chunk's steps.  At each step thread j reads r_t, k_t, w_t from
// shared memory (one address for the whole warp: a broadcast), forms
// y_t[j] from the old S in four partial sums and updates its column in the
// same pass over i.  y is written once per step, n neighbouring floats.
// `chunk` sets only how many steps are staged at once; the arithmetic of
// a step does not depend on it, so neither does the result, bit for bit.
//
// What bounds it.  The function reads each input once and writes y and
// S_T once: about 5 * BH * T * n * 4 bytes, against 5 n^2 + 5 n operations
// per row and step, so on paper it is bound by bytes.  This kernel is
// bound by neither: each step is a dependent chain (S_t needs S_{t-1}),
// and a prefill of B*H = 32 rows fills 32 of the 132 SMs with two warps
// each.  Splitting a row's i-range across warps, more blocks per head and
// wgmma on chunked products are later work.
//
// FMA contraction stays on: the kernel is held to its plain version by a
// tolerance (the sums run in another order).

#include <cuda_runtime.h>

namespace {

// Most steps staged at once; the wrapper refuses a larger chunk.
constexpr int MAX_CHUNK = 128;

template <int N>
constexpr size_t smem_bytes(int chunk) {
  // r, k, v, w chunks, u, the chunk's bonus terms
  return (size_t)(4 * chunk * N + N + chunk) * sizeof(float);
}

template <int N>
__global__ void __launch_bounds__(N)
rwkv6_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  float* __restrict__ y, float* __restrict__ sT, int T,
                  int chunk) {
  extern __shared__ __align__(16) float smem[];
  float* sr = smem;                   // (chunk, N) each
  float* sk = sr + chunk * N;
  float* sv = sk + chunk * N;
  float* sw = sv + chunk * N;
  float* su = sw + chunk * N;         // (N,)
  float* sb = su + N;                 // (chunk,) r_t . (u * k_t)

  const int j = threadIdx.x;
  const size_t row = blockIdx.x;
  const size_t seq = row * (size_t)T * N;
  const size_t mat = row * (size_t)N * N;

  float S[N];
#pragma unroll
  for (int i = 0; i < N; ++i) S[i] = s0 ? s0[mat + i * N + j] : 0.0f;
  su[j] = u[row * N + j];

  for (int t0 = 0; t0 < T; t0 += chunk) {
    const int cl = min(chunk, T - t0);
    __syncthreads();                  // the last chunk is done with smem
    const size_t off = seq + (size_t)t0 * N;
    const float4* gr = reinterpret_cast<const float4*>(r + off);
    const float4* gk = reinterpret_cast<const float4*>(k + off);
    const float4* gv = reinterpret_cast<const float4*>(v + off);
    const float4* gw = reinterpret_cast<const float4*>(w + off);
    for (int q = j; q < cl * N / 4; q += N) {
      reinterpret_cast<float4*>(sr)[q] = gr[q];
      reinterpret_cast<float4*>(sk)[q] = gk[q];
      reinterpret_cast<float4*>(sv)[q] = gv[q];
      reinterpret_cast<float4*>(sw)[q] = gw[q];
    }
    __syncthreads();
    // the bonus of step t by thread t mod N; i starts at the global step
    // so that the threads of a warp read distinct banks and the sum's order
    // does not depend on the chunk
    for (int t = j; t < cl; t += N) {
      float b = 0.0f;
#pragma unroll 8
      for (int q = 0; q < N; ++q) {
        const int i = (q + t0 + t) & (N - 1);
        b += sr[t * N + i] * su[i] * sk[t * N + i];
      }
      sb[t] = b;
    }
    __syncthreads();

    for (int t = 0; t < cl; ++t) {
      const float vj = sv[t * N + j];
      const float4* rt = reinterpret_cast<const float4*>(sr + t * N);
      const float4* kt = reinterpret_cast<const float4*>(sk + t * N);
      const float4* wt = reinterpret_cast<const float4*>(sw + t * N);
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 rq = rt[q], kq = kt[q], wq = wt[q];
        a0 += rq.x * S[4 * q];
        a1 += rq.y * S[4 * q + 1];
        a2 += rq.z * S[4 * q + 2];
        a3 += rq.w * S[4 * q + 3];
        S[4 * q] = wq.x * S[4 * q] + kq.x * vj;
        S[4 * q + 1] = wq.y * S[4 * q + 1] + kq.y * vj;
        S[4 * q + 2] = wq.z * S[4 * q + 2] + kq.z * vj;
        S[4 * q + 3] = wq.w * S[4 * q + 3] + kq.w * vj;
      }
      y[seq + (size_t)(t0 + t) * N + j] = (a0 + a1) + (a2 + a3) + sb[t] * vj;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) sT[mat + i * N + j] = S[i];
}

template <int N>
int dispatch(const float* r, const float* k, const float* v, const float* w,
             const float* u, const float* s0, float* y, float* sT, int BH,
             int T, int chunk, cudaStream_t stream) {
  // shared memory above 48 KB must be asked for (on the current device)
  const cudaError_t e = cudaFuncSetAttribute(
      rwkv6_scan_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<N>(MAX_CHUNK));
  if (e != cudaSuccess) return (int)e;
  rwkv6_scan_kernel<N><<<BH, N, smem_bytes<N>(chunk), stream>>>(
      r, k, v, w, u, s0, y, sT, T, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// All pointers f32, contiguous and 16-byte aligned (the wrapper checks);
// s0 may be null.  n in {16, 64}, 1 <= chunk <= 128, T >= 0.  Returns the
// CUDA error of the launch.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, const void* s0,
                                 void* y, void* sT, int BH, int T, int n,
                                 int chunk, cudaStream_t stream) {
  if (BH <= 0 || T < 0 || chunk < 1 || chunk > MAX_CHUNK)
    return (int)cudaErrorInvalidValue;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (n == 64)
    return dispatch<64>(f(r), f(k), f(v), f(w), f(u), f(s0),
                        static_cast<float*>(y), static_cast<float*>(sT), BH,
                        T, chunk, stream);
  if (n == 16)
    return dispatch<16>(f(r), f(k), f(v), f(w), f(u), f(s0),
                        static_cast<float*>(y), static_cast<float*>(sT), BH,
                        T, chunk, stream);
  return (int)cudaErrorInvalidValue;
}
