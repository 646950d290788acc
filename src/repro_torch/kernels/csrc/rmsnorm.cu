// rmsnorm — y = x * rsqrt(mean(x^2) + eps) * (1 + w) on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py (rmsnorm /
// _kernel): rows are every leading dim of x (..., D), the math is f32, the
// output is in x's dtype, w is (D,) in x's dtype.  The same function as
// the models' RMSNorm (repro/models/layers.py: rmsnorm), note the (1 + w).
//
// What bounds it.  Bytes: it reads x and w once and writes y once, a few
// operations per element, far under the H100's ridge.  With few rows (a
// decode step: 4 x 2048 for four slots of llama3.2-1b, 4 x 16 384 for
// jamba's mamba norm) the bytes take nanoseconds, and what is left is the
// launch itself and the trips to memory one after the other.
//
// Design: one pass over device memory.  A row takes TPR threads (a power
// of two from 32 to 512, planned by the launcher: plan_tpr); thread j of
// a row holds the row's 16-byte vectors j, j + TPR, ..., V of them (V =
// 1, 2, 4 or 8; 4 f32 or 8 bf16 a vector), and the same vectors of w, in
// registers: every load of x and w is issued before the first is used, so
// a row costs one trip to memory.  The thread adds its squares into one
// partial sum a lane of the vector and adds those by a tree; the warp
// reduces by a shuffle butterfly, and where a row spans warps their sums
// meet in shared memory, each thread adding them in the same order.  y is
// written from the registers.  Many rows: a warp or a few a row, and the
// rows over at most half the card's resident threads (1024 x 2048 bf16:
// 128 threads a row, two vectors a thread); few rows: a 256-thread block
// a row (a decode row of 2048 bf16 is one vector a thread), more only
// where 8 vectors a thread do not hold the row.  Vectors past a row's D
// are masked (D = 80 bf16 is 10 vectors for 32 lanes); past 512 x 8
// vectors (D over 32 768 bf16, on no path here) a loop adds the rest and
// reads them again to write y.  The reduction order differs from torch's,
// so kernel and plain version agree to a few f32 ulps, not bit for bit.
//
// lm_empty_launch launches an empty kernel: the floor of the timing
// method, against which a short kernel's time is read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// Threads a block where a row takes fewer (several rows a block), and the
// most threads a row takes while 8 vectors a thread hold it.
constexpr int BLOCK = 256;
// Threads a row, at least and at most.
constexpr int MIN_TPR = 32;
constexpr int MAX_TPR = 512;
// Most 16-byte vectors of x (and of w) a thread holds.
constexpr int MAX_V = 8;

template <typename T>
__host__ __device__ constexpr int vec() { return 16 / sizeof(T); }

__device__ __forceinline__ unsigned word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Element i of a vector, as f32 (bf16 to f32 is exact: the high half).
template <typename T>
__device__ __forceinline__ float elem(const uint4& v, int i);
template <>
__device__ __forceinline__ float elem<float>(const uint4& v, int i) {
  return __uint_as_float(word(v, i));
}
template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& v, int i) {
  const unsigned w = word(v, i / 2);
  return __uint_as_float(i % 2 ? w & 0xffff0000u : w << 16);
}

// The bits of f in T (round to nearest even), in the low bits.
template <typename T>
__device__ __forceinline__ unsigned bits(float f);
template <>
__device__ __forceinline__ unsigned bits<float>(float f) {
  return __float_as_uint(f);
}
template <>
__device__ __forceinline__ unsigned bits<__nv_bfloat16>(float f) {
  return __bfloat16_as_ushort(__float2bfloat16(f));
}

template <typename T>
__device__ __forceinline__ void add_squares(const uint4& v, float* part) {
#pragma unroll
  for (int i = 0; i < vec<T>(); ++i) {
    const float f = elem<T>(v, i);
    part[i] = fmaf(f, f, part[i]);
  }
}

// x * r * (1 + w) of a vector, in T.
template <typename T>
__device__ __forceinline__ uint4 scaled(const uint4& xv, const uint4& wv,
                                        float r) {
  constexpr int PER = vec<T>() / 4;       // elements a 32-bit word
  unsigned o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    o[k] = 0u;
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int i = k * PER + e;
      o[k] |= bits<T>(elem<T>(xv, i) * r * (1.0f + elem<T>(wv, i)))
              << (32 / PER * e);
    }
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// The compiler may not carry f32 copies of x from the squares to the
// write (they would cost registers): an empty asm that "changes" the raw
// bits makes it convert them again.
__device__ __forceinline__ void reconvert(uint4& v) {
  asm volatile("" : "+r"(v.x), "+r"(v.y), "+r"(v.z), "+r"(v.w));
}

template <typename T, int V>
__global__ void __launch_bounds__(MAX_TPR)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ y, int rows, int D, float eps, int tpr_log2) {
  constexpr int VEC = vec<T>();
  __shared__ float red[MAX_TPR / 32];
  const int tpr = 1 << tpr_log2;
  const int j = threadIdx.x & (tpr - 1);
  const int row = blockIdx.x * (blockDim.x >> tpr_log2) +
                  (threadIdx.x >> tpr_log2);
  const bool live = row < rows;
  const int nv = D / VEC;
  const uint4* xr = reinterpret_cast<const uint4*>(x) + (size_t)row * nv;
  const uint4* wr = reinterpret_cast<const uint4*>(w);
  uint4* yr = reinterpret_cast<uint4*>(y) + (size_t)row * nv;

  uint4 xv[V], wv[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int i = j + v * tpr;
    xv[v] = wv[v] = make_uint4(0u, 0u, 0u, 0u);
    if (live && i < nv) {
      xv[v] = xr[i];
      wv[v] = wr[i];
    }
  }
  float part[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) part[i] = 0.0f;
#pragma unroll
  for (int v = 0; v < V; ++v) add_squares<T>(xv[v], part);
  if (live)
    for (int i = j + V * tpr; i < nv; i += tpr)   // D past TPR * V vectors
      add_squares<T>(xr[i], part);
#pragma unroll
  for (int s = 1; s < VEC; s *= 2)
#pragma unroll
    for (int i = 0; i < VEC; i += 2 * s) part[i] += part[i + s];
  float ss = part[0];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (tpr > 32) {                           // the row's warps meet here
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) red[warp] = ss;
    __syncthreads();
    const int first = warp & ~((tpr >> 5) - 1);
    ss = 0.0f;
    for (int k = 0; k < (tpr >> 5); ++k) ss += red[first + k];
  }
  if (!live) return;
  const float r = rsqrtf(ss * (1.0f / (float)D) + eps);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int i = j + v * tpr;
    reconvert(xv[v]);
    if (i < nv) yr[i] = scaled<T>(xv[v], wv[v], r);
  }
  for (int i = j + V * tpr; i < nv; i += tpr)
    yr[i] = scaled<T>(xr[i], wr[i], r);
}

// f(kernel) for the instantiation (T, V); -1 for a V without one.
template <typename T, typename F>
int with_v(int V, F&& f) {
  if (V == 1) return f(rmsnorm_kernel<T, 1>);
  if (V == 2) return f(rmsnorm_kernel<T, 2>);
  if (V == 4) return f(rmsnorm_kernel<T, 4>);
  if (V == 8) return f(rmsnorm_kernel<T, 8>);
  return -1;
}

// Vectors a thread holds for a row of nv vectors over tpr threads: the
// power of two that holds them, at most MAX_V (the kernel's loop takes
// the rest).
int vectors_per_thread(int nv, int tpr) {
  const int need = (nv + tpr - 1) / tpr;
  int v = 1;
  while (v < need && v < MAX_V) v *= 2;
  return v;
}

// Threads a row: doubled from a warp while a row has more vectors than
// threads, a block a row is not reached (256 threads) and the rows stay
// within half the card's `resident` threads; then at least enough that a
// thread holds MAX_V vectors (up to 512).
int plan_tpr(long long rows, int nv, long long resident) {
  int tpr = MIN_TPR, lo = MIN_TPR;
  while (tpr < BLOCK && tpr < nv && rows * tpr * 4 <= resident) tpr *= 2;
  while (lo < MAX_TPR && (long long)MAX_V * lo < nv) lo *= 2;
  return tpr > lo ? tpr : lo;
}

template <typename T>
int launch_typed(const void* x, const void* w, void* y, int rows, int D,
                 float eps, int tpr, cudaStream_t stream) {
  int log2 = 0;
  while ((1 << log2) < tpr) ++log2;
  if ((1 << log2) != tpr || tpr < MIN_TPR || tpr > MAX_TPR)
    return (int)cudaErrorInvalidValue;
  const int threads = tpr > BLOCK ? tpr : BLOCK;
  const int rows_per_block = threads / tpr;
  const dim3 grid((rows + rows_per_block - 1) / rows_per_block);
  const int err = with_v<T>(vectors_per_thread(D / vec<T>(), tpr),
                            [&](auto kernel) {
    kernel<<<grid, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(y), rows, D, eps, log2);
    return (int)cudaGetLastError();
  });
  return err < 0 ? (int)cudaErrorInvalidValue : err;
}

// Launch with `tpr` threads a row; the CUDA error of the launch.
int launch_tpr(const void* x, const void* w, void* y, int rows, int D,
               float eps, int dtype, int tpr, cudaStream_t stream) {
  if (dtype == 0)
    return launch_typed<float>(x, w, y, rows, D, eps, tpr, stream);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(x, w, y, rows, D, eps, tpr, stream);
  return (int)cudaErrorInvalidValue;
}

__global__ void empty_kernel() {}

}  // namespace

// dtype: 0 float32, 1 bfloat16, of x, w and y alike.  D a multiple of
// 16 / sizeof(x), and x, w, y 16-byte aligned (the wrapper checks).  Picks
// the threads a row by plan_tpr on the current device.  Returns the CUDA
// error of the launch.
extern "C" int rmsnorm_launch(const void* x, const void* w, void* y, int rows,
                              int D, float eps, int dtype,
                              cudaStream_t stream) {
  if (rows <= 0 || D <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t status = cudaGetDevice(&device);
  if (status == cudaSuccess)
    status = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device);
  if (status == cudaSuccess)
    status = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, device);
  if (status != cudaSuccess) return (int)status;
  const int nv = D / (dtype == 0 ? 4 : 8);
  const int tpr = plan_tpr(rows, nv, (long long)sms * per_sm);
  return launch_tpr(x, w, y, rows, D, eps, dtype, tpr, stream);
}

// Per instantiation, f32 then bf16, V = 1, 2, 4, 8: out[0] the count, then
// four ints each: dtype (0 f32, 1 bf16), V, blocks resident on one SM at
// 256 and at 512 threads a block
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Returns the first CUDA
// error, or 0.
extern "C" int rmsnorm_occupancy(int* out) {
  out[0] = 8;
  int i = 0;
  for (int dtype = 0; dtype < 2; ++dtype)
    for (int V = 1; V <= MAX_V; V *= 2, ++i) {
      int* o = out + 1 + 4 * i;
      o[0] = dtype;
      o[1] = V;
      const auto occ = [&](auto kernel) {
        cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            o + 2, kernel, BLOCK, 0);
        if (e == cudaSuccess)
          e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(o + 3, kernel,
                                                            MAX_TPR, 0);
        return (int)e;
      };
      const int err = dtype == 0 ? with_v<float>(V, occ)
                                 : with_v<__nv_bfloat16>(V, occ);
      if (err) return err;
    }
  return 0;
}

// One launch of an empty kernel (one warp): the floor of a launch timed by
// CUDA events.  Returns the CUDA error of the launch.
extern "C" int lm_empty_launch(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return (int)cudaGetLastError();
}
