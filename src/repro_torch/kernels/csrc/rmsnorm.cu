// rmsnorm — y = x * rsqrt(mean(x^2) + eps) * (1 + w) on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py (rmsnorm /
// _kernel): rows are every leading dim of x (..., D), the math is f32, the
// output is in x's dtype, w is (D,) in x's dtype.  The same function as
// the models' RMSNorm (repro/models/layers.py: rmsnorm), note the (1 + w).
//
// Design.  One warp per row, eight rows per 256-thread block.  A lane reads
// VEC contiguous elements at a time (16 bytes: 4 f32 or 8 bf16; the wrapper
// refuses a D that is not a multiple of VEC and rows that are not 16-byte
// aligned), keeps VEC partial sums of squares in registers, adds them up,
// and the warp reduces by shuffles; the
// second pass re-reads the row (from L1 / L2) and writes y.  The reduction
// order differs from torch's, so kernel and plain version agree to a few
// f32 ulps, not bit for bit.
//
// What bounds it.  Bytes: it reads x and w once and writes y once, a few
// operations per element, far under the H100's ridge.  At decode the rows
// are few (4 x 2048 for four slots of llama3.2-1b) and the launch itself
// is the floor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS_PER_BLOCK = 8;
constexpr int THREADS = 32 * ROWS_PER_BLOCK;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int N>
struct alignas(N * sizeof(T)) Vec { T v[N]; };

template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  const Vec<T, N> t = *reinterpret_cast<const Vec<T, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f32(t.v[i]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ y, int rows, int D, float eps) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  constexpr int VEC = 16 / sizeof(T);
  if (row >= rows) return;
  const T* xr = x + (size_t)row * D;
  T* yr = y + (size_t)row * D;

  float part[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) part[i] = 0.0f;
  for (int c = lane * VEC; c < D; c += 32 * VEC) {
    float xv[VEC];
    load_vec<T, VEC>(xr + c, xv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) part[i] += xv[i] * xv[i];
  }
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) ss += part[i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);

  const float var = ss * (1.0f / (float)D);
  const float r = rsqrtf(var + eps);
  for (int c = lane * VEC; c < D; c += 32 * VEC) {
    float xv[VEC], wv[VEC];
    load_vec<T, VEC>(xr + c, xv);
    load_vec<T, VEC>(w + c, wv);
    Vec<T, VEC> out;
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      out.v[i] = from_f32<T>(xv[i] * r * (1.0f + wv[i]));
    *reinterpret_cast<Vec<T, VEC>*>(yr + c) = out;
  }
}

template <typename T>
int dispatch(const void* x, const void* w, void* y, int rows, int D,
             float eps, cudaStream_t stream) {
  const dim3 grid((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  rmsnorm_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      rows, D, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, of x, w and y alike.  D a multiple of
// 16 / sizeof(x), and x, w, y 16-byte aligned (the wrapper checks).
// Returns the CUDA error of the launch.
extern "C" int rmsnorm_launch(const void* x, const void* w, void* y, int rows,
                              int D, float eps, int dtype,
                              cudaStream_t stream) {
  if (rows <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch<float>(x, w, y, rows, D, eps, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, w, y, rows, D, eps, stream);
  return (int)cudaErrorInvalidValue;
}
