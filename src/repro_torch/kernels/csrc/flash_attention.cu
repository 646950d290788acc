// flash_attention — blockwise online-softmax attention on Hopper: the C
// entry point of K5 and its SIMT kernel.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention / _kernel): q (BH, Sq, hd), k and v (BKV, Sk, hd),
// query head b reading kv head b / (BH / BKV) (GQA); causal mask
// q_pos >= k_pos, sliding window (q_pos - k_pos) < window, kv padding
// k_pos < Sk, logit softcap tanh(s / c) * c before the mask, masked scores
// -1e30 (never -inf: a row fully masked in a live block gets p = 1 there and
// is wiped by the next block's corr = exp(-1e30 - m) = 0), k-blocks fully
// masked for the whole q-block skipped, running max / sum / accumulator in
// f32, output in q's dtype.  Positions start at 0 for q and k.
//
// Two kernels, chosen by the operands in flash_attention_launch below
// (kernels/flash_attention.py: tensor_core_path states the same rule):
// bf16 with hd 64, 80, 128 or 256 (every attention layer of the catalog's
// bf16 models) goes to flash_attention_sm90.cu (TMA, wgmma); f32 of every
// hd, whose 2e-5 limit rules out TF32, and bf16 of every other hd (the
// tiny test models' 16) stay on the SIMT kernel of this file.
//
// Design.  One CTA of 256 threads per (bh, 64-row q-block); it loops over
// 64-row k-blocks.  q, k and v tiles live in shared memory as f32 (the
// Pallas kernel casts them to f32 before both products, so bf16 and f32
// inputs take the same f32 arithmetic), rows padded by one float so that
// the strided reads hit distinct banks.  Thread (ty, tx) of a 16 x 16 grid
// owns query rows ty + 16 i (i < 4): it computes the scores of those rows
// against key rows tx + 16 j (j < 4), the row max and sum by shuffles across
// the 16 lanes that share ty, writes p to shared memory, and accumulates
// output columns tx + 16 j (j < NJ, NJ = ceil(hd / 16)) of its four rows.
// hd is any multiple of 8 up to 256; NJ is a template parameter (4, 8, 16).
//
// What bounds it.  The products: at a 1024-token causal prefill with 32
// query heads of hd 64 they are 4.3 GFLOP, 64 us on the f32 SIMT pipes
// (67 TFLOP/s) that this kernel uses, out of shared memory, with no TMA
// and synchronous tile loads.  It serves the operands the tensor-core
// kernel does not take, right and simple: f32, where a 3xTF32 path on the
// tensor cores is later work (ROADMAP), and bf16 head dims no model of
// the catalog has.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

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
  return __float2bfloat16(x);   // round to nearest even, as torch's cast
}

template <typename T>
struct alignas(8 * sizeof(T)) Vec8 { T v[8]; };

// Rows [row0, row0 + 64) of a row-major (S, hd) matrix into shared memory
// (row stride ld floats) as f32; rows at or past S are zeros.  hd % 8 == 0
// and a 16-byte aligned base make every 8-element chunk one aligned load.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int row0, int S, int hd) {
  const int chunks = hd / 8;
  for (int c = threadIdx.x; c < BQ * chunks; c += THREADS) {
    const int r = c / chunks;
    const int d0 = (c - r * chunks) * 8;
    float* out = dst + r * ld + d0;
    if (row0 + r < S) {
      const Vec8<T> t = *reinterpret_cast<const Vec8<T>*>(
          src + (size_t)(row0 + r) * hd + d0);
#pragma unroll
      for (int i = 0; i < 8; ++i) out[i] = to_f32(t.v[i]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) out[i] = 0.0f;
    }
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

constexpr size_t smem_bytes(int hd) {
  return (size_t)(3 * BQ * (hd + 1) + BQ * (BK + 1)) * sizeof(float);
}

template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Sk, int hd, int group, int causal, int window,
                       float softcap, float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* q_s = smem;
  float* k_s = q_s + BQ * ld;
  float* v_s = k_s + BK * ld;
  float* p_s = v_s + BK * ld;   // BQ x (BK + 1)

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int kvh = bh / group;
  const T* qp = q + (size_t)bh * Sq * hd;
  const T* kp = k + (size_t)kvh * Sk * hd;
  const T* vp = v + (size_t)kvh * Sk * hd;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile(q_s, ld, qp, q0, Sq, hd);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  const int nk = (Sk + BK - 1) / BK;
  const int last_q = q0 + BQ - 1;
  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * BK;
    // skip k-blocks that are fully masked for this q-block (uniform over
    // the CTA, so no thread skips a barrier another one waits at)
    if (causal && last_q < k0) break;
    if (window > 0 && !(k0 + BK - 1 > q0 - window)) continue;

    __syncthreads();   // the previous block's p_s / v_s reads are done
    load_tile(k_s, ld, kp, k0, Sk, hd);
    load_tile(v_s, ld, vp, k0, Sk, hd);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.0f) x = tanhf(x / softcap) * softcap;
        bool ok = kpos < Sk;
        if (causal) ok = ok && qpos >= kpos;
        if (window > 0) ok = ok && (qpos - kpos) < window;
        s[i][j] = ok ? x : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        if (d < hd) {
          const float vv = v_s[c * ld + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] += pv[i] * vv;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + ((size_t)bh * Sq + qpos) * hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) orow[d] = from_f32<T>(acc[i][j] / den);
    }
  }
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int BKV, int Sq, int Sk, int hd, int causal, int window,
           float softcap, float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, NJ>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(16 * NJ));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, BH);
  kernel<<<grid, THREADS, smem_bytes(hd), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, hd, BH / BKV,
      causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int BH,
             int BKV, int Sq, int Sk, int hd, int causal, int window,
             float softcap, float scale, cudaStream_t stream) {
  if (hd <= 64)
    return launch<T, 4>(q, k, v, o, BH, BKV, Sq, Sk, hd, causal, window,
                        softcap, scale, stream);
  if (hd <= 128)
    return launch<T, 8>(q, k, v, o, BH, BKV, Sq, Sk, hd, causal, window,
                        softcap, scale, stream);
  return launch<T, 16>(q, k, v, o, BH, BKV, Sq, Sk, hd, causal, window,
                       softcap, scale, stream);
}

}  // namespace

extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* o, int BH,
                                           int BKV, int Sq, int Sk, int hd,
                                           int causal, int window,
                                           float softcap, float scale,
                                           cudaStream_t stream);

// dtype: 0 float32, 1 bfloat16.  The wrapper has checked shapes (hd a
// multiple of 8 in [8, 256], BH % BKV == 0, BH <= 65535), dtypes,
// contiguity and 16-byte alignment.  Returns the CUDA error of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int BH, int BKV,
                                      int Sq, int Sk, int hd, int causal,
                                      int window, float softcap, float scale,
                                      int dtype, cudaStream_t stream) {
  if (hd < 8 || hd > 256 || hd % 8 != 0 || BKV <= 0 || BH % BKV != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && (hd == 64 || hd == 80 || hd == 128 || hd == 256))
    return flash_attention_sm90_launch(q, k, v, o, BH, BKV, Sq, Sk, hd,
                                       causal, window, softcap, scale,
                                       stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, BH, BKV, Sq, Sk, hd, causal, window,
                           softcap, scale, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, BH, BKV, Sq, Sk, hd, causal,
                                   window, softcap, scale, stream);
  return (int)cudaErrorInvalidValue;
}
