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
// What bounds it.  The function reads each input once and writes y and
// S_T once: about 5 * BH * T * n * 4 bytes, 0.0127 ms at rwkv6-1.6b's
// prefill layer (BH 32, T 1024, n 64).  Its work is 3 n^2 lane operations
// a row and step (r S, k v, the decay's FMA), about as long on the SIMT
// lanes.  Within a head the steps form a chain, one FMA deep per element
// of S; across the head's columns nothing is shared but r_t, k_t, w_t, and
// y_t[j] is a sum over rows that feeds nothing back.  This kernel is bound
// by neither: by shared memory's 128 bytes a clock per SM, which every
// lane's r_t, k_t, w_t pass through (one float a lane and clock, broadcast
// or not), and by the latency of each step group's shuffle tree.
//
// Design.  The earlier kernel gave a head one block of n threads, thread j
// walking column j (n registers): 32 blocks of two warps on 132 SMs at
// prefill, one row's chain alone taking 0.27 ms.  Here a head's columns
// are split over n / COLS CTAs (plan_cols picks COLS from the rows and the
// card's SMs), a column's rows over G lanes of a warp, and each lane keeps
// CPL = 2 neighbouring columns, so that every r, k, w it reads serves two
// columns:
// lane (g, s) keeps rows 4 (s + G q) + e (e < 4, q < n / (4 G)) of columns
// c0 + jj0, c0 + jj0 + 1 in registers; G = 16 at n = 64 (one quad of rows
// a lane), 4 at n = 16.  Each step a lane reads its quads of r_t, k_t, w_t
// (a warp's G segments read 16 G contiguous bytes: no bank conflict) and
// its two v_t[j], and issues 24 FP operations at n = 64.  GROUP = G / CPL
// steps make G partial sums a lane; one reduce-scatter over the segments
// (__shfl_xor G/2, ..., 1, keeping one half at each level) leaves segment
// s with the whole sum of value s (step s / CPL, column s % CPL), which it
// writes with + bonus * v_t[j] by one FMA.  Two groups go at a time, so
// that their trees' shuffles overlap, then a last group; a chunk's last
// steps (fewer than a group) take the same tree one step at a time.
//
// Staging.  One producer warp keeps a ring of two chunk slots: a chunk's
// r, k, w of the head (contiguous in the (T, n) layout) by 1-d bulk copies
// (TMA) completed on the slot's "full" mbarrier, and v_t[c0 .. c0 + COLS)
// of the CTA's own columns by 16-byte cp.async copies that arrive on the
// same barrier (a bulk copy a step was slower: the copy engine takes small
// copies one at a time).  When a slot has landed the producer works out
// the chunk's bonus terms r_t . (u * k_t), each by one lane in a fixed
// order by quads of i starting at quad t mod n/4 (t the global step:
// distinct banks, and an order that does not depend on the chunk), and
// arrives on the slot's "ready" barrier; the consumers free the slot on
// its "empty" barrier.  The bonus of chunk c + 1 and the load of chunk
// c + 2 run while the consumers walk chunk c.  A slot holds `chunk` steps
// of r, k, w (n each), v (COLS) and the bonus, no more than the sequence
// has: a decode step's CTAs stay small.  s0 and S_T pass through a padded
// shared tile so that device memory sees whole rows of the CTA's columns.
//
// Every sum's order is fixed by n (G, CPL and the tree): neither `chunk`
// nor the CTAs per head change a bit of the result.  The FMAs are written
// out (__fmaf_rn, __fmul_rn) so that the plain emulation in
// tests/test_torch_rwkv6_split.py follows the same order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_barrier.cuh"  // mbar_*, bulk_load, copy16_async: the ring

namespace {

// Most steps a slot holds; the wrapper refuses a larger chunk.
constexpr int MAX_CHUNK = 128;
// Shared memory a block can have on the H100 (227 KB).
constexpr size_t SMEM_LIMIT = 232448;
// Slots in the staging ring (three or four gained nothing on the card).
constexpr int STAGES = 2;

// Lanes a column's rows are split over, segments of one quad of rows each:
// 16 at n = 64, 4 at n = 16.
template <int N>
constexpr int segments() { return N == 64 ? 16 : 4; }

template <int N, int COLS>
struct Plan {
  static constexpr int G = segments<N>();
  static constexpr int CPL = 2;                     // columns a lane
  static constexpr int QUADS = N / 4 / G;           // quads of rows a lane
  static constexpr int WARP_COLS = 32 / G * CPL;    // columns a warp
  static constexpr int WARPS = COLS / WARP_COLS;    // consumer warps
  static constexpr int GROUP = G / CPL;             // steps a reduction
  static constexpr int THREADS = 32 * (WARPS + 1);  // and the producer
  static constexpr int TILE_LD = COLS + 1;          // padded S tile row
  // one slot, in floats: r, k, w (chunk, N), v (chunk, COLS), bonus
  // (chunk), rounded up to 128 bytes
  static __host__ __device__ size_t slot(int chunk) {
    return ((size_t)chunk * (3 * N + COLS + 1) + 31) / 32 * 32;
  }
  // the slots, u (N), the S tile (N, TILE_LD); then 3 barriers a slot
  static __host__ __device__ size_t floats(int chunk) {
    return STAGES * slot(chunk) + N + ((size_t)N * TILE_LD + 1) / 2 * 2;
  }
  static __host__ __device__ size_t smem_bytes(int chunk) {
    return floats(chunk) * sizeof(float) + 3 * STAGES * sizeof(uint64_t);
  }
};

// Levels H, H/2, ... of a reduce-scatter over the segments (xor H): each
// level halves the values a lane holds, p[0 .. 2C) to p[0 .. C), keeping
// the upper half where the lane's bit H is set and adding the partner's
// copy of it.  After the levels G/2 .. 1 of G values, lane s holds value s.
template <int H, int C>
__device__ __forceinline__ void reduce_scatter(float* p, int s) {
  if constexpr (C >= 1) {
    const bool upper = s & H;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const float send = upper ? p[i] : p[i + C];
      const float keep = upper ? p[i + C] : p[i];
      p[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, H));
    }
    reduce_scatter<H / 2, C / 2>(p, s);
  }
}

// Levels H, H/2, ..., 1 of an all-reduce of one value (xor H).
template <int H>
__device__ __forceinline__ void all_reduce(float& p) {
  if constexpr (H >= 1) {
    p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, H));
    all_reduce<H / 2>(p);
  }
}

__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;" :: "r"(threads) : "memory");
}

template <int N, int COLS>
__global__ void __launch_bounds__(Plan<N, COLS>::THREADS)
rwkv6_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  float* __restrict__ y, float* __restrict__ sT, int T,
                  int chunk) {
  using P = Plan<N, COLS>;
  constexpr int G = P::G;
  constexpr int CPL = P::CPL;
  constexpr int CTAS = N / COLS;
  extern __shared__ __align__(128) float smem[];
  const size_t SLOT = P::slot(chunk);
  float* su = smem + STAGES * SLOT;                 // (N,)
  float* tile = su + N;                             // (N, TILE_LD)
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + P::floats(chunk));
  // slot b: full + 8 b, ready + 8 b, empty + 8 b; chunk c takes slot
  // c % STAGES, for the (c / STAGES)-th time
  const uint32_t full = smem_addr(bars);
  const uint32_t ready = full + 8 * STAGES;
  const uint32_t empty = full + 16 * STAGES;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t row = blockIdx.x / CTAS;
  const int c0 = (blockIdx.x % CTAS) * COLS;
  const size_t seq = row * (size_t)T * N;
  const size_t mat = row * (size_t)N * N;
  const int n_chunks = (T + chunk - 1) / chunk;

  if (threadIdx.x == 0) {
    for (int b = 0; b < STAGES; ++b) {
      mbar_init(full + 8 * b, 1 + 32);   // expect_tx + a producer warp
      mbar_init(ready + 8 * b, 32);
      mbar_init(empty + 8 * b, 32 * P::WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == P::WARPS) {
    // the producer warp: loads, then the bonus terms, a chunk ahead
    for (int i = lane; i < N; i += 32) su[i] = u[row * N + i];
    __syncwarp();
    const auto load = [&](int c) {
      const int b = c % STAGES;
      const int t0 = c * chunk;
      const int cl = min(chunk, T - t0);
      float* base = smem + b * SLOT;
      const size_t off = seq + (size_t)t0 * N;
      if (lane == 0) {
        const uint32_t rows = (uint32_t)cl * N * sizeof(float);
        mbar_expect_tx(full + 8 * b, 3 * rows);
        bulk_load(smem_addr(base), r + off, rows, full + 8 * b);
        bulk_load(smem_addr(base + chunk * N), k + off, rows, full + 8 * b);
        bulk_load(smem_addr(base + 2 * chunk * N), w + off, rows,
                  full + 8 * b);
      }
      // v's rows of the CTA's columns, 16 bytes a copy, each lane then
      // arriving when its copies have landed
      for (int q = lane; q < cl * (COLS / 4); q += 32) {
        const int t = q / (COLS / 4), c4 = 4 * (q % (COLS / 4));
        copy16_async(smem_addr(base + 3 * chunk * N + t * COLS + c4),
                     v + off + (size_t)t * N + c0 + c4);
      }
      copies_arrive(full + 8 * b);
    };
    const auto bonus = [&](int c) {
      const int b = c % STAGES;
      const int t0 = c * chunk;
      const int cl = min(chunk, T - t0);
      float* base = smem + b * SLOT;
      const float* sr = base;
      const float* sk = base + chunk * N;
      float* sb = base + 3 * chunk * N + chunk * COLS;
      mbar_wait(full + 8 * b, (c / STAGES) & 1);
      for (int t = lane; t < cl; t += 32) {
        const float4* rt = reinterpret_cast<const float4*>(sr + t * N);
        const float4* kt = reinterpret_cast<const float4*>(sk + t * N);
        const float4* ut = reinterpret_cast<const float4*>(su);
        float acc = 0.0f;
#pragma unroll
        for (int q = 0; q < N / 4; ++q) {
          const int i = (q + t0 + t) & (N / 4 - 1);
          const float4 rq = rt[i], kq = kt[i], uq = ut[i];
          acc = __fmaf_rn(__fmul_rn(rq.x, uq.x), kq.x, acc);
          acc = __fmaf_rn(__fmul_rn(rq.y, uq.y), kq.y, acc);
          acc = __fmaf_rn(__fmul_rn(rq.z, uq.z), kq.z, acc);
          acc = __fmaf_rn(__fmul_rn(rq.w, uq.w), kq.w, acc);
        }
        sb[t] = acc;
      }
      mbar_arrive(ready + 8 * b);
    };
    for (int c = 0; c < min(STAGES, n_chunks); ++c) load(c);
    if (n_chunks > 0) bonus(0);
    for (int c = 0; c < n_chunks; ++c) {
      if (c + 1 < n_chunks) bonus(c + 1);
      if (c + STAGES < n_chunks) {
        mbar_wait(empty + 8 * (c % STAGES), (c / STAGES) & 1);
        load(c + STAGES);
      }
    }
    return;
  }

  // the consumers: lane (g, s) keeps rows 4 (s + G q) + e of columns
  // c0 + jj0 + cc, cc < CPL
  const int s = lane & (G - 1);
  const int jj0 = warp * P::WARP_COLS + lane / G * CPL;
  const int tid = threadIdx.x;
  constexpr int CONSUMERS = 32 * P::WARPS;
  float S[P::QUADS][4][CPL];
  if (s0) {
    // whole rows of the CTA's columns into the tile, then each lane's rows
    for (int q = tid; q < N * COLS / 4; q += CONSUMERS) {
      const int i = q / (COLS / 4), c4 = 4 * (q % (COLS / 4));
      const float4 x =
          *reinterpret_cast<const float4*>(s0 + mat + i * N + c0 + c4);
      float* d = tile + i * P::TILE_LD + c4;
      d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
    }
    consumers_sync(CONSUMERS);
#pragma unroll
    for (int q = 0; q < P::QUADS; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc)
          S[q][e][cc] = tile[(4 * (s + G * q) + e) * P::TILE_LD + jj0 + cc];
  } else {
#pragma unroll
    for (int q = 0; q < P::QUADS; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc) S[q][e][cc] = 0.0f;
  }

  for (int c = 0; c < n_chunks; ++c) {
    const int b = c % STAGES;
    const int t0 = c * chunk;
    const int cl = min(chunk, T - t0);
    const float* sr = smem + b * SLOT;
    const float* sk = sr + chunk * N;
    const float* sw = sk + chunk * N;
    const float* sv = sw + chunk * N;
    const float* sb = sv + chunk * COLS;
    mbar_wait(full + 8 * b, (c / STAGES) & 1);
    mbar_wait(ready + 8 * b, (c / STAGES) & 1);
    float* yt = y + seq + (size_t)t0 * N + c0 + jj0;
    // one step of the lane's rows: for each of its columns the partial sum
    // of r_t S over the rows (from the old S), then S <- w_t S + k_t v_t
    const auto step = [&](int t, float* p) {
      const float4* rt = reinterpret_cast<const float4*>(sr + t * N);
      const float4* kt = reinterpret_cast<const float4*>(sk + t * N);
      const float4* wt = reinterpret_cast<const float4*>(sw + t * N);
      const float2 vj = *reinterpret_cast<const float2*>(sv + t * COLS + jj0);
      const float vv[CPL] = {vj.x, vj.y};
#pragma unroll
      for (int q = 0; q < P::QUADS; ++q) {
        const float4 rq = rt[s + G * q], kq = kt[s + G * q],
                     wq = wt[s + G * q];
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc) {
          float a = __fmul_rn(rq.x, S[q][0][cc]);
          a = __fmaf_rn(rq.y, S[q][1][cc], a);
          a = __fmaf_rn(rq.z, S[q][2][cc], a);
          a = __fmaf_rn(rq.w, S[q][3][cc], a);
          p[cc] = q == 0 ? a : __fadd_rn(p[cc], a);
          S[q][0][cc] = __fmaf_rn(wq.x, S[q][0][cc], __fmul_rn(kq.x, vv[cc]));
          S[q][1][cc] = __fmaf_rn(wq.y, S[q][1][cc], __fmul_rn(kq.y, vv[cc]));
          S[q][2][cc] = __fmaf_rn(wq.z, S[q][2][cc], __fmul_rn(kq.z, vv[cc]));
          S[q][3][cc] = __fmaf_rn(wq.w, S[q][3][cc], __fmul_rn(kq.w, vv[cc]));
        }
      }
    };
    // segment s writes value s of a group: step s / CPL, column s % CPL
    const auto write = [&](int t, float p) {
      const int ts = t + s / CPL, cc = s % CPL;
      yt[(size_t)ts * N + cc] =
          __fmaf_rn(sb[ts], sv[ts * COLS + jj0 + cc], p);
    };
    // two groups of GROUP steps at a time: their G partial sums each (step
    // m, column cc at m CPL + cc), then their reduce-scatters, whose
    // shuffles overlap
    int t = 0;
    for (; t + 2 * P::GROUP <= cl; t += 2 * P::GROUP) {
      float p[2][G];
#pragma unroll
      for (int g = 0; g < 2; ++g)
#pragma unroll
        for (int m = 0; m < P::GROUP; ++m)
          step(t + g * P::GROUP + m, p[g] + m * CPL);
      reduce_scatter<G / 2, G / 2>(p[0], s);
      reduce_scatter<G / 2, G / 2>(p[1], s);
      write(t, p[0][0]);
      write(t + P::GROUP, p[1][0]);
    }
    // a last group (its own loop also lets the compiler schedule the pairs'
    // loop better: 6 % on the card, PERF.md)
    for (; t + P::GROUP <= cl; t += P::GROUP) {
      float p[G];
#pragma unroll
      for (int m = 0; m < P::GROUP; ++m) step(t + m, p + m * CPL);
      reduce_scatter<G / 2, G / 2>(p, s);
      write(t, p[0]);
    }
    // the chunk's last steps one at a time, by the same tree: the first
    // level scatters the lane's two columns, the rest add up one value
    for (; t < cl; ++t) {
      float p[CPL];
      step(t, p);
      reduce_scatter<G / 2, CPL / 2>(p, s);
      all_reduce<G / 2 / CPL>(p[0]);
      const int cc = s / (G / CPL);       // the scattered level's bit
      if (s % (G / CPL) == 0)
        yt[(size_t)t * N + cc] =
            __fmaf_rn(sb[t], sv[t * COLS + jj0 + cc], p[0]);
    }
    mbar_arrive(empty + 8 * b);
  }

  // each lane's rows into the tile, then whole rows out
  consumers_sync(CONSUMERS);          // the tile's s0 readers are done
#pragma unroll
  for (int q = 0; q < P::QUADS; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc)
        tile[(4 * (s + G * q) + e) * P::TILE_LD + jj0 + cc] = S[q][e][cc];
  consumers_sync(CONSUMERS);
  for (int q = tid; q < N * COLS / 4; q += CONSUMERS) {
    const int i = q / (COLS / 4), c4 = 4 * (q % (COLS / 4));
    const float* d = tile + i * P::TILE_LD + c4;
    *reinterpret_cast<float4*>(sT + mat + i * N + c0 + c4) =
        make_float4(d[0], d[1], d[2], d[3]);
  }
}

// The instantiations: (n, columns a CTA), for each n by columns, fewest
// first.  Calls f(Plan, kernel) for the one that (n, cols) names; -1 when
// none does.
constexpr int SPLITS[][2] = {{64, 16}, {64, 32}, {16, 16}};

template <typename F>
int with_split(int n, int cols, F&& f) {
  if (n == 64 && cols == 16)
    return f(Plan<64, 16>(), rwkv6_scan_kernel<64, 16>);
  if (n == 64 && cols == 32)
    return f(Plan<64, 32>(), rwkv6_scan_kernel<64, 32>);
  if (n == 16 && cols == 16)
    return f(Plan<16, 16>(), rwkv6_scan_kernel<16, 16>);
  return -1;
}

// The columns of a head one CTA takes for BH rows on `sms` SMs, among the
// instantiations of head dim n whose two slots of `chunk` steps fit a
// block: the fewest whose grid still fits one CTA an SM (n = 64: four CTAs
// of four consumer warps a head), else the most (two CTAs of eight warps);
// -1 for an n without one.
int plan_cols(int BH, int n, int chunk, int sms) {
  int most = -1;
  for (const auto& split : SPLITS) {
    if (split[0] != n) continue;
    const int fits = with_split(n, split[1], [&](auto plan, auto) {
      return (int)(decltype(plan)::smem_bytes(chunk) <= SMEM_LIMIT);
    });
    if (fits != 1) continue;
    if ((long long)BH * (n / split[1]) <= sms) return split[1];
    most = split[1];
  }
  return most;
}

}  // namespace

// All pointers f32, contiguous and 16-byte aligned (the wrapper checks);
// s0 may be null.  n in {16, 64}, 1 <= chunk <= 128, T >= 0.  Splits each
// head's columns over CTAs by plan_cols on the current device's SMs and
// writes the columns a CTA took to *cols.  Returns the CUDA error of the
// launch.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, const void* s0,
                                 void* y, void* sT, int BH, int T, int n,
                                 int chunk, int* cols, cudaStream_t stream) {
  if (BH <= 0 || T < 0 || chunk < 1 || chunk > MAX_CHUNK)
    return (int)cudaErrorInvalidValue;
  // a slot holds no more steps than the sequence has: a decode step's
  // CTAs stay small enough to share an SM
  if (T > 0 && T < chunk) chunk = T;
  int device = 0, sms = 0;
  cudaError_t status = cudaGetDevice(&device);
  if (status == cudaSuccess)
    status = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device);
  if (status != cudaSuccess) return (int)status;
  *cols = plan_cols(BH, n, chunk, sms);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const int err = with_split(n, *cols, [&](auto plan, auto kernel) {
    using P = decltype(plan);
    const size_t bytes = P::smem_bytes(chunk);
    // shared memory above 48 KB must be asked for (on the current device)
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    kernel<<<BH * (n / *cols), P::THREADS, bytes, stream>>>(
        f(r), f(k), f(v), f(w), f(u), f(s0), static_cast<float*>(y),
        static_cast<float*>(sT), T, chunk);
    return (int)cudaGetLastError();
  });
  return err < 0 ? (int)cudaErrorInvalidValue : err;
}

// Per instantiation, in SPLITS' order, at `chunk`: out[0] the count, then
// five ints each: n, columns a CTA, blocks resident on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor; 0 where the shared
// memory exceeds a block's), threads a block, shared-memory bytes.
// Returns the first CUDA error, or 0.
extern "C" int rwkv6_scan_occupancy(int chunk, int* out) {
  const int count = sizeof(SPLITS) / sizeof(SPLITS[0]);
  out[0] = count;
  for (int i = 0; i < count; ++i) {
    int* o = out + 1 + 5 * i;
    o[0] = SPLITS[i][0];
    o[1] = SPLITS[i][1];
    const int err = with_split(o[0], o[1], [&](auto plan, auto kernel) {
      using P = decltype(plan);
      o[3] = P::THREADS;
      o[4] = (int)P::smem_bytes(chunk);
      o[2] = 0;
      if ((size_t)o[4] > SMEM_LIMIT) return 0;
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, o[4]);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(o + 2, kernel,
                                                          P::THREADS, o[4]);
      return (int)e;
    });
    if (err) return err;
  }
  return 0;
}
