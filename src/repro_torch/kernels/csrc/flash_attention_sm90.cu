// flash_attention_sm90 — K5's tensor-core path on Hopper: bf16 attention
// with head dim 64, 80, 128 or 256 (llama3.2-1b's, stablelm-3b's, jamba's
// and gemma3-4b's layers).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:140
// (flash_attention / _kernel) for those operands; flash_attention.cu's
// flash_attention_launch sends them here and every other operand to its
// SIMT kernel.  The function is the one that file's header states: q
// (BH, Sq, hd), k and v (BKV, Sk, hd), query head b reading kv head
// b / (BH / BKV); scale, then tanh(s / c) * c, then the masks k_pos < Sk,
// causal q_pos >= k_pos, window q_pos - k_pos < window, masked scores -1e30;
// an f32 running max, sum and accumulator with corr = exp(m_prev - m_new);
// output acc / max(l, 1e-30) rounded to bf16 to nearest even; k-blocks
// fully masked for the q-block skipped.
//
// What bounds it.  At llama3.2-1b's prefill layer (BH 32, BKV 8, Sq = Sk =
// 1024, hd 64, causal) QK^T and PV over the causal pairs are 4.3 GFLOP:
// 4.35 us at the H100's 989 TFLOP/s dense bf16 tensor-core peak, against
// 3 us to move q, k, v and the output once.  The bound is the tensor cores,
// and at gemma3-4b's (BH 8, BKV 4, hd 256: 4.30 GFLOP, 4.35 us against
// 3.76 us of bytes) too; at stablelm-3b's (BH 32 = BKV, hd 80) it is the
// 21.0 MB moved, 6.26 us against 5.43 us of products.
//
// Design.  One CTA per (head, BM-row q-block), grid (BH, q-blocks) with
// the last q-blocks (the most keys under a causal mask) first.  The last
// warp is the producer: one thread issues TMA loads through three tensor
// maps (hd x S x heads, 128-byte swizzle, rows past Sq or Sk and columns
// past hd zero-filled): the Q tile once, then each live 64-key block's K
// and V tiles into a ring of STAGES slots, with a full and an empty
// mbarrier per slot.  The warps before it are consumer warpgroups of 64
// query rows each.  Per key block: S = Q K^T by wgmma m64n64k16 with both
// operands read from shared memory through descriptors (K lies K-major as
// it is stored); the softmax on the accumulator fragment in registers (a
// thread holds two rows; row max and sum by shuffles across the 4 lanes
// that share a row; the masks only in blocks that straddle the diagonal,
// the window edge or Sk; f32 expf and tanhf); then O += P V by wgmma with
// P from registers, the S fragment converted as it lies, and V read from
// shared memory MN-major (the transpose bit).  The PV of one block is
// issued with the next block's QK^T and runs on the tensor cores during
// that block's softmax (FA3's intra-warpgroup overlap); when it is done,
// one thread of each warpgroup frees its slot.
//
// Head dims.  A tile row is BOXES = ceil(hd / 64) boxes of 64 columns, 128
// bytes each, one swizzle atom wide.  hd 128 and 256 fill them; at hd 80
// the second box holds columns 64-79 and TMA zero-fills 80-127 (a box
// counts its full bytes against the barrier's expected transactions, as
// one past Sq or Sk does).  Only the shared-memory tile is padded: the
// tensor maps' inner dimension and row stride (160 bytes) and the store
// take the true hd.  QK^T runs hd / 16 k-steps (5 at hd 80) and PV one
// wgmma m64n{hd}k16 (n80 reads its last 16 columns from the second box),
// so that the tensor cores do hd 80's work and no more.  hd 64 - 128: BM
// 128, two consumer warpgroups (288 threads).  hd 256: BM 64, one consumer
// warpgroup (160 threads): its accumulator alone is 128 f32 a thread, and
// with S's 32, P's hi and lo 32 and the addresses it fits in the 255
// registers a thread of a 160-thread CTA may take, where two warpgroups
// (288 threads) would leave 224; at gemma3-4b's prefill it also gives 128
// CTAs on the 132 SMs where BM 128 gives 64.  Its PV is two wgmma
// m64n128k16 of two boxes each.  Three K / V stages at every hd: hd 256 at
// BM 64 fills 225 KB of the 227 KB a block may use; one CTA an SM.  153 /
// 161 / 167 / 240 registers (hd 64 / 80 / 128 / 256), no spill: the
// `build` line of chip_smoke.py, which fails if an instantiation spills.
//
// P's precision.  The plain version multiplies f32 P by f32 V; a bf16 P
// carries up to 2^-9 of relative error per weight, and where a row's
// output cancels towards zero that breaks the bf16 limit (the smaller of
// 2e-2 and 2 bf16 ulps of the plain output + 2e-5).  So P goes in as a
// pair, p_hi = bf16(p) and p_lo = bf16(p - p_hi), two wgmmas into the same
// accumulator (about 2^-17 relative error, half again the tensor-core
// work).  Evidence: tests/test_torch_flash_split.py emulates both on the
// CPU over chip_smoke.py's matrix (hd {16, 64, 80, 128, 256} x S {1, 77,
// 1024, 2048} x 8 mask options x GQA groups {1, 4, 8}): one bf16 P lands
// more than 10x over the limit wherever a row has more than one key, the
// pair under 0.6 of it (the final rounding's one ulp against the limit's
// two).  The pair is the design's cost; the bound above counts
// the function's work alone.
//
// A barrier wait that does not complete within about 2^32 cycles traps:
// that is a fault of the kernel, and a trap reports it where a spin would
// hang the card.

#include <cuda.h>            // CUtensorMap and its enums: types only
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "sm90_barrier.cuh"  // smem_addr, mbar_*: the ring's barriers

namespace {

constexpr int BN = 64;                  // keys of a block
constexpr int STAGES = 3;               // K / V slots in the ring
constexpr int ATOM = 64;                // bf16 columns of one 128-byte row
constexpr int SMEM_LIMIT = 232448;      // dynamic shared memory of a block
constexpr float NEG_INF = -1e30f;

// The tile of head dim HD (a multiple of 16 up to 256).
template <int HD>
struct Tiles {
  static constexpr int BOXES = (HD + ATOM - 1) / ATOM;  // 64-column boxes
  static constexpr int BM = HD > 128 ? 64 : 128;        // query rows
  static constexpr int WARPGROUPS = BM / 64;            // consumers
  static constexpr int CONSUMERS = 128 * WARPGROUPS;
  static constexpr int THREADS = CONSUMERS + 32;        // and the producer
  static constexpr uint32_t Q = BM * BOXES * 128;       // bytes of Q
  static constexpr uint32_t KV = BN * BOXES * 128;      // of a K or V tile
  // the tiles from a 1024-byte aligned base (the swizzle's period), then
  // 2 * STAGES + 1 mbarriers
  static constexpr uint32_t SMEM =
      1024 + Q + 2 * STAGES * KV + 8 * (2 * STAGES + 1);
  // PV in SPLITS wgmmas of PV_N output columns (n256 as two n128)
  static constexpr int PV_N = HD > 128 ? 128 : HD;
  static constexpr int SPLITS = HD / PV_N;
  static_assert(HD % 16 == 0 && HD % PV_N == 0 && SMEM <= SMEM_LIMIT,
                "no tile for this head dim");
};

// One box of a 3-d tensor map at (column, row, head) into shared memory;
// its bytes count against the barrier's expected transactions.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(col), "r"(row), "r"(head)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1 =
// 128B swizzle.  K-major: the stride is the 1024 bytes between 8-row
// groups and the leading offset is unused.  MN-major: the leading offset
// is the distance between 64-column boxes, the stride the 1024 bytes
// between 8-row groups along K.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N of this warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}
// Keep the compiler from moving reads or writes of a wgmma's registers
// across the asynchronous wgmma that owns them, or the writes that define
// them past the wgmma.fence before it (which would serialize the wgmmas).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int M, int N>
__device__ __forceinline__ void fence_regs(float (&d)[M][N]) {
#pragma unroll
  for (int m = 0; m < M; ++m) fence_regs(d[m]);
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i]) :: "memory");
}

// D (m64n64, f32) += A (m64k16, bf16, shared memory, K-major) x
// B (k16n64, bf16, shared memory, K-major); D = A x B when scale_d is 0.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, "
      "%1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;"
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (m64n64, f32) += A (m64k16, bf16, registers) x B (k16n64, bf16,
// shared memory, MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, "
      "%1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, "
      "1, 1;"
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (m64n80, f32) += A (m64k16, bf16, registers) x B (k16n80, bf16,
// shared memory, MN-major: the transpose bit): columns 0-63 from the
// first 64-column box, 64-79 from the second, the leading offset away.
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {%0, "
      "%1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "
      "%39}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;"
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (m64n128, f32) += A (m64k16, bf16, registers) x B (k16n128, bf16,
// shared memory, MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, "
      "%1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "
      "%39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, "
      "%51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, "
      "%63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;"
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_n64(d, a, b);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[40],
                                         const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_n80(d, a, b);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_n128(d, a, b);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  uint32_t u;
  memcpy(&u, &x, 4);
  return u;
}

// O += P V over a block's keys in steps of 16 rows of V (2048 bytes), P
// as its hi and lo halves; V is MN-major, its 64-column boxes BN * 128
// bytes apart.  acc[s] holds output columns [s * 2R, (s + 1) * 2R), which
// start at box s * 2R / 64.
template <int SPLITS, int R>
__device__ __forceinline__ void issue_pv(float (&acc)[SPLITS][R],
                                         const uint32_t (&hi)[BN / 16][4],
                                         const uint32_t (&lo)[BN / 16][4],
                                         uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int sp = 0; sp < SPLITS; ++sp) {
      const uint64_t b = smem_desc(
          v + sp * (2 * R / ATOM) * BN * 128 + kk * 16 * 128, BN * 128, 1024);
      wgmma_rs(acc[sp], hi[kk], b);
      wgmma_rs(acc[sp], lo[kk], b);
    }
}

// (a, b) as bf16 pairs hi = bf16(a, b), lo = bf16((a, b) - hi), the lower
// column in the low half, as a wgmma A fragment register holds them.
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// The key blocks [kb0, kb1) a q-block of BM rows starting at q0 visits:
// those before the causal diagonal and after the window's far edge.
template <int BM>
__device__ __forceinline__ void key_blocks(int q0, int Sk, int causal,
                                           int window, int& kb0, int& kb1) {
  kb1 = (Sk + BN - 1) / BN;
  if (causal) kb1 = min(kb1, (q0 + BM - 1) / BN + 1);
  kb0 = 0;
  if (window > 0) {
    // the first block whose last key k0 + BN - 1 > q0 - window
    const int t = q0 - window - BN + 2;
    if (t > 0) kb0 = (t + BN - 1) / BN;
  }
}

// Whether some (query, key) pair of the q-block and the key block at k0 is
// masked, so that the block needs the elementwise mask.
template <int BM>
__device__ __forceinline__ bool straddles(int q0, int k0, int Sk, int causal,
                                          int window) {
  bool edge = k0 + BN > Sk;
  if (causal) edge = edge || k0 + BN - 1 > q0;
  if (window > 0) edge = edge || q0 + BM - 1 - k0 >= window;
  return edge;
}

template <int HD>
__global__ void __launch_bounds__(Tiles<HD>::THREADS, 1)
flash_attention_kernel_sm90(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            __nv_bfloat16* __restrict__ o, int Sq, int Sk,
                            int group, int causal, int window, float softcap,
                            float scale) {
  using T = Tiles<HD>;
  constexpr int BM = T::BM;
  extern __shared__ uint8_t smem[];
  const uint32_t q_s = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t k_s = q_s + T::Q;                      // slot st: + st * KV
  const uint32_t v_s = k_s + STAGES * T::KV;
  const uint32_t q_full = v_s + STAGES * T::KV;
  const uint32_t full = q_full + 8;                     // slot st: + 8 st
  const uint32_t empty = full + 8 * STAGES;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int kvh = bh / group;
  int kb0, kb1;
  key_blocks<BM>(q0, Sk, causal, window, kb0, kb1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, T::WARPGROUPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= T::CONSUMERS) {
    // the producer: one thread keeps the ring full
    if (threadIdx.x == T::CONSUMERS) {
      mbar_expect_tx(q_full, T::Q);
#pragma unroll
      for (int a = 0; a < T::BOXES; ++a)
        tma_load(q_s + a * BM * 128, &qmap, q_full, a * ATOM, q0, bh);
      for (int kb = kb0; kb < kb1; ++kb) {
        const int n = kb - kb0;
        const int st = n % STAGES;
        // the slot's previous block must have been consumed
        if (n >= STAGES) mbar_wait(empty + 8 * st, (n / STAGES - 1) & 1);
        mbar_expect_tx(full + 8 * st, 2 * T::KV);
#pragma unroll
        for (int a = 0; a < T::BOXES; ++a) {
          tma_load(k_s + st * T::KV + a * BN * 128, &kmap,
                   full + 8 * st, a * ATOM, kb * BN, kvh);
          tma_load(v_s + st * T::KV + a * BN * 128, &vmap,
                   full + 8 * st, a * ATOM, kb * BN, kvh);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: 64 query rows; this thread holds rows `row` and
  // row + 8, and in each 8-column group the columns colq and colq + 1
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int row = q0 + wg * 64 + (t / 32) * 16 + (t % 32) / 4;
  const int colq = 2 * (t % 4);

  // output columns [sp * PV_N, (sp + 1) * PV_N) in acc[sp], as the PV's
  // accumulator fragment lies
  constexpr int R = T::PV_N / 2;
  float acc[T::SPLITS][R];
#pragma unroll
  for (int sp = 0; sp < T::SPLITS; ++sp)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[sp][j] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.0f, 0.0f};
  const uint32_t q_wg = q_s + wg * 64 * 128;

  // S = Q K^T of the block in slot st over hd in steps of 16: within a
  // 64-column box the step moves the descriptors' start by 32 bytes, the
  // swizzle follows the address bits.  The first step overwrites S (scale_d
  // 0), so that no other instruction defines S's registers.  Issued, not
  // waited for.
  float s[BN / 2];
  auto issue_qk = [&](int st) {
    const uint32_t k_st = k_s + st * T::KV;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss_n64(s,
                   smem_desc(q_wg + (kk / 4) * BM * 128 + off, 16, 1024),
                   smem_desc(k_st + (kk / 4) * BN * 128 + off, 16, 1024),
                   kk > 0);
    }
    wgmma_commit();
  };
  // The softmax of block kb on the fragment s, in place: element j is row
  // row + 8 ((j >> 1) & 1), column k0 + 8 (j >> 2) + colq + (j & 1).
  // Updates m and l, leaves p in s and the rescale of O in corr.
  auto softmax = [&](int kb, float (&corr)[2]) {
    const int k0 = kb * BN;
    const bool edge = straddles<BM>(q0, k0, Sk, causal, window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) {
      const int r = (j >> 1) & 1;
      float x = s[j] * scale;
      if (softcap > 0.0f) x = tanhf(x / softcap) * softcap;
      if (edge) {
        const int kpos = k0 + 8 * (j >> 2) + colq + (j & 1);
        const int qpos = row + 8 * r;
        bool ok = kpos < Sk;
        if (causal) ok = ok && qpos >= kpos;
        if (window > 0) ok = ok && (qpos - kpos) < window;
        x = ok ? x : NEG_INF;
      }
      s[j] = x;
      mx[r] = fmaxf(mx[r], x);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) {
      const int r = (j >> 1) & 1;
      s[j] = expf(s[j] - m[r]);
      sum[r] += s[j];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
    }
  };

  // P from s as the A fragments of the PV, hi and lo halves: S's
  // accumulator layout is the A fragment's, registers 8 kk + 2 i, + 1
  // being A register i of the k16 step kk.
  uint32_t p_hi[BN / 16][4], p_lo[BN / 16][4];
  auto split_p = [&]() {
#pragma unroll
    for (int j = 0; j < BN / 2; j += 2)
      split_pair(s[j], s[j + 1], p_hi[j / 8][(j % 8) / 2],
                 p_lo[j / 8][(j % 8) / 2]);
  };

  // The loop keeps one block's PV in flight: block n issues its QK^T and
  // block n - 1's PV, waits for the QK^T alone and runs its softmax on the
  // ALUs while the PV runs on the tensor cores; P's A fragments are
  // written only once that PV is done.  No branch encloses a wgmma in
  // flight and no other instruction writes its registers, so that the
  // compiler need not serialize the wgmmas.
  float corr[2];
  mbar_wait(q_full, 0);
  if (kb0 < kb1) {
    mbar_wait(full, 0);
    issue_qk(0);
    wgmma_wait<0>();
    fence_regs(s);
    softmax(kb0, corr);
    split_p();
    for (int kb = kb0 + 1; kb < kb1; ++kb) {
      const int n = kb - kb0;
      const int st = n % STAGES;
      const uint32_t v_prev = v_s + ((n - 1) % STAGES) * T::KV;
      mbar_wait(full + 8 * st, (n / STAGES) & 1);
      fence_regs(acc);
      fence_regs(p_hi);
      fence_regs(p_lo);
      issue_qk(st);
      issue_pv(acc, p_hi, p_lo, v_prev);
      wgmma_commit();
      wgmma_wait<1>();     // S is done, the PV runs on
      fence_regs(s);
      softmax(kb, corr);
      wgmma_wait<0>();     // the PV is done: free its slot, rescale O
      fence_regs(acc);
      fence_regs(p_hi);
      fence_regs(p_lo);
      if (t == 0) mbar_arrive(empty + 8 * ((n - 1) % STAGES));
      split_p();
#pragma unroll
      for (int sp = 0; sp < T::SPLITS; ++sp)
#pragma unroll
        for (int j = 0; j < R; ++j) acc[sp][j] *= corr[(j >> 1) & 1];
    }
    // the last block's PV
    fence_regs(acc);
    fence_regs(p_hi);
    fence_regs(p_lo);
    wgmma_fence();
    issue_pv(acc, p_hi, p_lo,
             v_s + ((kb1 - kb0 - 1) % STAGES) * T::KV);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  __nv_bfloat16* out = o + (size_t)bh * Sq * HD;
  const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int sp = 0; sp < T::SPLITS; ++sp)
#pragma unroll
    for (int j = 0; j < R; j += 2) {
      const int r = (j >> 1) & 1;
      const int qpos = row + 8 * r;
      if (qpos < Sq) {
        const int col = sp * T::PV_N + 8 * (j >> 2) + colq;
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)qpos * HD + col) =
            __floats2bfloat162_rn(acc[sp][j] / den[r],
                                  acc[sp][j + 1] / den[r]);
      }
    }
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime so
// that the library links against cudart alone.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess
        && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a (heads, rows, hd) bf16 tensor as hd x rows x heads, boxes of
// 64 columns x box_rows rows, 128-byte swizzle, out-of-range rows and
// columns (past hd 80 in the second box) read as zeros.  The row stride,
// hd * 2 bytes, is a multiple of 16 at every hd the kernel takes.
int tensor_map(CUtensorMap* map, const void* ptr, int heads, int rows,
               int hd, int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)rows * hd * 2};
  const cuuint32_t box[3] = {ATOM, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int BKV, int Sq, int Sk, int causal, int window, float softcap,
           float scale, cudaStream_t stream) {
  using T = Tiles<HD>;
  auto kernel = flash_attention_kernel_sm90<HD>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  CUtensorMap qmap, kmap, vmap;
  int err = tensor_map(&qmap, q, BH, Sq, HD, T::BM);
  if (err == 0) err = tensor_map(&kmap, k, BKV, Sk, HD, BN);
  if (err == 0) err = tensor_map(&vmap, v, BKV, Sk, HD, BN);
  if (err != 0) return err;
  const dim3 grid(BH, (Sq + T::BM - 1) / T::BM);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), Sq, Sk, BH / BKV,
      causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q, k, v with hd 64, 80, 128 or 256, checked by
// flash_attention_launch (and the wrapper before it: contiguous, 16-byte
// aligned, BH % BKV == 0).  Returns the CUDA error of the launch.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* o, int BH,
                                           int BKV, int Sq, int Sk, int hd,
                                           int causal, int window,
                                           float softcap, float scale,
                                           cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<64>(q, k, v, o, BH, BKV, Sq, Sk, causal, window, softcap,
                        scale, stream);
    case 80:
      return launch<80>(q, k, v, o, BH, BKV, Sq, Sk, causal, window, softcap,
                        scale, stream);
    case 128:
      return launch<128>(q, k, v, o, BH, BKV, Sq, Sk, causal, window,
                         softcap, scale, stream);
    case 256:
      return launch<256>(q, k, v, o, BH, BKV, Sq, Sk, causal, window,
                         softcap, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}
