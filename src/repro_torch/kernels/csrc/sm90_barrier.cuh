// sm90_barrier.cuh — the shared-memory barriers and copies that the LM
// kernels' staging rings are built from on Hopper (sm_90a):
// flash_attention_sm90.cu (K5, tensor-map loads of K / V tiles) and
// rwkv6_scan.cu (K6, 1-d bulk copies of a chunk's r, k, w, 16-byte
// asynchronous copies of the CTA's columns of v) and mamba_scan.cu (K7,
// 16- or 4-byte asynchronous copies of a chunk's dt, x, B and C, waited
// for by commit groups).
//
// A ring slot has a "full" barrier that completes when the bytes the
// producer announced (mbar_expect_tx) have landed, and an "empty" barrier
// on which the consumers arrive when they are done with the slot.  A
// phase's parity flips each time the barrier completes: the n-th use of a
// slot waits on parity n & 1.
//
// A barrier wait that does not complete within about 2^32 cycles traps:
// that is a fault of the kernel, and a trap reports it where a spin would
// hang the card.

#pragma once

#include <stdint.h>

namespace {

constexpr long long WAIT_LIMIT = 1ll << 32;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

// Make the initialised barriers visible to the block (and to the copy
// engine) before the __syncthreads that follows.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > WAIT_LIMIT) __trap();
  }
}

// One contiguous 1-d bulk copy (TMA) of `bytes` from device memory into
// shared memory; both addresses 16-byte aligned, `bytes` a multiple of 16.
// Its bytes count against the barrier's expected transactions.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(bar)
      : "memory");
}

// One 16-byte asynchronous copy from device memory into shared memory
// (cp.async, cached in L2 only); both addresses 16-byte aligned.
__device__ __forceinline__ void copy16_async(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src))
               : "memory");
}

// One 4-byte asynchronous copy (cp.async, cached in L1 and L2); both
// addresses 4-byte aligned.
__device__ __forceinline__ void copy4_async(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src))
               : "memory");
}

// Close this thread's group of cp.async copies issued so far.
__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until every committed group of this thread's cp.async copies has
// landed in shared memory (other threads' copies need a barrier after).
__device__ __forceinline__ void copies_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Arrive on the barrier once this thread's earlier cp.async copies have
// landed; the arrival is one of the barrier's expected count (noinc).
__device__ __forceinline__ void copies_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
               :: "r"(bar) : "memory");
}

}  // namespace
