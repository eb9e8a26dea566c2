// Hopper (sm_90a) building blocks shared by the tensor-core and bulk-copy
// kernels (attention_sm90.cu, artv_decode_sm90.cu, sample_head_sm90.cu):
// mbarriers, cp.async and 1-D bulk copies into shared memory, wgmma's
// fences and its shared-memory descriptors.
#pragma once

#include "common.cuh"

namespace mmvid {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// makes the barriers' initialisation visible to the async proxy (the
// bulk copies' completions); once, after the inits, before a sync
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Wait for the phase of `bar` with this parity to complete.  A wait that
// lasts about 2^28 polls (seconds; a tile takes microseconds) traps: a
// pipeline fault ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (polls == (1u << 28)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

// one arrival that also expects `bytes` more of bulk-copy completions
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::"r"(
          bar),
      "r"(bytes)
      : "memory");
}

// expect `bytes` more of bulk-copy completions, without an arrival
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// 1-D bulk copy global -> shared of `bytes` (a multiple of 16; both
// addresses 16-byte aligned), counted on `bar`'s transaction bytes
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 16 bytes global -> shared, of which the first src_bytes (0 .. 16) are
// read and the rest zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// arrive on `bar` once this thread's cp.asyncs so far have landed (one of
// the barrier's expected arrivals)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(bar)
               : "memory");
}

// shared memory written through the generic proxy (st.shared, cp.async),
// next read through the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier of the `count` threads (a multiple of 32) that use this id;
// id 0 is __syncthreads'
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of products are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving uses of an accumulator across the
// asynchronous product's wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory descriptor with the 128-byte swizzle (tile
// 1024-byte aligned): `lbo` and `sbo` in bytes.  sbo is the distance of
// 8-row groups; lbo is unused where the operand's contiguous extent (K for
// a K-major operand, N for an MN-major one read through the transpose
// bit) lies inside one 128-byte row, as in every use here.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Byte offset of 16-byte chunk c (0 .. 7) of row r in a tile of 128-byte
// rows with the 128-byte swizzle, as the hardware reads it
__device__ __forceinline__ uint32_t swizzle128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// 32-bit flag in device memory: a release store at gpu scope
__device__ __forceinline__ void flag_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

}  // namespace sm90
}  // namespace mmvid
