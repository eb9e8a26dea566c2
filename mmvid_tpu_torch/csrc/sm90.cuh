// Hopper (sm_90a) building blocks shared by the tensor-core and bulk-copy
// kernels (attention_sm90.cu, attention_int8_sm90.cu, artv_decode_sm90.cu,
// fused_ln_qkv_sm90.cu, sample_head_sm90.cu): mbarriers, cp.async, 1-D
// bulk copies and 2-D tensor copies (TMA) into shared memory, wgmma's
// fences, its swizzled tile layouts and their shared-memory descriptors.
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

// close this thread's group of cp.asyncs so far; wait until at most N of
// its groups are still in flight
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// Byte offset of 16-byte chunk c of row r in a tile of rb-byte rows (rb
// 32, 64 or 128) stored with the rb-byte swizzle, as the hardware reads it:
// the chunk index XORed with address bits 7 .. 6 + log2(rb / 16) (for 128-
// byte rows r % 8, for 64-byte rows (r / 2) % 4, for 32-byte rows (r / 4)
// % 2).  Tiles start at a multiple of 1024 bytes.
__host__ __device__ __forceinline__ uint32_t swizzle_offset(int r, int c,
                                                            int rb) {
  return r * rb + ((c ^ ((r * rb >> 7) & (rb / 16 - 1))) << 4);
}

__device__ __forceinline__ uint32_t swizzle128(int r, int c) {
  return swizzle_offset(r, c, 128);
}

// wgmma shared-memory descriptor of a tile of rb-byte rows with the
// rb-byte swizzle (swizzle_offset's layout): 8-row groups 8 * rb bytes
// apart (the stride byte offset), the leading byte offset unused (16): the
// extent of one wgmma along the row (32 bytes of K for a K-major operand;
// N for an MN-major one read through the transpose bit) lies inside one
// row in every use here.  Base offset 0; a step along the row advances
// the start address by its bytes.
__device__ __forceinline__ uint64_t desc_swizzled(uint32_t addr, int rb) {
  const uint64_t mode = rb == 128 ? 1 : rb == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>((8 * rb) >> 4) << 32) | (mode << 62);
}

// 2-D tensor copy (TMA) global -> shared of the box at (c0 inner, c1
// outer) of the tensor map at `tmap` (a __grid_constant__ parameter's
// address), counted on `bar`'s transaction bytes; out-of-bounds elements
// are zero-filled
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* tmap,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(tmap), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// 2-D tensor copy (TMA) shared -> global of the box at (c0 inner, c1
// outer), elements outside the tensor not written; committed with
// bulk_commit, waited for with bulk_wait_read
__device__ __forceinline__ void tma_store_2d(const void* tmap, int c0, int c1,
                                             uint32_t src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], "
      "[%3];\n" ::"l"(tmap),
      "r"(c0), "r"(c1), "r"(src)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until this thread's committed bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// until they are done
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// 32-bit flag in device memory: a release store at gpu scope
__device__ __forceinline__ void flag_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

}  // namespace sm90
}  // namespace mmvid
