// int8 self-attention for the MMVID backbone (MMVID_ATTN_INT8=1, serving
// only), on Hopper's s8 tensor cores (wgmma, s32 sums), sm_90a.
//
// Replaces the TPU kernel mmvid_tpu/ops/attention.py::_make_packed_kernel
// with int8_qk=True (driven by fused_attention_blhd / _pallas_attention)
// and computes the function of
// mmvid_tpu_torch/ops/attention_int8.py::attention_int8_reference, per
// (batch, head) over all L rows:
//
//     q    = T(q * scale)                       (q's dtype T, as JAX)
//     qs   = max(max|q|, 1e-8) / 127            ks, vs likewise
//     q8   = rint(q / qs)                       k8, v8 likewise
//     S    = int32(q8 . k8^T)
//     logit = float(S) * (qs * ks) + mask       (no FMA contraction)
//     p    = exp(logit - rowmax),  denom = sum(p)
//     p8   = rint(p * 127)
//     out  = T(float(int32(p8 . v8)) * (vs / 127) / denom)
//
// Rounding is half to even, q / qs a true division (the build has no
// fast-math), and every product and sum that JAX writes as one op is one
// correctly rounded op here (__fmul_rn, __fadd_rn), so the integers match
// the plain version's and the outputs differ only where expf's last bit
// moves p * 127 across a tie or the row sum by an ulp.  Two conversions
// use the 1.5 * 2^23 trick, exact in their ranges: float(S) as
// int_as_float(S + 0x4B400000) - 1.5 * 2^23 (|S| <= 64 * 127^2 < 2^22),
// and rint(p * 127) as the low byte of float_as_int(p * 127 + 1.5 * 2^23)
// (the add rounds half to even at integers; p * 127 in [0, 127]).  The
// ragged L edge is masked, not padded: JAX's zero-padded rows do not move
// its abs-max scales, and keys >= L give p8 = 0 here as the -1e9 padding
// keys give p8 = 0 there.
//
// The mask: every mask a model builds has two values (0 and NEG_INF), and
// comes with its compact form, one bit a key (ops/attention_int8.py
// CompactMask): logit + (bit ? c1 : c0) is the same fp32 add as logit +
// mask.  kCompact stages the block's rows of bits once into shared memory
// (128 x 640 bits at L 629, 10 KB), read by both S passes; a call without
// a compact form reads the fp32 mask from device memory instead, in the
// same kernel.
//
// What bounds it on the H100: 3 * B*L*H*D input elements read and B*L*H*D
// written, the mask once; 4*B*H*L*L*D s8 operations.  At B16 H12 L629 D64:
// 63 MB against 19 G operations, so bytes (0.019 ms at 3.35 TB/s).
//
// What set the pace of the first kernel (PERF.md, the attribution run of
// mmvid_tpu_torch/attribution.py): every block of a head scanned and
// quantized the head's q, k, v again, and read its fp32 mask rows in both
// S passes, 8 bytes at a time; its s8 products ran on mma.sync.  Design:
// - two launches.  The operand pass, one block per (q|k|v, head, batch),
//   takes the abs-max of its tensor, writes the scale, and writes the
//   int8 operands once in the layout that shared memory takes them in:
//   Q and K as 64-byte rows (D 64; D 32 zero-padded to 64) with the
//   64-byte swizzle, V transposed (through shared memory) as 64-key tiles
//   of 64 d-rows of 64 bytes, swizzled alike (8-bit wgmma reads both
//   operands K-major only).  x / s without a division: Markstein's
//   correction of x * RN(1 / s) is RN(x / s).
// - the attention: one block per (128-query tile, head, batch), two
//   consumer warpgroups of 64 query rows and one producer warp, which
//   issues bulk copies of the block's Q8 tile, its mask bits, the head's
//   K8 tiles (one mbarrier each, so pass 1 starts on the first) and V8^T,
//   all resident (L <= 1024).  99 KB of shared memory at L 629, so two
//   blocks share an SM.
// - S = Q8 . K8^T by wgmma m64n64k32 (two k-steps), twice: pass 1 takes
//   the exact row max (no online softmax: p8 = rint(p * 127) needs the
//   whole row's max; S is an integer, so both passes give the same
//   logits), pass 2 p, the row sums and p8.  Pass 1 keeps two S tiles in
//   flight and, with the compact mask, takes the integer max of S over
//   the row's c0 keys and over its c1 keys (logit is monotone in S), a
//   plain max where a thread's keys of the tile are all one class (and in
//   pass 2 no mask add where they are all c0 = 0).
// - O += P8 . V8^T by wgmma m64n64k32 with A from registers: the s32
//   accumulator's layout is not the s8 A fragment's, so each quad of
//   lanes trades its packed p8 pairs by shuffles (FlashAttention-3's fp8
//   permutation); V8^T is the K-major B operand.
// What sets its pace (PERF.md, the attribution run): pass 2's ALU work,
// about twenty instructions a logit (one expf each), then the operand
// pass's strided reads of q, k and v (128-byte row pieces).
// The s32 sums stay far inside their range (D * 127^2, L * 127^2).

#include <climits>

#include <atomic>
#include <type_traits>

#include "sm90.cuh"

namespace mmvid {
namespace {

using namespace sm90;

constexpr int kRows = 128;                      // query rows per block
constexpr int kKeys = 64;                       // keys per tile
constexpr int kRowBytes = 64;                   // an int8 operand row
constexpr int kTileBytes = kKeys * kRowBytes;   // 4 KB
constexpr int kMaxL = 1024;                     // K8 and V8^T resident
constexpr int kMaxTiles = kMaxL / kKeys;
constexpr int kConsumers = 256;                 // two warpgroups
constexpr int kThreads = kConsumers + 32;       // and one producer warp
constexpr int kPrepThreads = 256;
constexpr int kMaxDevices = 64;
constexpr float kMagic = 12582912.f;            // 1.5 * 2^23
constexpr int kMagicBits = 0x4B400000;
// barriers: Q, V, mask bits, then one a K tile
constexpr int kBars = 3 + kMaxTiles;

// 8 consecutive elements (16-byte aligned) as floats
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) f[j] = __bfloat162float(h[j]);
}
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// x rounded to T (q * scale is computed in q's dtype)
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// rint(x / s) as a byte, for |x / s| <= 127: x / s correctly rounded
// without a division (Markstein: with y = RN(1 / s) and the faithful q =
// RN(x * y), the remainder x - q * s is exact in one fma and RN(q + r * y)
// is RN(x / s)), then rounded half to even by the 1.5 * 2^23 add
__device__ __forceinline__ uint32_t quant_byte(float x, float s, float y) {
  const float q = __fmul_rn(x, y);
  const float r = __fmaf_rn(-q, s, x);
  return __float_as_uint(__fadd_rn(__fmaf_rn(r, y, q), kMagic)) & 0xFFu;
}

// float(S), exact for |S| < 2^22
__device__ __forceinline__ float s_to_float(int s) {
  return __fsub_rn(__int_as_float(s + kMagicBits), kMagic);
}

// The operand pass: block (which, h, b) takes tensor `which` (0 q, 1 k,
// 2 v) of head h, batch b.  work holds, per head bh = b * H + h, the
// images Q8 [Lp][64], K8 [Lp][64] and V8^T [Lp / 64][64][64] (Lp: L
// rounded up to 64; Q8 at work + bh * Lp * 64, K8 and V8^T BH * Lp * 64
// and 2 * BH * Lp * 64 further), then the scales, float4 (qs, ks, vs, 0)
// per head.
template <typename T, int D>
__global__ void __launch_bounds__(kPrepThreads)
int8_operands_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, int L, int H, long long sqb,
                     long long sql, long long sqh, long long skb,
                     long long skl, long long skh, long long svb,
                     long long svl, long long svh, float scale,
                     uint8_t* __restrict__ work) {
  static_assert(D == 32 || D == 64, "head dim 32 or 64");
  constexpr int kChunks = D / 8;  // 8-element chunks of a row
  constexpr int kVtStride = kKeys + 8;
  __shared__ float red[kPrepThreads / 32];
  __shared__ __align__(16) uint8_t vt[kKeys * kVtStride];
  const int which = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int BH = gridDim.y * gridDim.z, bh = b * H + h;
  const int Lp = (L + kKeys - 1) / kKeys * kKeys;
  const T* src = which == 0   ? q + b * sqb + h * sqh
                 : which == 1 ? k + b * skb + h * skh
                              : v + b * svb + h * svh;
  const long long sl = which == 0 ? sql : which == 1 ? skl : svl;
  auto value = [&](float x) {
    return which == 0 ? round_to(__fmul_rn(x, scale), src) : x;
  };

  // 1. the abs-max and the scale
  float m = 0.f;
#pragma unroll 4
  for (int i = tid; i < L * kChunks; i += kPrepThreads) {
    float f[8];
    load8(src + (i / kChunks) * sl + (i % kChunks) * 8, f);
#pragma unroll
    for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(value(f[j])));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (tid % 32 == 0) red[tid / 32] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int w = 1; w < kPrepThreads / 32; ++w) m = fmaxf(m, red[w]);
  const float s = __fdiv_rn(fmaxf(m, 1e-8f), 127.f);
  const float y = __frcp_rn(s);
  if (tid == 0)
    reinterpret_cast<float*>(work + 3ll * BH * Lp * kRowBytes)[4 * bh +
                                                                which] = s;
  uint8_t* img = work + (static_cast<long long>(which) * BH + bh) * Lp *
                            kRowBytes;

  // 2. the int8 image, 16 bytes a thread at a time: rows >= L and bytes
  // >= D zero
  if (which < 2) {
    // row r, chunk c: values 16c .. 16c + 15 of the row
#pragma unroll 2
    for (int i = tid; i < Lp * 4; i += kPrepThreads) {
      const int r = i / 4, c = i % 4;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (r < L && 16 * c < D) {
        float f[16];
        load8(src + r * sl + 16 * c, f);
        load8(src + r * sl + 16 * c + 8, f + 8);
#pragma unroll
        for (int j = 0; j < 16; ++j)
          w[j / 4] |= quant_byte(value(f[j]), s, y) << (8 * (j % 4));
      }
      *reinterpret_cast<uint4*>(img + swizzle_offset(r, c, kRowBytes)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    return;
  }
  // V^T, a 64-key tile at a time: the tile's rows quantized into shared
  // memory as they lie (16-byte loads, [key][d]), then each 16-byte chunk
  // of the image (d-row r, keys 16c .. 16c + 15) gathered down 16 of them
  // (the 72-byte row stride puts the 16 bytes in 16 banks)
  for (int t0 = 0; t0 < Lp; t0 += kKeys) {
    for (int i = tid; i < kKeys * kChunks; i += kPrepThreads) {
      const int key = i / kChunks, c8 = (i % kChunks) * 8;
      uint32_t w[2] = {0u, 0u};
      if (t0 + key < L) {
        float f[8];
        load8(src + (t0 + key) * sl + c8, f);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          w[j / 4] |= quant_byte(f[j], s, y) << (8 * (j % 4));
      }
      *reinterpret_cast<uint2*>(vt + key * kVtStride + c8) =
          make_uint2(w[0], w[1]);
    }
    __syncthreads();
    for (int i = tid; i < kKeys * 4; i += kPrepThreads) {
      const int r = i % kKeys, c = i / kKeys;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (r < D) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          w[j / 4] |= static_cast<uint32_t>(vt[(16 * c + j) * kVtStride + r])
                      << (8 * (j % 4));
      }
      *reinterpret_cast<uint4*>(img + t0 * kRowBytes +
                                swizzle_offset(r, c, kRowBytes)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    __syncthreads();
  }
}

// d[64 x 64] (+)= A[64 x 32] . B[32 x 64], s8 with s32 sums, A and B
// K-major in shared memory; `accumulate` 0 overwrites d
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 32] . B[32 x 64], s8 with s32 sums, A in registers
// (a0: row g, k 4t .. 4t + 3; a1: row g + 8, the same k; a2, a3: k + 16),
// B K-major in shared memory; `accumulate` 0 overwrites d
__device__ __forceinline__ void wgmma_s8_n64_rs(int (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void fence_iregs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__host__ __device__ constexpr int smem_bytes(int n_tiles, int words) {
  // alignment slack, K8 and V8^T, Q8, bits, bars
  return 1024 + 2 * n_tiles * kTileBytes + kRows * kRowBytes +
         kRows * words * 4 + 8 * kBars;
}

template <typename T, bool kCompact>
__global__ void __launch_bounds__(kThreads, 2)
attention_int8_wgmma(const uint8_t* __restrict__ work,
                     const float* __restrict__ mask,
                     const uint32_t* __restrict__ bits, int words, float c0,
                     float c1, T* __restrict__ out, int L, int H, int D,
                     long long sob, long long sol, long long soh) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const int Lp = (L + kKeys - 1) / kKeys * kKeys, n_tiles = Lp / kKeys;
  const uint32_t k_s = base;
  const uint32_t v_s = k_s + n_tiles * kTileBytes;
  const uint32_t q_s = v_s + n_tiles * kTileBytes;
  const uint32_t m_s = q_s + kRows * kRowBytes;
  const uint32_t bars = m_s + (kCompact ? kRows * words * 4 : 0);
  const uint32_t q_full = bars, v_full = bars + 8, m_full = bars + 16;
  auto k_full = [&](int j) { return bars + 8 * (3 + j); };

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int BH = gridDim.y * gridDim.z, bh = b * H + h;
  // consumer warpgroups with query rows < L: the last tile may have one
  const int groups = L - q0 > 64 ? 2 : 1;
  const long long img = static_cast<long long>(Lp) * kRowBytes;
  const uint8_t* q8 = work + bh * img;
  const uint8_t* k8 = work + (BH + bh) * img;
  const uint8_t* v8 = work + (2ll * BH + bh) * img;
  if (tid == 0) {
    for (int i = 0; i < 3 + n_tiles; ++i) mbar_init(bars + 8 * i, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp: one thread copies
    if (tid == kConsumers) {
      const uint32_t qb = groups * 64 * kRowBytes;
      mbar_arrive_expect_tx(q_full, qb);
      bulk_copy(q_s, q8 + q0 * kRowBytes, qb, q_full);
      if (kCompact) {
        const uint32_t mb = min(kRows, L - q0) * words * 4;
        mbar_arrive_expect_tx(m_full, mb);
        bulk_copy(m_s, bits + static_cast<long long>(q0) * words, mb,
                  m_full);
      }
      for (int j = 0; j < n_tiles; ++j) {
        mbar_arrive_expect_tx(k_full(j), kTileBytes);
        bulk_copy(k_s + j * kTileBytes, k8 + j * kTileBytes, kTileBytes,
                  k_full(j));
      }
      mbar_arrive_expect_tx(v_full, n_tiles * kTileBytes);
      bulk_copy(v_s, v8, n_tiles * kTileBytes, v_full);
    }
    return;
  }

  const int wg = tid / 128;
  if (wg >= groups) return;  // all its rows are >= L
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  // this thread's rows of S and O: block rows rr and rr + 8
  const int rr = wg * 64 + warp * 16 + g;
  const int rowA = q0 + rr, rowB = rowA + 8;
  const float4 sc4 = reinterpret_cast<const float4*>(
      work + 3ll * BH * img)[bh];
  const float qsks = __fmul_rn(sc4.x, sc4.y);
  const float vs127 = __fdiv_rn(sc4.z, 127.f);
  const uint32_t qa = q_s + wg * 64 * kRowBytes;
  // the mask rows: words of the staged bits, or fp32 rows in device
  // memory (a row >= L reads row L - 1; it is never stored)
  const uint32_t* mwA =
      reinterpret_cast<const uint32_t*>(gbase + (m_s - base)) + rr * words;
  const uint32_t* mwB = mwA + 8 * words;
  const float* mA = mask + static_cast<long long>(min(rowA, L - 1)) * L;
  const float* mB = mask + static_cast<long long>(min(rowB, L - 1)) * L;
  mbar_wait(q_full, 0);
  if (kCompact) mbar_wait(m_full, 0);

  // mask bit or value of the S fragment entry (i, e) of row A (half 0)
  // or B (half 1) in the tile at key k0: key k0 + 8i + 2t + e.  wA, wB:
  // the rows' two words of the tile, shifted right by 2t.
  uint32_t wA[2] = {0u, 0u}, wB[2] = {0u, 0u};
  auto mask_words = [&](int j) {
    if constexpr (kCompact) {
      wA[0] = mwA[2 * j] >> (2 * t);
      wA[1] = mwA[2 * j + 1] >> (2 * t);
      wB[0] = mwB[2 * j] >> (2 * t);
      wB[1] = mwB[2 * j + 1] >> (2 * t);
    }
  };
  auto bit_at = [&](int half, int i, int e) {
    return ((half ? wB : wA)[i >> 2] >> (8 * (i & 3) + e)) & 1u;
  };
  auto mask_at = [&](int half, int k0, int i, int e) {
    if constexpr (kCompact) return bit_at(half, i, e) ? c1 : c0;
    return (half ? mB : mA)[k0 + 8 * i + 2 * t + e];
  };
  // this thread's 16 entries of a row in the tile: 0 none masked (all
  // c0), 1 all masked (all c1), 2 mixed (always 2 for the fp32 mask)
  auto row_kind = [&](int half) {
    if constexpr (!kCompact) return 2;
    const uint32_t* w = half ? wB : wA;
    const uint32_t mine = 0x03030303u;  // bits 8(i % 4) + e
    return ((w[0] | w[1]) & mine) == 0        ? 0
           : ((w[0] & w[1] & mine) == mine) ? 1
                                            : 2;
  };
  // sc[4i + e]: row A, key k0 + 8i + 2t + e; sc[4i + 2 + e]: row B
  auto logit = [&](int s, float m) {
    return __fadd_rn(__fmul_rn(s_to_float(s), qsks), m);
  };
  int sc[32], sb[32];
  // S of K tile j into acc: issued and committed, not waited for
  auto s_into = [&](int j, int (&acc)[32]) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma_s8_n64(acc, desc_swizzled(qa + 32 * kk, kRowBytes),
                   desc_swizzled(k_s + j * kTileBytes + 32 * kk, kRowBytes),
                   kk);
    wgmma_commit();
  };

  // pass 1: the exact row max of the logits.  With the compact mask, the
  // largest S among the row's c0 keys and among its c1 keys: S -> float(S)
  // * qsks + c is monotone (each op correctly rounded, qsks > 0), so the
  // row max is the larger of the two logits; keys >= L take no part.
  float mx[2] = {-INFINITY, -INFINITY};
  int top[2][2] = {{INT_MIN, INT_MIN}, {INT_MIN, INT_MIN}};  // [half][bit]
  auto fold = [&](int half, int k0, int i, int e, int sv) {
    if constexpr (kCompact) {
      const uint32_t on = bit_at(half, i, e);
      top[half][0] = on ? top[half][0] : max(top[half][0], sv);
      top[half][1] = on ? max(top[half][1], sv) : top[half][1];
    } else {
      mx[half] = fmaxf(mx[half], logit(sv, mask_at(half, k0, i, e)));
    }
  };
  auto fold_tile = [&](int j, int (&acc)[32]) {
    const int k0 = j * kKeys;
    mask_words(j);
    if (k0 + kKeys <= L) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int kind = row_kind(half);
        if (kind == 0) {  // one class: a plain integer max
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              top[half][0] = max(top[half][0], acc[4 * i + 2 * half + e]);
        } else if (kind == 1) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              top[half][1] = max(top[half][1], acc[4 * i + 2 * half + e]);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              fold(half, k0, i, e, acc[4 * i + 2 * half + e]);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if (k0 + 8 * i + 2 * t + (x & 1) < L)
            fold(x >> 1, k0, i, x & 1, acc[4 * i + x]);
    }
  };
  // two tiles in flight: S(j + 1) is on the tensor cores while S(j) is
  // folded.  The tile indices are clamped rather than the products made
  // conditional (a wgmma under a condition is serialised); folding the
  // last tile again leaves the maxima as they are.
  mbar_wait(k_full(0), 0);
  s_into(0, sc);
  for (int j = 0; j < n_tiles; j += 2) {
    const int j1 = min(j + 1, n_tiles - 1), j2 = min(j + 2, n_tiles - 1);
    mbar_wait(k_full(j1), 0);
    s_into(j1, sb);
    wgmma_wait<1>();
    fence_iregs(sc);
    fold_tile(j, sc);
    mbar_wait(k_full(j2), 0);
    s_into(j2, sc);
    wgmma_wait<1>();
    fence_iregs(sb);
    fold_tile(j1, sb);
  }
  wgmma_wait<0>();
  fence_iregs(sc);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if constexpr (kCompact) {
      if (top[r][0] != INT_MIN) mx[r] = logit(top[r][0], c0);
      if (top[r][1] != INT_MIN) mx[r] = fmaxf(mx[r], logit(top[r][1], c1));
    }
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }

  // pass 2: p, the row sums, p8 into shared memory, O += P8 . V8
  mbar_wait(v_full, 0);
  float den[2] = {0.f, 0.f};
  int o[32];
  // p of entry (i, e) of row `half` with mask value m: added to the row's
  // sum; returns p * 127 + 1.5 * 2^23, whose low byte is p8
  auto prob = [&](int half, int i, int e, float m, bool add_mask = true) {
    const int sv = sc[4 * i + 2 * half + e];
    const float p = expf(__fsub_rn(
        add_mask ? logit(sv, m) : __fmul_rn(s_to_float(sv), qsks), mx[half]));
    den[half] += p;
    return __float_as_uint(__fadd_rn(__fmul_rn(p, 127.f), kMagic));
  };
  // P8 as the A fragments of P8 . V8, one per 32-key step kk (a0, a2 of
  // row A, a1, a3 of row B): this thread holds keys 8i + 2t, + 1 of each
  // row (pair[i]); lane t of a quad needs keys 4t .. 4t + 3 and 16 + 4t ..
  // 16 + 4t + 3 of the step, held in pairs by lanes 2 (t % 2) and 2 (t %
  // 2) + 1, as the low (t < 2) or high halves of their packed words
  uint32_t afr[2][4];
  const int src0 = (lane & ~3) | (2 * (t & 1));
  const uint32_t pick = t < 2 ? 0x5410u : 0x7632u;
  auto fragments = [&](int half, const uint32_t (&pair)[8]) {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint32_t w0 = __byte_perm(pair[4 * kk], pair[4 * kk + 1], 0x5410);
      const uint32_t w1 =
          __byte_perm(pair[4 * kk + 2], pair[4 * kk + 3], 0x5410);
      const uint32_t x0 = __shfl_sync(0xffffffffu, w0, src0);
      const uint32_t y0 = __shfl_sync(0xffffffffu, w0, src0 + 1);
      const uint32_t x1 = __shfl_sync(0xffffffffu, w1, src0);
      const uint32_t y1 = __shfl_sync(0xffffffffu, w1, src0 + 1);
      afr[kk][half] = __byte_perm(x0, y0, pick);
      afr[kk][2 + half] = __byte_perm(x1, y1, pick);
    }
  };
  // a whole tile's row `half`; kind as row_kind (a constant here), 3 for
  // kind 0 with c0 == 0, where logit + 0 is the logit itself
  auto probs_row = [&](int half, int k0, auto kind, uint32_t (&pair)[8]) {
    constexpr int kKind = decltype(kind)::value;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint32_t b[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        b[e] = prob(half, i, e,
                    kKind == 0   ? c0
                    : kKind == 1 ? c1
                    : kKind == 2 ? mask_at(half, k0, i, e)
                                 : 0.f,
                    kKind != 3);
      pair[i] = __byte_perm(b[0], b[1], 0x0040);
    }
  };
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kKeys;
    s_into(j, sc);
    mask_words(j);
    // S(j), and P8(j - 1) . V8(j - 1): its A fragments are free
    wgmma_wait<0>();
    fence_iregs(sc);
    fence_iregs(o);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t pair[8];
      if (k0 + kKeys <= L) {
        const int kind = row_kind(half);
        if (kind == 0 && c0 == 0.f)
          probs_row(half, k0, std::integral_constant<int, 3>(), pair);
        else if (kind == 0)
          probs_row(half, k0, std::integral_constant<int, 0>(), pair);
        else if (kind == 1)
          probs_row(half, k0, std::integral_constant<int, 1>(), pair);
        else
          probs_row(half, k0, std::integral_constant<int, 2>(), pair);
      } else {  // keys >= L: p = 0
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          uint32_t b[2] = {0u, 0u};
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (k0 + 8 * i + 2 * t + e < L)
              b[e] = prob(half, i, e, mask_at(half, k0, i, e));
          pair[i] = __byte_perm(b[0], b[1], 0x0040);
        }
      }
      fragments(half, pair);  // every lane, after the branches
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma_s8_n64_rs(
          o, afr[kk],
          desc_swizzled(v_s + j * kTileBytes + 32 * kk, kRowBytes),
          j > 0 || kk > 0);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_iregs(o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    den[r] += __shfl_xor_sync(0xffffffffu, den[r], 1);
    den[r] += __shfl_xor_sync(0xffffffffu, den[r], 2);
  }

  T* ob = out + b * sob + h * soh;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int half = x >> 1, d = 8 * i + 2 * t + (x & 1);
      const int row = half ? rowB : rowA;
      if (row < L && d < D)
        ob[row * sol + d] = from_float<T>(__fdiv_rn(
            __fmul_rn(__int2float_rn(o[4 * i + x]), vs127), den[half]));
    }
}

// the shared-memory attribute, set once per device and kernel
template <typename K>
cudaError_t allow_smem(K* kernel, std::atomic<bool>* ready, int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev].load(std::memory_order_relaxed)) {
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)) !=
        cudaSuccess)
      return err;
    ready[dev].store(true, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* mask, const uint32_t* bits, int words,
                   float c0, float c1, uint8_t* work, void* out, int B,
                   int L, int H, const long long* st, float scale,
                   cudaStream_t stream) {
  int8_operands_kernel<T, D><<<dim3(3, H, B), kPrepThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), L, H, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], scale, work);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_tiles = (L + kKeys - 1) / kKeys;
  const dim3 grid((L + kRows - 1) / kRows, H, B);
  if (bits != nullptr) {
    static std::atomic<bool> ready[kMaxDevices];
    auto* kernel = attention_int8_wgmma<T, true>;
    if ((err = allow_smem(kernel, ready,
                          smem_bytes(kMaxTiles, kMaxL / 32))) != cudaSuccess)
      return err;
    kernel<<<grid, kThreads, smem_bytes(n_tiles, words), stream>>>(
        work, mask, bits, words, c0, c1, static_cast<T*>(out), L, H, D,
        st[9], st[10], st[11]);
  } else {
    static std::atomic<bool> ready[kMaxDevices];
    auto* kernel = attention_int8_wgmma<T, false>;
    if ((err = allow_smem(kernel, ready, smem_bytes(kMaxTiles, 0))) !=
        cudaSuccess)
      return err;
    kernel<<<grid, kThreads, smem_bytes(n_tiles, 0), stream>>>(
        work, mask, nullptr, 0, c0, c1, static_cast<T*>(out), L, H, D,
        st[9], st[10], st[11]);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace mmvid

// q, k, v, out: [B, L, H, D] with unit stride over D, 16-byte aligned
// bases and (batch, position, head) element strides in `strides` (12
// values, q, k, v, out) that are multiples of 8; mask: contiguous fp32
// [L, L]; bits: its compact form (int32 [L, words], words = 4 * ceil(L /
// 128), ops/attention_int8.py::pack_bits; c1 where a bit is set, else c0)
// or null; work: ops/attention_int8.py::workspace_bytes(B, L, H) bytes,
// 16-byte aligned.  dtype: 0 fp32, 1 bf16; head_dim 32 or 64; L <= 1024.
// scale: the logit scale rounded to the dtype (q is scaled in its dtype).
// Two launches; returns cudaGetLastError() after them.
extern "C" int mmvid_attention_int8_fwd(int dtype, int head_dim,
                                        const void* q, const void* k,
                                        const void* v, const void* mask,
                                        const void* bits, int words,
                                        float c0, float c1, void* work,
                                        void* out, int B, int L, int H,
                                        const long long* strides, float scale,
                                        void* stream) {
  using namespace mmvid;
  const float* m = static_cast<const float*>(mask);
  const uint32_t* bw = static_cast<const uint32_t*>(bits);
  uint8_t* w = static_cast<uint8_t*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0 || H <= 0 || L > kMaxL || B > 65535 || H > 65535 ||
      (bw != nullptr && words != 4 * ((L + 127) / 128)))
    return cudaErrorInvalidValue;
  if (dtype == kBFloat16 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, m, bw, words, c0, c1, w, out,
                                     B, L, H, strides, scale, s);
  if (dtype == kBFloat16 && head_dim == 32)
    return launch<__nv_bfloat16, 32>(q, k, v, m, bw, words, c0, c1, w, out,
                                     B, L, H, strides, scale, s);
  if (dtype == kFloat32 && head_dim == 64)
    return launch<float, 64>(q, k, v, m, bw, words, c0, c1, w, out, B, L, H,
                             strides, scale, s);
  if (dtype == kFloat32 && head_dim == 32)
    return launch<float, 32>(q, k, v, m, bw, words, c0, c1, w, out, B, L, H,
                             strides, scale, s);
  return cudaErrorInvalidValue;
}
