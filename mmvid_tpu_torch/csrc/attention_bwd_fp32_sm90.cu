// Attention's backward in fp32 on Hopper's tensor cores in split TF32
// ("3xTF32", wgmma), sm_90a: the fp32 route of csrc/attention.cu's
// mmvid_attention_bwd.  Every released recipe trains in fp32 (none passes
// --bf16), and so do the text_augment recipe and the tiny training steps,
// so each of their backward calls lands here.
//
// Replaces the backward of the TPU kernel's custom_vjp,
// mmvid_tpu/ops/attention.py::_fused_attention_bwd (JAX's XLA VJP of
// _attention_xla), and computes the function of mmvid_tpu_torch/ops/
// attention.py::attention_backward (the formulas in
// csrc/attention_bwd_sm90.cu's header) with fp32 softmax and sums.
//
// The products in split TF32, the design of the sample head's fp32-W
// route (csrc/sample_head_tf32_sm90.cu): each operand is rounded to TF32
// (cvt.rna, 11 significant bits) and its remainder rounded again, a =
// a_hi + a_lo, and a.b = a_lo b_hi + a_hi b_lo + a_hi b_hi in wgmma's fp32
// accumulators; the dropped a_lo b_lo and the remainders' roundings are
// about 2^-22 of a term.  The tensor cores truncate a long sum in their
// accumulator, so a sum over the queries (dK, dV: 516-629 terms) takes
// one 32-query tile's products into a fresh accumulator, promoted into
// the fp32 sum in registers (rounded to nearest); the sums over D (S, dP)
// and over a warpgroup's 64 keys (dQ's part) stay in one accumulator.
//
// Row statistics, as the bf16 route: the forward kernel writes each row's
// log-sum-exp in base 2 when grad is on, and delta_i = G_i . O_i from the
// forward's fp32 output O.
//
// Three launches, no atomics (two calls give equal bits):
// 1. delta (attention_bwd_fp32_delta): G . O of every row, into [B, H,
//    lse_ld];
// 2. the key pass (attention_bwd_fp32_key): one block of two warpgroups
//    per 128 keys, head and batch (each warpgroup 64 keys, the wgmma M),
//    over 32-query tiles.  Per tile a warpgroup computes S^T = K.Q^T and
//    dP^T = V.G^T (K and V split once into shared memory as A, the tile's
//    Q and G split as B), P^T = 2^(x - lse) and dS^T in registers, dV +=
//    P^T.G and dK += dS^T.Q (A: P^T and dS^T from the accumulator
//    fragment, B: the tile's G^T and Q^T), and its part of the tile's dQ^T
//    = K^T.dS^T (A: K^T's fragments read from shared memory, B: dS, the
//    transposed store of dS^T); the two warpgroups' dQ^T are summed (the
//    first's plus the second's) into a scratch of partials [key blocks,
//    B, H, L, D];
// 3. dQ (attention_bwd_fp32_dq): scale x the partials summed in
//    key-block order.
//
// wgmma takes 32-bit operands K-major only (no transpose bit), so every
// shared-memory operand is stored with its reduction index contiguous:
// K and V as [keys][D] (for S^T, dP^T), the tile's Q and G both as
// [queries][D] (B of S^T, dP^T) and transposed as [D][queries] (B of dK,
// dV), dS as [queries][keys] (B of dQ^T); each in 32-float (128-byte)
// swizzled slabs.  The accumulator fragment of S^T is not the A fragment
// of a tf32 k8 product (a thread holds queries 2t, 2t + 1 of each 8; the A
// fragment wants t, t + 4): the reduction index is permuted instead, the
// same way in both operands: step s's A position p is query 8s + 2p (p <
// 4) or 8s + 2(p - 4) + 1, and the transposed Q and G tiles are stored in
// that order.
//
// What bounds it on the H100: the five products in split TF32, 3 x 10 B
// H L^2 D flops at 495 TFLOP/s, 0.2377 ms at B16 H12 L565 D64 (on the
// CUDA cores' FMAs, 10 B H L^2 D at 67 TFLOP/s, 0.586 ms: PR 17's design
// ran there, 1.8826 ms).  Beside the products: the splits and the
// transposed stores of each tile (all 256 threads, the next tile's Q and
// G already in registers), the mask's bits (where the caller passes its
// compact form, as the models do; else the fp32 mask from L2) in
// registers, dQ's partials
// (2 x ceil(L / 128) B H L D x 4 bytes, 0.28 GB at B16 L565).
//
// A key or query >= L: zero rows, P and dS 0, never stored.  Rows whose
// key block the mask wholly masks get P = 2^(-1.4e9 - lse) = 0 there.

#include <atomic>

#include "attention_bwd.cuh"
#include "sm90.cuh"

namespace mmvid {
namespace {

using namespace sm90;
using bwd::Args;
using bwd::kDQ;
using bwd::kG;
using bwd::kO;

constexpr int kKeys = 128;             // keys a block: two warpgroups of 64
constexpr int kQT = 32;                // queries a tile
constexpr int kThreads = 256;
constexpr int kSlab = 32;              // floats a 128-byte swizzled row
constexpr int kMaxDevices = 64;
constexpr int kLanes = 16;             // lanes a row of the delta launch
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, all in 128-byte swizzled slabs of 32 floats a row
template <int D>
struct Layout {
  static constexpr int kSlabs = D / kSlab;              // 2 or 1
  static constexpr int kKv = kKeys * 128;               // a slab of K or V
  static constexpr int kQs = kQT * 128;                 // of the tile's Q
  // K hi, K lo, V hi, V lo: [slab][key][32]
  static constexpr int kK = 0;
  static constexpr int kTiles = 4 * kSlabs * kKv;
  // Q hi / lo, G hi / lo: [slab][query][32]; Q^T, G^T hi / lo: [D][32
  // queries, permuted]
  static constexpr int kQ = kTiles;
  static constexpr int kQT_ = kQ + 4 * kSlabs * kQs;
  // dS hi / lo of each warpgroup: [2 slabs of 32 keys][query][32]
  static constexpr int kDs = kQT_ + 4 * D * 128;
  static constexpr int kDsWg = 2 * 2 * kQs;
  // the tile's mask bits: [32 queries][4 words] (the block's 128 keys)
  static constexpr int kBits = kDs + 2 * kDsWg;
  static constexpr int kSmem = 1024 + kBits + kQT * 16;
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}
// hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// byte offset of float c (< 32) of row r in a 128-byte swizzled slab
__device__ __forceinline__ uint32_t slab_off(int r, int c) {
  return swizzle128(r, c >> 2) + 4 * (c & 3);
}

__device__ __forceinline__ void st_f32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void st_v4(uint32_t addr, const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}
__device__ __forceinline__ uint32_t ld_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// d[64 x 32] (+)= A[64 x 8] . B[8 x 32] in TF32, A and B K-major in shared
// memory
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x N] (+)= A[64 x 8] . B[8 x N] in TF32, N 64 or 32, A in registers
// (a0 row g, k t; a1 row g + 8; a2, a3 k + 4), B K-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate));
  }
}

__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return desc_swizzled(addr, 128);
}

// The k8 step s of an m64n32 accumulator x (keys x 32 queries) as split
// A fragments over the permuted queries: a0 = (row g, query 8s + 2t) =
// x[4s], a1 = (row g + 8, 8s + 2t) = x[4s + 2], a2 = (row g, 8s + 2t + 1)
// = x[4s + 1], a3 = (row g + 8, 8s + 2t + 1) = x[4s + 3]
__device__ __forceinline__ void a_frag(const float (&x)[16], int s,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(x[4 * s], hi[0], lo[0]);
  split(x[4 * s + 2], hi[1], lo[1]);
  split(x[4 * s + 1], hi[2], lo[2]);
  split(x[4 * s + 3], hi[3], lo[3]);
}

// acc = X . B over the tile's 32 queries, X (keys x queries) split from
// its accumulator fragment, B^T's hi / lo slabs at b_hi / b_lo ([N rows]
// [32 permuted queries]); issued, not committed
template <int N>
__device__ __forceinline__ void product_tile(float (&acc)[N / 2],
                                             const float (&x)[16],
                                             uint32_t b_hi, uint32_t b_lo) {
#pragma unroll
  for (int s = 0; s < kQT / 8; ++s) {
    uint32_t hi[4], lo[4];
    a_frag(x, s, hi, lo);
    const uint64_t dh = desc(b_hi + 32 * s), dl = desc(b_lo + 32 * s);
    wgmma_rs<N>(acc, lo, dh, s > 0);
    wgmma_rs<N>(acc, hi, dl, 1);
    wgmma_rs<N>(acc, hi, dh, 1);
  }
}

template <int D, bool kBits>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_fp32_key(const Args a) {
  using T = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  // slab c of the hi (part 0) or lo (part 1) of K (which 0) or V (1)
  auto kv = [&](int which, int part, int c) {
    return base + T::kK + ((2 * which + part) * T::kSlabs + c) * T::kKv;
  };
  // slab c of Q (which 0) or G (1), hi or lo, [query][32]
  auto qs = [&](int which, int part, int c) {
    return base + T::kQ + ((2 * which + part) * T::kSlabs + c) * T::kQs;
  };
  // Q^T (0) or G^T (1), hi or lo: [D][32 permuted queries]
  auto qt = [&](int which, int part) {
    return base + T::kQT_ + (2 * which + part) * D * 128;
  };
  // warpgroup w's dS, hi or lo, slab c of 32 keys: [query][32 keys]
  auto ds = [&](int w, int part, int c) {
    return base + T::kDs + w * T::kDsWg + (2 * part + c) * T::kQs;
  };

  const int tid = threadIdx.x, L = a.L;
  const int kb = blockIdx.x, k0 = kb * kKeys, h = blockIdx.y, b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * gridDim.y + h;
  auto at = [&](const void* p, int which) {
    return static_cast<const float*>(p) + b * a.st[which][0] +
           h * a.st[which][2];
  };
  const float *qb = at(a.q, bwd::kQ), *kbp = at(a.k, bwd::kK),
              *vb = at(a.v, bwd::kV), *gb = at(a.g, bwd::kG);
  const long long sql = a.st[bwd::kQ][1], sgl = a.st[bwd::kG][1];
  const int n_tiles = (L + kQT - 1) / kQT;

  // The loads: a tile's Q and G, a thread row lr = tid / 8 and the
  // 16-byte chunk lc = tid % 8 of each slab.  (A warp's 32 rows of one
  // chunk put its transposed stores below in 32 banks, not 8, but was
  // slower: attribution.py's chunk_major_loads.)
  const int lr = tid >> 3, lc = tid & 7;
  float4 pq[T::kSlabs], pg[T::kSlabs];
  // with the compact mask, threads < 128 load word tid % 4 of query row tid
  // / 4 of the tile (the block's 128 keys)
  uint32_t pb = 0;
  const uint32_t* bits_row =
      a.bits + static_cast<long long>(tid >> 2) * a.words + 4 * kb + (tid & 3);
  auto load_tile = [&](int j) {
    const int row = j * kQT + lr;
    const bool ok = row < L;
    if (kBits && tid < 4 * kQT)
      pb = j * kQT + (tid >> 2) < L
               ? __ldg(bits_row + static_cast<long long>(j) * kQT * a.words)
               : 0u;
#pragma unroll
    for (int c = 0; c < T::kSlabs; ++c) {
      pq[c] = ok ? __ldg(reinterpret_cast<const float4*>(
                       qb + row * sql + kSlab * c + 4 * lc))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
      pg[c] = ok ? __ldg(reinterpret_cast<const float4*>(
                       gb + row * sgl + kSlab * c + 4 * lc))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  load_tile(0);

  // K and V of the block, split, [slab][key][32]: rows >= L zero
  for (int i = tid; i < kKeys * D / 4; i += kThreads) {
    const int key = i / (D / 4), c4 = i % (D / 4);
    const int c = c4 / 8, ch = c4 % 8;
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const float* src = which ? vb : kbp;
      const long long stl = a.st[which ? bwd::kV : bwd::kK][1];
      const float4 x = k0 + key < L
                           ? __ldg(reinterpret_cast<const float4*>(
                                 src + (k0 + key) * stl + 4 * c4))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      uint32_t hi[4], lo[4];
      split(x.x, hi[0], lo[0]);
      split(x.y, hi[1], lo[1]);
      split(x.z, hi[2], lo[2]);
      split(x.w, hi[3], lo[3]);
      const uint32_t off = swizzle128(key, ch);
      st_v4(kv(which, 0, c) + off, hi);
      st_v4(kv(which, 1, c) + off, lo);
    }
  }

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  // this thread's keys: warpgroup rows kr and kr + 8 (of 64)
  const int kr = warp * 16 + g;
  const int key0 = k0 + wg * 64 + kr;
  const float* lse_bh = a.lse + bh * a.lse_ld;
  const float* delta_bh = a.delta + bh * a.lse_ld;
  float* part = a.part +
                ((static_cast<long long>(kb) * gridDim.z + b) * gridDim.y +
                 h) * L * D;
  // the inverse of the A fragment's query order: query m (< 8) of a step
  // sits at position (m even) m / 2, (odd) 4 + m / 2
  const int lp = 8 * (lr >> 3) + ((lr & 1) ? 4 + ((lr & 7) >> 1)
                                           : ((lr & 7) >> 1));
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int q0 = j * kQT;
    // every warp is done with tile j - 1's operands
    __syncthreads();
    // tile j's Q and G, split: [query][32] slabs and the transposed,
    // permuted [D][32]
#pragma unroll
    for (int which = 0; which < 2; ++which)
#pragma unroll
      for (int c = 0; c < T::kSlabs; ++c) {
        const float4 x = which ? pg[c] : pq[c];
        const float xs[4] = {x.x, x.y, x.z, x.w};
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) split(xs[u], hi[u], lo[u]);
        const uint32_t off = swizzle128(lr, lc);
        st_v4(qs(which, 0, c) + off, hi);
        st_v4(qs(which, 1, c) + off, lo);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int d = kSlab * c + 4 * lc + u;
          st_f32(qt(which, 0) + slab_off(d, lp), hi[u]);
          st_f32(qt(which, 1) + slab_off(d, lp), lo[u]);
        }
      }
    if (kBits && tid < 4 * kQT)
      reinterpret_cast<uint32_t*>(gbase + T::kBits)[tid] = pb;
    if (j + 1 < n_tiles) load_tile(j + 1);
    fence_proxy_async();
    __syncthreads();

    // S^T = K.Q^T, dP^T = V.G^T over D: keys x 32 queries
    float st[16], dp[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) st[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < D / 8; ++s) {
      const int c = s / 4;
      const uint32_t ko = wg * 64 * 128 + 32 * (s % 4), qo = 32 * (s % 4);
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        float(&x)[16] = which ? dp : st;
        const uint64_t ah = desc(kv(which, 0, c) + ko);
        const uint64_t al = desc(kv(which, 1, c) + ko);
        const uint64_t bh_ = desc(qs(which, 0, c) + qo);
        const uint64_t bl = desc(qs(which, 1, c) + qo);
        wgmma_ss_n32(x, al, bh_, s > 0);
        wgmma_ss_n32(x, ah, bl, 1);
        wgmma_ss_n32(x, ah, bh_, 1);
      }
    }
    wgmma_commit();
    // the mask entries while the products run: st[4i + 2r + e] is key
    // key0 + 8r, query q0 + 8i + 2t + e; from the tile's bits (the block's
    // key wg 64 + kr + 8r) or the fp32 mask in L2
    float mk[16];
    const uint32_t* mb = reinterpret_cast<const uint32_t*>(gbase + T::kBits);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qr = q0 + 8 * i + 2 * t + e, key = key0 + 8 * r;
          if constexpr (kBits) {
            const int kl = wg * 64 + kr + 8 * r;
            mk[4 * i + 2 * r + e] =
                (mb[4 * (8 * i + 2 * t + e) + (kl >> 5)] >> (kl & 31)) & 1u
                    ? a.c1
                    : a.c0;
          } else {
            mk[4 * i + 2 * r + e] =
                qr < L && key < L
                    ? __ldg(a.mask + static_cast<long long>(qr) * L + key)
                    : -1e9f;
          }
        }
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // the statistics of queries q0 + 8i + 2t and + 1 (lse_ld is a
      // multiple of 64, so both lie in the rows' buffers)
      const int qr = q0 + 8 * i + 2 * t;
      const float2 ls = *reinterpret_cast<const float2*>(lse_bh + qr);
      const float2 dl = *reinterpret_cast<const float2*>(delta_bh + qr);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 4 * i + 2 * r + e;
          const bool ok = qr + e < L && key0 + 8 * r < L;
          const float p =
              ok ? fast_exp2(fmaf(fmaf(st[n], a.scale, mk[n]), kLog2e,
                                  -(e ? ls.y : ls.x)))
                 : 0.f;
          dp[n] = ok ? p * (dp[n] - (e ? dl.y : dl.x)) : 0.f;
          st[n] = p;
        }
    }
    // dV += P^T.G: this tile's products into a fresh accumulator
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    wgmma_fence();
    product_tile<D>(acc, st, qt(1, 0), qt(1, 1));
    wgmma_commit();
    // dS^T, split, stored transposed as this warpgroup's dS [query][key]
    // while they run
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          uint32_t hi, lo;
          split(dp[4 * i + 2 * r + e], hi, lo);
          const int key = kr + 8 * r, qr = 8 * i + 2 * t + e;
          const uint32_t off = slab_off(qr, key & 31);
          st_f32(ds(wg, 0, key >> 5) + off, hi);
          st_f32(ds(wg, 1, key >> 5) + off, lo);
        }
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dv[i] += acc[i];
    // dK += dS^T.Q
    wgmma_fence();
    product_tile<D>(acc, dp, qt(0, 0), qt(0, 1));
    wgmma_commit();
    // this warpgroup's dS visible to its tensor cores
    fence_proxy_async();
    named_sync(1 + wg, 128);
    // dQ^T = K^T.dS^T over the warpgroup's 64 keys: rows d = 16 warp + g
    // (+ 8) of D (for D 32 warps 2 and 3 feed zeros), K^T's fragments read
    // from the split K, two k8 steps a group, two groups in flight
    float dq[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) dq[i] = 0.f;
    const bool rows_ok = warp * 16 < D;
    auto k_frag = [&](int s, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int d = warp * 16 + g + 8 * (u & 1);
        const int key = wg * 64 + 8 * s + t + 4 * (u >> 1);
        const uint32_t off = (d / kSlab) * T::kKv + slab_off(key, d % kSlab);
        hi[u] = rows_ok ? ld_u32(kv(0, 0, 0) + off) : 0u;
        lo[u] = rows_ok ? ld_u32(kv(0, 1, 0) + off) : 0u;
      }
    };
    uint32_t fh[2][2][4], fl[2][2][4];
#pragma unroll
    for (int grp = 0; grp < 4; ++grp) {
      uint32_t(&gh)[2][4] = fh[grp & 1];
      uint32_t(&gl)[2][4] = fl[grp & 1];
      if (grp >= 2) wgmma_wait<1>();   // group grp - 2 is done
      k_frag(2 * grp, gh[0], gl[0]);
      k_frag(2 * grp + 1, gh[1], gl[1]);
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int s = 2 * grp + u;
        const uint32_t o = 32 * (s % 4);
        const uint64_t dh = desc(ds(wg, 0, s / 4) + o);
        const uint64_t dl = desc(ds(wg, 1, s / 4) + o);
        wgmma_rs<32>(dq, gl[u], dh, s > 0);
        wgmma_rs<32>(dq, gh[u], dl, 1);
        wgmma_rs<32>(dq, gh[u], dh, 1);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(dq);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] += acc[i];
    // the two warpgroups' dQ^T summed, the first's plus the second's: the
    // second puts its own into its dS buffer (its products are done) and
    // goes on; the first waits for it, adds and stores the tile's partial
    // dq[4i + 2r + e] is d = 16 warp + g + 8r, query q0 + 8i + 2t + e
    float* xbuf = reinterpret_cast<float*>(gbase + T::kDs + T::kDsWg);
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(
              xbuf + (warp * 16 + g + 8 * r) * kQT + 8 * i + 2 * t) =
              make_float2(dq[4 * i + 2 * r], dq[4 * i + 2 * r + 1]);
      asm volatile("bar.arrive 3, %0;\n" ::"n"(kThreads) : "memory");
    } else {
      named_sync(3, kThreads);
      if (rows_ok) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int d = warp * 16 + g + 8 * r;
            const float2 o = *reinterpret_cast<const float2*>(
                xbuf + d * kQT + 8 * i + 2 * t);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int qr = q0 + 8 * i + 2 * t + e;
              if (qr < L)
                part[static_cast<long long>(qr) * D + d] =
                    dq[4 * i + 2 * r + e] + (e ? o.y : o.x);
            }
          }
      }
    }
  }
  // dk, dv [4i + 2r + e]: key key0 + 8r, column 8i + 2t + e
  float* dkb = static_cast<float*>(a.dk) + b * a.st[bwd::kDK][0] +
               h * a.st[bwd::kDK][2];
  float* dvb = static_cast<float*>(a.dv) + b * a.st[bwd::kDV][0] +
               h * a.st[bwd::kDV][2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key < L) {
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const int c = 8 * i + 2 * t;
        *reinterpret_cast<float2*>(dkb + key * a.st[bwd::kDK][1] + c) =
            make_float2(dk[4 * i + 2 * r] * a.scale,
                        dk[4 * i + 2 * r + 1] * a.scale);
        *reinterpret_cast<float2*>(dvb + key * a.st[bwd::kDV][1] + c) =
            make_float2(dv[4 * i + 2 * r], dv[4 * i + 2 * r + 1]);
      }
    }
  }
}

// delta = G . O of each row (b, l, h): 16 lanes a row, D / 16 dims a
// lane, summed over the lanes by shuffles
template <int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_fp32_delta(const Args a, int B) {
  constexpr int kDPT = D / kLanes;
  const int L = a.L, H = a.H;
  const long long r = static_cast<long long>(blockIdx.x) * (kThreads / kLanes)
                      + threadIdx.x / kLanes;
  const int c = threadIdx.x % kLanes;
  const bool ok = r < static_cast<long long>(B) * L * H;
  const int h = ok ? static_cast<int>(r % H) : 0;
  const int l = ok ? static_cast<int>(r / H % L) : 0;
  const int b = ok ? static_cast<int>(r / H / L) : 0;
  float s = 0.f;
  if (ok) {
    const long long go = b * a.st[kG][0] + l * a.st[kG][1] +
                         h * a.st[kG][2] + c * kDPT;
    const long long oo = b * a.st[kO][0] + l * a.st[kO][1] +
                         h * a.st[kO][2] + c * kDPT;
    const float* g = static_cast<const float*>(a.g) + go;
    const float* o = static_cast<const float*>(a.o) + oo;
#pragma unroll
    for (int e = 0; e < kDPT; ++e) s = fmaf(g[e], o[e], s);
  }
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (ok && c == 0)
    a.delta[(static_cast<long long>(b) * H + h) * a.lse_ld + l] = s;
}

// dq = scale x the partials of the key blocks, summed in block order: a
// thread per 2 elements of a row (b, l, h)
template <int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_fp32_dq(const Args a, int B, int blocks) {
  const long long n = static_cast<long long>(B) * a.H * a.L * (D / 2);
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  // i = ((b H + h) L + l) (D / 2) + d2: the partials' own order
  const int d2 = static_cast<int>(i % (D / 2));
  const long long row = i / (D / 2);
  const int l = static_cast<int>(row % a.L);
  const int h = static_cast<int>(row / a.L % a.H);
  const int b = static_cast<int>(row / a.L / a.H);
  const long long step = static_cast<long long>(B) * a.H * a.L * D;
  const float* p = a.part + row * D + 2 * d2;
  float2 s = *reinterpret_cast<const float2*>(p);
  for (int kb = 1; kb < blocks; ++kb) {
    const float2 x = *reinterpret_cast<const float2*>(p + kb * step);
    s.x += x.x;
    s.y += x.y;
  }
  float* out = static_cast<float*>(a.dq) + b * a.st[kDQ][0] +
               l * a.st[kDQ][1] + h * a.st[kDQ][2];
  *reinterpret_cast<float2*>(out + 2 * d2) =
      make_float2(s.x * a.scale, s.y * a.scale);
}

template <int D, bool kBits>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  using T = Layout<D>;
  static_assert(T::kSmem <= 232448, "shared memory of one block");
  // the shared-memory attribute, set at the first launch on each device
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev].load(std::memory_order_relaxed)) {
    if ((err = cudaFuncSetAttribute(
             attention_bwd_fp32_key<D, kBits>,
             cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem)) !=
        cudaSuccess)
      return err;
    ready[dev].store(true, std::memory_order_relaxed);
  }
  const long long rows = static_cast<long long>(B) * a.L * a.H;
  const int per = kThreads / kLanes;
  attention_bwd_fp32_delta<D>
      <<<static_cast<unsigned>((rows + per - 1) / per), kThreads, 0,
         stream>>>(a, B);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attention_bwd_fp32_key<D, kBits>
      <<<dim3((a.L + kKeys - 1) / kKeys, a.H, B), kThreads, T::kSmem,
         stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long n = rows * (D / 2);
  attention_bwd_fp32_dq<D>
      <<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0,
         stream>>>(a, B, (a.L + kKeys - 1) / kKeys);
  return cudaGetLastError();
}

}  // namespace

// fp32 with mmvid_attention_bwd's arguments (csrc/attention_bwd.cu); the
// caller has checked 16-byte aligned bases and row/head/batch strides that
// are multiples of 4, lse_ld a multiple of 64 that is >= L, and the
// partials' scratch.
cudaError_t attention_bwd_fp32(int head_dim, const bwd::Args& a, int B,
                               cudaStream_t stream) {
  const bool bits = a.bits != nullptr;
  if (head_dim == 64)
    return bits ? launch<64, true>(a, B, stream)
                : launch<64, false>(a, B, stream);
  if (head_dim == 32)
    return bits ? launch<32, true>(a, B, stream)
                : launch<32, false>(a, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace mmvid
