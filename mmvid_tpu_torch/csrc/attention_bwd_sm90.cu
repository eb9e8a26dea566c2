// Attention's backward for bf16 q, k, v on Hopper's tensor cores (wgmma),
// sm_90a: the bf16 route of csrc/attention.cu's mmvid_attention_bwd; its
// fp32 route is csrc/attention_bwd_fp32_sm90.cu.
//
// Replaces the backward of the TPU kernel's custom_vjp,
// mmvid_tpu/ops/attention.py::_fused_attention_bwd (JAX's XLA VJP of
// _attention_xla, which recomputes the [L, L] fp32 probabilities), and
// computes the function of mmvid_tpu_torch/ops/attention.py::
// attention_backward, per (batch, head), for the cotangent G:
//
//     S = scale Q.K^T + mask      P = softmax_rows(S)          (fp32)
//     dV = P^T.G                  dP = G.V^T
//     delta_i = sum_j P_ij dP_ij  dS = P o (dP - delta)
//     dQ = scale dS.K             dK = scale dS^T.Q
//
// q, k, v in the residual stream's [B, L, H*D] layout (strided: views of
// one packed QKV projection), G, the forward's output O and dq, dk, dv
// [B, L, H, D], the mask an additive fp32 [L, L] tensor; the ragged L
// edge is masked, never padded.
//
// Numerics, the forward kernel's (csrc/attention_sm90.cu): S = Q.K^T and
// dP = G.V^T from bf16 operands with fp32 sums (exact products, as JAX's
// fp32 einsum of bf16 inputs); P and dS meet their bf16 partner split as
// hi = bf16(x), lo = bf16(x - hi), two products each (about 16
// significant bits, near JAX's fp32); the softmax and dS in fp32.
//
// Row statistics.  JAX's residuals are (q, k, v, mask) and its backward
// recomputes the softmax.  Here the forward kernel, when grad is on, also
// writes each row's log-sum-exp (base 2, [B, H, L] fp32), and the
// backward saves the forward's output O, which autograd keeps alive for
// the output projection anyway: P = 2^(x - lse) needs no pass over the
// keys for the max and sum, and delta_i = G_i . O_i (in exact arithmetic
// sum_j P_ij dP_ij, since O_i = sum_j P_ij V_j) needs none for delta.
// Without them the backward would take a statistics pass of two more
// products a tile.  O is stored in bf16, so the forward also writes the
// rest of its fp32 O, O_lo = bf16(O - bf16(O)), and delta reads O + O_lo
// (about 16 bits): from the bf16 O alone, delta moves dq and dk by up to
// 3e-3 of 1 + |dq| at the CPU tests' shapes, as far as an unsplit P does
// (tests/test_torch_attention_backward.py).
//
// Two launches, no atomics, so two calls give equal bits:
// 1. the query pass (attention_bwd_query): one block per 128 query rows,
//    head and batch.  It computes delta for its rows from G and O + O_lo
//    (written to [B, H, lse_ld] for launch 2), then walks the key tiles:
//    S and dP (wgmma, Q and G K-major from shared memory, K and V the B
//    operand), P and dS in registers, dQ += dS.K (dS from registers, K
//    MN-major); dQ is the block's alone, summed in key order;
// 2. the key pass (attention_bwd_key): one block per 128 keys, head and
//    batch, the transposed walk over the query tiles: S^T = K.Q^T and
//    dP^T = V.G^T (K and V from shared memory as A), P^T and dS^T in
//    registers (the accumulator fragment of keys x queries is the A
//    fragment of the next products), dV += P^T.G and dK += dS^T.Q (G
//    and Q MN-major).
// dQ takes its own pass, and so recomputes S and dP, rather than fp32
// atomics into one dQ (run-to-run bits would differ) or per-key-tile
// partials reduced in order (0.25 GB of partials at B16 L565).
//
// What bounds it on the H100: 8 products of 2 B H L^2 D flops with the
// splits (S, dP, dV x 2, dK x 2, dQ x 2), 0.063 ms at B16 H12 L565 D64;
// this design does 10 (S and dP twice).  The mask is read from L2 by each
// block once, 2 B H L^2 4 bytes over both passes (0.49 GB at B16 L565);
// the forward found its mask reads set its pace (attention_sm90.cu).
//
// Design, the simple form the port's first kernel takes: two consumer
// warpgroups of 64 rows (the wgmma M) a block, no producer warpgroup; all
// 256 threads copy the streamed tiles by cp.async (16 bytes a thread; rows
// >= L zero-filled by the source size) into a 2-stage ring, one
// __syncthreads a tile, the next tile's copies in flight while this one
// is computed.  Each thread reads its 32 mask entries of a tile from L2
// into registers after issuing the tile's first products, which cover the
// loads' latency.  Tiles of 2*D-byte rows with the 128-byte (D 64) or
// 64-byte (D 32) swizzle, as the forward's.  256 threads a block leave
// 255 registers a thread (the key pass holds dK and dV, S^T and dP^T and
// the split P^T and dS^T).
//
// Two redesigns were timed against this kernel in turns and lost
// (mmvid_tpu_torch/attribution.py --attention-bwd-source; an NVIDIA H100
// 80GB HBM3 at 700 W, B16 H12 D64 L565 mask_prev, PERF.md): one key pass
// of 8 products (S and dP once) fed by a producer warpgroup's tensor
// copies into an mbarrier ring, setmaxnreg 40 / 232, the mask's compact
// form, dQ from per-key-block fp32 partials summed by a third launch:
// 0.5028 ms against 0.3976 (the partials' stores and their sum 0.11 ms;
// summed in the key pass by the tile's last block instead, 0.6246 ms);
// and this kernel reading the mask's compact form from L2 instead of the
// fp32 mask: 0.4421 against 0.3973.
//
// A key or query >= L: zero K/V (or Q/G) rows, logit -inf, P and dS
// forced to 0, never stored.  Rows whose first key tile the mask wholly
// masks (-1e9) get P = 2^(-1.4e9 - lse) = 0 there, as the plain version's
// softmax gives.

#include <atomic>

#include "attention_bwd.cuh"
#include "attention_sm90.cuh"

namespace mmvid {
namespace {

using namespace sm90;

constexpr int kRows = 128;      // rows a block owns: two warpgroups of 64
constexpr int kTile = 64;       // rows of a streamed tile
constexpr int kStages = 2;      // the streamed tiles' ring
constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;

// What a launch of either pass reads and writes.  Strides in elements:
// batch, row, head of q, k, v, o (the forward's output), g (the
// cotangent), dq, dk, dv.
struct BwdArgs {
  const __nv_bfloat16 *q, *k, *v, *o, *g;
  const __nv_bfloat16* o_lo;  // the rest of the fp32 O, in o's layout
  __nv_bfloat16 *dq, *dk, *dv;
  const float* mask;
  const float* lse;  // [B, H, lse_ld], base 2
  float* delta;      // [B, H, lse_ld]: written by the query pass
  long long st[8][3];
  int L, lse_ld;
  float scale, scale_log2;
};
enum { kQ, kK, kV, kO, kG, kDQ, kDK, kDV };

template <int D>
struct BwdTile {
  static constexpr int kRowBytes = 2 * D;  // one bf16 row: 128 or 64 bytes
  static constexpr int kChunks = kRowBytes / 16;
  static constexpr int kOwnBytes = kRows * kRowBytes;    // Q or G; K or V
  static constexpr int kTileBytes = kTile * kRowBytes;   // a streamed tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  // + up to 1023 bytes to align the tiles to the 1024-byte swizzle atom,
  // and the query pass's delta of its rows
  static constexpr int kSmem =
      1024 + 2 * kOwnBytes + kStages * kStageBytes + 4 * kRows;
};

template <int D>
__device__ __forceinline__ uint32_t swizzle(int r, int c) {
  return swizzle_offset(r, c, BwdTile<D>::kRowBytes);
}
template <int D>
__device__ __forceinline__ uint64_t descriptor(uint32_t addr) {
  return desc_swizzled(addr, BwdTile<D>::kRowBytes);
}

// This thread's part of copying kN rows of 2*D bytes (row i at src + i *
// stride) into a swizzled tile at dst, rows >= valid zero-filled: the
// block covers 256 / (D / 8) rows a pass, a thread one 16-byte chunk of
// each
template <int D, int kN>
__device__ __forceinline__ void copy_rows(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int valid,
                                          int tid) {
  constexpr int kC = BwdTile<D>::kChunks;
  constexpr int kPass = kThreads / kC;
  const int ch = tid % kC, r0 = tid / kC;
#pragma unroll
  for (int i = 0; i < kN / kPass; ++i) {
    const int r = r0 + kPass * i;
    const bool ok = r < valid;
    cp_async16(dst + swizzle<D>(r, ch), ok ? src + r * stride + ch * 8 : src,
               ok ? 16 : 0);
  }
}

// acc (+)= A . B^T over D: A's 64 rows at a (K-major), B's 64 rows at b
// (K-major), both 2*D-byte swizzled rows; issued, not committed
template <int D>
__device__ __forceinline__ void product_nt(float (&acc)[32], uint32_t a,
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(acc, descriptor<D>(a + kk * 32), descriptor<D>(b + kk * 32),
                 kk > 0);
}

// acc += X . B over 64 rows of B at b (MN-major: B's rows are X's
// columns), X split into hi + lo A fragments; issued, not committed
template <int D>
__device__ __forceinline__ void product_split(float (&acc)[D / 2],
                                              const uint32_t (&hi)[4][4],
                                              const uint32_t (&lo)[4][4],
                                              uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = descriptor<D>(b + kk * 16 * BwdTile<D>::kRowBytes);
    wgmma_rs<D>(acc, hi[kk], db);
    wgmma_rs<D>(acc, lo[kk], db);
  }
}

// Wait for this thread's copies of the current tile, make them (and every
// thread's) visible to the tensor cores' async proxy
__device__ __forceinline__ void tile_landed() {
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
}

// Store rows r0 and r0 + 8 (< L) of an accumulator fragment times f as
// bf16: x[4i + 2r + e] is row r0 + 8r, column 8i + 2t + e
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base,
                                           long long stride,
                                           const float (&x)[D / 2], float f,
                                           int r0, int t, int L) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row < L) {
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<uint32_t*>(base + row * stride + 8 * i + 2 * t) =
            pack_bf16x2(x[4 * i + 2 * r] * f, x[4 * i + 2 * r + 1] * f);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_query(const BwdArgs a) {
  using T = BwdTile<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_tile = base, g_tile = base + T::kOwnBytes;
  auto k_tile = [&](int s) {
    return base + 2 * T::kOwnBytes + s * T::kStageBytes;
  };
  float* delta_s = reinterpret_cast<float*>(
      smem_raw + (base - smem_addr(smem_raw)) + 2 * T::kOwnBytes +
      kStages * T::kStageBytes);

  const int tid = threadIdx.x, L = a.L;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * gridDim.y + h;
  auto at = [&](const __nv_bfloat16* p, int which) {
    return p + b * a.st[which][0] + h * a.st[which][2];
  };
  const __nv_bfloat16 *qb = at(a.q, kQ), *kb = at(a.k, kK), *vb = at(a.v, kV),
                      *gb = at(a.g, kG), *ob = at(a.o, kO),
                      *at_o_lo = at(a.o_lo, kO);
  const long long sql = a.st[kQ][1], skl = a.st[kK][1], svl = a.st[kV][1],
                  sgl = a.st[kG][1], sol = a.st[kO][1];
  const int n_tiles = (L + kTile - 1) / kTile;
  auto stage = [&](int j) {
    const int k0 = j * kTile;
    copy_rows<D, kTile>(k_tile(j % kStages), kb + k0 * skl, skl, L - k0, tid);
    copy_rows<D, kTile>(k_tile(j % kStages) + T::kTileBytes, vb + k0 * svl,
                        svl, L - k0, tid);
  };
  copy_rows<D, kRows>(q_tile, qb + q0 * sql, sql, L - q0, tid);
  copy_rows<D, kRows>(g_tile, gb + q0 * sgl, sgl, L - q0, tid);
  stage(0);
  cp_async_commit();

  // delta of the block's rows, G . (O + O_lo) in fp32: two threads a
  // row, D / 2 dims each in 8-element loads
  {
    const int r = tid >> 1, half = tid & 1, row = q0 + r;
    float s = 0.f;
    if (row < L) {
      const long long at = row * sol + half * (D / 2);
      const __nv_bfloat16* gr = gb + row * sgl + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        const uint4 gv = *reinterpret_cast<const uint4*>(gr + c);
        const uint4 ov = *reinterpret_cast<const uint4*>(ob + at + c);
        const uint4 lv = *reinterpret_cast<const uint4*>(
            at_o_lo + at + c);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* l2 = reinterpret_cast<const __nv_bfloat162*>(&lv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s = fmaf(__low2float(g2[e]),
                   __low2float(o2[e]) + __low2float(l2[e]), s);
          s = fmaf(__high2float(g2[e]),
                   __high2float(o2[e]) + __high2float(l2[e]), s);
        }
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (half == 0) {
      delta_s[r] = s;
      if (row < L) a.delta[bh * a.lse_ld + row] = s;
    }
  }

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rr = wg * 64 + warp * 16 + g, r0 = q0 + rr;  // rows r0, r0 + 8
  // the warpgroup has query rows < L
  const bool active = q0 + wg * 64 < L;
  float lse[2], dl[2];
  const float* mrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const bool ok = row < L;
    lse[r] = ok ? a.lse[bh * a.lse_ld + row] : 0.f;
    // a row >= L reads row L - 1's mask: never stored
    mrow[r] = a.mask + static_cast<long long>(ok ? row : L - 1) * L + 2 * t;
  }
  const uint32_t qa = q_tile + wg * 64 * T::kRowBytes;
  const uint32_t ga = g_tile + wg * 64 * T::kRowBytes;
  float dq[D / 2], sc[32], dp[32], mk[32];
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    // tile j landed; every thread is done with tile j - 1, whose stage
    // takes tile j + 1
    tile_landed();
    if (j == 0) {
      dl[0] = delta_s[rr];
      dl[1] = delta_s[rr + 8];
    }
    if (j + 1 < n_tiles) stage(j + 1);
    cp_async_commit();
    if (!active) continue;
    const uint32_t kt = k_tile(j % kStages), vt = kt + T::kTileBytes;
    const int k0 = j * kTile;
    wgmma_fence();
    product_nt<D>(sc, qa, kt);
    product_nt<D>(dp, ga, vt);
    wgmma_commit();
    // the mask entries of this thread's fragment: sc[4i + e] is row r0 +
    // 8 (e / 2), key k0 + 8i + 2t + e % 2; -inf for keys >= L
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * i + (e & 1);
        mk[4 * i + e] = k0 + c + 2 * t < L ? __ldg(mrow[e >> 1] + k0 + c)
                                           : -INFINITY;
      }
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    // P = 2^(x - lse), dS = P (dP - delta), in place of S
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const float p =
          fast_exp2(fmaf(sc[i], a.scale_log2, mk[i] * kLog2e) - lse[r]);
      sc[i] = p * (dp[i] - dl[r]);
    }
    pack_split(sc, hi, lo);
    wgmma_fence();
    product_split<D>(dq, hi, lo, kt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
  }
  if (active)
    store_rows<D>(a.dq + b * a.st[kDQ][0] + h * a.st[kDQ][2], a.st[kDQ][1],
                  dq, a.scale, r0, t, L);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_key(const BwdArgs a) {
  using T = BwdTile<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t k_tile = base, v_tile = base + T::kOwnBytes;
  auto q_tile = [&](int s) {
    return base + 2 * T::kOwnBytes + s * T::kStageBytes;
  };

  const int tid = threadIdx.x, L = a.L;
  const int k0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * gridDim.y + h;
  auto at = [&](const __nv_bfloat16* p, int which) {
    return p + b * a.st[which][0] + h * a.st[which][2];
  };
  const __nv_bfloat16 *qb = at(a.q, kQ), *kb = at(a.k, kK), *vb = at(a.v, kV),
                      *gb = at(a.g, kG);
  const long long sql = a.st[kQ][1], skl = a.st[kK][1], svl = a.st[kV][1],
                  sgl = a.st[kG][1];
  const int n_tiles = (L + kTile - 1) / kTile;
  auto stage = [&](int j) {
    const int q0 = j * kTile;
    copy_rows<D, kTile>(q_tile(j % kStages), qb + q0 * sql, sql, L - q0, tid);
    copy_rows<D, kTile>(q_tile(j % kStages) + T::kTileBytes, gb + q0 * sgl,
                        sgl, L - q0, tid);
  };
  copy_rows<D, kRows>(k_tile, kb + k0 * skl, skl, L - k0, tid);
  copy_rows<D, kRows>(v_tile, vb + k0 * svl, svl, L - k0, tid);
  stage(0);
  cp_async_commit();

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  // this thread's keys: rows r0 and r0 + 8 of S^T
  const int r0 = k0 + wg * 64 + warp * 16 + g;
  const bool active = k0 + wg * 64 < L;
  const uint32_t ka = k_tile + wg * 64 * T::kRowBytes;
  const uint32_t va = v_tile + wg * 64 * T::kRowBytes;
  const float* lse_bh = a.lse + bh * a.lse_ld;
  const float* delta_bh = a.delta + bh * a.lse_ld;
  float dk[D / 2], dv[D / 2], st[32], dpt[32], mk[32];
  uint32_t p_hi[4][4], p_lo[4][4], s_hi[4][4], s_lo[4][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    tile_landed();
    if (j + 1 < n_tiles) stage(j + 1);
    cp_async_commit();
    if (!active) continue;
    const uint32_t qt = q_tile(j % kStages), gt = qt + T::kTileBytes;
    const int q0 = j * kTile;
    wgmma_fence();
    product_nt<D>(st, ka, qt);
    product_nt<D>(dpt, va, gt);
    wgmma_commit();
    // st[4i + e] is key r0 + 8 (e / 2), query q0 + 8i + 2t + e % 2: the
    // mask's entry [query, key]; -inf where either is >= L
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qr = q0 + 8 * i + 2 * t + (e & 1), kr = r0 + 8 * (e >> 1);
        mk[4 * i + e] =
            qr < L && kr < L
                ? __ldg(a.mask + static_cast<long long>(qr) * L + kr)
                : -INFINITY;
      }
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      // the statistics of queries q0 + 8i + 2t and + 1 (lse_ld is a
      // multiple of 64, so both lie in the rows' buffers)
      const int qr = q0 + 8 * i + 2 * t;
      const float2 ls = *reinterpret_cast<const float2*>(lse_bh + qr);
      const float2 dl = *reinterpret_cast<const float2*>(delta_bh + qr);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 4 * i + e;
        const bool ok = qr + (e & 1) < L;
        const float p =
            ok ? fast_exp2(fmaf(st[n], a.scale_log2, mk[n] * kLog2e) -
                           ((e & 1) ? ls.y : ls.x))
               : 0.f;
        dpt[n] = ok ? p * (dpt[n] - ((e & 1) ? dl.y : dl.x)) : 0.f;
        st[n] = p;
      }
    }
    pack_split(st, p_hi, p_lo);
    pack_split(dpt, s_hi, s_lo);
    wgmma_fence();
    product_split<D>(dv, p_hi, p_lo, gt);
    product_split<D>(dk, s_hi, s_lo, qt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
  }
  if (active) {
    store_rows<D>(a.dk + b * a.st[kDK][0] + h * a.st[kDK][2], a.st[kDK][1],
                  dk, a.scale, r0, t, L);
    store_rows<D>(a.dv + b * a.st[kDV][0] + h * a.st[kDV][2], a.st[kDV][1],
                  dv, 1.f, r0, t, L);
  }
}

template <int D>
cudaError_t launch(const BwdArgs& a, int B, int H, cudaStream_t stream) {
  constexpr int smem = BwdTile<D>::kSmem;
  // the shared-memory attribute, set at the first launch on each device
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev].load(std::memory_order_relaxed)) {
    if ((err = cudaFuncSetAttribute(
             attention_bwd_query<D>,
             cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
            cudaSuccess ||
        (err = cudaFuncSetAttribute(
             attention_bwd_key<D>,
             cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
            cudaSuccess)
      return err;
    ready[dev].store(true, std::memory_order_relaxed);
  }
  const dim3 grid((a.L + kRows - 1) / kRows, H, B);
  attention_bwd_query<D><<<grid, kThreads, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attention_bwd_key<D><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// bf16 with mmvid_attention_bwd's arguments (csrc/attention_bwd.cu); the
// caller has checked 16-byte aligned bases and row/head/batch strides that
// are multiples of 8, and lse_ld a multiple of 64 that is >= L.
cudaError_t attention_bwd_wgmma(int head_dim, const bwd::Args& args, int B,
                                cudaStream_t stream) {
  BwdArgs a;
  a.q = static_cast<const __nv_bfloat16*>(args.q);
  a.k = static_cast<const __nv_bfloat16*>(args.k);
  a.v = static_cast<const __nv_bfloat16*>(args.v);
  a.o = static_cast<const __nv_bfloat16*>(args.o);
  a.g = static_cast<const __nv_bfloat16*>(args.g);
  a.o_lo = static_cast<const __nv_bfloat16*>(args.o_lo);
  a.dq = static_cast<__nv_bfloat16*>(args.dq);
  a.dk = static_cast<__nv_bfloat16*>(args.dk);
  a.dv = static_cast<__nv_bfloat16*>(args.dv);
  a.mask = args.mask;
  a.lse = args.lse;
  a.delta = args.delta;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) a.st[i][j] = args.st[i][j];
  a.L = args.L;
  a.lse_ld = args.lse_ld;
  a.scale = args.scale;
  a.scale_log2 = args.scale * kLog2e;
  if (head_dim == 64) return launch<64>(a, B, args.H, stream);
  if (head_dim == 32) return launch<32>(a, B, args.H, stream);
  return cudaErrorInvalidValue;
}

}  // namespace mmvid
