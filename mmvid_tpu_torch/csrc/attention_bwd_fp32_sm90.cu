// Attention's backward in fp32 on Hopper's CUDA cores (sm_90a): the fp32
// route of csrc/attention.cu's mmvid_attention_bwd.  Every released recipe
// trains in fp32 (none passes --bf16), and so do the text_augment recipe
// and the tiny training steps, so each of their backward calls lands here.
//
// Replaces the backward of the TPU kernel's custom_vjp,
// mmvid_tpu/ops/attention.py::_fused_attention_bwd (JAX's XLA VJP of
// _attention_xla), and computes the function of mmvid_tpu_torch/ops/
// attention.py::attention_backward (the formulas in
// csrc/attention_bwd_sm90.cu's header) with fp32 products, softmax and
// sums: FFMA throughout, no TF32, as the fp32 forward
// (csrc/attention_fp32_sm90.cu) and JAX's fp32 einsums.
//
// Row statistics, as the bf16 route: the forward kernel writes each row's
// log-sum-exp in base 2 when grad is on, and delta_i = G_i . O_i from the
// forward's fp32 output O.
//
// Three launches, no atomics (two calls give equal bits):
// 1. delta (attention_bwd_fp32_delta): G . O of every row, 16 lanes a
//    row, into [B, H, lse_ld];
// 2. the key pass (attention_bwd_fp32_key): one block of 256 threads per
//    128 keys, head and batch, over 64-query tiles.  A thread is one of 16
//    row groups (rg) x 16 column groups (cg).  S (q . k, times scale in
//    fp32) and dP = G.V^T as 4 query rows (rg + 16 i) x 8 keys (cg + 16 c)
//    register micro-tiles, so each thread's mask reads run along the keys
//    of a row, as in the forward; P = 2^(x - lse) and dS into shared
//    memory; one __syncthreads; then dV += P^T.G and dK += dS^T.Q on 8
//    adjacent keys (8 rg + i) x D / 16 dims a thread (P and dS read as
//    float4 along the keys), and the tile's dQ partial, dS.K over the
//    block's 128 keys, on 4 query rows x D / 16 dims a thread, stored to
//    a scratch of [key blocks, B, H, L, D];
// 3. dQ (attention_bwd_fp32_dq): scale x the partials summed in key-block
//    order.
// So S and dP are computed once: the five products of the backward.  The
// first form of this route took a query pass of its own for dQ (S and dP
// again, seven products): 2.3521 ms at B16 H12 L565 D64 mask_prev, behind
// SDPA's fp32 forward and backward, 1.9723 ms (PERF.md; an H100 80GB HBM3
// at 700 W).  The partials cost 2 x 5 x B L H D x 4 bytes at L565 (0.28
// GB, 0.08 ms at the memory's rate), less than two products on the CUDA
// cores.
//
// What bounds it on the H100: the five products, 10 B H L^2 D flops at the
// fp32 pipes' 67 TFLOP/s, 0.586 ms at B16 H12 L565 D64.  As in the fp32
// forward, q, k, v and g are read as float4 along D from padded row-major
// shared tiles (row stride D + 4 floats: the keys or rows of a warp's
// 16-byte loads fall in distinct banks); the Q/G tiles are staged by
// cp.async in a 2-stage ring, one tile landing while the other is
// computed; the mask is read by each thread from L2 into registers a tile
// ahead of its use.
//
// A key or query >= L: zero rows, P and dS 0, never stored.  Rows whose
// first key tile the mask wholly masks get P = 2^(-1.4e9 - lse) = 0 there.

#include <atomic>

#include "sm90.cuh"

namespace mmvid {
namespace {

using sm90::cp_async16;
using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::smem_addr;

constexpr int kMaxDevices = 64;
constexpr int kCols = 16;             // column groups
constexpr int kRowGroups = 16;        // row groups
constexpr int kThreads = kRowGroups * kCols;
constexpr int kBlock = 128;           // keys a block of the key pass
constexpr int kBK = 64;               // queries of a streamed tile
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

// What the launches read and write (strides in elements: batch, row, head
// of q, k, v, o, g, dq, dk, dv)
struct Fp32BwdArgs {
  const float *q, *k, *v, *o, *g;
  float *dq, *dk, *dv;
  const float* mask;
  const float* lse;  // [B, H, lse_ld], base 2
  float* delta;      // [B, H, lse_ld]: written by launch 1
  float* part;       // [key blocks, B, H, L, D]: dQ's partials
  long long st[8][3];
  int L, H, lse_ld;
  float scale;
};
enum { kQ, kK, kV, kO, kG, kDQ, kDK, kDV };

template <int D>
struct Fp32BwdTile {
  static constexpr int kS = D + 4;          // padded row stride (floats)
  static constexpr int kOwn = kBlock * kS;  // the block's K or V
  static constexpr int kTile = kBK * kS;    // one streamed Q or G tile
  static constexpr int kStage = 2 * kTile;
  // P and dS of a tile, [64 queries][128 keys]
  static constexpr int kPS = kBlock + 4;
  static constexpr int kSmem =
      (2 * kOwn + kStages * kStage + 2 * kBK * kPS) * 4;
};

template <int N>
struct VecF;
template <>
struct VecF<4> {
  using T = float4;
};
template <>
struct VecF<2> {
  using T = float2;
};
__device__ __forceinline__ float vget(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}
__device__ __forceinline__ float vget(const float2& x, int i) {
  return i == 0 ? x.x : x.y;
}
__device__ __forceinline__ float4 to_vec(const float (&x)[4]) {
  return make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ float2 to_vec(const float (&x)[2]) {
  return make_float2(x[0], x[1]);
}
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// This thread's part of copying kBK rows of D floats (row i at src + i *
// stride) into a padded tile at dst, rows >= valid zero-filled
template <int D>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          long long stride, int valid,
                                          int tid) {
  constexpr int kChunks = D / 4, kPass = kThreads / kChunks;
  const int c = tid / kChunks, ch = tid % kChunks;
#pragma unroll
  for (int n = 0; n < kBK / kPass; ++n) {
    const int r = c + kPass * n;
    const bool ok = r < valid;
    cp_async16(smem_addr(dst + r * Fp32BwdTile<D>::kS + 4 * ch),
               src + (ok ? r : 0) * stride + 4 * ch, ok ? 16 : 0);
  }
}

// kBlock rows of D floats times f into a padded tile, rows >= valid zero
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long stride, int valid,
                                          float f, int tid) {
  constexpr int kChunks = D / 4;
  for (int i = tid; i < kBlock * kChunks; i += kThreads) {
    const int r = i / kChunks, ch = i % kChunks;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) {
      x = *reinterpret_cast<const float4*>(src + r * stride + 4 * ch);
      x.x *= f;
      x.y *= f;
      x.z *= f;
      x.w *= f;
    }
    *reinterpret_cast<float4*>(dst + r * Fp32BwdTile<D>::kS + 4 * ch) = x;
  }
}

// acc[i][c] += a[rows ra + 16 i] . b[rows rb + 16 c] over D, both padded
// tiles, d in order
template <int D, int NA, int NB>
__device__ __forceinline__ void micro_product(float (&acc)[NA][NB],
                                              const float* a, int ra,
                                              const float* b, int rb) {
  constexpr int kS = Fp32BwdTile<D>::kS;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    float4 av[NA], bv[NB];
#pragma unroll
    for (int i = 0; i < NA; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ra + 16 * i) * kS + d);
#pragma unroll
    for (int c = 0; c < NB; ++c)
      bv[c] = *reinterpret_cast<const float4*>(b + (rb + 16 * c) * kS + d);
#pragma unroll
    for (int i = 0; i < NA; ++i)
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        acc[i][c] = fmaf(av[i].x, bv[c].x, acc[i][c]);
        acc[i][c] = fmaf(av[i].y, bv[c].y, acc[i][c]);
        acc[i][c] = fmaf(av[i].z, bv[c].z, acc[i][c]);
        acc[i][c] = fmaf(av[i].w, bv[c].w, acc[i][c]);
      }
  }
}

// delta = G . O of each row (b, l, h): 16 lanes a row, D / 16 dims a
// lane, summed over the lanes by shuffles
template <int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_fp32_delta(const Fp32BwdArgs a, int B) {
  constexpr int kDPT = D / kCols;
  using VecD = typename VecF<kDPT>::T;
  const int L = a.L, H = a.H;
  const long long r = static_cast<long long>(blockIdx.x) * kRowGroups +
                      threadIdx.x / kCols;
  const int cg = threadIdx.x % kCols;
  const bool ok = r < static_cast<long long>(B) * L * H;
  const int h = ok ? static_cast<int>(r % H) : 0;
  const int l = ok ? static_cast<int>(r / H % L) : 0;
  const int b = ok ? static_cast<int>(r / H / L) : 0;
  float s = 0.f;
  if (ok) {
    const VecD gv = *reinterpret_cast<const VecD*>(
        a.g + b * a.st[kG][0] + l * a.st[kG][1] + h * a.st[kG][2] +
        cg * kDPT);
    const VecD ov = *reinterpret_cast<const VecD*>(
        a.o + b * a.st[kO][0] + l * a.st[kO][1] + h * a.st[kO][2] +
        cg * kDPT);
#pragma unroll
    for (int e = 0; e < kDPT; ++e) s = fmaf(vget(gv, e), vget(ov, e), s);
  }
#pragma unroll
  for (int off = 1; off < kCols; off <<= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (ok && cg == 0)
    a.delta[(static_cast<long long>(b) * H + h) * a.lse_ld + l] = s;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_fp32_key(const Fp32BwdArgs a) {
  using T = Fp32BwdTile<D>;
  constexpr int RQ = kBK / kRowGroups;     // 4 query rows a thread of S
  constexpr int KC = kBlock / kCols;       // 8 keys a thread of S
  constexpr int RK = kBlock / kRowGroups;  // 8 keys a thread of dK, dV
  constexpr int kDPT = D / kCols;
  using VecD = typename VecF<kDPT>::T;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = smem + T::kOwn;
  auto q_tile = [&](int s) { return smem + 2 * T::kOwn + s * T::kStage; };
  float* p_s = smem + 2 * T::kOwn + kStages * T::kStage;
  float* ds_s = p_s + kBK * T::kPS;

  const int tid = threadIdx.x, L = a.L;
  const int rg = tid / kCols, cg = tid % kCols;
  const int k0 = blockIdx.x * kBlock, h = blockIdx.y, b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * gridDim.y + h;
  auto at = [&](const float* p, int which) {
    return p + b * a.st[which][0] + h * a.st[which][2];
  };
  const float *qb = at(a.q, kQ), *kb = at(a.k, kK), *vb = at(a.v, kV),
              *gb = at(a.g, kG);
  const long long sql = a.st[kQ][1], sgl = a.st[kG][1];
  // this block's dQ partials, [L, D] rows of (key block, b, h)
  float* part = a.part +
                ((static_cast<long long>(blockIdx.x) * gridDim.z + b) *
                     gridDim.y + h) * L * D;
  const int n_tiles = (L + kBK - 1) / kBK;
  auto stage = [&](int j) {
    const int q0 = j * kBK;
    copy_rows<D>(q_tile(j % kStages), qb + q0 * sql, sql, L - q0, tid);
    copy_rows<D>(q_tile(j % kStages) + T::kTile, gb + q0 * sgl, sgl, L - q0,
                 tid);
  };
  stage(0);
  cp_async_commit();

  // the mask entries [query rg + 16 i, key k0 + cg + 16 c] of the next
  // query tile, a tile ahead (-1e9 for queries or keys >= L: P is forced
  // to 0 there anyway)
  float mk[RQ][KC];
  auto load_mask = [&](int j) {
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qr = j * kBK + rg + kRowGroups * i;
      const float* m = a.mask + static_cast<long long>(qr) * L + k0 + cg;
#pragma unroll
      for (int c = 0; c < KC; ++c)
        mk[i][c] = qr < L && k0 + cg + kCols * c < L ? __ldg(m + kCols * c)
                                                     : -1e9f;
    }
  };
  load_mask(0);
  load_rows<D>(ks, kb + k0 * a.st[kK][1], a.st[kK][1], L - k0, 1.f, tid);
  load_rows<D>(vs, vb + k0 * a.st[kV][1], a.st[kV][1], L - k0, 1.f, tid);

  float dk[RK][kDPT], dv[RK][kDPT];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int e = 0; e < kDPT; ++e) dk[i][e] = dv[i][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<0>();
    // tile j (and k, v) landed for every thread; every thread is done
    // with tile j - 1, P and dS
    __syncthreads();
    if (j + 1 < n_tiles) stage(j + 1);
    cp_async_commit();
    const float* qt = q_tile(j % kStages);
    const float* gt = qt + T::kTile;
    const int q0 = j * kBK;
    {
      float lse[RQ], dl[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int qr = q0 + rg + kRowGroups * i;
        lse[i] = qr < L ? __ldg(a.lse + bh * a.lse_ld + qr) : 0.f;
        dl[i] = qr < L ? __ldg(a.delta + bh * a.lse_ld + qr) : 0.f;
      }
      float sc[RQ][KC], dp[RQ][KC];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < KC; ++c) sc[i][c] = dp[i][c] = 0.f;
      micro_product<D, RQ, KC>(sc, qt, rg, ks, cg);
      micro_product<D, RQ, KC>(dp, gt, rg, vs, cg);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          const bool ok =
              q0 + rg + kRowGroups * i < L && k0 + cg + kCols * c < L;
          const float p =
              ok ? exp2_ftz(fmaf(fmaf(sc[i][c], a.scale, mk[i][c]), kLog2e,
                                 -lse[i]))
                 : 0.f;
          const int n = (rg + kRowGroups * i) * T::kPS + cg + kCols * c;
          p_s[n] = p;
          ds_s[n] = p * (dp[i][c] - dl[i]);
        }
    }
    if (j + 1 < n_tiles) load_mask(j + 1);
    __syncthreads();  // P and dS of the whole tile are visible
    // dV += P^T . G, dK += dS^T . Q: keys 8 rg + i, queries in order
#pragma unroll 2
    for (int qr = 0; qr < kBK; ++qr) {
      const VecD gv =
          *reinterpret_cast<const VecD*>(gt + qr * T::kS + cg * kDPT);
      const VecD qv =
          *reinterpret_cast<const VecD*>(qt + qr * T::kS + cg * kDPT);
      const float* pr = p_s + qr * T::kPS + RK * rg;
      const float* sr = ds_s + qr * T::kPS + RK * rg;
      float pv[RK], sv[RK];
#pragma unroll
      for (int u = 0; u < RK; u += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(pr + u);
        const float4 s4 = *reinterpret_cast<const float4*>(sr + u);
        pv[u] = p4.x, pv[u + 1] = p4.y, pv[u + 2] = p4.z, pv[u + 3] = p4.w;
        sv[u] = s4.x, sv[u + 1] = s4.y, sv[u + 2] = s4.z, sv[u + 3] = s4.w;
      }
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int e = 0; e < kDPT; ++e) {
          dv[i][e] = fmaf(pv[i], vget(gv, e), dv[i][e]);
          dk[i][e] = fmaf(sv[i], vget(qv, e), dk[i][e]);
        }
    }
    // the tile's dQ partial, dS . K over the block's keys in order: query
    // rows rg + 16 i, dims cg D / 16
    float dq[RQ][kDPT];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int e = 0; e < kDPT; ++e) dq[i][e] = 0.f;
#pragma unroll 2
    for (int c = 0; c < kBlock; c += 4) {
      float4 sv[RQ];
      VecD kv[4];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        sv[i] = *reinterpret_cast<const float4*>(
            ds_s + (rg + kRowGroups * i) * T::kPS + c);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        kv[u] = *reinterpret_cast<const VecD*>(ks + (c + u) * T::kS +
                                               cg * kDPT);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int e = 0; e < kDPT; ++e)
            dq[i][e] = fmaf(vget(sv[i], u), vget(kv[u], e), dq[i][e]);
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qr = q0 + rg + kRowGroups * i;
      if (qr < L)
        *reinterpret_cast<VecD*>(part + static_cast<long long>(qr) * D +
                                 cg * kDPT) = to_vec(dq[i]);
    }
  }
  float* dkb = a.dk + b * a.st[kDK][0] + h * a.st[kDK][2];
  float* dvb = a.dv + b * a.st[kDV][0] + h * a.st[kDV][2];
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int key = k0 + RK * rg + i;
    if (key < L) {
      float x[kDPT];
#pragma unroll
      for (int e = 0; e < kDPT; ++e) x[e] = dk[i][e] * a.scale;
      *reinterpret_cast<VecD*>(dkb + key * a.st[kDK][1] + cg * kDPT) =
          to_vec(x);
      *reinterpret_cast<VecD*>(dvb + key * a.st[kDV][1] + cg * kDPT) =
          to_vec(dv[i]);
    }
  }
}

// dq = scale x the partials of the key blocks, summed in block order: a
// thread per 4 elements of a row (b, l, h)
template <int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_fp32_dq(const Fp32BwdArgs a, int B, int blocks) {
  const long long n = static_cast<long long>(B) * a.H * a.L * (D / 4);
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  // i = ((b H + h) L + l) (D / 4) + d4: the partials' own order
  const int d4 = static_cast<int>(i % (D / 4));
  const long long row = i / (D / 4);
  const int l = static_cast<int>(row % a.L);
  const int h = static_cast<int>(row / a.L % a.H);
  const int b = static_cast<int>(row / a.L / a.H);
  const long long step = static_cast<long long>(B) * a.H * a.L * D;
  const float* p = a.part + row * D + 4 * d4;
  float4 s = *reinterpret_cast<const float4*>(p);
  for (int kb = 1; kb < blocks; ++kb) {
    const float4 x = *reinterpret_cast<const float4*>(p + kb * step);
    s.x += x.x;
    s.y += x.y;
    s.z += x.z;
    s.w += x.w;
  }
  s.x *= a.scale;
  s.y *= a.scale;
  s.z *= a.scale;
  s.w *= a.scale;
  *reinterpret_cast<float4*>(a.dq + b * a.st[kDQ][0] + l * a.st[kDQ][1] +
                             h * a.st[kDQ][2] + 4 * d4) = s;
}

template <int D>
cudaError_t launch(const Fp32BwdArgs& a, int B, cudaStream_t stream) {
  using T = Fp32BwdTile<D>;
  // the shared-memory attribute, set at the first launch on each device
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev].load(std::memory_order_relaxed)) {
    if ((err = cudaFuncSetAttribute(
             attention_bwd_fp32_key<D>,
             cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem)) !=
        cudaSuccess)
      return err;
    ready[dev].store(true, std::memory_order_relaxed);
  }
  const long long rows = static_cast<long long>(B) * a.L * a.H;
  attention_bwd_fp32_delta<D>
      <<<static_cast<unsigned>((rows + kRowGroups - 1) / kRowGroups),
         kThreads, 0, stream>>>(a, B);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int blocks = (a.L + kBlock - 1) / kBlock;
  attention_bwd_fp32_key<D>
      <<<dim3(blocks, a.H, B), kThreads, T::kSmem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long n = rows * (D / 4);
  attention_bwd_fp32_dq<D>
      <<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0,
         stream>>>(a, B, blocks);
  return cudaGetLastError();
}

}  // namespace

// fp32 with mmvid_attention_bwd's arguments (csrc/attention.cu); the
// caller has checked 16-byte aligned bases and row/head/batch strides that
// are multiples of 4, lse_ld a multiple of 64 that is >= L, and scratch
// of ceil(L / kBlock) * B * H * L * D floats (dQ's partials, one
// [B, H, L, D] a block of kBlock keys).
cudaError_t attention_bwd_fp32(int head_dim, const void* const* ptrs,
                               const float* mask, const float* lse,
                               float* delta, float* scratch, int B, int L,
                               int H, int lse_ld, const long long* strides,
                               float scale, cudaStream_t stream) {
  Fp32BwdArgs a;
  a.q = static_cast<const float*>(ptrs[0]);
  a.k = static_cast<const float*>(ptrs[1]);
  a.v = static_cast<const float*>(ptrs[2]);
  a.o = static_cast<const float*>(ptrs[3]);
  a.g = static_cast<const float*>(ptrs[4]);
  a.dq = static_cast<float*>(const_cast<void*>(ptrs[5]));
  a.dk = static_cast<float*>(const_cast<void*>(ptrs[6]));
  a.dv = static_cast<float*>(const_cast<void*>(ptrs[7]));
  a.mask = mask;
  a.lse = lse;
  a.delta = delta;
  a.part = scratch;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) a.st[i][j] = strides[3 * i + j];
  a.L = L;
  a.H = H;
  a.lse_ld = lse_ld;
  a.scale = scale;
  if (scratch == nullptr) return cudaErrorInvalidValue;
  if (head_dim == 64) return launch<64>(a, B, stream);
  if (head_dim == 32) return launch<32>(a, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace mmvid
