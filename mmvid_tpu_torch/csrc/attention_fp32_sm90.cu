// Full-sequence self-attention in fp32 on Hopper's CUDA cores (sm_90a): the
// fp32 route of csrc/attention.cu's C entry point.  Every released recipe
// runs its model in fp32 (none passes --bf16), and the CLIP scorer's towers
// are fp32, so every attention call of those runs lands here.
//
// Replaces the TPU kernel mmvid_tpu/ops/attention.py::_make_packed_kernel
// for fp32 inputs and computes the function of
// mmvid_tpu_torch/ops/attention.py::attention_reference:
//
//     out[b, i, h, :] = softmax_j(scale * q[b,i,h,:] . k[b,j,h,:] + mask[i,j])
//                       @ v[b, :, h, :]
//
// with fp32 products, logits, softmax and accumulation (FFMA throughout:
// no TF32, which would change the arithmetic), q, k, v and out in the
// residual stream's [B, L, H*D] layout (strided: on every path q, k and v
// are views of one packed QKV projection), the mask an additive fp32
// [L, L] tensor.  The ragged L edge is masked, never padded.
//
// What bounds it on the H100: 4*L*L*D flops per (batch, head) against
// 4*L*D*4 bytes of q, k, v and out, so the fp32 pipes (operations: 0.234
// ms at B16 H12 L565 D64 and 0.290 ms at L629 at 67 TFLOP/s; the bytes,
// about 0.11 GB with the mask, take 0.033 ms).  The first fp32 kernel
// (commit f37e588's csrc/attention.cu) ran at about 1 FFMA per shared-
// memory load and reread K, V and the mask from L2 for every 64 queries;
// it took 5.9x the bound.
//
// Design:
// - one block of 256 threads per (query tile, head, batch), one block an
//   SM; a thread is one of 16 row groups x 16 column groups and owns R
//   query rows (rg + 16 i) of the tile, so the tile is 16 R rows: R = 8
//   (128 rows), 6 or 4 (96, 64), chosen by shape (fp32_tile_rows below:
//   the grid's waves against the rows a block pads);
// - a register micro-tile per thread: R rows x 4 keys (cg + 16 j) of each
//   64-key tile of S, and R rows x D / 16 adjacent head dims of O.  q and
//   k are read as float4 along D from padded row-major shared tiles (row
//   stride D + 4 floats: the 16 keys of a load fall in distinct banks), so
//   a step of 4 dims costs R + 4 16-byte loads for 16 R FFMAs; P.V reads
//   P as float4 along the keys and V as D / 16 floats a key;
// - q is scaled in fp32 as it is loaded (q * scale, as the plain version
//   rounds it) and kept in shared memory for the whole key loop;
// - K and V of each key tile are staged by cp.async (16 bytes a thread;
//   keys >= L zero-filled by the source size) into a 2-stage ring: tile
//   j + 1 lands while tile j is computed, one __syncthreads a tile (a
//   third stage gained nothing);
// - the mask is read by each thread from L2 into registers, its R x 4
//   entries of the next tile issued right after this tile's softmax, so
//   P.V and the next Q.K^T cover their latency.  Staging the block's mask
//   rows in shared memory (by cp.async, then by one bulk copy a row) was
//   slower (PERF.md);
// - the online softmax in fp32: the row max over a tile by warp shuffles
//   across the 16 lanes that share a row (a row's threads are lanes of
//   one warp), exp2 (MUFU.EX2, results below 2^-126 flushed to 0) with
//   log2(e) folded into one FFMA, the running max, a per-thread partial
//   row sum and the accumulator rescaled per tile; the partial sums meet
//   by shuffles at the end;
// - P goes through shared memory: the rows of a warp are its own, so a
//   __syncwarp orders P's writes before the P.V reads.  kBf16Probs
//   (MMVID_ATTN_BF16=1) rounds P to bf16 there; the row sums stay fp32.
// What sets its pace on the card (mmvid_tpu_torch/attribution.py, PERF.md):
// the FFMAs and the 16-byte shared loads that feed them, about 80% of the
// issued instructions; the rest is the softmax, the copies' waits, and
// the last partial wave of blocks.
//
// With grad on (lse given) the epilogue also writes each row's log-sum-exp
// in base 2, the backward's (csrc/attention_bwd_fp32_sm90.cu) statistics.
//
// A key >= L gets logit -inf; a query row >= L computes on zero q and row
// q0's mask and is never stored.  A first tile that the mask wholly masks
// (-1e9) is forgotten when a later tile raises the row max (alpha = 0), as
// in the bf16 route.

#include <atomic>

#include "sm90.cuh"

namespace mmvid {
namespace {

using sm90::cp_async16;
using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::smem_addr;

constexpr int kMaxDevices = 64;
constexpr int kCols = 16;              // column groups: the lanes of a row
constexpr int kRowGroups = 16;         // row groups
constexpr int kThreads = kRowGroups * kCols;
constexpr int kBK = 64;                // keys a tile
constexpr int kKPT = kBK / kCols;      // keys a thread of each tile
constexpr int kStages = 2;              // the K/V ring
constexpr float kLog2e = 1.4426950408889634f;

template <int D, int R>
struct Fp32Tile {
  static constexpr int kBQ = kRowGroups * R;  // query rows a block
  // row strides (floats): q, k and P padded so that the rows or keys of a
  // warp's 16-byte loads fall in distinct banks
  static constexpr int kQS = D + 4;
  static constexpr int kKS = D + 4;
  static constexpr int kVS = D;
  static constexpr int kPS = kBK + 4;
  static constexpr int kQ = kBQ * kQS;  // floats of each buffer
  static constexpr int kK = kBK * kKS;
  static constexpr int kV = kBK * kVS;
  static constexpr int kP = kBQ * kPS;
  static constexpr int kStage = kK + kV;
  static constexpr int kSmem = (kQ + kStages * kStage + kP) * 4;
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
// 2^x with the result's subnormals flushed to 0 (one MUFU.EX2, no range
// handling): a probability below 2^-126 of the row's largest, 1, adds
// nothing to the row's fp32 sums
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float4 vdiv(const float (&o)[4], float l) {
  return make_float4(o[0] / l, o[1] / l, o[2] / l, o[3] / l);
}
__device__ __forceinline__ float2 vdiv(const float (&o)[2], float l) {
  return make_float2(o[0] / l, o[1] / l);
}

template <int D, int R, bool kBf16Probs>
__global__ void __launch_bounds__(kThreads, 1)
attention_fwd_kernel_fp32_sm90(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ mask,
    float* __restrict__ out, int L, long long sqb, long long sql,
    long long sqh, long long skb, long long skl, long long skh,
    long long svb, long long svl, long long svh, long long sob,
    long long sol, long long soh, float* __restrict__ lse, int lse_ld,
    float scale) {
  using T = Fp32Tile<D, R>;
  constexpr int kDPT = D / kCols;     // output dims a thread
  constexpr int kChunks = D / 4;      // 16-byte chunks of a q, k, v row
  constexpr int kPass = kThreads / kChunks;  // K/V rows a copy pass
  using VecD = typename VecF<kDPT>::T;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ps = smem + T::kQ + kStages * T::kStage;

  const int tid = threadIdx.x;
  const int rg = tid / kCols, cg = tid % kCols;
  const int q0 = blockIdx.x * T::kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const float* qb = q + b * sqb + h * sqh;
  const float* kb = k + b * skb + h * skh;
  const float* vb = v + b * svb + h * svh;
  float* ob = out + b * sob + h * soh;
  const int n_tiles = (L + kBK - 1) / kBK;

  auto k_tile = [&](int s) { return smem + T::kQ + s * T::kStage; };
  auto v_tile = [&](int s) { return k_tile(s) + T::kK; };

  // key tile j's K and V rows into stage s: this thread's 16-byte chunk
  // kv_ch of rows kv_c, kv_c + kPass, ...; keys >= L zero-filled
  const int kv_c = tid / kChunks, kv_ch = tid % kChunks;
  auto stage_tile = [&](int j, int s) {
    const int k0 = j * kBK;
    float* kd = k_tile(s) + kv_c * T::kKS + 4 * kv_ch;
    float* vd = v_tile(s) + kv_c * T::kVS + 4 * kv_ch;
#pragma unroll
    for (int n = 0; n < kBK / kPass; ++n) {
      const int key = k0 + kv_c + kPass * n;
      const long long row = key < L ? key : 0;
      const int bytes = key < L ? 16 : 0;
      cp_async16(smem_addr(kd + kPass * n * T::kKS),
                 kb + row * skl + 4 * kv_ch, bytes);
      cp_async16(smem_addr(vd + kPass * n * T::kVS),
                 vb + row * svl + 4 * kv_ch, bytes);
    }
  };

  // this thread's mask entries of the next key tile, read from L2 into
  // registers a tile ahead of their use: row pointers advanced a tile at a
  // time (a row >= L reads row q0: never stored)
  const float* mrow[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + rg + kRowGroups * i;
    mrow[i] = mask + static_cast<long long>(row < L ? row : q0) * L + cg;
  }
  float mk[R][kKPT];
  auto load_mask = [&](int j) {
    const int k0 = j * kBK;
#pragma unroll
    for (int c = 0; c < kKPT; ++c) {
      const bool ok = k0 + cg + kCols * c < L;
#pragma unroll
      for (int i = 0; i < R; ++i)
        mk[i][c] = ok ? __ldg(mrow[i] + kCols * c) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) mrow[i] += kBK;
  };

  // the ring's first tiles, a group of copies each (a group, if empty,
  // past the last tile, so that a wait counts tiles)
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_tiles) stage_tile(j, j);
    cp_async_commit();
  }
  load_mask(0);
  // the block's queries, scaled in fp32; rows >= L zero
  for (int i = tid; i < T::kBQ * kChunks; i += kThreads) {
    const int r = i / kChunks, ch = i % kChunks, row = q0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < L) {
      x = *reinterpret_cast<const float4*>(qb + row * sql + 4 * ch);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    *reinterpret_cast<float4*>(qs + r * T::kQS + 4 * ch) = x;
  }

  float o[R][kDPT];
  float m_run[R], l_run[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int e = 0; e < kDPT; ++e) o[i][e] = 0.f;
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }

  for (int j = 0, s = 0; j < n_tiles; ++j, s = s + 1 < kStages ? s + 1 : 0) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile j landed
    // every thread's copies of tile j landed, and every thread is done
    // with tile j - 1: its stage takes tile j + kStages - 1, the P rows
    // tile j's
    __syncthreads();
    const int ahead = j + kStages - 1;
    if (ahead < n_tiles)
      stage_tile(ahead, s == 0 ? kStages - 1 : s - 1);
    cp_async_commit();

    // S = (scale q) . k: R rows x 4 keys, d in order, one FFMA each
    float sc[R][kKPT];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < kKPT; ++c) sc[i][c] = 0.f;
    const float* kt = k_tile(s);
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      float4 qv[R], kv[kKPT];
#pragma unroll
      for (int i = 0; i < R; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            qs + (rg + kRowGroups * i) * T::kQS + d);
#pragma unroll
      for (int c = 0; c < kKPT; ++c)
        kv[c] = *reinterpret_cast<const float4*>(
            kt + (cg + kCols * c) * T::kKS + d);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < kKPT; ++c) {
          sc[i][c] = fmaf(qv[i].x, kv[c].x, sc[i][c]);
          sc[i][c] = fmaf(qv[i].y, kv[c].y, sc[i][c]);
          sc[i][c] = fmaf(qv[i].z, kv[c].z, sc[i][c]);
          sc[i][c] = fmaf(qv[i].w, kv[c].w, sc[i][c]);
        }
    }

    // logits, the running max and sum, P
    const int k0 = j * kBK;
    float alpha[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kKPT; ++c) {
        const int key = k0 + cg + kCols * c;
        const float x = key < L ? sc[i][c] + mk[i][c] : -INFINITY;
        sc[i][c] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < kCols; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const float m_log2 = m_new * kLog2e;
      alpha[i] = exp2_ftz(fmaf(m_run[i], kLog2e, -m_log2));  // 0 on tile 0
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < kKPT; ++c) {
        const float p = exp2_ftz(fmaf(sc[i][c], kLog2e, -m_log2));
        sc[i][c] = p;
        psum += p;
      }
      l_run[i] = fmaf(l_run[i], alpha[i], psum);
      m_run[i] = m_new;
    }
    if (j + 1 < n_tiles) load_mask(j + 1);
    // P: the rows of a warp are its own
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < kKPT; ++c)
        ps[(rg + kRowGroups * i) * T::kPS + cg + kCols * c] =
            kBf16Probs ? __bfloat162float(__float2bfloat16(sc[i][c]))
                       : sc[i][c];
    __syncwarp();  // the warp's P is visible to its lanes

    // O = alpha O + P.V, keys in order
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int e = 0; e < kDPT; ++e) o[i][e] *= alpha[i];
    const float* vt = v_tile(s);
#pragma unroll 4
    for (int c = 0; c < kBK; c += 4) {
      float4 pv[R];
      VecD vv[4];
#pragma unroll
      for (int i = 0; i < R; ++i)
        pv[i] = *reinterpret_cast<const float4*>(
            ps + (rg + kRowGroups * i) * T::kPS + c);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        vv[u] = *reinterpret_cast<const VecD*>(vt + (c + u) * T::kVS +
                                               cg * kDPT);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int e = 0; e < kDPT; ++e)
            o[i][e] = fmaf(vget(pv[i], u), vget(vv[u], e), o[i][e]);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    float l = l_run[i];
#pragma unroll
    for (int off = 1; off < kCols; off <<= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    const int row = q0 + rg + kRowGroups * i;
    if (row < L)
      *reinterpret_cast<VecD*>(ob + row * sol + cg * kDPT) = vdiv(o[i], l);
    // the row's log-sum-exp in base 2 for the backward (grad on): P =
    // 2^(log2(e) (scale q.k + mask) - lse)
    if (lse != nullptr && cg == 0 && row < L)
      lse[(static_cast<long long>(b) * gridDim.y + h) * lse_ld + row] =
          fmaf(m_run[i], kLog2e, log2f(l));
  }
}

template <int D, int R, bool kBf16Probs>
cudaError_t launch(int dev, const void* q, const void* k, const void* v,
                   const float* mask, void* out, float* lse, int lse_ld,
                   int B, int L, int H, const long long* st, float scale,
                   cudaStream_t stream) {
  using T = Fp32Tile<D, R>;
  auto* kernel = attention_fwd_kernel_fp32_sm90<D, R, kBf16Probs>;
  // the shared-memory attribute, set at the first launch on each device
  static std::atomic<bool> ready[kMaxDevices];
  if (!ready[dev].load(std::memory_order_relaxed)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (err != cudaSuccess) return err;
    ready[dev].store(true, std::memory_order_relaxed);
  }
  const dim3 grid((L + T::kBQ - 1) / T::kBQ, H, B);
  kernel<<<grid, kThreads, T::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), mask, static_cast<float*>(out), L, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], lse, lse_ld, scale);
  return cudaGetLastError();
}

// The kernel's query tiles, in rows a thread: 128, 96 and 64 rows.
constexpr int kTileRows[] = {8, 6, 4};

// The tile for B x H heads of L queries on `sms` SMs (one block an SM):
// the least modelled time, waves of the grid x a block's work, its rows
// plus 20 (the loads, softmax and syncs that do not shrink with the
// tile); ties go to the larger tile.
int fp32_tile_rows(int B, int L, int H, int sms) {
  int best = kTileRows[0];
  long long best_cost = 0;
  for (int R : kTileRows) {
    const long long bq = kRowGroups * R;
    const long long blocks = (L + bq - 1) / bq * static_cast<long long>(H) * B;
    const long long cost = (blocks + sms - 1) / sms * (bq + 20);
    if (R == kTileRows[0] || cost < best_cost) {
      best = R;
      best_cost = cost;
    }
  }
  return best;
}

template <int D, bool kBf16Probs>
cudaError_t launch_rows(int rows, int dev, const void* q, const void* k,
                        const void* v, const float* mask, void* out,
                        float* lse, int lse_ld, int B, int L, int H,
                        const long long* st, float scale,
                        cudaStream_t stream) {
  switch (rows) {
    case 8:
      return launch<D, 8, kBf16Probs>(dev, q, k, v, mask, out, lse, lse_ld,
                                      B, L, H, st, scale, stream);
    case 6:
      return launch<D, 6, kBf16Probs>(dev, q, k, v, mask, out, lse, lse_ld,
                                      B, L, H, st, scale, stream);
    case 4:
      return launch<D, 4, kBf16Probs>(dev, q, k, v, mask, out, lse, lse_ld,
                                      B, L, H, st, scale, stream);
  }
  return cudaErrorInvalidValue;
}

// the device's SM count (queried once a device)
cudaError_t sm_count(int* dev, int* sms) {
  static std::atomic<int> count[kMaxDevices];
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev >= kMaxDevices) return cudaErrorInvalidDevice;
  *sms = count[*dev].load(std::memory_order_relaxed);
  if (*sms == 0) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *dev);
    if (err != cudaSuccess) return err;
    count[*dev].store(*sms, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

cudaError_t launch_at(int rows, int dev, int head_dim, bool bf16_probs,
                      const void* q, const void* k, const void* v,
                      const float* mask, void* out, float* lse, int lse_ld,
                      int B, int L, int H, const long long* strides,
                      float scale, cudaStream_t stream) {
  if (head_dim != 64 && head_dim != 32) return cudaErrorInvalidValue;
  using Launch = decltype(&launch_rows<64, false>);
  const Launch fns[2][2] = {{launch_rows<32, false>, launch_rows<32, true>},
                            {launch_rows<64, false>, launch_rows<64, true>}};
  return fns[head_dim == 64][bf16_probs](rows, dev, q, k, v, mask, out, lse,
                                         lse_ld, B, L, H, strides, scale,
                                         stream);
}

}  // namespace

// fp32 q, k, v, out with the C entry's arguments (csrc/attention.cu); the
// caller has checked 16-byte aligned bases of q, k, v and the mask, and
// batch, row and head strides that are multiples of 4.  The tile by
// shape (fp32_tile_rows).  lse: null, or [B, H, lse_ld] fp32 that takes
// each row's log-sum-exp in base 2 (the backward's row statistics).
cudaError_t attention_fp32(int head_dim, bool bf16_probs, const void* q,
                           const void* k, const void* v, const float* mask,
                           void* out, float* lse, int lse_ld, int B, int L,
                           int H, const long long* strides, float scale,
                           cudaStream_t stream) {
  int dev = 0, sms = 0;
  const cudaError_t err = sm_count(&dev, &sms);
  if (err != cudaSuccess) return err;
  return launch_at(fp32_tile_rows(B, L, H, sms), dev, head_dim, bf16_probs,
                   q, k, v, mask, out, lse, lse_ld, B, L, H, strides, scale,
                   stream);
}

}  // namespace mmvid

// The rows a thread of the query tile (the tile is 16 x that) that the
// fp32 route takes for B x H heads of L queries on the current device, or
// -1 on a CUDA error.  For the tests and the attribution script.
extern "C" int mmvid_attention_fp32_rows(int B, int L, int H) {
  int dev = 0, sms = 0;
  if (mmvid::sm_count(&dev, &sms) != cudaSuccess) return -1;
  return mmvid::fp32_tile_rows(B, L, H, sms);
}

// The fp32 kernel at a given tile (rows a thread: 8, 6 or 4), with
// mmvid_attention_fwd's other arguments and checks, for the card tests
// (every tile against the plain version) and the attribution script (the
// tiles timed at each shape).  The route itself is mmvid_attention_fwd.
extern "C" int mmvid_attention_fp32_at(int rows, int head_dim,
                                       int bf16_probs, const void* q,
                                       const void* k, const void* v,
                                       const void* mask, void* out, int B,
                                       int L, int H, const long long* strides,
                                       float scale, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  const cudaError_t err = mmvid::sm_count(&dev, &sms);
  if (err != cudaSuccess) return err;
  return mmvid::launch_at(rows, dev, head_dim, bf16_probs != 0, q, k, v,
                          static_cast<const float*>(mask), out, nullptr, 0, B,
                          L, H, strides, scale,
                          static_cast<cudaStream_t>(stream));
}
