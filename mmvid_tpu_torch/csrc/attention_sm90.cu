// Full-sequence self-attention for the MMVID backbone, bf16, on Hopper's
// tensor cores (wgmma), sm_90a.  The bf16 route of csrc/attention.cu's C
// entry point; its fp32 route is csrc/attention_fp32_sm90.cu.
//
// Replaces the TPU kernel mmvid_tpu/ops/attention.py::_make_packed_kernel
// (driven by fused_attention_blhd / _pallas_attention) and computes the
// function of mmvid_tpu_torch/ops/attention.py::attention_reference:
//
//     out[b, i, h, :] = softmax_j(scale * q[b,i,h,:] . k[b,j,h,:] + mask[i,j])
//                       @ v[b, :, h, :]
//
// q, k, v and out in the residual stream's [B, L, H*D] layout (strided: on
// the main path q, k and v are views of one packed QKV projection, a row
// stride of 3*H*D elements), the mask an additive fp32 [L, L] tensor.
//
// Numerics, those of the TPU kernel: S = Q.K^T with bf16 operands and fp32
// sums (exact products, as on the MXU), the scale applied to the fp32 S,
// the softmax in fp32.  By default the probabilities meet V in fp32 as in
// JAX: P is split as P_hi = bf16(P), P_lo = bf16(P - P_hi), and
// O += P_hi.V + P_lo.V, two tensor-core products on one V tile (P keeps
// about 16 significant bits; the outputs differ from the plain version's
// in about 0.2% of bf16 roundings).  kBf16Probs (MMVID_ATTN_BF16=1, JAX's
// bf16_av variant) takes P_hi alone.  The row sums are taken over the fp32
// P.  Online softmax over 64-key tiles, so the [L, L] logits never leave
// the registers; sums run in another order than the whole-row softmax.
//
// What bounds it on the H100: 4*L*L*D flops per (batch, head) against
// 2*L*D*2 bytes of K/V, so the tensor cores (operations: 0.0197 ms at
// B16 H12 L629 D64, 0.0170 ms at L565 counting one product of each kind;
// the split adds half again).  Besides, each block reads its 128 mask
// rows: B*H*L*L*4 bytes a call, 304 MB at L629, all from L2 (the mask is
// 1.6 MB), and K/V once a block, 155 MB.
//
// Design (the hopper-kernels guide, section 1, in a simple form):
// - one block per (128-query tile, head, batch): two consumer warpgroups
//   of 64 query rows each (the wgmma M) and one producer warpgroup;
// - the producers copy the Q tile once, then per 64-key tile the K and V
//   rows with cp.async (16 bytes a thread; rows >= L zero-filled) and the
//   block's 128 x 64 mask entries with one bulk copy a row
//   (cp.async.bulk), into a 3-stage ring in shared memory; a stage's
//   arrival is tracked by an mbarrier (cp.async.mbarrier.arrive.noinc for
//   the rows, the bulk copies' bytes) and its release by another.
//   cp.async, not TMA, for K/V: it takes the strided views as they are,
//   needs no tensor map encoded on the host at every call (by
//   cuTensorMapEncodeTiled, reached through an entry-point lookup), and
//   zero-fills the ragged edge by its source size.  The mask rows start
//   at any 4-byte offset (L is odd), which no TMA map of the [L, L] mask
//   can describe: a bulk copy of the 272 aligned bytes around each row's
//   64 floats.  One warp of producers copying K/V alone, and the
//   consumers reading the mask from L2 themselves, were each slower;
// - K/V rows are 2*D bytes, stored with the 128-byte (D 64) or 64-byte
//   (D 32) swizzle that the wgmma shared-memory descriptors name;
// - S = Q.K^T: wgmma m64n64k16, Q and K both K-major from shared memory;
// - the online softmax in registers on S's accumulator fragment: row max
//   over the quad of lanes that holds a row, exp2 with log2(e) folded into
//   the scale and the mask;
// - O += P.V: wgmma with A = P from registers (S's accumulator fragment,
//   rounded to bf16, is already A's register layout) and B = the V tile
//   from shared memory, MN-major (the transpose bit; V's D is contiguous);
//   N = D;
// - each consumer warpgroup pipelines its tiles: S(j + 1) is issued
//   before P(j).V(j), and its softmax runs while P(j).V(j) is on the
//   tensor cores.
// On the card the copies set the pace, not the tensor cores (PERF.md):
// leaving out the softmax changes the time little, leaving out the mask's
// copy and reads the most.  Sharing the mask between the blocks of two
// heads (a cluster, multicast bulk copies) was slower: the pair of blocks
// waits for each other.
//
// With grad on (lse and out_lo given) the epilogue also writes each row's
// log-sum-exp in base 2 and the rest of the fp32 output, bf16(O - bf16(O)):
// the backward's (csrc/attention_bwd_sm90.cu) statistics, one store of a
// float a row and one more of the output's size (6% at B16 L565).
//
// A key >= L gets logit -inf and zero K/V rows; a query row >= L computes
// on a valid mask row and is never stored.  A first tile that the mask
// wholly masks (-1e9) is forgotten when a later tile raises the row max
// (alpha = 0), as in the fp32 route.

#include <atomic>

#include "attention_sm90.cuh"

namespace mmvid {
namespace {

using namespace sm90;

constexpr int kRows = 128;             // query rows per block
constexpr int kKeys = 64;              // keys per K/V tile
constexpr int kStages = 3;             // ring depth (2: slower, 4: no gain)
constexpr int kConsumers = 256;        // two warpgroups
constexpr int kProducers = 128;        // one warpgroup
constexpr int kThreads = kConsumers + kProducers;
// A stage's mask tile: the block's 128 query rows, each with the 64
// floats of the stage's keys.  They start at any 4-byte offset of the
// [L, L] mask, so 17 aligned 16-byte chunks cover a row; rows are
// kMaskStride floats apart.
constexpr int kMaskChunks = 17;
constexpr int kMaskStride = 72;
constexpr int kMaskTileBytes = kRows * kMaskStride * 4;
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr int kRowBytes = 2 * D;  // one bf16 row: 128 or 64 bytes
  static constexpr int kChunks = kRowBytes / 16;
  static constexpr int kQBytes = kRows * kRowBytes;
  static constexpr int kKVBytes = kKeys * kRowBytes;  // one K or V tile
  static constexpr int kStageBytes = 2 * kKVBytes + kMaskTileBytes;
  static constexpr int kBars = 1 + 2 * kStages;  // Q, full[], empty[]
  // + up to 1023 bytes to align the tiles to the 1024-byte swizzle atom
  static constexpr int kSmem = 1024 + kQBytes + kStages * kStageBytes +
                               8 * kBars;
};

// A tile of 2*D-byte rows with the 128-byte (D 64) or 64-byte (D 32)
// swizzle: sm90.cuh's swizzle_offset and desc_swizzled.
template <int D>
__device__ __forceinline__ uint32_t swizzle(int r, int c) {
  return swizzle_offset(r, c, Tile<D>::kRowBytes);
}
template <int D>
__device__ __forceinline__ uint64_t descriptor(uint32_t addr) {
  return desc_swizzled(addr, Tile<D>::kRowBytes);
}

// One producer thread's part of copying kN rows of 2*D bytes (row i at
// src + i * stride) into a swizzled tile at dst, rows >= valid
// zero-filled: the warpgroup covers 128 / (D / 8) rows a pass, a thread
// one 16-byte chunk of each.
template <int D, int kN>
__device__ __forceinline__ void copy_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int valid,
                                          int ptid) {
  constexpr int kPass = kProducers / Tile<D>::kChunks;
  const int ch = ptid % Tile<D>::kChunks, r0 = ptid / Tile<D>::kChunks;
  const __nv_bfloat16* p = src + r0 * stride + ch * 8;
  const long long step = kPass * stride;
  if (valid >= kN) {
#pragma unroll
    for (int i = 0; i < kN / kPass; ++i, p += step)
      cp_async16(dst + swizzle<D>(r0 + kPass * i, ch), p, 16);
  } else {
#pragma unroll
    for (int i = 0; i < kN / kPass; ++i, p += step) {
      const bool ok = r0 + kPass * i < valid;
      cp_async16(dst + swizzle<D>(r0 + kPass * i, ch), ok ? p : src,
                 ok ? 16 : 0);
    }
  }
}

// Producer thread r's part of staging the mask entries of query row
// row0 + r for keys k0 .. k0 + 63 into a mask tile, one bulk copy
// counted on the stage's barrier `bar`: from the 16-byte aligned float
// index (row * L) & ~3, so key k0 + c sits at float (row * L) % 4 + c of
// the tile's row r.  17 chunks of 16 bytes cover the 64 floats; the copy
// stops at the 16-byte chunk that holds the mask's last float.  A row >= L
// is not copied (its consumers read row 0's).
__device__ __forceinline__ void stage_mask_row(uint32_t dst,
                                               const float* __restrict__ mask,
                                               int row0, int k0, int L, int r,
                                               uint32_t bar) {
  if (row0 + r >= L) return;
  const long long idx = (static_cast<long long>(row0 + r) * L & ~3ll) + k0;
  const long long left = static_cast<long long>(L) * L - idx;  // floats
  const int bytes = left >= 4 * kMaskChunks
                        ? 16 * kMaskChunks
                        : 16 * static_cast<int>((left + 3) / 4);
  mbar_expect_tx(bar, bytes);
  bulk_copy(dst + 4 * r * kMaskStride, mask + idx, bytes, bar);
}

// S = Q . K^T for one warpgroup's 64 rows and a 64-key tile, issued and
// committed (not waited for)
template <int D>
__device__ __forceinline__ void qk_product(float (&sc)[32], uint32_t qa,
                                           uint32_t kt) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(sc, descriptor<D>(qa + kk * 32), descriptor<D>(kt + kk * 32),
                 kk > 0);
  wgmma_commit();
}

// The mask entries of this thread's S fragment for keys k0 .. k0 + 63
// from a staged mask tile: sc[4i + e] is row r0 + 8 * (e / 2), key k0 +
// 8i + 2t + e % 2 (the accumulator layout); m0, m1 point at the two
// rows' key k0 + 2t.  -inf for keys >= L.
__device__ __forceinline__ void load_mask(float (&mk)[32], const float* m0,
                                          const float* m1, int k0, int t,
                                          int L) {
  if (k0 + kKeys <= L) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mk[4 * i + e] = (e < 2 ? m0 : m1)[8 * i + (e & 1)];
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * i + 2 * t + (e & 1);
        mk[4 * i + e] =
            k0 + c < L ? (e < 2 ? m0 : m1)[8 * i + (e & 1)] : -INFINITY;
      }
  }
}

// Online softmax, base 2, of one S tile in place: sc becomes the tile's
// unnormalised probabilities against the new running max; alpha is the
// factor of the rows' earlier sums (0 on the first tile).  The quad of
// lanes that holds a row meets in shuffles for the max; the row sums stay
// per thread until the end.
__device__ __forceinline__ void softmax_tile(float (&sc)[32],
                                             const float (&mk)[32],
                                             float scale_log2,
                                             float (&m_run)[2],
                                             float (&l_run)[2],
                                             float (&alpha)[2]) {
  float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sc[i] = fmaf(sc[i], scale_log2, mk[i] * kLog2e);
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  }
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // a row with every logit so far -inf keeps p = 0, not NaN
    m_use[r] = mx[r] == -INFINITY ? 0.f : mx[r];
    alpha[r] = fast_exp2(m_run[r] - m_use[r]);
    m_run[r] = mx[r];
    l_run[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    sc[i] = fast_exp2(sc[i] - m_use[r]);
    l_run[r] += sc[i];
  }
}

// P as wgmma A fragments, one per 16-key step: S's accumulator fragments
// 2kk and 2kk + 1 are A's (rows g, g + 8; keys 2t, 2t + 8 of the step).
// p_lo = bf16(P - P_hi) unless kBf16Probs.
template <bool kBf16Probs>
__device__ __forceinline__ void pack_probs(const float (&sc)[32],
                                           uint32_t (&p_hi)[4][4],
                                           uint32_t (&p_lo)[4][4]) {
  if constexpr (kBf16Probs) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p_hi[kk][e] = pack_bf16x2(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
  } else {
    pack_split(sc, p_hi, p_lo);
  }
}

// O += P . V over a 64-key tile (V at vt), issued and committed
template <int D, bool kBf16Probs>
__device__ __forceinline__ void pv_product(float (&o)[D / 2],
                                           const uint32_t (&p_hi)[4][4],
                                           const uint32_t (&p_lo)[4][4],
                                           uint32_t vt) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t dv = descriptor<D>(vt + kk * 16 * Tile<D>::kRowBytes);
    wgmma_rs<D>(o, p_hi[kk], dv);
    if (!kBf16Probs) wgmma_rs<D>(o, p_lo[kk], dv);
  }
  wgmma_commit();
}

template <int D, bool kBf16Probs>
__global__ void __launch_bounds__(kThreads, 1)
attention_fwd_kernel_wgmma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
    __nv_bfloat16* __restrict__ out, int L, long long sqb, long long sql,
    long long sqh, long long skb, long long skl, long long skh,
    long long svb, long long svl, long long svh, long long sob,
    long long sol, long long soh, float* __restrict__ lse,
    __nv_bfloat16* __restrict__ out_lo, int lse_ld, float scale_log2) {
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_tile = base;
  const uint32_t bars = base + T::kQBytes + kStages * T::kStageBytes;
  const uint32_t q_full = bars;
  auto k_tile = [&](int s) { return base + T::kQBytes + s * T::kStageBytes; };
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  // consumer warpgroups with query rows < L: the last tile may have one
  const int groups = L - q0 > 64 ? 2 : 1;
  const int n_tiles = (L + kKeys - 1) / kKeys;
  if (tid == 0) {
    mbar_init(q_full, kProducers);
    for (int s = 0; s < kStages; ++s) {
      // each producer thread's K/V rows, and the mask rows' bytes
      mbar_init(full(s), kProducers);
      mbar_init(empty(s), 4 * groups);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warpgroup
    const int ptid = tid - kConsumers;
    const __nv_bfloat16* qb = q + b * sqb + h * sqh;
    const __nv_bfloat16* kb = k + b * skb + h * skh;
    const __nv_bfloat16* vb = v + b * svb + h * svh;
    copy_tile<D, kRows>(q_tile, qb + q0 * sql, sql, L - q0, ptid);
    cp_async_arrive(q_full);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages, k0 = j * kKeys;
      // the consumers are done with this stage's previous tile
      if (j >= kStages) mbar_wait(empty(s), ((j / kStages) & 1) ^ 1);
      copy_tile<D, kKeys>(k_tile(s), kb + k0 * skl, skl, L - k0, ptid);
      copy_tile<D, kKeys>(k_tile(s) + T::kKVBytes, vb + k0 * svl, svl,
                          L - k0, ptid);
      stage_mask_row(k_tile(s) + 2 * T::kKVBytes, mask, q0, k0, L, ptid,
                     full(s));
      cp_async_arrive(full(s));
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  const int wg = tid / 128;
  if (wg >= groups) return;  // all its rows are >= L
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  // this thread's rows of S and O: r0 and r0 + 8, rr and rr + 8 of the
  // block's
  const int rr = wg * 64 + warp * 16 + g, r0 = q0 + rr;
  float o[D / 2], sc[32], mk[32], alpha[2];
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  uint32_t p_hi[4][4], p_lo[4][4];
  // rows r0 and r0 + 8 at key 2t in a stage's mask tile (offsets from
  // the stage's K tile, in floats); a row >= L reads the tile's row 0
  const int m0 = (2 * T::kKVBytes) / 4 + 2 * t +
                 (r0 < L ? rr * kMaskStride + r0 * L % 4 : q0 * L % 4);
  const int m1 = (2 * T::kKVBytes) / 4 + 2 * t +
                 (r0 + 8 < L ? (rr + 8) * kMaskStride + (r0 + 8) * L % 4
                             : q0 * L % 4);
  auto mask_frag = [&](int j) {
    const float* st = reinterpret_cast<const float*>(
        smem_raw + (k_tile(j % kStages) - smem_addr(smem_raw)));
    load_mask(mk, st + m0, st + m1, j * kKeys, t, L);
  };
  const uint32_t qa = q_tile + wg * 64 * T::kRowBytes;
  // K tile j's address once it has landed
  auto wait_tile = [&](int j) {
    mbar_wait(full(j % kStages), (j / kStages) & 1);
    __syncwarp();
    // K and V came through the generic proxy (cp.async); wgmma reads
    // shared memory through the async proxy
    fence_proxy_async();
    return k_tile(j % kStages);
  };
  // this warp is done with tile j's stage
  auto release = [&](int j) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(j % kStages));
  };

#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;

  // Software pipeline (one warpgroup): while P(j).V(j) runs on the tensor
  // cores, S(j + 1) has been computed and its softmax runs on the ALUs.
  mbar_wait(q_full, 0);
  __syncwarp();
  qk_product<D>(sc, qa, wait_tile(0));
  mask_frag(0);
  wgmma_wait<0>();
  fence_regs(sc);
  softmax_tile(sc, mk, scale_log2, m_run, l_run, alpha);  // alpha = 0
  pack_probs<kBf16Probs>(sc, p_hi, p_lo);
  for (int j = 0; j + 1 < n_tiles; ++j) {
    qk_product<D>(sc, qa, wait_tile(j + 1));
    pv_product<D, kBf16Probs>(o, p_hi, p_lo,
                              k_tile(j % kStages) + T::kKVBytes);
    mask_frag(j + 1);
    wgmma_wait<1>();  // S(j + 1) has landed; P(j).V(j) may still run
    fence_regs(sc);
    softmax_tile(sc, mk, scale_log2, m_run, l_run, alpha);
    wgmma_wait<0>();
    fence_regs(o);
    release(j);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    pack_probs<kBf16Probs>(sc, p_hi, p_lo);
  }
  pv_product<D, kBf16Probs>(o, p_hi, p_lo,
                            k_tile((n_tiles - 1) % kStages) + T::kKVBytes);
  wgmma_wait<0>();
  fence_regs(o);

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / l;
    // the row's log-sum-exp in base 2 for the backward (grad on): the
    // logits x = log2(e) (scale q.k + mask) give P = 2^(x - lse)
    const int row = r0 + 8 * r;
    if (lse != nullptr && t == 0 && row < L)
      lse[(static_cast<long long>(b) * gridDim.y + h) * lse_ld + row] =
          m_run[r] + log2f(l);
  }
  __nv_bfloat16* ob = out + b * sob + h * soh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row < L) {
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const float x0 = o[4 * i + 2 * r] * inv[r];
        const float x1 = o[4 * i + 2 * r + 1] * inv[r];
        const uint32_t val = pack_bf16x2(x0, x1);
        const long long at = row * sol + 8 * i + 2 * t;
        *reinterpret_cast<uint32_t*>(ob + at) = val;
        // with grad on, the fp32 output's rest, bf16(x - bf16(x)), at the
        // same place of out_lo (out's layout): the backward's delta = g .
        // O reads out + out_lo, about 16 bits of O
        if (out_lo != nullptr) {
          const __nv_bfloat162 hi =
              *reinterpret_cast<const __nv_bfloat162*>(&val);
          *reinterpret_cast<uint32_t*>(out_lo + b * sob + h * soh + at) =
              pack_bf16x2(x0 - __low2float(hi), x1 - __high2float(hi));
        }
      }
    }
  }
}

template <int D, bool kBf16Probs>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* mask, void* out, float* lse, void* out_lo,
                   int lse_ld, int B, int L, int H, const long long* st,
                   float scale, cudaStream_t stream) {
  auto* kernel = attention_fwd_kernel_wgmma<D, kBf16Probs>;
  constexpr int smem = Tile<D>::kSmem;
  // the shared-memory attribute, set at the first launch on each device
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev].load(std::memory_order_relaxed)) {
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
        cudaSuccess)
      return err;
    ready[dev].store(true, std::memory_order_relaxed);
  }
  const dim3 grid((L + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), mask,
      static_cast<__nv_bfloat16*>(out), L, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], lse,
      static_cast<__nv_bfloat16*>(out_lo), lse_ld, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// bf16 q, k, v, out with the C entry's arguments (csrc/attention.cu); the
// caller has checked 16-byte aligned bases and row/head/batch strides.
// lse: null, or [B, H, lse_ld] fp32 that takes each row's log-sum-exp in
// base 2; out_lo: null, or bf16 in out's layout that takes the rest of
// the fp32 output (the backward's row statistics and delta's O).
cudaError_t attention_wgmma(int head_dim, bool bf16_probs, const void* q,
                            const void* k, const void* v, const float* mask,
                            void* out, float* lse, void* out_lo, int lse_ld,
                            int B, int L, int H, const long long* strides,
                            float scale, cudaStream_t stream) {
  if (head_dim == 64)
    return bf16_probs ? launch<64, true>(q, k, v, mask, out, lse, out_lo,
                                         lse_ld, B, L, H, strides, scale,
                                         stream)
                      : launch<64, false>(q, k, v, mask, out, lse, out_lo,
                                          lse_ld, B, L, H, strides, scale,
                                          stream);
  if (head_dim == 32)
    return bf16_probs ? launch<32, true>(q, k, v, mask, out, lse, out_lo,
                                         lse_ld, B, L, H, strides, scale,
                                         stream)
                      : launch<32, false>(q, k, v, mask, out, lse, out_lo,
                                          lse_ld, B, L, H, strides, scale,
                                          stream);
  return cudaErrorInvalidValue;
}

}  // namespace mmvid
