// Fused sample head of the mask-predict sampler, bf16 W, on Hopper's
// tensor cores (wgmma), sm_90a.  The bf16 route of
// ops/sample_head.py::fused_sample_head for the shapes its docstring
// names; other shapes and fp32 W keep the CUDA-core kernel of
// csrc/sample_head.cu.
//
// Replaces the TPU kernel mmvid_tpu/ops/sample_head.py::fused_sample_head
// and computes what csrc/sample_head.cu computes, with the same noise: per
// row m of x [M, D], h = LN(x[m]) rounded to bf16, logits = h @ W + b (fp32
// sums), noised = logits + temp * G1, tok = argmax(noised + G2) (the lowest
// column on a tie), Y = exp(noised[tok] - logsumexp(noised)); G1 and G2
// from Philox4x32-10 keyed by (seed, row, column) (sample_head.cuh), so one
// seed gives both kernels the same draws.  Only tok and Y are written.
//
// What bounds it on the H100: operations.  2 M D V flops (12.9 GFLOP at
// M 8192, D 768, V 1024: 0.013 ms at 989 TFLOP/s); besides, one Philox
// call and four logarithms for each of the M V logits.  The CUDA-core
// kernel ran the product in fp32 FMAs (0.19 ms at the fp32 peak alone),
// read W with 2-byte loads, and kept 112 KB of shared memory a block.
//
// Design:
// - one block per 64 rows (128 blocks at M 8192, one wave): four consumer
//   warpgroups and one producer warpgroup;
// - an LN prologue (one warp a row, two-pass fp32 statistics) writes the
//   block's bf16 rows into shared memory in the wgmma A layout: K-major,
//   the 128-byte swizzle, 64-column sub-tiles 8 KB apart; resident for the
//   whole block (96 KB at D 768);
// - consumer warpgroup g owns the 64-column N tiles g, g + 4, ... of the
//   vocabulary and has its own 3-slab ring, fed by one producer warp with
//   cp.async (16 bytes a thread, written with the 128-byte swizzle by
//   hand): slabs of 64 rows of W [D, V] (V contiguous) by 64 columns, read
//   by m64n64k16 wgmma as the MN-major B operand through the transpose bit,
//   as csrc/attention_sm90.cu reads V.  The warpgroups drift apart, so
//   one's epilogue runs while another's products do;
// - the 64 x 64 accumulator stays in registers; the epilogue adds the
//   bias, draws the noise and folds each logit into its row's running
//   state (max, sum of exp, best score, column, noised value), merged over
//   the N tiles, the four lanes that share a row, then the warpgroups in
//   shared memory in a fixed order.  The epilogue's integer and
//   logarithm work (about 200 instructions a logit), not the product,
//   sets the pace; four warpgroups hide more of its latency than two.
// Rows >= M are zero in shared memory, computed and never stored.

#include <atomic>

#include "sample_head.cuh"
#include "sm90.cuh"

namespace mmvid {
namespace {

using namespace sm90;

constexpr int kRows = 64;            // rows per block (the wgmma M)
constexpr int kTileN = 64;           // columns per N tile (the wgmma N)
constexpr int kSlabK = 64;           // W rows per slab
constexpr int kStages = 3;           // slabs per ring
constexpr int kSlabBytes = kSlabK * kTileN * 2;  // 8 KB
constexpr int kGroups = 4;           // consumer warpgroups, a ring each
constexpr int kConsumers = 128 * kGroups;
constexpr int kProducers = 128;      // one warpgroup, a warp per ring
constexpr int kThreads = kConsumers + kProducers;
constexpr int kFeeders = kProducers / kGroups;
constexpr int kMaxChunks = 4;        // 8-value chunks of a row a lane holds
constexpr int kMaxD = 960;
constexpr int kMaxDevices = 64;

// the extra shared memory beside A: rings, warpgroup 1's row states,
// barriers, and slack to align the base to the 1024-byte swizzle atom
constexpr int kSmemExtra =
    kGroups * kStages * kSlabBytes +
    (kGroups - 1) * kRows * static_cast<int>(sizeof(RowState)) +
    8 * 2 * kGroups * kStages + 1024;

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64]: A K-major, B MN-major (the
// transpose bit; its 64 columns are one 128-byte swizzle row, so the
// descriptor's leading byte offset is unused), both in shared memory;
// `accumulate` 0 overwrites d
__device__ __forceinline__ void wgmma_n64_tb(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__global__ void __launch_bounds__(kThreads, 1)
    sample_head_kernel_wgmma(const float* __restrict__ x,
                             const float* __restrict__ ln_w,
                             const float* __restrict__ ln_b,
                             const __nv_bfloat16* __restrict__ w,
                             const float* __restrict__ bias, float temp,
                             const unsigned long long* __restrict__ seed_ptr,
                             int M, int D, int V, float* __restrict__ y_out,
                             long long* __restrict__ tok_out) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t a_tile = base;  // [D / 64][64 rows][128 B]
  const uint32_t rings = base + kRows * D * 2;
  // warpgroups 1 .. 3's row states, [kGroups - 1][kRows]
  RowState* merge =
      reinterpret_cast<RowState*>(gbase + kRows * D * 2 +
                                  kGroups * kStages * kSlabBytes);
  const uint32_t bars = smem_addr(merge + (kGroups - 1) * kRows);
  auto slab = [&](int ring, int s) {
    return rings + (ring * kStages + s) * kSlabBytes;
  };
  auto full = [&](int ring, int s) {
    return bars + 8 * (ring * kStages + s);
  };
  auto empty = [&](int ring, int s) {
    return bars + 8 * ((kGroups + ring) * kStages + s);
  };
  const int tid = threadIdx.x, m0 = blockIdx.x * kRows;
  const int k_slabs = D / kSlabK, n_tiles = V / (kGroups * kTileN);
  if (tid == 0) {
    for (int r = 0; r < kGroups; ++r)
      for (int s = 0; s < kStages; ++s) {
        mbar_init(full(r, s), kFeeders);
        mbar_init(empty(r, s), 4);  // one arrival a consumer warp
      }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producers: a warp a ring
    const int ring = (tid - kConsumers) / kFeeders;
    const int p = (tid - kConsumers) % kFeeders;
    int it = 0;
    for (int jt = 0; jt < n_tiles; ++jt) {
      const int n0 = (kGroups * jt + ring) * kTileN;
      for (int q = 0; q < k_slabs; ++q, ++it) {
        const int s = it % kStages;
        if (it >= kStages)
          mbar_wait(empty(ring, s), ((it / kStages) & 1) ^ 1);
        // 64 rows x 8 chunks of 16 bytes (one 128-byte swizzle row each)
#pragma unroll 4
        for (int idx = p; idx < kSlabK * 8; idx += kFeeders) {
          const int k = idx / 8, cc = idx % 8;
          cp_async16(slab(ring, s) + swizzle128(k, cc),
                     w + static_cast<long long>(q * kSlabK + k) * V + n0 +
                         cc * 8,
                     16);
        }
        cp_async_arrive(full(ring, s));
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // 1. LN prologue: one warp a row, the row in registers
  const int warp = tid / 32, lane = tid % 32;
  const int n_ch = D / 8;
  for (int r = warp; r < kRows; r += kConsumers / 32) {
    const int row = m0 + r;
    float v[kMaxChunks][8];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j) {
      const int ch = lane + 32 * j;
#pragma unroll
      for (int e = 0; e < 8; ++e) v[j][e] = 0.f;
      if (row < M && ch < n_ch) {
        const float4* src = reinterpret_cast<const float4*>(
            x + static_cast<long long>(row) * D + ch * 8);
        const float4 lo = src[0], hi = src[1];
        const float t[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          v[j][e] = t[e];
          sum += t[e];
        }
      }
    }
    const float mu = warp_sum(sum) / D;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j)
      if (lane + 32 * j < n_ch)
#pragma unroll
        for (int e = 0; e < 8; ++e) sq += (v[j][e] - mu) * (v[j][e] - mu);
    const float rstd = rsqrtf(warp_sum(sq) / D + 1e-5f);
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j) {
      const int ch = lane + 32 * j;
      if (ch < n_ch) {
        uint32_t packed[4] = {0u, 0u, 0u, 0u};
        if (row < M) {
          float hv[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int d = ch * 8 + e;
            hv[e] = (v[j][e] - mu) * rstd * ln_w[d] + ln_b[d];
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const __nv_bfloat162 b2 =
                __floats2bfloat162_rn(hv[2 * e], hv[2 * e + 1]);
            packed[e] = *reinterpret_cast<const uint32_t*>(&b2);
          }
        }
        *reinterpret_cast<uint4*>(gbase + (ch / 8) * (kRows * 128) +
                                  swizzle128(r, ch % 8)) =
            make_uint4(packed[0], packed[1], packed[2], packed[3]);
      }
    }
  }
  fence_proxy_async();  // A is read by wgmma, through the async proxy
  named_sync(1, kConsumers);

  // 2. products and the sampling epilogue, N tile by N tile
  const int wg = tid / 128, wl = tid % 128;
  const int g = lane >> 2, t = lane & 3;
  const int rr = (wl / 32) * 16 + g;  // this thread's rows: rr, rr + 8
  const unsigned long long seed = *seed_ptr;
  const uint2 key = make_uint2(static_cast<uint32_t>(seed),
                               static_cast<uint32_t>(seed >> 32));
  RowState st[2] = {row_state_init(V), row_state_init(V)};
  float acc[32];
  int it = 0;
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int n0 = (kGroups * jt + wg) * kTileN;
    for (int q = 0; q < k_slabs; ++q, ++it) {
      const int s = it % kStages;
      mbar_wait(full(wg, s), (it / kStages) & 1);
      __syncwarp();
      fence_proxy_async();  // W came through cp.async (the generic proxy)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSlabK / 16; ++kk) {
        const int ks = q * (kSlabK / 16) + kk;  // 16-deep step of K
        const uint64_t da = desc_swizzled(
            a_tile + (ks / 4) * (kRows * 128) + (ks % 4) * 32, 128);
        wgmma_n64_tb(acc, da,
                     desc_swizzled(slab(wg, s) + kk * 16 * 128, 128),
                     q > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(wg, s));
    }
    // acc[4i + e]: row rr + 8 (e / 2), column n0 + 8i + 2t + e % 2;
    // each thread takes its columns in rising order
    // per row, the tile's 16 logits of this thread: their max first, then
    // their sum of exp against it, merged into the row's state once
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + rr + 8 * h;
      if (row >= M) continue;
      RowState tile = row_state_init(V);
      float noised[16];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n0 + 8 * i + 2 * t + e;
          const uint4 bits = philox4x32_10(
              make_uint4(static_cast<uint32_t>(c),
                         static_cast<uint32_t>(row), 0u, 0u),
              key);
          const float nz = (acc[4 * i + 2 * h + e] + __ldg(bias + c)) +
                           temp * gumbel_from_bits(bits.x);
          const float score = nz + gumbel_from_bits(bits.y);
          noised[2 * i + e] = nz;
          tile.m = fmaxf(tile.m, nz);
          if (score > tile.best) {  // columns rise: the first wins a tie
            tile.best = score;
            tile.idx = c;
            tile.noised = nz;
          }
        }
      }
      tile.s = 0.f;
#pragma unroll
      for (int k = 0; k < 16; ++k) tile.s += expf(noised[k] - tile.m);
      row_state_merge(st[h], tile);
    }
  }
  // the four lanes of a row, then warpgroups 1, 2, 3 into warpgroup 0
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row_state_shfl_merge(st[h], 1);
    row_state_shfl_merge(st[h], 2);
  }
  if (wg > 0 && t == 0) {
    merge[(wg - 1) * kRows + rr] = st[0];
    merge[(wg - 1) * kRows + rr + 8] = st[1];
  }
  named_sync(1, kConsumers);
  if (wg == 0 && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + rr + 8 * h;
      if (row >= M) continue;
      for (int o = 0; o < kGroups - 1; ++o)
        row_state_merge(st[h], merge[o * kRows + rr + 8 * h]);
      y_out[row] = row_state_y(st[h]);
      tok_out[row] = st[h].idx;
    }
  }
}

}  // namespace
}  // namespace mmvid

// The shapes this kernel takes: D a multiple of 64 up to 960, V a
// multiple of 256 (ops/sample_head.py states the same rule)
extern "C" int mmvid_sample_head_sm90_takes(int D, int V) {
  return D > 0 && D % 64 == 0 && D <= mmvid::kMaxD && V > 0 &&
         V % (mmvid::kGroups * mmvid::kTileN) == 0;
}

// x [M, D] fp32, ln_w / ln_b [D] fp32, w [D, V] bf16, bias [V] fp32, seed:
// one uint64 in device memory; all contiguous, x and w 16-byte aligned.
// Writes y [M] fp32 and tok [M] int64.  Returns cudaGetLastError() after
// the launch.
extern "C" int mmvid_sample_head_sm90(const void* x, const void* ln_w,
                                      const void* ln_b, const void* w,
                                      const void* bias, float temp,
                                      const void* seed, int M, int D, int V,
                                      void* y, void* tok, void* stream) {
  using namespace mmvid;
  if (M <= 0 || !mmvid_sample_head_sm90_takes(D, V))
    return cudaErrorInvalidValue;
  const int smem = kRows * D * 2 + kSmemExtra;
  static std::atomic<int> ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (ready[dev].load(std::memory_order_relaxed) < smem) {
    if ((err = cudaFuncSetAttribute(
             sample_head_kernel_wgmma,
             cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
        cudaSuccess)
      return err;
    ready[dev].store(smem, std::memory_order_relaxed);
  }
  sample_head_kernel_wgmma<<<(M + kRows - 1) / kRows, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
      temp, static_cast<const unsigned long long*>(seed), M, D, V,
      static_cast<float*>(y), static_cast<long long*>(tok));
  return cudaGetLastError();
}
