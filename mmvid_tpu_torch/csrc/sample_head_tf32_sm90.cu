// Fused sample head of the mask-predict sampler, fp32 W, on Hopper's
// tensor cores in split TF32 ("3xTF32"), sm_90a.  The fp32-W route of
// ops/sample_head.py::fused_sample_head for the shapes its docstring
// names; other shapes keep the CUDA-core kernel of csrc/sample_head.cu.
//
// Replaces the TPU kernel mmvid_tpu/ops/sample_head.py::fused_sample_head
// and computes what csrc/sample_head.cu computes for fp32 W, with the same
// noise: per row m of x [M, D], h = LN(x[m]) in fp32 (fp32 statistics, eps
// 1e-5), logits = h @ W + b, noised = logits + temp * G1, tok =
// argmax(noised + G2) (the lowest column on a tie), Y = exp(noised[tok] -
// logsumexp(noised)); G1 and G2 from Philox4x32-10 keyed by (seed, row,
// column) (sample_head.cuh), so one seed gives the three kernels the same
// draws.  Only tok and Y are written.
//
// The product in split TF32: each operand is rounded to TF32 (cvt.rna, 11
// significant bits) and its remainder rounded again, a = a_hi + a_lo, and
// h @ W = h_hi W_hi + h_hi W_lo + h_lo W_hi in the fp32 accumulators of
// wgmma; the dropped h_lo W_lo and the remainders' roundings are about
// 2^-22 of a term, fp32's own summation noise at these depths.  W's split
// is made once a sampling call by ops/sample_head.py::prepare_head_weight,
// as W^T [V, D] (K-major: wgmma has no transpose for 32-bit types); h's
// is made here, in registers, from the raw x.
//
// What bounds it on the H100: operations.  3 x 2 M D V flops at 495
// TFLOP/s TF32 (0.078 ms at M 8192, D 768, V 1024; the same product on
// the CUDA cores' fp32 FMAs, 2 M D V at 67 TFLOP/s, 0.192 ms); beside it
// the sampling, one Philox call, four logarithms and an exponential a
// logit, integer and logarithm work that wants many warps (the bf16 twin,
// sample_head_sm90.cu, spends its 0.12 ms on it with 16 warps an SM).
//
// Design: two launches.
// 1. The logits, sample_head_tf32_logits: a block owns 128 rows and a
//    run of V's 128-column tiles (the grid: column runs x row tiles, the
//    run length chosen by the wrapper so that the grid fills the card);
//    288 threads:
//    - one producer thread keeps slabs of 32 columns of depth in flight
//      by 2-D tensor copies (TMA, the 128-byte swizzle the wgmma
//      descriptors name, rows past M zero-filled): x [128 rows x 32],
//      W_hi and W_lo [128 columns x 32], 48 KB a stage, a 4-stage
//      mbarrier ring that runs on across the block's tiles;
//    - two consumer warpgroups, 64 rows each.  Before the first slab each
//      warp computes its 16 rows' LN statistics (two passes, from device
//      memory).  Per k8 step a thread normalises its A fragment from the
//      landed x (the plain version's rounding steps), splits it into TF32
//      high and low parts in registers and issues three m64n128k8 wgmma
//      with A from registers, while the previous step's products run;
//    - the tensor cores truncate each sum into their accumulator, which
//      shrinks a long sum there: over all of D in one accumulator Y read
//      6.4e-5 from the plain version, 1.4e-5 at temp 0 against the 1e-5
//      bound.  So each slab's products go to a fresh accumulator, added
//      into the tile's fp32 sum in registers (rounded to nearest): 5.5e-6
//      at temp 0; 64 + 64 registers a thread;
//    - the tile's sums go to the logits [M, V] (fp32, 34 MB at M 8192,
//      which L2 holds for the next launch).
//    The sampling cannot share these warps: the accumulators leave a
//    consumer thread too few registers for it, and it wants more warps
//    than the tensor-core blocks have (done beside the products by the 8
//    consumer warps, a one-launch draft took 0.24 ms).
// 2. The sampling, sample_head_tf32_sample: one warp a row, 8 rows a
//    block of 256 threads, many blocks an SM: a lane takes columns lane,
//    lane + 32, ... (rising), adds the bias, draws the noise and folds
//    each logit into its running state (max, sum of exp, best score,
//    column, noised value); the lanes' states are merged (the lowest
//    column on a tie) and lane 0 writes Y and tok.
// Rows >= M are zero-filled, computed and never stored.

#include "sample_head.cuh"
#include "sm90.cuh"

namespace mmvid {
namespace {

using namespace sm90;

constexpr int kRows = 128;                   // rows a block
constexpr int kTileN = 128;                  // columns a tile (wgmma N)
constexpr int kSlabK = 32;                   // depth a slab: 128 bytes
constexpr int kStages = 4;
constexpr int kSlabBytes = kRows * kSlabK * 4;   // x, W_hi or W_lo
constexpr int kStageBytes = 3 * kSlabBytes;      // 48 KB
constexpr int kConsumers = 256;              // two warpgroups
constexpr int kThreads = kConsumers + 32;    // and a producer warp
constexpr int kSampleRows = 8;               // rows a sampling block
constexpr int kStatRows = 4;                 // rows a warp's stats load
constexpr int kMaxD = 1024;
constexpr int kMaxDevices = 64;

// shared memory beside the ring: ln_w and ln_b (fp32, 2 D floats), the
// rows' statistics, the barriers, and slack to align the base to the
// 1024-byte swizzle atom
__host__ __device__ constexpr int smem_bytes(int d) {
  return 1024 + kStages * kStageBytes + 8 * d + 8 * kRows +
         8 * 2 * kStages;
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// d[64 x 128] (+)= A[64 x 8] . B[8 x 128] in TF32, A in registers (the
// fragment: a0 row g, k t; a1 row g + 8; a2, a3 k + 4), B K-major in
// shared memory; `accumulate` 0 overwrites d
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__global__ void __launch_bounds__(kThreads, 1)
    sample_head_tf32_logits(const __grid_constant__ CUtensorMap x_map,
                            const __grid_constant__ CUtensorMap whi_map,
                            const __grid_constant__ CUtensorMap wlo_map,
                            const float* __restrict__ x,
                            const float* __restrict__ ln_w,
                            const float* __restrict__ ln_b, int M, int D,
                            int V, float* __restrict__ logits) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  float* lnp = reinterpret_cast<float*>(gbase + kStages * kStageBytes);
  float2* stats = reinterpret_cast<float2*>(lnp + 2 * D);  // [kRows]
  const uint32_t bars = smem_addr(stats + kRows);
  auto stage = [&](int s) { return base + s * kStageBytes; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kRows;
  const int k_slabs = D / kSlabK;
  const int tiles = V / kTileN / gridDim.x;       // this block's run
  const int n_begin = blockIdx.x * tiles * kTileN;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  for (int i = tid; i < D; i += kThreads) {
    lnp[i] = ln_w[i];
    lnp[D + i] = ln_b[i];
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp: one thread copies
    if (tid == kConsumers) {
      int it = 0;
      for (int j = 0; j < tiles; ++j) {
        const int n0 = n_begin + j * kTileN;
        for (int q = 0; q < k_slabs; ++q, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(full(s), kStageBytes);
          tma_load_2d(stage(s), &x_map, q * kSlabK, m0, full(s));
          tma_load_2d(stage(s) + kSlabBytes, &whi_map, q * kSlabK, n0,
                      full(s));
          tma_load_2d(stage(s) + 2 * kSlabBytes, &wlo_map, q * kSlabK, n0,
                      full(s));
        }
      }
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;

  // 1. LN statistics of the warp's 16 rows (rows 16 warp .. + 15 of the
  // block), kStatRows rows at a time in registers (their loads in flight
  // together), two passes in fp32; rows past M get (0, 0)
  for (int i = 0; i < 16; i += kStatRows) {
    float4 v[kStatRows][kMaxD / 128];
#pragma unroll
    for (int h = 0; h < kStatRows; ++h) {
      const int row = m0 + warp * 16 + i + h;
      const float4* xr = reinterpret_cast<const float4*>(
          x + static_cast<long long>(row < M ? row : 0) * D);
#pragma unroll
      for (int c = 0; c < kMaxD / 128; ++c) {
        const int ch = lane + 32 * c;
        v[h][c] = row < M && ch < D / 4 ? __ldg(xr + ch)
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int h = 0; h < kStatRows; ++h) {
      float s1 = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxD / 128; ++c)
        s1 += (v[h][c].x + v[h][c].y) + (v[h][c].z + v[h][c].w);
      const float mu = warp_sum(s1) / D;
      float sq = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxD / 128; ++c) {
        if (lane + 32 * c < D / 4) {
          const float a = v[h][c].x - mu, b = v[h][c].y - mu;
          const float e = v[h][c].z - mu, f = v[h][c].w - mu;
          sq += (a * a + b * b) + (e * e + f * f);
        }
      }
      const float rstd = rsqrtf(warp_sum(sq) / D + 1e-5f);
      const int row = m0 + warp * 16 + i + h;
      if (lane == 0)
        stats[warp * 16 + i + h] =
            row < M ? make_float2(mu, rstd) : make_float2(0.f, 0.f);
    }
  }
  __syncwarp();
  const float2 ms[2] = {stats[warp * 16 + g], stats[warp * 16 + g + 8]};

  // 2. The A fragment of k8 step kk of a slab from the landed x: rows g
  // and g + 8 of the warp's 16, depth t and t + 4, h = ((x - mu) * rstd) *
  // ln_w + ln_b (the plain version's rounding steps), split into TF32 high
  // and low parts
  auto normalise = [&](int it, int q, int kk, uint32_t (&hi)[4],
                       uint32_t (&lo)[4]) {
    const uint32_t xs = stage(it % kStages);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = warp * 16 + g + 8 * (j & 1);  // row of the block
      const int chunk = 2 * kk + (j >> 1);        // 16-byte chunk
      float xv;
      asm volatile("ld.shared.f32 %0, [%1];\n"
                   : "=f"(xv)
                   : "r"(xs + r * 128 + ((chunk ^ (r & 7)) << 4) + 4 * t));
      const int k = q * kSlabK + 4 * chunk + t;
      const float2 m = ms[j & 1];
      const float hv = __fadd_rn(
          __fmul_rn(__fmul_rn(__fsub_rn(xv, m.x), m.y), lnp[k]), lnp[D + k]);
      hi[j] = tf32_rna(hv);
      lo[j] = tf32_rna(__fsub_rn(hv, __uint_as_float(hi[j])));
    }
  };
  // this warp is done with step it's stage
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(it % kStages));
  };
  // k8 step kk's products, h_lo W_hi, h_hi W_lo, h_hi W_hi, into the
  // accumulator (`fresh`: overwriting it)
  float acc[64], sum[64];
  auto products = [&](int it, int kk, const uint32_t (&hi)[4],
                      const uint32_t (&lo)[4], bool fresh) {
    const uint32_t whi = stage(it % kStages) + kSlabBytes + 32 * kk;
    const uint32_t wlo = whi + kSlabBytes;
    wgmma_fence();
    wgmma_tf32_n128(acc, lo, desc_swizzled(whi, 128), !fresh);
    wgmma_tf32_n128(acc, hi, desc_swizzled(wlo, 128), 1);
    wgmma_tf32_n128(acc, hi, desc_swizzled(whi, 128), 1);
    wgmma_commit();
  };
  // the accumulator, once its products are done, into the tile's sum
  auto promote = [&]() {
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] += acc[i];
  };

  // 3. The tiles.  Each slab (four k8 steps) goes to a fresh accumulator,
  // promoted into the sum; the fragments of the next step are made while
  // a step's products run (two buffers, the products reading one until
  // they are done).
  uint32_t ahi[2][4], alo[2][4];
  int it = 0;
  for (int j = 0; j < tiles; ++j) {
    const int n0 = n_begin + j * kTileN;
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = 0.f;
    mbar_wait(full(it % kStages), (it / kStages) & 1);
    normalise(it, 0, 0, ahi[0], alo[0]);
    for (int q = 0; q < k_slabs; ++q, ++it) {
      products(it, 0, ahi[0], alo[0], true);
      normalise(it, q, 1, ahi[1], alo[1]);
      products(it, 1, ahi[1], alo[1], false);
      wgmma_wait<1>();  // step 0's products are done: buffer 0 is free
      normalise(it, q, 2, ahi[0], alo[0]);
      products(it, 2, ahi[0], alo[0], false);
      normalise(it, q, 3, ahi[1], alo[1]);
      products(it, 3, ahi[1], alo[1], false);
      wgmma_wait<1>();
      if (q + 1 < k_slabs) {
        mbar_wait(full((it + 1) % kStages), ((it + 1) / kStages) & 1);
        normalise(it + 1, q + 1, 0, ahi[0], alo[0]);
      }
      promote();
      release(it);
    }
    // sum[4i + e] is row 16 warp + g + 8 (e / 2), column 8i + 2t + e % 2
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + warp * 16 + g + 8 * h;
      if (row >= M) continue;
      float* out = logits + static_cast<long long>(row) * V + n0 + 2 * t;
#pragma unroll
      for (int i = 0; i < kTileN / 8; ++i)
        *reinterpret_cast<float2*>(out + 8 * i) =
            make_float2(sum[4 * i + 2 * h], sum[4 * i + 2 * h + 1]);
    }
  }
}

// The sampling of a row, one warp: bias, noise, the running state over
// the lane's rising columns, then the lanes' states merged
__global__ void __launch_bounds__(32 * kSampleRows)
    sample_head_tf32_sample(const float* __restrict__ logits,
                            const float* __restrict__ bias, float temp,
                            const unsigned long long* __restrict__ seed_ptr,
                            int M, int V, float* __restrict__ y_out,
                            long long* __restrict__ tok_out) {
  const int row = blockIdx.x * kSampleRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const unsigned long long seed = *seed_ptr;
  const uint2 key = make_uint2(static_cast<uint32_t>(seed),
                               static_cast<uint32_t>(seed >> 32));
  const float* lr = logits + static_cast<long long>(row) * V;
  RowState st = row_state_init(V);
#pragma unroll 4
  for (int c = lane; c < V; c += 32) {
    const uint4 bits = philox4x32_10(
        make_uint4(static_cast<uint32_t>(c), static_cast<uint32_t>(row), 0u,
                   0u),
        key);
    const float noised =
        (__ldcs(lr + c) + __ldg(bias + c)) + temp * gumbel_from_bits(bits.x);
    // columns rise along the loop: the first index wins a tie
    row_state_add(st, noised, noised + gumbel_from_bits(bits.y), c);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) row_state_shfl_merge(st, off);
  if (lane == 0) {
    y_out[row] = row_state_y(st);
    tok_out[row] = st.idx;
  }
}

}  // namespace
}  // namespace mmvid

// The shapes this kernel takes: D a multiple of 64 up to 1024, V a
// multiple of 128 (ops/sample_head.py states the same rule)
extern "C" int mmvid_sample_head_tf32_takes(int D, int V) {
  return D > 0 && D % 64 == 0 && D <= mmvid::kMaxD && V > 0 &&
         V % mmvid::kTileN == 0;
}

// x [M, D] fp32, ln_w / ln_b [D] fp32, w_hi / w_lo [V, D] fp32 (W^T's TF32
// high parts and the remainders' TF32 roundings), bias [V] fp32, seed: one
// uint64 in device memory; all contiguous and 16-byte aligned.  runs: the
// column runs a row tile is cut into (a divisor of V / 128).  Scratch:
// logits [M, V] fp32.  Writes y [M] fp32 and tok [M] int64.  Two
// launches; returns cudaGetLastError() after them.
extern "C" int mmvid_sample_head_tf32(const void* x, const void* ln_w,
                                      const void* ln_b, const void* w_hi,
                                      const void* w_lo, const void* bias,
                                      float temp, const void* seed, int M,
                                      int D, int V, int runs, void* logits,
                                      void* y, void* tok, void* stream) {
  using namespace mmvid;
  const int row_tiles = (M + kRows - 1) / kRows;
  if (M <= 0 || !mmvid_sample_head_tf32_takes(D, V) || runs <= 0 ||
      (V / kTileN) % runs != 0 || row_tiles > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap x_map, whi_map, wlo_map;
  cudaError_t err = sm90::make_map_128b(
      &x_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, M, D, kRows);
  if (err == cudaSuccess)
    err = sm90::make_map_128b(&whi_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                              w_hi, V, D, kTileN);
  if (err == cudaSuccess)
    err = sm90::make_map_128b(&wlo_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                              w_lo, V, D, kTileN);
  if (err != cudaSuccess) return err;
  // the shared-memory attribute, once per device, at the largest D
  static std::atomic<int> ready[kMaxDevices];
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev].load(std::memory_order_relaxed)) {
    if ((err = cudaFuncSetAttribute(
             sample_head_tf32_logits,
             cudaFuncAttributeMaxDynamicSharedMemorySize,
             smem_bytes(kMaxD))) != cudaSuccess)
      return err;
    ready[dev].store(1, std::memory_order_relaxed);
  }
  float* lg = static_cast<float*>(logits);
  sample_head_tf32_logits<<<dim3(runs, row_tiles), kThreads, smem_bytes(D),
                            s>>>(x_map, whi_map, wlo_map,
                                 static_cast<const float*>(x),
                                 static_cast<const float*>(ln_w),
                                 static_cast<const float*>(ln_b), M, D, V,
                                 lg);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  sample_head_tf32_sample<<<(M + kSampleRows - 1) / kSampleRows,
                            32 * kSampleRows, 0, s>>>(
      lg, static_cast<const float*>(bias), temp,
      static_cast<const unsigned long long*>(seed), M, V,
      static_cast<float*>(y), static_cast<long long*>(tok));
  return cudaGetLastError();
}
