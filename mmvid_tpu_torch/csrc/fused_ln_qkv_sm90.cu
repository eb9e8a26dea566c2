// Fused LayerNorm + packed QKV projection of a backbone block, bf16, on
// Hopper's tensor cores (wgmma) fed by tensor copies (TMA), sm_90a.
//
// Replaces the TPU kernel mmvid_tpu/ops/fused_ln_qkv.py::_kernel (driven by
// fused_ln_qkv) on the bf16 models it is gated for.  Per row m of x [M, D]
// (bf16):
//
//     mu, var = mean(x[m]), mean(x[m]^2) - mu^2        fp32, eps 1e-5
//     h       = ((x[m] - mu) * rsqrt(var + eps)) * ln_w + ln_b   fp32,
//               then rounded to bf16
//     qkv[m]  = h @ W^T + b      W = in_proj_weight [3D, D] (bf16), products
//                                summed in fp32, b added in fp32, then bf16
//
// the function of that kernel and of the plain reference
// mmvid_tpu_torch/ops/fused_ln_qkv.py::ln_qkv_reference.  The output is
// the packed [M, 3D] projection that the attention takes as strided q, k
// and v views, so nothing is padded or split.
//
// What bounds it on the H100: 2*M*D*3D flops on (M*D + 3D*D + M*3D) * 2
// bytes in bf16, far above the card's flop:byte balance, so the tensor
// cores (0.036 ms at M 10064, D 768).
//
// Design: two launches.  A statistics pass (one warp per row, 16-byte
// loads) writes (mu, rstd) per row, 8 bytes.  Then the product, persistent
// (one block an SM, each walking 128 x 192 output tiles, columns fastest,
// so the blocks in flight share their x rows in L2 and W, 3.4 MB, stays
// there):
// - a producer warp, one thread of which keeps x slabs [128 rows x 64]
//   and W slabs [192 rows x 64] in flight by 2-D tensor copies (TMA, the
//   128-byte swizzle that the wgmma descriptors name, rows past M or 3D
//   zero-filled) into a 4-stage mbarrier ring that runs on across tiles;
// - two consumer warpgroups, each owning 64 rows of the tile and all 192
//   columns: wgmma m64n192k16, fp32 sums in 96 registers a thread.  W =
//   in_proj_weight [3D, D] is K-major as it lies, so it needs no
//   transpose.  A consumer takes its A fragments from the landed x slab
//   by ldmatrix, normalises them in registers (h from x, mu, rstd and
//   ln_w, ln_b staged in shared memory, the plain version's rounding
//   steps, then bf16) and feeds them to wgmma's register-A form; two
//   slabs' fragments, so that slab k + 1 is normalised while slab k's
//   products run.  The epilogue adds the bias (staged in shared memory),
//   rounds to bf16 into a swizzled staging tile, and one thread stores it
//   by tensor copies while the warpgroup goes on to its next tile.
// 128 x 192 rather than 128 x 256: 256 columns need 128 accumulator
// registers a thread, and at the 168 registers ptxas gives a thread of
// this block the kernel spilled and its wgmma were serialised.  A
// normaliser warpgroup beside the consumers (normalising each slab in
// shared memory) was slower: one warpgroup normalises more slowly than the
// tensor cores consume.  M 10064 is 79 row tiles x 12 column tiles, 948
// tiles (7.2 waves of 132 SMs); M 9040, 852 (6.5).  The tensor maps are
// encoded at each call on the host (cuTensorMapEncodeTiled, looked up
// through the CUDA runtime's entry-point query, so the library links no
// -lcuda).

#include <atomic>

#include "sm90.cuh"

namespace mmvid {
namespace {

using namespace sm90;

constexpr int kTM = 128;     // output rows per block
constexpr int kTN = 192;     // output columns per block
constexpr int kTK = 64;      // depth per slab: one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kXBytes = kTM * kTK * 2;
constexpr int kWBytes = kTN * kTK * 2;
constexpr int kStageBytes = kXBytes + kWBytes;
constexpr int kConsumers = 256;  // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and a producer warp
// the output tile, staged for its tensor stores: per warpgroup four boxes
// of 64 rows x 64 columns (128-byte rows, the 128-byte swizzle)
constexpr int kOutBox = 64;
constexpr int kOutBoxBytes = 64 * kOutBox * 2;
constexpr int kOutBytes = 2 * (kTN / kOutBox) * kOutBoxBytes;
// the ring, the output tile, each warpgroup's copy of the tile's bias
// (fp32), ln_w and ln_b (fp32, D <= kMaxD), barriers
constexpr int kMaxD = 1024;
constexpr int kSmem = 1024 + kStages * kStageBytes + kOutBytes + 2 * 4 * kTN +
                      8 * kMaxD + 8 * 2 * kStages;
constexpr int kStatThreads = 256;
constexpr float kEps = 1e-5f;
constexpr int kMaxDevices = 64;

__global__ void __launch_bounds__(kStatThreads)
ln_stats_kernel(const __nv_bfloat16* __restrict__ x, int M, int D,
                float2* __restrict__ stats) {
  const int row = (blockIdx.x * kStatThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  // 16-byte loads: 8 bf16 at a time (D is a multiple of 8)
  const uint4* xr =
      reinterpret_cast<const uint4*>(x + static_cast<long long>(row) * D);
  float s = 0.f, s2 = 0.f;
  for (int c = lane; c < D / 8; c += 32) {
    const uint4 raw = xr[c];
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float v = __bfloat162float(
          __ushort_as_bfloat16((words[q / 2] >> (16 * (q % 2))) & 0xffffu));
      s += v;
      s2 = fmaf(v, v, s2);
    }
  }
  const float mu = warp_sum(s) / D;
  const float var = warp_sum(s2) / D - mu * mu;
  if (lane == 0) stats[row] = make_float2(mu, rsqrtf(var + kEps));
}

// d[64 x 192] (+)= A[64 x 16] . B[16 x 192], A in registers (the mma
// fragment: a0 row g, k 2t, 2t + 1; a1 row g + 8; a2, a3 k + 8), B K-major
// in shared memory; `accumulate` 0 overwrites d
__device__ __forceinline__ void wgmma_n192_rs(float (&d)[96],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, "
      "%71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, "
      "%85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ float bf16_at(uint32_t word, int half) {
  return __bfloat162float(
      __ushort_as_bfloat16((word >> (16 * half)) & 0xffffu));
}

// four 8x8 bf16 matrices from shared memory, in the mma fragment layout
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__global__ void __launch_bounds__(kThreads, 1)
ln_qkv_wgmma(const __grid_constant__ CUtensorMap x_map,
             const __grid_constant__ CUtensorMap w_map,
             const __grid_constant__ CUtensorMap out_map,
             const float2* __restrict__ stats,
             const float* __restrict__ ln_w, const float* __restrict__ ln_b,
             const __nv_bfloat16* __restrict__ bias, int M, int D, int N) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  // the ring, the output tile, the bias copies, ln_w and ln_b (fp32), the
  // barriers
  const uint32_t out_tile = base + kStages * kStageBytes;
  float* bias_s =
      reinterpret_cast<float*>(gbase + kStages * kStageBytes + kOutBytes);
  float* lnp = bias_s + 2 * kTN;
  const uint32_t bars = out_tile + kOutBytes + 2 * 4 * kTN + 8 * D;
  auto x_tile = [&](int s) { return base + s * kStageBytes; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const int tid = threadIdx.x;
  const int k_steps = D / kTK;
  const int n_cols = (N + kTN - 1) / kTN;
  const int n_tiles = n_cols * ((M + kTM - 1) / kTM);
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

  // Tiles, columns fastest: tile i is (row tile i / n_cols, column tile
  // i % n_cols); the block takes every gridDim.x-th.  The ring runs on
  // across tiles, so the next tile's slabs load during an epilogue.
  if (tid >= kConsumers) {  // the producer warp: one thread copies
    if (tid == kConsumers) {
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = tile / n_cols * kTM, n0 = tile % n_cols * kTN;
        for (int ks = 0; ks < k_steps; ++ks, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(full(s), kStageBytes);
          tma_load_2d(x_tile(s), &x_map, ks * kTK, m0, full(s));
          tma_load_2d(x_tile(s) + kXBytes, &w_map, ks * kTK, n0, full(s));
        }
      }
    }
    return;
  }

  const int wg = tid / 128, wl = tid % 128;
  const int warp = wl / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  // The normalisation, in registers: the A fragments of the warpgroup's
  // 64 rows of a slab, four 16-deep steps, by ldmatrix from the swizzled
  // slab, each value normalised (h = ((x - mu) * rstd) * ln_w + ln_b in
  // fp32, the plain version's rounding steps, then bf16); rows g and g + 8
  // of the warp's 16, columns 2t, 2t + 1 and 2t + 8, 2t + 9 of a step
  float2 ms[2];
  auto normalise = [&](int it, int ks, uint32_t (&a)[4][4]) {
    const int r = warp * 16 + (lane & 15);  // this lane's ldmatrix row
    const uint32_t xr = x_tile(it % kStages) + (wg * 64 + r) * 128;
#pragma unroll
    for (int kk = 0; kk < kTK / 16; ++kk) {
      const int chunk = 2 * kk + (lane >> 4);
      ldmatrix_x4(a[kk], xr + ((chunk ^ (r & 7)) << 4));
      const int k = ks * kTK + 16 * kk + 2 * t;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k + 8 * (j >> 1);
        const float2 w = *reinterpret_cast<const float2*>(lnp + kj);
        const float2 b = *reinterpret_cast<const float2*>(lnp + D + kj);
        const float2 m = ms[j & 1];
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float hv = __fmul_rn(bf16_at(a[kk][j], e) - m.x, m.y);
          y[e] = __fadd_rn(__fmul_rn(hv, e ? w.y : w.x), e ? b.y : b.x);
        }
        const __nv_bfloat162 hb = __floats2bfloat162_rn(y[0], y[1]);
        a[kk][j] = *reinterpret_cast<const uint32_t*>(&hb);
      }
    }
  };
  // this warp is done with step it's stage
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(it % kStages));
  };
  float acc[96];
  auto products = [&](int it, int ks, const uint32_t (&a)[4][4]) {
    const uint32_t wb = x_tile(it % kStages) + kXBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTK / 16; ++kk)
      wgmma_n192_rs(acc, a[kk], desc_swizzled(wb + 32 * kk, 128),
                    ks > 0 || kk > 0);
    wgmma_commit();
  };

  // Two slabs' fragments, so that a slab's products (which read their
  // fragments until they are done) run while the next one is normalised;
  // k_steps is even (D % 128 == 0)
  uint32_t afr[2][4][4];
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = tile / n_cols * kTM, n0 = tile % n_cols * kTN;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wg * 64 + warp * 16 + g + 8 * h;
      ms[h] = row < M ? stats[row] : make_float2(0.f, 0.f);
    }
    // the warpgroup's copy of the tile's bias, read after the epilogue's
    // barrier (0 past N)
    float* wg_bias = bias_s + wg * kTN;
#pragma unroll
    for (int c = wl; c < kTN; c += 128)
      wg_bias[c] = n0 + c < N ? __bfloat162float(bias[n0 + c]) : 0.f;
    mbar_wait(full(it % kStages), (it / kStages) & 1);
    normalise(it, 0, afr[0]);
    for (int ks = 0; ks < k_steps; ks += 2, it += 2) {
      products(it, ks, afr[0]);
      if (ks > 0) {
        wgmma_wait<1>();  // step it - 1's products are done
        release(it - 1);
      }
      mbar_wait(full((it + 1) % kStages), ((it + 1) / kStages) & 1);
      normalise(it + 1, ks + 1, afr[1]);
      products(it + 1, ks + 1, afr[1]);
      wgmma_wait<1>();  // step it's products are done: afr[0] is free
      release(it);
      if (ks + 2 < k_steps) {
        mbar_wait(full((it + 2) % kStages), ((it + 2) / kStages) & 1);
        normalise(it + 2, ks + 2, afr[0]);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    release(it - 1);

    // acc[4i + e]: row 16 warp + g, column 8i + 2t + e; acc[4i + 2 + e]
    // the row 8 below.  Plus the bias, to bf16, into the warpgroup's
    // staged boxes (box i / 8, 16-byte chunk i % 8 of the row), once its
    // last tile's stores have read them; then one thread stores the boxes
    // and the warpgroup goes on while they drain
    const uint32_t wg_out = out_tile + wg * (kTN / kOutBox) * kOutBoxBytes;
    if (wl == 0) bulk_wait_read();
    named_sync(1 + wg, 128);
#pragma unroll
    for (int i = 0; i < kTN / 8; ++i) {
      const float2 bv =
          *reinterpret_cast<const float2*>(wg_bias + 8 * i + 2 * t);
      const float b0 = bv.x, b1 = bv.y;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = warp * 16 + g + 8 * half;
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            acc[4 * i + 2 * half] + b0, acc[4 * i + 2 * half + 1] + b1);
        const uint32_t a = wg_out + (i / 8) * kOutBoxBytes +
                           swizzle_offset(r, i % 8, 128) + 4 * t;
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a),
                     "r"(*reinterpret_cast<const uint32_t*>(&v))
                     : "memory");
      }
    }
    fence_proxy_async();  // the boxes are read by the tensor stores
    named_sync(1 + wg, 128);
    if (wl == 0) {
#pragma unroll
      for (int bx = 0; bx < kTN / kOutBox; ++bx)
        tma_store_2d(&out_map, n0 + bx * kOutBox, m0 + wg * 64,
                     wg_out + bx * kOutBoxBytes);
      bulk_commit();
    }
  }
  if (wl == 0) bulk_wait();
}

// a bf16 [rows, cols] row-major tensor, boxes of box_rows x 64 columns
// (128 bytes) with the 128-byte swizzle
cudaError_t make_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                     int box_rows) {
  return make_map_128b(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, rows,
                       cols, box_rows);
}

}  // namespace
}  // namespace mmvid

// x [M, D], w [3D, D] and bias [3D] in bf16, ln_w / ln_b [D] fp32, all
// contiguous and 16-byte aligned; D a multiple of 128, at most 1024.
// stats: workspace of M float2.  Writes qkv [M, 3D] in bf16.  Returns
// cudaGetLastError() after the launches.
extern "C" int mmvid_ln_qkv(const void* x, const void* ln_w, const void* ln_b,
                            const void* w, const void* bias, int M, int D,
                            void* stats, void* out, void* stream) {
  using namespace mmvid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || D <= 0 || D % 128 != 0 || D > kMaxD)
    return cudaErrorInvalidValue;
  const int N = 3 * D;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  float2* st = static_cast<float2*>(stats);
  CUtensorMap x_map, w_map, out_map;
  cudaError_t err = make_map(&x_map, x, M, D, kTM);
  if (err == cudaSuccess) err = make_map(&w_map, w, N, D, kTN);
  if (err == cudaSuccess) err = make_map(&out_map, out, M, N, kOutBox);
  if (err != cudaSuccess) return err;
  ln_stats_kernel<<<(M + kStatThreads / 32 - 1) / (kStatThreads / 32),
                    kStatThreads, 0, s>>>(xb, M, D, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // the shared-memory attribute and the SM count, once per device
  static std::atomic<int> sms[kMaxDevices];
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int n_sm = sms[dev].load(std::memory_order_relaxed);
  if (n_sm == 0) {
    if ((err = cudaFuncSetAttribute(
             ln_qkv_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
             kSmem)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(
             &n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    sms[dev].store(n_sm, std::memory_order_relaxed);
  }
  const long long tiles =
      static_cast<long long>((N + kTN - 1) / kTN) * ((M + kTM - 1) / kTM);
  const int grid = static_cast<int>(tiles < n_sm ? tiles : n_sm);
  ln_qkv_wgmma<<<grid, kThreads, kSmem, s>>>(
      x_map, w_map, out_map, st, static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const __nv_bfloat16*>(bias),
      M, D, N);
  return cudaGetLastError();
}
