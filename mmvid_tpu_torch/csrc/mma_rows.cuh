// Products of a few activation rows (up to 64) with a 16-column slice of a
// bf16 weight matrix W [N, K] (torch Linear layout, K contiguous) on the
// tensor cores: mma.sync m16n8k16, bf16 operands, fp32 sums.  Shared by
// the row-batch matrix-vector kernels (artv_decode.cu, gridstep.cu).
//
// A block of kMmaThreads (8 warps) owns output columns n0 .. n0 + 16; the
// warps split K into contiguous runs of 32-deep groups.  Each thread loads
// 16 bytes of a W row straight from device memory (no shared-memory copy:
// every weight byte is read once) and the matching 8 activations of two
// rows.  To use those 16-byte loads as mma fragments, the 32 depths of a
// group are permuted the same way in A and B: mma depth slots
// {2t, 2t+1, 2t+8, 2t+9} of step s (s = 0, 1) are the real depths
// k0 + 8t + 4s + {0, 1, 2, 3} of lane group t.  A sum over depth does not
// depend on their order, so the product is unchanged.  The 8 warps'
// partial sums meet in shared memory and are added in a fixed order.
#pragma once

#include "common.cuh"

namespace mmvid {

constexpr int kMmaThreads = 256;
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kMmaCols = 16;      // output columns per block
constexpr int kMmaMaxRows = 64;   // activation rows, in groups of 16
constexpr int kMmaRowGroups = kMmaMaxRows / 16;
// floats of shared memory for the cross-warp reduction
constexpr int kMmaRedFloats = kMmaWarps * kMmaRowGroups * 2 * 32 * 4;

using MmaAcc = float[kMmaRowGroups][2][4];

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two fp32 values rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// This warp's partial sums over the depth groups [kg0, kg1) (32 deep each)
// for rows < `rows`: acc[mg][nt] is the m16n8 accumulator of rows
// mg * 16 + {g, g + 8} and columns n0 + nt * 8 + 2t + {0, 1} (g = lane / 4,
// t = lane % 4).  load8(r, k, v) writes the fp32 activations A[r][k .. k+8)
// to v[0 .. 8); they are rounded to bf16 here.
template <typename Load8>
__device__ __forceinline__ void mma_rows_partial(
    const __nv_bfloat16* __restrict__ w, int K, int n0, int rows, int kg0,
    int kg1, Load8 load8, MmaAcc& acc) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int groups = (rows + 15) / 16;
#pragma unroll
  for (int mg = 0; mg < kMmaRowGroups; ++mg)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mg][nt][e] = 0.f;
  const uint4* w0 = reinterpret_cast<const uint4*>(
      w + static_cast<long long>(n0 + g) * K);
  const uint4* w1 = reinterpret_cast<const uint4*>(
      w + static_cast<long long>(n0 + 8 + g) * K);
  // one group ahead: the next group's weights are in flight while this
  // group's products run
  uint4 wa = make_uint4(0, 0, 0, 0), wb = wa;
  if (kg0 < kg1) {
    wa = __ldg(w0 + kg0 * 4 + t);
    wb = __ldg(w1 + kg0 * 4 + t);
  }
  for (int kg = kg0; kg < kg1; ++kg) {
    uint4 na = wa, nb = wb;
    if (kg + 1 < kg1) {
      na = __ldg(w0 + (kg + 1) * 4 + t);
      nb = __ldg(w1 + (kg + 1) * 4 + t);
    }
    const uint32_t bw[2][4] = {{wa.x, wa.y, wa.z, wa.w},
                               {wb.x, wb.y, wb.z, wb.w}};
    const int k = kg * 32 + 8 * t;
#pragma unroll
    for (int mg = 0; mg < kMmaRowGroups; ++mg) {
      if (mg < groups) {
        uint32_t ua[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mg * 16 + g + 8 * h;
          float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
          if (r < rows) load8(r, k, v);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            ua[h][q] = pack_bf16x2(v[2 * q], v[2 * q + 1]);
        }
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const uint32_t af[4] = {ua[0][2 * s], ua[1][2 * s],
                                  ua[0][2 * s + 1], ua[1][2 * s + 1]};
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const uint32_t bf[2] = {bw[nt][2 * s], bw[nt][2 * s + 1]};
            mma_bf16_16816(acc[mg][nt], af, bf);
          }
        }
      }
    }
    wa = na;
    wb = nb;
  }
}

// Add the block's 8 warp partials (warp 0 first) and hand each output
// (row r < rows, column n0 + c) to epi(r, c, sum).  red: kMmaRedFloats of
// shared memory.  Called by every thread of the block.
template <typename Epi>
__device__ __forceinline__ void mma_rows_reduce(const MmaAcc& acc, float* red,
                                                int rows, Epi epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int groups = (rows + 15) / 16;
  float* mine = red + warp * (kMmaRedFloats / kMmaWarps);
#pragma unroll
  for (int mg = 0; mg < kMmaRowGroups; ++mg)
    if (mg < groups)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mine[((mg * 2 + nt) * 32 + lane) * 4 + e] = acc[mg][nt][e];
  __syncthreads();
  for (int o = threadIdx.x; o < rows * kMmaCols; o += kMmaThreads) {
    const int r = o / kMmaCols, c = o % kMmaCols;
    const int mg = r / 16, rr = r % 16, nt = c / 8, cc = c % 8;
    // the accumulator fragment slot of (rr, cc): lane g * 4 + t, element
    // 2 * (rr >= 8) + cc % 2
    const int idx = ((mg * 2 + nt) * 32 + (rr % 8) * 4 + cc / 2) * 4 +
                    (rr / 8) * 2 + cc % 2;
    float sum = 0.f;
#pragma unroll
    for (int wi = 0; wi < kMmaWarps; ++wi)
      sum += red[wi * (kMmaRedFloats / kMmaWarps) + idx];
    epi(r, c, sum);
  }
}

}  // namespace mmvid
