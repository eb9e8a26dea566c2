// int8 self-attention for the MMVID backbone (MMVID_ATTN_INT8=1, serving
// only), on the tensor cores' s8 path (mma.sync m16n8k32, s32 sums).
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
// Rounding is half to even (__float2int_rn), q / qs a true division (the
// build has no fast-math), and every product and sum that JAX writes as
// one op is one correctly rounded op here (__fmul_rn, __fadd_rn), so the
// integers match the plain version's and the outputs differ only where
// expf's last bit moves p * 127 across a tie or the row sum by an ulp.
// The ragged L edge is masked, not padded: JAX's zero-padded rows do not
// move its abs-max scales, and keys >= L give p8 = 0 here as the -1e9
// padding keys give p8 = 0 there.  int32 sums stay far inside their range
// (D * 127^2 and L * 127^2 with L <= 1024).
//
// What bounds it on the H100: 3 * B*L*H*D input elements read and B*L*H*D
// written, and B*H*L*L*4 mask bytes from L2; 4*B*H*L*L*D s8 operations.
// At B16 H12 L629 D64: 63 MB against 19 G operations, so bytes (0.019 ms
// at 3.35 TB/s; 0.0098 ms of operations at 1979 TOPS).
//
// Design (a first, simple kernel; speed is later work):
// - one block per (128-query tile, head, batch), 8 warps of 16 rows;
// - the per-(batch, head) scales need the whole L column of q, k and v,
//   so each block first scans its head's q, k and v (16-byte loads) for
//   the three abs-maxima: one launch, at the cost of every block of a
//   head reading the head again (about 0.24 MB at L629);
// - the block then quantizes its head's K and V into shared memory as
//   int8 (K row-major, V transposed so that a key run is one 32-bit mma
//   fragment), rows >= L zero, and its 128 query rows;
// - each warp computes S for its 16 rows over all keys twice: first for
//   the exact row max (S is an integer, so the two passes give the same
//   logits), then for p, the fp32 row sum and p8, which it stages in
//   shared memory (16 x 32 keys) to re-read in the A-fragment layout of
//   the P.V product; the [L, L] logits never leave the registers.

#include "common.cuh"

namespace mmvid {
namespace {

constexpr int kRows = 128;              // query rows per block
constexpr int kWarps = kRows / 16;      // one warp per 16 rows
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxL = 1024;             // a head's K and V in shared memory
constexpr int kPStride = 48;            // bytes per staged P row (32 + 16)

__device__ __forceinline__ void mma_s8_16832(int (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 8 consecutive elements (16-byte aligned) as floats
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) f[j] = __bfloat162float(h[j]);
}
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
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

__device__ __forceinline__ int8_t quant(float x, float s) {
  return static_cast<int8_t>(__float2int_rn(__fdiv_rn(x, s)));
}

__device__ __forceinline__ uint32_t pack4(const int8_t* v) {
  return static_cast<uint32_t>(static_cast<uint8_t>(v[0])) |
         static_cast<uint32_t>(static_cast<uint8_t>(v[1])) << 8 |
         static_cast<uint32_t>(static_cast<uint8_t>(v[2])) << 16 |
         static_cast<uint32_t>(static_cast<uint8_t>(v[3])) << 24;
}

__device__ __forceinline__ float block_max(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  return m;
}

template <int D>
struct Smem {
  static constexpr int kKStride = D + 16;  // bytes per int8 K or Q row
  __host__ __device__ static int v_stride(int Lp) { return Lp + 16; }
  static int bytes(int Lp) {
    return Lp * kKStride + D * v_stride(Lp) + kRows * kKStride +
           kWarps * 16 * kPStride;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_int8_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ mask,
                      T* __restrict__ out, int L, long long sqb, long long sql,
                      long long sqh, long long skb, long long skl,
                      long long skh, long long svb, long long svl,
                      long long svh, long long sob, long long sol,
                      long long soh, float scale) {
  static_assert(D % 32 == 0, "head dim must be a multiple of 32");
  constexpr int kChunks = D / 8;  // 8-element chunks of a row
  constexpr int KS = Smem<D>::kKStride;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[3][kWarps];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int Lp = (L + 31) / 32 * 32;
  const int VS = Smem<D>::v_stride(Lp);
  int8_t* K8 = reinterpret_cast<int8_t*>(smem);
  int8_t* V8t = K8 + Lp * KS;
  int8_t* Q8 = V8t + D * VS;
  int8_t* Pst = Q8 + kRows * KS;
  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;
  T* ob = out + b * sob + h * soh;

  // 1. the head's abs-maxima of q (scaled, in T), k and v
  float mq = 0.f, mk = 0.f, mv = 0.f;
  for (int i = tid; i < L * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    float f[8];
    load8(qb + r * sql + c, f);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mq = fmaxf(mq, fabsf(round_to(__fmul_rn(f[j], scale), qb)));
    load8(kb + r * skl + c, f);
#pragma unroll
    for (int j = 0; j < 8; ++j) mk = fmaxf(mk, fabsf(f[j]));
    load8(vb + r * svl + c, f);
#pragma unroll
    for (int j = 0; j < 8; ++j) mv = fmaxf(mv, fabsf(f[j]));
  }
  const float qs = __fdiv_rn(fmaxf(block_max(mq, red[0]), 1e-8f), 127.f);
  const float ks = __fdiv_rn(fmaxf(block_max(mk, red[1]), 1e-8f), 127.f);
  const float vs = __fdiv_rn(fmaxf(block_max(mv, red[2]), 1e-8f), 127.f);

  // 2. int8 K (row-major) and V (transposed) of the head, rows >= L zero;
  // the block's query rows
  for (int i = tid; i < Lp * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    int8_t k8[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    int8_t v8[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (r < L) {
      float f[8];
      load8(kb + r * skl + c, f);
#pragma unroll
      for (int j = 0; j < 8; ++j) k8[j] = quant(f[j], ks);
      load8(vb + r * svl + c, f);
#pragma unroll
      for (int j = 0; j < 8; ++j) v8[j] = quant(f[j], vs);
    }
    *reinterpret_cast<uint2*>(K8 + r * KS + c) =
        make_uint2(pack4(k8), pack4(k8 + 4));
#pragma unroll
    for (int j = 0; j < 8; ++j) V8t[(c + j) * VS + r] = v8[j];
  }
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8, row = row0 + r;
    int8_t q8[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (row < L) {
      float f[8];
      load8(qb + row * sql + c, f);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        q8[j] = quant(round_to(__fmul_rn(f[j], scale), qb), qs);
    }
    *reinterpret_cast<uint2*>(Q8 + r * KS + c) =
        make_uint2(pack4(q8), pack4(q8 + 4));
  }
  __syncthreads();

  // 3. each warp: 16 query rows against every key
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;  // the warp's first row in the tile
  if (row0 + wr >= L) return;
  uint32_t qa[D / 32][4];
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk) {
    const int8_t* base = Q8 + kk * 32 + 4 * t;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(base + (wr + g) * KS);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(base + (wr + g + 8) * KS);
    qa[kk][2] =
        *reinterpret_cast<const uint32_t*>(base + (wr + g) * KS + 16);
    qa[kk][3] =
        *reinterpret_cast<const uint32_t*>(base + (wr + g + 8) * KS + 16);
  }
  const int rowA = row0 + wr + g, rowB = rowA + 8;
  // rows >= L compute on a valid mask row and are never stored
  const float* mA = mask + static_cast<long long>(min(rowA, L - 1)) * L;
  const float* mB = mask + static_cast<long long>(min(rowB, L - 1)) * L;
  const float qsks = __fmul_rn(qs, ks);

  // S for keys n0 .. n0 + 7: c[e] is (rowA, n0 + 2t + e), c[2 + e] rowB's
  auto tile = [&](int n0, int (&c)[4]) {
    c[0] = c[1] = c[2] = c[3] = 0;
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
      const int8_t* kp = K8 + (n0 + g) * KS + kk * 32 + 4 * t;
      mma_s8_16832(c, qa[kk], *reinterpret_cast<const uint32_t*>(kp),
                   *reinterpret_cast<const uint32_t*>(kp + 16));
    }
  };

  // pass 1: the exact row max of the logits
  float mxA = -INFINITY, mxB = -INFINITY;
  for (int n0 = 0; n0 < Lp; n0 += 8) {
    int c[4];
    tile(n0, c);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = n0 + 2 * t + e;
      if (key < L) {
        mxA = fmaxf(mxA, __fadd_rn(__fmul_rn(static_cast<float>(c[e]), qsks),
                                   mA[key]));
        mxB = fmaxf(mxB, __fadd_rn(
                             __fmul_rn(static_cast<float>(c[2 + e]), qsks),
                             mB[key]));
      }
    }
  }
  // the four lanes of a row
  mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, 1));
  mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, 2));
  mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, 1));
  mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, 2));

  // pass 2: p, the row sums, p8 and O = p8 . v8, 32 keys a step
  int8_t* P = Pst + warp * 16 * kPStride;
  float dA = 0.f, dB = 0.f;
  int acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0;
  for (int ch = 0; ch < Lp; ch += 32) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n0 = ch + 8 * j;
      int c[4];
      tile(n0, c);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = n0 + 2 * t + e;
        float pA = 0.f, pB = 0.f;
        if (key < L) {
          pA = expf(__fsub_rn(
              __fadd_rn(__fmul_rn(static_cast<float>(c[e]), qsks), mA[key]),
              mxA));
          pB = expf(__fsub_rn(
              __fadd_rn(__fmul_rn(static_cast<float>(c[2 + e]), qsks),
                        mB[key]),
              mxB));
        }
        dA += pA;
        dB += pB;
        P[g * kPStride + 8 * j + 2 * t + e] =
            static_cast<int8_t>(__float2int_rn(__fmul_rn(pA, 127.f)));
        P[(g + 8) * kPStride + 8 * j + 2 * t + e] =
            static_cast<int8_t>(__float2int_rn(__fmul_rn(pB, 127.f)));
      }
    }
    __syncwarp();
    uint32_t pa[4];
    pa[0] = *reinterpret_cast<const uint32_t*>(P + g * kPStride + 4 * t);
    pa[1] =
        *reinterpret_cast<const uint32_t*>(P + (g + 8) * kPStride + 4 * t);
    pa[2] =
        *reinterpret_cast<const uint32_t*>(P + g * kPStride + 16 + 4 * t);
    pa[3] = *reinterpret_cast<const uint32_t*>(P + (g + 8) * kPStride + 16 +
                                                4 * t);
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const int8_t* vp = V8t + (dn * 8 + g) * VS + ch + 4 * t;
      mma_s8_16832(acc[dn], pa, *reinterpret_cast<const uint32_t*>(vp),
                   *reinterpret_cast<const uint32_t*>(vp + 16));
    }
    __syncwarp();  // P is rewritten by the next step
  }
  dA += __shfl_xor_sync(0xffffffffu, dA, 1);
  dA += __shfl_xor_sync(0xffffffffu, dA, 2);
  dB += __shfl_xor_sync(0xffffffffu, dB, 1);
  dB += __shfl_xor_sync(0xffffffffu, dB, 2);

  const float vs127 = __fdiv_rn(vs, 127.f);
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = dn * 8 + 2 * t + e;
      if (rowA < L)
        ob[rowA * sol + d] = from_float<T>(__fdiv_rn(
            __fmul_rn(static_cast<float>(acc[dn][e]), vs127), dA));
      if (rowB < L)
        ob[rowB * sol + d] = from_float<T>(__fdiv_rn(
            __fmul_rn(static_cast<float>(acc[dn][2 + e]), vs127), dB));
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* mask, void* out, int B, int L, int H,
                   const long long* st, float scale, cudaStream_t stream) {
  auto* kernel = attention_int8_kernel<T, D>;
  // the largest dynamic shared memory any L takes; setting it is cheap
  // and idempotent, so every launch sets it
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<D>::bytes(kMaxL));
  if (err != cudaSuccess) return err;
  const int Lp = (L + 31) / 32 * 32;
  const dim3 grid((L + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreads, Smem<D>::bytes(Lp), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), L, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mmvid

// q, k, v, out: [B, L, H, D] with unit stride over D, 16-byte aligned
// bases and (batch, position, head) element strides in `strides` (12
// values, q, k, v, out) that are multiples of 8; mask: contiguous fp32
// [L, L].  dtype: 0 fp32, 1 bf16; head_dim 32 or 64; L <= 1024.  scale:
// the logit scale rounded to the dtype (q is scaled in its dtype).
// Returns cudaGetLastError() after launch.
extern "C" int mmvid_attention_int8_fwd(int dtype, int head_dim,
                                        const void* q, const void* k,
                                        const void* v, const void* mask,
                                        void* out, int B, int L, int H,
                                        const long long* strides, float scale,
                                        void* stream) {
  using namespace mmvid;
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0 || H <= 0 || L > kMaxL || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  if (dtype == kBFloat16 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, m, out, B, L, H, strides, scale,
                                     s);
  if (dtype == kBFloat16 && head_dim == 32)
    return launch<__nv_bfloat16, 32>(q, k, v, m, out, B, L, H, strides, scale,
                                     s);
  if (dtype == kFloat32 && head_dim == 64)
    return launch<float, 64>(q, k, v, m, out, B, L, H, strides, scale, s);
  if (dtype == kFloat32 && head_dim == 32)
    return launch<float, 32>(q, k, v, m, out, B, L, H, strides, scale, s);
  return cudaErrorInvalidValue;
}
