// One whole ART-V decode step (every block, one token), hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel mmvid_tpu/ops/artv_decode.py::decode_token_step
// (kernel _make_kernel), which runs the step as one program over a
// sequential (layer, phase) grid with the residual stream in VMEM.  The
// function is the one of the plain reference
// mmvid_tpu_torch/ops/artv_decode.py::decode_token_step_reference: per
// block, LN1 and the packed QKV product, attention of the current token
// over the cache rows < pos (seeded by the token itself), out-projection
// and residual, LN2, the QuickGELU MLP and its residual; outputs y [B, D]
// fp32 and each block's k_new, v_new in the cache dtype.
//
// What bounds it on the H100: bytes.  A step streams every block's weights
// (12 D^2 values a block, 169.9 MB in bf16 at 768 x 12) and the live cache
// rows (2 B pos D values a block, 0.59 MB x pos at B 16), 2.7 GFLOP in
// all: at 3.35 TB/s that is 0.071 ms at pos 115, 0.116 ms at pos 370 and
// 0.161 ms at pos 625; 59.2 ms for the 511 steps of a batch of 16.
//
// Design.  A Hopper block has no sequential grid and no 170 MB of fast
// memory.  The step is one persistent cooperative kernel, as the TPU
// kernel is one program: its blocks walk five phases a layer, each over
// its own work items, with a grid-wide barrier between phases (60 a step
// at 12 layers), so the host enqueues one launch a token:
//   1. LN1 + QKV        (3D / 16 tiles of 16 output columns)
//   2. attention        (one item per (head, batch row))
//   3. out-proj + residual           (D / 16 tiles)
//   4. LN2 + fc + QuickGELU          (4D / 16 tiles)
//   5. proj + residual + bproj       (D / 16 tiles)
// The products stream whole weight rows with 16-byte loads into bf16
// mma.sync fragments, all B rows as the m dimension (mma_rows.cuh); each
// LN is recomputed by every tile of its product from the fp32 residual (B
// x D values, read from L2), so no normalised copy is written.  The
// residual y, q, v, the attention context and the MLP activations live in
// device memory between phases and are read through L2 (__ldcg), since an
// SM's L1 may hold a copy from an earlier phase.  fp32 models (the test
// sizes) take a plain CUDA-core loop instead of mma.  An attention item
// reads each cache row's head slice with 16-byte loads, keeps the pos
// logits in shared memory, takes their max, and sums probabilities and
// the AV product in fp32, the cache-row probabilities rounded to the cache
// dtype.  What bounds it instead of bytes: the 60 phases are short (a D x
// D product is 1.2 MB, 0.35 us at the memory rate) against a barrier of a
// few microseconds, and the D-column products have 48 tiles for 132 SMs.
// chip_smoke.py measures a launch and a barrier with the grid-step probe
// (gridstep.cu).  A first version launched the five phases as kernels, 61
// launches a step: on the card its steps were 5% shorter, but the host,
// enqueueing them, set the pace of the sampler (PERF.md).

#include <atomic>

#include "mma_rows.cuh"

namespace mmvid {
namespace {

constexpr float kEps = 1e-5f;
constexpr int kThreads = kMmaThreads;  // both phase kinds use 256 threads
// fp32 logits in 32 KB of shared memory, beside the AV partial sums
constexpr int kMaxPos = 8192;
constexpr int kMaxDevices = 64;

enum Phase : int { kQkv = 0, kOut = 1, kFc = 2, kProj = 3 };

struct LinearArgs {
  const float* a;      // [B, K] fp32 activations (the residual for LN phases)
  const float* ln_w;   // [K] (LN phases)
  const float* ln_b;
  const void* w;       // [N, K] weights in T
  const float* bias;   // [N]
  int B, K, N, D;
  float scale;         // hd^-0.5 (kQkv)
  float* y;            // [B, D] residual (kOut, kProj)
  float* q32;          // [B, D] scaled q (kQkv)
  void* knew;          // [B, D] T (kQkv)
  void* vnew;          // [B, D] T (kQkv)
  float* v32;          // [B, D] unrounded v (kQkv)
  float* g;            // [B, 4D] MLP activations (kFc)
};

struct StepArgs {
  const float* x;
  int n_layers, B, D, heads, W, pos;
  const float *ln1_w, *ln1_b, *ln2_w, *ln2_b;
  const void* w_qkv;
  const float* b_qkv;
  const void* w_out;
  const float* b_out;
  const void* w_fc;
  const float* b_fc;
  const void* w_proj;
  const float* b_proj;
  const void* cache_k;
  const void* cache_v;
  float* y;
  void* knew;
  void* vnew;
  float* scratch;  // q, v (fp32), ctx [B, D] each, then g [B, 4D]
  unsigned* barrier;
};

template <typename T, int kPhase>
__device__ __forceinline__ void epilogue(const LinearArgs& p, int r, int n,
                                         float sum) {
  if (kPhase == kQkv) {
    const float v = sum + p.bias[n];
    const int part = n / p.D, i = r * p.D + n % p.D;
    if (part == 0) {
      p.q32[i] = v * p.scale;
    } else if (part == 1) {
      static_cast<T*>(p.knew)[i] = from_float<T>(v);
    } else {
      p.v32[i] = v;
      static_cast<T*>(p.vnew)[i] = from_float<T>(v);
    }
  } else if (kPhase == kOut) {
    const int i = r * p.D + n;
    p.y[i] = __ldcg(p.y + i) + (sum + p.bias[n]);
  } else if (kPhase == kFc) {
    const float f = sum + p.bias[n];
    p.g[r * p.N + n] = f * (1.f / (1.f + expf(-1.702f * f)));
  } else {
    const int i = r * p.D + n;
    p.y[i] = (__ldcg(p.y + i) + sum) + p.bias[n];
  }
}

// Output columns tile * 16 .. + 16 of a product phase.  smem: the row
// statistics and the cross-warp reduction (2 * kMmaMaxRows + kMmaRedFloats
// floats).
template <typename T, int kPhase>
__device__ void linear_tile(const LinearArgs& p, int tile, float* smem) {
  constexpr bool kLn = kPhase == kQkv || kPhase == kFc;
  float2* stats = reinterpret_cast<float2*>(smem);
  float* red = smem + 2 * kMmaMaxRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = tile * kMmaCols;
  if (kLn) {  // two-pass row statistics of the residual, 16-byte loads
    for (int r = warp; r < p.B; r += kMmaWarps) {
      const float4* row = reinterpret_cast<const float4*>(
          p.a + static_cast<long long>(r) * p.K);
      float s = 0.f;
#pragma unroll 4
      for (int i = lane; i < p.K / 4; i += 32) {
        const float4 v = __ldcg(row + i);
        s += (v.x + v.y) + (v.z + v.w);
      }
      const float mu = warp_sum(s) / p.K;
      float s2 = 0.f;
#pragma unroll 4
      for (int i = lane; i < p.K / 4; i += 32) {
        const float4 v = __ldcg(row + i);
        s2 = fmaf(v.x - mu, v.x - mu, s2);
        s2 = fmaf(v.y - mu, v.y - mu, s2);
        s2 = fmaf(v.z - mu, v.z - mu, s2);
        s2 = fmaf(v.w - mu, v.w - mu, s2);
      }
      const float var = warp_sum(s2) / p.K;
      if (lane == 0) stats[r] = make_float2(mu, rsqrtf(var + kEps));
    }
    __syncthreads();
  }
  // A[r][k] in fp32 before its rounding to T: ((x - mu) * rstd) * w + b,
  // each step rounded as the plain version rounds it (no contraction)
  auto a_at = [&](int r, float v, float w, float bias) {
    if (!kLn) return v;
    const float2 st = stats[r];
    return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, st.x), st.y), w),
                     bias);
  };
  auto epi = [&](int r, int c, float sum) {
    epilogue<T, kPhase>(p, r, n0 + c, sum);
  };
  if constexpr (sizeof(T) == 2) {
    auto load8 = [&](int r, int k, float* v) {
      const float4* src = reinterpret_cast<const float4*>(
          p.a + static_cast<long long>(r) * p.K + k);
      const float4 lo = __ldcg(src), hi = __ldcg(src + 1);
      const float raw[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      float w[8] = {1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f};
      float bias[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (kLn) {
        const float4* lw = reinterpret_cast<const float4*>(p.ln_w + k);
        const float4* lb = reinterpret_cast<const float4*>(p.ln_b + k);
        const float4 w0 = lw[0], w1 = lw[1], b0 = lb[0], b1 = lb[1];
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          w[e] = wv[e];
          bias[e] = bv[e];
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = a_at(r, raw[e], w[e], bias[e]);
    };
    const int groups = p.K / 32;
    MmaAcc acc;
    mma_rows_partial(static_cast<const __nv_bfloat16*>(p.w), p.K, n0, p.B,
                     warp * groups / kMmaWarps,
                     (warp + 1) * groups / kMmaWarps, load8, acc);
    mma_rows_reduce(acc, red, p.B, epi);
  } else {
    // fp32 weights: one output a thread, a plain loop over K
    const float* w = static_cast<const float*>(p.w);
    for (int o = threadIdx.x; o < p.B * kMmaCols; o += kThreads) {
      const int r = o / kMmaCols, c = o % kMmaCols;
      const float* wr = w + static_cast<long long>(n0 + c) * p.K;
      const float* ar = p.a + static_cast<long long>(r) * p.K;
      float sum = 0.f;
      for (int k = 0; k < p.K; ++k)
        sum = fmaf(a_at(r, __ldcg(ar + k), kLn ? p.ln_w[k] : 1.f,
                        kLn ? p.ln_b[k] : 0.f),
                   wr[k], sum);
      epi(r, c, sum);
    }
  }
  __syncthreads();  // smem is reused by the block's next work item
}

__device__ __forceinline__ float block_reduce(float v, float* sh, bool max) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = max ? fmaxf(v, o) : v + o;
  }
  __syncthreads();  // sh may still be read by an earlier reduction
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  v = sh[0];
  for (int i = 1; i < kThreads / 32; ++i)
    v = max ? fmaxf(v, sh[i]) : v + sh[i];
  return v;
}

// sum over aligned groups of `width` lanes (a power of two), in each lane
__device__ __forceinline__ float group_sum(float v, int width) {
  for (int off = width / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 16 bytes of T (16-byte aligned) as fp32; L2 for data this step wrote
template <typename T, bool kFresh>
__device__ __forceinline__ void load16(const T* p, float* out) {
  const uint4* src = reinterpret_cast<const uint4*>(p);
  const uint4 raw = kFresh ? __ldcg(src) : __ldg(src);
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < 16 / static_cast<int>(sizeof(T)); ++e)
    out[e] = to_float(v[e]);
}

// Attention of batch row b, head h: the current token over its cache rows
// < pos, seeded by the token itself.  A cache row's head slice is read by
// hd / kVec lanes, 16 bytes each, so the block reads kThreads / (hd /
// kVec) rows at a time.  smem: pos logits, then kThreads * kVec partial
// sums and a reduction scratch.
template <typename T>
__device__ void attention_item(const StepArgs& a, const T* ck, const T* cv,
                               const T* knew, int h, int b, float* smem) {
  constexpr int kVec = 16 / sizeof(T);  // elements in 16 bytes
  const int D = a.D, hd = D / a.heads, pos = a.pos;
  const float* q32 = a.scratch;
  const float* v32 = a.scratch + a.B * D;
  float* ctx = a.scratch + 2 * a.B * D;
  float* s = smem;  // [pos] logits, then probabilities
  float* part = smem + kMaxPos;
  float* sh = part + kThreads * kVec;
  const int lanes = hd / kVec;               // lanes per row: 4, 8 or 16
  const int c = threadIdx.x % lanes;         // this lane's 16-byte slice
  const int rows = kThreads / lanes;         // rows per pass of the block
  const int r0 = threadIdx.x / lanes;
  const long long head0 = static_cast<long long>(b) * D + h * hd;
  float qf[kVec], qr[kVec], kn[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) qf[e] = __ldcg(q32 + head0 + c * kVec + e);
  load16<T, true>(knew + head0 + c * kVec, kn);
  float cur = 0.f;
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    qr[e] = to_float(from_float<T>(qf[e]));
    cur = fmaf(qf[e], kn[e], cur);
  }
  cur = group_sum(cur, lanes);  // the current token's logit: fp32 q, rounded k
  const long long cache0 =
      static_cast<long long>(b) * a.W * D + h * hd + c * kVec;
  float m = cur;
#pragma unroll 4
  for (int j0 = 0; j0 < pos; j0 += rows) {
    const int j = j0 + r0;
    float dot = 0.f;
    if (j < pos) {
      float kv[kVec];
      load16<T, false>(ck + cache0 + static_cast<long long>(j) * D, kv);
#pragma unroll
      for (int e = 0; e < kVec; ++e) dot = fmaf(qr[e], kv[e], dot);
    }
    dot = group_sum(dot, lanes);
    if (j < pos) {
      if (c == 0) s[j] = dot;
      m = fmaxf(m, dot);
    }
  }
  m = block_reduce(m, sh, true);  // also orders the s[] writes
  float lsum = 0.f;
  for (int j = threadIdx.x; j < pos; j += kThreads) {
    const float pj = expf(s[j] - m);
    s[j] = pj;
    lsum += pj;
  }
  const float pc = expf(cur - m);
  const float l = pc + block_reduce(lsum, sh, false);
  // AV: the lanes of pass row r0 sum rows j = r0 mod rows, 16 bytes each
  float acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
#pragma unroll 4
  for (int j = r0; j < pos; j += rows) {
    const float pj = to_float(from_float<T>(s[j]));
    float vv[kVec];
    load16<T, false>(cv + cache0 + static_cast<long long>(j) * D, vv);
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] = fmaf(pj, vv[e], acc[e]);
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) part[r0 * hd + c * kVec + e] = acc[e];
  __syncthreads();
  if (threadIdx.x < hd) {
    const int d = threadIdx.x;
    float sum = pc * __ldcg(v32 + head0 + d);
    for (int i = 0; i < rows; ++i) sum += part[i * hd + d];
    ctx[head0 + d] = sum / l;
  }
  __syncthreads();  // smem is reused by the block's next work item
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) artv_step_kernel(StepArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int B = a.B, D = a.D, hd = D / a.heads;
  unsigned* bar = a.barrier;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < B * D;
       i += gridDim.x * kThreads)
    a.y[i] = a.x[i];
  grid_barrier(bar, bar + 1);
  const long long dd = static_cast<long long>(D) * D;
  for (int l = 0; l < a.n_layers; ++l) {
    T* knew = static_cast<T*>(a.knew) + static_cast<long long>(l) * B * D;
    LinearArgs p{};
    p.B = B;
    p.D = D;
    p.y = a.y;
    // 1. LN1 + QKV
    p.a = a.y;
    p.ln_w = a.ln1_w + l * D;
    p.ln_b = a.ln1_b + l * D;
    p.w = static_cast<const T*>(a.w_qkv) + l * 3 * dd;
    p.bias = a.b_qkv + l * 3 * D;
    p.K = D;
    p.N = 3 * D;
    p.scale = 1.f / sqrtf(static_cast<float>(hd));
    p.q32 = a.scratch;
    p.v32 = a.scratch + B * D;
    p.knew = knew;
    p.vnew = static_cast<T*>(a.vnew) + static_cast<long long>(l) * B * D;
    for (int t = blockIdx.x; t < p.N / kMmaCols; t += gridDim.x)
      linear_tile<T, kQkv>(p, t, smem);
    grid_barrier(bar, bar + 1);
    // 2. attention over the cache rows < pos
    const long long cl = static_cast<long long>(l) * B * a.W * D;
    for (int it = blockIdx.x; it < a.heads * B; it += gridDim.x)
      attention_item<T>(a, static_cast<const T*>(a.cache_k) + cl,
                        static_cast<const T*>(a.cache_v) + cl, knew,
                        it % a.heads, it / a.heads, smem);
    grid_barrier(bar, bar + 1);
    // 3. out-proj + residual
    p.a = a.scratch + 2 * B * D;  // ctx
    p.w = static_cast<const T*>(a.w_out) + l * dd;
    p.bias = a.b_out + l * D;
    p.N = D;
    for (int t = blockIdx.x; t < p.N / kMmaCols; t += gridDim.x)
      linear_tile<T, kOut>(p, t, smem);
    grid_barrier(bar, bar + 1);
    // 4. LN2 + fc + QuickGELU
    p.a = a.y;
    p.ln_w = a.ln2_w + l * D;
    p.ln_b = a.ln2_b + l * D;
    p.w = static_cast<const T*>(a.w_fc) + l * 4 * dd;
    p.bias = a.b_fc + l * 4 * D;
    p.N = 4 * D;
    p.g = a.scratch + 3 * B * D;
    for (int t = blockIdx.x; t < p.N / kMmaCols; t += gridDim.x)
      linear_tile<T, kFc>(p, t, smem);
    grid_barrier(bar, bar + 1);
    // 5. proj + residual + bproj
    p.a = p.g;
    p.w = static_cast<const T*>(a.w_proj) + l * 4 * dd;
    p.bias = a.b_proj + l * D;
    p.K = 4 * D;
    p.N = D;
    for (int t = blockIdx.x; t < p.N / kMmaCols; t += gridDim.x)
      linear_tile<T, kProj>(p, t, smem);
    if (l + 1 < a.n_layers) grid_barrier(bar, bar + 1);
  }
}

template <typename T>
cudaError_t decode_step(StepArgs a, cudaStream_t s) {
  // shared memory: the larger of a product tile's and an attention item's
  const size_t smem = sizeof(float) *
      (kMaxPos + kThreads * (16 / sizeof(T)) + kThreads / 32);
  static_assert(sizeof(float) * (2 * kMmaMaxRows + kMmaRedFloats) <=
                    sizeof(float) * (kMaxPos + kThreads * 4 + kThreads / 32),
                "a product tile's shared memory fits in an attention item's");
  auto* kernel = artv_step_kernel<T>;
  // co-resident blocks on each device (0: not known yet), found and the
  // shared-memory attribute set at the first step there, not every token
  static std::atomic<int> resident[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int max_blocks = resident[dev].load(std::memory_order_relaxed);
  if (max_blocks == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             static_cast<int>(smem))) != cudaSuccess)
      return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, smem)) != cudaSuccess)
      return err;
    max_blocks = per_sm * sms;
    if (max_blocks < 1) return cudaErrorInvalidConfiguration;
    resident[dev].store(max_blocks, std::memory_order_relaxed);
  }
  // as many blocks as the largest phase has work items, all co-resident
  const int work = a.heads * a.B > 4 * a.D / kMmaCols ? a.heads * a.B
                                                      : 4 * a.D / kMmaCols;
  const int grid = work < max_blocks ? work : max_blocks;
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                     dim3(grid), dim3(kThreads), args, smem,
                                     s);
}

}  // namespace
}  // namespace mmvid

// x [B, D] fp32; per-layer params stacked on a leading n_layers axis (LN
// params and biases fp32, weights [out, in] in the dtype `dtype`: 0 fp32,
// 1 bf16); caches [n_layers, B, W, D] in that dtype, rows < pos read.
// Writes y [B, D] fp32 and k_new, v_new [n_layers, B, D]; scratch holds
// B * 7D floats; barrier: 2 uints, zeroed before the first call.  All
// contiguous and 16-byte aligned; D / heads in {32, 64}, 1 <= B <= 64,
// pos <= min(W, 8192).  Returns the launch's error, then
// cudaGetLastError().
extern "C" int mmvid_artv_decode_step(
    const void* x, int dtype, int n_layers, int B, int D, int heads, int W,
    int pos, const void* ln1_w, const void* ln1_b, const void* ln2_w,
    const void* ln2_b, const void* w_qkv, const void* b_qkv,
    const void* w_out, const void* b_out, const void* w_fc, const void* b_fc,
    const void* w_proj, const void* b_proj, const void* cache_k,
    const void* cache_v, void* y, void* knew, void* vnew, void* scratch,
    void* barrier, void* stream) {
  using namespace mmvid;
  if (heads <= 0 || D % heads != 0) return cudaErrorInvalidValue;
  const int hd = D / heads;
  if ((hd != 32 && hd != 64) || B < 1 || B > kMmaMaxRows || pos < 0 ||
      pos > W || pos > kMaxPos || n_layers < 1)
    return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const StepArgs a{f(x),     n_layers,  B,         D,
                   heads,    W,         pos,       f(ln1_w),
                   f(ln1_b), f(ln2_w),  f(ln2_b),  w_qkv,
                   f(b_qkv), w_out,     f(b_out),  w_fc,
                   f(b_fc),  w_proj,    f(b_proj), cache_k,
                   cache_v,  static_cast<float*>(y), knew,
                   vnew,     static_cast<float*>(scratch),
                   static_cast<unsigned*>(barrier)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kFloat32)
    err = decode_step<float>(a, s);
  else if (dtype == kBFloat16)
    err = decode_step<__nv_bfloat16>(a, s);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
