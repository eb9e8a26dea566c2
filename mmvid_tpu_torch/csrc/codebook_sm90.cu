// Nearest codebook entry (the VQ encoder's lookup), hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel mmvid_tpu/ops/codebook.py::_nn_kernel (driven by
// nearest_codebook_indices_pallas).  It computes the same function as that
// kernel and as the plain reference
// mmvid_tpu_torch/ops/codebook.py::nearest_codebook_reference:
//
//     idx[m] = argmax_j ( z[m] . e_j - 0.5 * |e_j|^2 )     (fp32)
//
// which is argmin_j |z[m] - e_j|^2 without the row-constant |z[m]|^2.  On an
// exact tie the lowest j wins, as jnp.argmax and torch.argmax do.
//
// What bounds it on the H100: 2*M*K*D flops in exact fp32 FFMA (no tensor
// cores: TF32 or a 3xTF32 split would move near-tie winners, another
// function) against (M + K) * D * 4 bytes read once, so the fp32 CUDA
// cores: 8.0 us at M1024 D256 K1024 (67 TFLOP/s).
//
// Design: a 2-D grid of tiles, 64 rows of z by 128 codes a block, so the
// code axis is spread over the card (M1024 K1024: 16 x 8 = 128 blocks, two
// an SM); each block reads its z tile and its code tile once.  D is staged
// through shared memory in chunks of 32 floats, 3 chunks in flight by
// cp.async, row by row as they lie in device memory (padded by 4 floats,
// so a warp's 16-byte reads of 32 codes spread over the banks).  Each
// thread keeps an 8 x 4 register tile of sums: one 16-byte read feeds 16
// FFMAs (a warp's z reads are broadcasts).  |e|^2 is summed once per code
// per block from the staged chunks (1/64 of the product's work, no extra
// reads), in d order as the products are.  Each block reduces its tile to a
// best (score, index) per row into a workspace [K/codes a tile, M]; the
// last block to finish a row tile (a per-row-tile counter that the last
// block resets to 0, behind __threadfence) merges the partials in
// code-tile order and writes the ids: one launch, no second pass over the
// [M, K] scores, which never reach device memory.  Every sum runs over d
// in order, and a strict > everywhere in ascending code order keeps the
// lowest index on a tie.

#include "sm90.cuh"

namespace mmvid {
namespace {

// The tiling: kBM rows of z by kBN codes a block, kTM x kTN a thread,
// kStages chunks of D in flight.  A warp is one group of kTM rows across
// all kBN codes; a thread's codes are lane + 32 * j (ascending in j).  The
// tiles sit in shared memory row by row (a row of z, or a code, kBK floats
// of D and 4 of padding), so that 16-byte cp.asyncs fill them straight
// from device memory and a warp's 16-byte reads of 32 codes' d-quads take
// the least wavefronts (the padding spreads them over the banks).
constexpr int kBM = 64, kBN = 128, kTM = 8, kTN = 4, kStages = 3;
constexpr int kBK = 32;                      // D chunk, floats
constexpr int kLd = kBK + 4;                 // a row's stride
constexpr int kThreads = (kBM / kTM) * 32;   // 256
constexpr int kCopies = (kBM + kBN) * (kBK / 4) / kThreads;
constexpr int kStage = (kBM + kBN) * kLd;    // floats a stage
constexpr size_t kSmemBytes = sizeof(float) * kStages * kStage;
static_assert(kBN == 32 * kTN, "a warp spans the block's codes");
static_assert((kBM + kBN) * (kBK / 4) % kThreads == 0, "tile copies");
static_assert(kThreads >= kBN, "a thread for each code's |e|^2");

// Queue chunk `chunk`'s copies into its stage: row r < BM is row m0 + r of
// z, row BM + c is code k0 + c; 16 bytes each, zeros past M, K or D
// (consecutive threads take consecutive 16 bytes of a row: coalesced).
__device__ __forceinline__ void load_chunk(
    const float* __restrict__ z, const float* __restrict__ cb, int M, int D,
    int K, int m0, int k0, int chunk, float* stage) {
  const int d0 = chunk * kBK;
#pragma unroll
  for (int i = 0; i < kCopies; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / (kBK / 4), q = idx % (kBK / 4);
    const int d = d0 + 4 * q;
    const bool is_z = r < kBM;
    const int row = is_z ? m0 + r : k0 + r - kBM;
    const bool valid = (is_z ? row < M : row < K) && d < D;
    const float* src = is_z ? z : cb;
    if (valid) src += static_cast<long long>(row) * D + d;
    sm90::cp_async16(sm90::smem_addr(stage + r * kLd + 4 * q), src,
                     valid ? 16 : 0);
  }
}

// (s2, i2) beats (s, i): a higher score, or the same score at a lower index
__device__ __forceinline__ bool beats(float s2, int i2, float s, int i) {
  return s2 > s || (s2 == s && i2 < i);
}

__global__ void __launch_bounds__(kThreads, 2)
nearest_code_tiled_kernel(const float* __restrict__ z,
                          const float* __restrict__ cb, int M, int D, int K,
                          float* __restrict__ part_score,
                          int* __restrict__ part_idx,
                          unsigned* __restrict__ counters,
                          long long* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ bool is_last;
  const int t = threadIdx.x, lane = t % 32, rg = t / 32;  // rg: row group
  const int ct = blockIdx.x, n_ct = gridDim.x;            // code tile
  const int m0 = blockIdx.y * kBM, k0 = ct * kBN;
  const int n_chunks = (D + kBK - 1) / kBK;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  // |e|^2 of code t (t < kBN), summed over d in order, as the products are
  float e2 = 0.f;

  // the pipeline: chunks 0 .. kStages - 2 in flight, one group each (empty
  // groups past the last chunk keep the count uniform)
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks)
      load_chunk(z, cb, M, D, K, m0, k0, c, smem + c * kStage);
    sm90::cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    sm90::cp_async_wait<kStages - 2>();   // chunk c has landed (this thread's)
    __syncthreads();                 // (everyone's), and chunk c - 1 is read
    if (c + kStages - 1 < n_chunks)
      load_chunk(z, cb, M, D, K, m0, k0, c + kStages - 1,
                 smem + ((c + kStages - 1) % kStages) * kStage);
    sm90::cp_async_commit();
    const float* zs = smem + (c % kStages) * kStage;
    const float* es = zs + kBM * kLd;
#pragma unroll
    for (int q = 0; q < kBK / 4; ++q) {
      float4 av[kTM], bv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)   // the warp's rows: broadcasts
        av[i] = *reinterpret_cast<const float4*>(zs + (rg * kTM + i) * kLd +
                                                 4 * q);
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        bv[j] = *reinterpret_cast<const float4*>(es + (lane + 32 * j) * kLd +
                                                 4 * q);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
          acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
          acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
          acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
        }
    }
    if (t < kBN) {
#pragma unroll
      for (int q = 0; q < kBK / 4; ++q) {
        const float4 e = *reinterpret_cast<const float4*>(es + t * kLd +
                                                          4 * q);
        e2 = fmaf(e.x, e.x, e2);
        e2 = fmaf(e.y, e.y, e2);
        e2 = fmaf(e.z, e.z, e2);
        e2 = fmaf(e.w, e.w, e2);
      }
    }
  }
  sm90::cp_async_wait<0>();
  __syncthreads();   // every chunk read: the stages are free

  float* e2s = smem;   // [kBN]
  if (t < kBN) e2s[t] = e2;
  __syncthreads();
  float half_e2[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) half_e2[j] = 0.5f * e2s[lane + 32 * j];

  // each row's best over this block's codes: ascending j in the thread,
  // then across the warp's 32 lanes (which hold the same rows)
  float best[kTM];
  int best_i[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    best[i] = -INFINITY;
    best_i[i] = k0;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int code = k0 + lane + 32 * j;
      const float s = acc[i][j] - half_e2[j];
      if (code < K && s > best[i]) {
        best[i] = s;
        best_i[i] = code;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float s2 = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int i2 = __shfl_xor_sync(0xffffffffu, best_i[i], off);
      if (beats(s2, i2, best[i], best_i[i])) {
        best[i] = s2;
        best_i[i] = i2;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = m0 + rg * kTM + i;
    if (lane == i && row < M) {
      part_score[static_cast<long long>(ct) * M + row] = best[i];
      part_idx[static_cast<long long>(ct) * M + row] = best_i[i];
    }
  }
  __threadfence();
  __syncthreads();
  if (t == 0) {
    const unsigned ticket = atomicAdd(&counters[blockIdx.y], 1u);
    is_last = ticket == static_cast<unsigned>(n_ct - 1);
    if (is_last) atomicExch(&counters[blockIdx.y], 0u);  // for the next call
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // the last block of this row tile merges the code tiles in order
  if (t < kBM && m0 + t < M) {
    const int row = m0 + t;
    float s = -INFINITY;
    int idx = 0;
    for (int c = 0; c < n_ct; ++c) {
      const float s2 = __ldcg(part_score + static_cast<long long>(c) * M + row);
      const int i2 = __ldcg(part_idx + static_cast<long long>(c) * M + row);
      if (c == 0 || beats(s2, i2, s, idx)) {
        s = s2;
        idx = i2;
      }
    }
    out[row] = idx;
  }
}

}  // namespace
}  // namespace mmvid

// z [M, D] fp32, codebook [K, D] fp32, both contiguous and 16-byte
// aligned; D a multiple of 4; 0 < M, 0 < K, ceil(M / 64) <= 65535.
// Scratch: part_score [ceil(K / 128), M] fp32 and part_idx of the same
// shape int32, and counters [ceil(M / 64)] uint32, zero before the first
// call on a stream (each call leaves them zero).  Writes idx [M] int64.
// Returns cudaGetLastError() after the launch.
extern "C" int mmvid_nearest_code(const void* z, const void* codebook, int M,
                                  int D, int K, void* part_score,
                                  void* part_idx, void* counters, void* idx,
                                  void* stream) {
  using namespace mmvid;
  const int row_tiles = (M + kBM - 1) / kBM;
  if (M <= 0 || D <= 0 || K <= 0 || D % 4 != 0 || row_tiles > 65535)
    return cudaErrorInvalidValue;
  static bool smem_set[64] = {};   // once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !smem_set[dev]) {
    err = cudaFuncSetAttribute(nearest_code_tiled_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return err;
    if (dev < 64) smem_set[dev] = true;
  }
  const dim3 grid((K + kBN - 1) / kBN, row_tiles);
  nearest_code_tiled_kernel<<<grid, kThreads, kSmemBytes,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const float*>(codebook), M, D,
      K, static_cast<float*>(part_score), static_cast<int*>(part_idx),
      static_cast<unsigned*>(counters), static_cast<long long*>(idx));
  return cudaGetLastError();
}
