// The grid-step probe: what a kernel launch costs on the H100, hand-written
// for Hopper (sm_90a).
//
// Replaces the TPU kernel of scripts/probe_gridstep.py (its pallas_call),
// which measures the cost of one step of a sequential (12, 16) Pallas grid.
// The function is the same: 12 chained layers
//     x <- x + (bf16(x) @ W_l) * 1e-3,   x [B, D] fp32, W_l [D, D] bf16
// (W_l = the probe's W[l, 0], here in the [out, in] layout), and the plain
// reference is mmvid_tpu_torch/ops/gridstep.py::probe_call_reference.
// A GPU has no sequential grid, so the probe computes one call in three
// launch structures and times 64 chained calls of each:
//   * 1 launch a call: one persistent cooperative kernel runs all 12 layers,
//     with a grid-wide barrier between them (what a whole-step decode
//     kernel would do);
//   * 12 launches a call: one kernel a layer;
//   * 192 launches a call: one a TPU grid step, the 15 idle phases of each
//     layer launched as kernels that return at once.
// The differences between the three times give the cost of a launch and of
// a grid barrier.  What bounds the function itself: 2 B D^2 12 64
// operations on the tensor cores (14.5 GFLOP, 0.015 ms at the bf16 peak);
// its bytes (the 12 weight blocks once, 14.2 MB) take 0.004 ms.
//
// Each layer is 48 blocks of 16 output columns (mma_rows.cuh).  Layers read
// and write two ping-pong buffers, since every block reads all of x; the
// persistent kernel reads x through L2 only (__ldcg), as its L1 may hold
// a stale copy from two layers before.

#include "mma_rows.cuh"

namespace mmvid {
namespace {

constexpr float kProbeStep = 1e-3f;

// columns tile * 16 .. + 16 of dst = src + (bf16(src) @ W^T) * 1e-3
__device__ __forceinline__ void probe_tile(const float* src, float* dst,
                                           const __nv_bfloat16* w, int B,
                                           int D, int tile, float* red) {
  const int warp = threadIdx.x / 32;
  const int n0 = tile * kMmaCols, groups = D / 32;
  auto load8 = [&](int r, int k, float* v) {
    const float4* p = reinterpret_cast<const float4*>(
        src + static_cast<long long>(r) * D + k);
    const float4 lo = __ldcg(p), hi = __ldcg(p + 1);
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  };
  MmaAcc acc;
  mma_rows_partial(w, D, n0, B, warp * groups / kMmaWarps,
                   (warp + 1) * groups / kMmaWarps, load8, acc);
  mma_rows_reduce(acc, red, B, [&](int r, int c, float sum) {
    const long long i = static_cast<long long>(r) * D + n0 + c;
    dst[i] = __ldcg(src + i) + sum * kProbeStep;
  });
  __syncthreads();  // red is reused by the block's next tile
}

__global__ void __launch_bounds__(kMmaThreads)
    probe_layer_kernel(const float* src, float* dst,
                       const __nv_bfloat16* __restrict__ w, int B, int D,
                       int compute) {
  __shared__ float red[kMmaRedFloats];
  if (!compute) return;  // an idle grid step
  probe_tile(src, dst, w, B, D, blockIdx.x, red);
}

__global__ void __launch_bounds__(kMmaThreads)
    probe_persistent_kernel(const float* x, float* out, float* scratch,
                            const __nv_bfloat16* __restrict__ w, int B, int D,
                            int layers, unsigned* barrier) {
  __shared__ float red[kMmaRedFloats];
  const int tiles = D / kMmaCols;
  const long long bd = static_cast<long long>(B) * D;
  for (int l = 0; l < layers; ++l) {
    const float* src = l == 0 ? x : scratch + ((l - 1) % 2) * bd;
    float* dst = l == layers - 1 ? out : scratch + (l % 2) * bd;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
      probe_tile(src, dst, w + l * static_cast<long long>(D) * D, B, D, tile,
                 red);
    if (l + 1 < layers) grid_barrier(barrier, barrier + 1);
  }
}

}  // namespace
}  // namespace mmvid

// x [B, D] fp32; w [layers, D, D] bf16 ([out, in]); out [B, D] fp32;
// scratch [2, B, D] fp32; barrier: 2 uints, zeroed before the first call.
// launches: 1 (persistent), layers, or layers * phases (phases - 1 idle
// launches after each layer).  All contiguous, 16-byte aligned; D a
// multiple of 32, 1 <= B <= 64.  Returns cudaGetLastError() after the
// launches.
extern "C" int mmvid_gridstep(const void* x, const void* w, void* out,
                              void* scratch, void* barrier, int B, int D,
                              int layers, int launches, void* stream) {
  using namespace mmvid;
  if (B < 1 || B > kMmaMaxRows || D <= 0 || D % 32 != 0 || layers < 1 ||
      launches < 1 || (launches != 1 && launches % layers != 0))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  float* sp = static_cast<float*>(scratch);
  const auto* wp = static_cast<const __nv_bfloat16*>(w);
  unsigned* bp = static_cast<unsigned*>(barrier);
  const int tiles = D / kMmaCols;
  if (launches == 1) {
    void* args[] = {&xp, &op, &sp, &wp, &B, &D, &layers, &bp};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(probe_persistent_kernel), dim3(tiles),
        dim3(kMmaThreads), args, 0, s);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
  const int phases = launches / layers;
  const long long bd = static_cast<long long>(B) * D;
  for (int l = 0; l < layers; ++l) {
    const float* src = l == 0 ? xp : sp + ((l - 1) % 2) * bd;
    float* dst = l == layers - 1 ? op : sp + (l % 2) * bd;
    for (int ph = 0; ph < phases; ++ph) {
      probe_layer_kernel<<<tiles, kMmaThreads, 0, s>>>(
          src, dst, wp + l * static_cast<long long>(D) * D, B, D, ph == 0);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}
