// One whole ART-V decode step (every block, one token), bf16, redesigned
// for Hopper (sm_90a) so that the weights stream at the card's rate.
// bf16 only; ops/artv_decode.py::decode_token_step launches it when asked
// for (kernel='stream'), and the phased kernel of csrc/artv_decode.cu
// otherwise (see the end of this note).
//
// Replaces the TPU kernel mmvid_tpu/ops/artv_decode.py::decode_token_step
// and computes the function of the plain reference
// mmvid_tpu_torch/ops/artv_decode.py::decode_token_step_reference with its
// rounding points (fp32 LN statistics, h, the attention context, the
// cache-row probabilities and the MLP activations rounded to bf16, fp32
// sums); only the order of the fp32 sums differs.
//
// What bounds it on the H100: bytes.  A step streams 12 D^2 weights a
// block (169.9 MB at 768 x 12 layers) and the live cache rows: 0.116 ms at
// pos 370, B 16.  The phased kernel (artv_decode.cu) ran at 6x that: two
// 16-byte loads in flight a thread, 48 tiles for 132 SMs in the D-column
// products, 60 grid barriers a step, and the LN statistics recomputed per
// tile.
//
// Design.  One persistent cooperative launch a token, one block per SM:
// - Work items.  Per layer: QKV (3D / 16 tiles of 16 output columns, K =
//   D), attention (one per (head, batch row)), out-proj (D / 16 tiles),
//   fc (4D / 16 tiles), proj split along K into 4 chunks of D (D / 16 x 4
//   items).  Item u of a layer (counted over the five kinds in that
//   order) belongs to block u % gridDim.x, so the blocks share a layer's
//   bytes evenly and every SM streams in every phase (768 items a layer at
//   D 768, B 16).
// - A weight stream that runs ahead.  Warp 8 of each block is a producer:
//   it walks the block's items of every layer in order and copies each
//   one's 16 weight rows (K bf16 values each) into a ring of shared-memory
//   slots with 1-D bulk copies (cp.async.bulk, one a row, completion
//   counted on the slot's mbarrier).  It waits only for free slots, never
//   for another block, so the stream crosses phase and layer boundaries.
//   Rows are stored 64 bytes apart beyond their length, so the consumers'
//   16-byte fragment loads hit distinct banks.  The ring takes what shared
//   memory is left: 7 slots (179 KB in flight) at D 768, B 16; 3 at B 64.
// - Products.  Eight consumer warps split an item's K; each holds the
//   m16n8k16 mma.sync fragments of all B rows (as in mma_rows.cuh, with
//   the same permutation of the 32 depths of a group in A and B) and reads
//   A and W from shared memory; the warps' sums meet in shared memory in a
//   fixed order.
// - LN once per block per phase.  A block stages the rows it reads as
//   bf16 in shared memory before its first item of a phase: LN1 / LN2 rows
//   from the fp32 residual (two-pass statistics on registers, one read from
//   L2), the attention context or a K chunk of the MLP activations (bf16
//   in device memory).
// - No grid barrier.  Each item publishes a flag (the call's first stamp
//   plus the layer, a value no earlier layer or call wrote) after its
//   outputs, and an item waits only for the flags of what it reads:
//   attention (h, b) for the 3 hd / 16 QKV tiles of head h, out-proj for
//   the attention items, fc for the out-proj tiles, a proj chunk for its
//   fc tiles, the next layer's QKV for the proj tiles.  A proj item writes
//   its partial
//   sums to scratch and counts itself on its column tile's counter; the
//   last to arrive adds the partials in chunk order (no float atomics:
//   the step is bitwise repeatable), the residual and the bias, and
//   publishes the tile.  Every wait is on an earlier kind of item, and
//   every block walks its items in that order, so blocks that are all
//   co-resident (the cooperative launch) cannot deadlock.  The counters
//   return to 0 within a step; the flags are never zeroed.
// - Attention as in the phased kernel (the current token seeds the
//   softmax, the pos logits in shared memory, each cache row's head slice
//   read with 16-byte loads, 16 a thread in flight), on half a block: a
//   block runs its next two attention items at once, so 192 items fit 132
//   blocks in one round.
// - The helpers the items share are called, not inlined: inlined, the
//   kernel's code was about twice the phased kernel's and every part of
//   an item ran slower (the instruction cache, by all signs).
// What sets its pace on the card (PERF.md): the chain of hand-offs between
// blocks (five a layer) and the attention items, not the weight stream.
// It is slower than the phased kernel at B 16, ART-V's batch, so the phased
// kernel stays the bf16 route and this one runs only when a caller asks
// for it (decode_token_step(..., kernel='stream')).
//
// Residual stream: the layer's input (x at layer 0, else y) -> R (after
// attention, scratch) -> y (after the MLP).  Each is written whole before
// any reader of the next layer starts, by the flags' order.

#include <atomic>

#include "mma_rows.cuh"
#include "sm90.cuh"

namespace mmvid {
namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr float kEps = 1e-5f;
constexpr int kConsumers = 256;          // 8 warps
constexpr int kWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kCols = 16;                // output columns of an item
constexpr int kRowPad = 64;              // bytes after each staged row
constexpr int kProjSplit = 4;            // proj's K chunks, D deep each
constexpr int kMaxPos = 4096;            // fp32 logits of a team, 16 KB
constexpr int kTeam = 128;               // threads of an attention item
constexpr int kVec = 8;                  // bf16 values in 16 bytes
constexpr int kMaxLnVec = 8;             // float4s of a row a lane holds
constexpr int kMaxDevices = 64;
constexpr int kMisc = 1280;              // barriers and row statistics
constexpr int kBarBytes = 256;
constexpr int kMaxSlots = 8;
// shared floats of an attention item: logits, AV partials, a reduction;
// two items run at once, one a team
constexpr int kTeamFloats = kMaxPos + kTeam * kVec + kTeam / 32;
constexpr int kAttnFloats = 2 * kTeamFloats;

enum Kind : int { kQkv = 0, kAttn = 1, kOut = 2, kFc = 3, kProj = 4 };

struct Args {
  const float* x;
  int n_layers, B, D, heads, W, pos;
  const float *ln1_w, *ln1_b, *ln2_w, *ln2_b;
  const bf16* w_qkv;
  const float* b_qkv;
  const bf16* w_out;
  const float* b_out;
  const bf16* w_fc;
  const float* b_fc;
  const bf16* w_proj;
  const float* b_proj;
  const bf16* cache_k;
  const bf16* cache_v;
  float* y;
  bf16* knew;
  bf16* vnew;
  float* scratch;
  unsigned* sync;   // flags, then the split-K counters
  unsigned stamp0;  // layer l publishes stamp0 + l + 1
  int slots;        // ring slots
  int ring_off;     // bytes from the shared base to the ring
};

// The items of one layer, in order
struct Layout {
  int nq, na, no, nf, np, total;
  __device__ Layout(const Args& a) {
    nq = 3 * a.D / kCols;
    na = a.heads * a.B;
    no = a.D / kCols;
    nf = 4 * a.D / kCols;
    np = a.D / kCols * kProjSplit;
    total = nq + na + no + nf + np;
  }
  __device__ void at(int u, int& kind, int& i) const {
    if (u < nq) { kind = kQkv; i = u; return; }
    u -= nq;
    if (u < na) { kind = kAttn; i = u; return; }
    u -= na;
    if (u < no) { kind = kOut; i = u; return; }
    u -= no;
    if (u < nf) { kind = kFc; i = u; return; }
    kind = kProj;
    i = u - nf;
  }
};

// Counters and flags in a.sync.  The counters sit at offsets no shape
// moves (a call of another B or D finds them at 0, where every step leaves
// them); a flag left by another shape holds an older step's value.
constexpr int kMaxTiles = 1024 / kCols;
struct Sync {
  unsigned *cnt_proj, *qkv, *attn, *outf, *fc, *projf;
  __device__ Sync(const Args& a) {
    const int t = a.D / kCols;
    cnt_proj = a.sync;
    qkv = cnt_proj + kMaxTiles;
    attn = qkv + 3 * t;
    outf = attn + a.heads * a.B;
    fc = outf + t;
    projf = fc + 4 * t;
  }
};

// Scratch (floats): q (scaled), v, R [B, D] fp32; the proj partials
// [4, B, D] fp32; the context [B, D] and MLP activations [B, 4D] in bf16
struct Scratch {
  float *q32, *v32, *res, *part_p;
  bf16 *ctx, *g;
  __device__ Scratch(const Args& a) {
    const long long bd = static_cast<long long>(a.B) * a.D;
    q32 = a.scratch;
    v32 = q32 + bd;
    res = v32 + bd;
    part_p = res + bd;
    ctx = reinterpret_cast<bf16*>(part_p + kProjSplit * bd);
    g = ctx + bd;
  }
};

// The weight rows of a weight item: 16 rows of K values from row n0,
// column k0 of a [N, ldw] matrix
struct Slice {
  const bf16* w;
  int ldw, n0, k0, K;
};

__device__ __forceinline__ Slice slice_of(const Args& a, int l, int kind,
                                          int i) {
  const long long dd = static_cast<long long>(a.D) * a.D;
  const int D = a.D;
  switch (kind) {
    case kQkv:
      return {a.w_qkv + l * 3 * dd, D, i * kCols, 0, D};
    case kOut:
      return {a.w_out + l * dd, D, i * kCols, 0, D};
    case kFc:
      return {a.w_fc + l * 4 * dd, D, i * kCols, 0, D};
    default:
      return {a.w_proj + l * 4 * dd, 4 * D, i / kProjSplit * kCols,
              i % kProjSplit * D, D};
  }
}

__device__ __forceinline__ int row_stride(int K) { return 2 * K + kRowPad; }

__device__ __forceinline__ void consumers_sync() {
  named_sync(1, kConsumers);
}

// Warp 0 of the consumers polls until flags[0 .. n) all equal `stamp`
// (relaxed loads, then one acquire fence).  A wait of about 2^26 polls
// (seconds) traps.
__device__ __noinline__ void poll_flags(const unsigned* flags, int n,
                                        unsigned stamp) {
  for (int i = threadIdx.x; i < n; i += 32) {
    const volatile unsigned* f = flags + i;
    for (uint32_t polls = 0; *f != stamp; ++polls) {
      if (polls == (1u << 26)) __trap();
      __nanosleep(32);
    }
  }
  __syncwarp();
  __threadfence();
}

// poll_flags, then the consumers meet
__device__ void wait_flags(const unsigned* flags, int n, unsigned stamp) {
  if (threadIdx.x < 32) poll_flags(flags, n, stamp);
  consumers_sync();
}

// After the consumers' writes of an item: publish its flag.  The
// barrier orders the block's writes before thread 0's release store, whose
// release is cumulative over them (no separate fence)
__device__ __forceinline__ void publish(unsigned* flag, unsigned stamp) {
  consumers_sync();
  if (threadIdx.x == 0) flag_release(flag, stamp);
}

// Stage LN(src) [B, D] fp32 (device memory, written by other blocks) as
// bf16 rows at `a_sm` (row stride 2D + kRowPad), rows B .. 16-padded zero.
// One warp two rows at a time, the rows and the LN params in registers,
// all their loads in flight together: one read of src from L2.
__device__ __noinline__ void stage_ln(const float* src, const float* ln_w,
                         const float* ln_b, int B, int D, char* a_sm) {
  constexpr int kPair = 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n4 = D / 4, as = row_stride(D);
  const int rows = (B + 15) / 16 * 16;
  float4 w[kMaxLnVec], bias[kMaxLnVec];
#pragma unroll
  for (int j = 0; j < kMaxLnVec; ++j) {
    const int i = lane + 32 * j;
    if (i < n4) {
      w[j] = reinterpret_cast<const float4*>(ln_w)[i];
      bias[j] = reinterpret_cast<const float4*>(ln_b)[i];
    }
  }
  for (int r0 = warp; r0 < rows; r0 += kPair * kWarps) {
    float4 v[kPair][kMaxLnVec];
#pragma unroll
    for (int h = 0; h < kPair; ++h) {
      const int r = r0 + h * kWarps;
      const float4* row = reinterpret_cast<const float4*>(
          src + static_cast<long long>(r < B ? r : 0) * D);
#pragma unroll
      for (int j = 0; j < kMaxLnVec; ++j) {
        const int i = lane + 32 * j;
        v[h][j] = i < n4 && r < B ? __ldcg(row + i)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int h = 0; h < kPair; ++h) {
      const int r = r0 + h * kWarps;
      if (r >= rows) continue;
      uint2* dst = reinterpret_cast<uint2*>(a_sm + r * as);
      if (r >= B) {
        for (int i = lane; i < n4; i += 32) dst[i] = make_uint2(0, 0);
        continue;
      }
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxLnVec; ++j)
        s += (v[h][j].x + v[h][j].y) + (v[h][j].z + v[h][j].w);
      const float mu = warp_sum(s) / D;
      float s2 = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxLnVec; ++j) {
        if (lane + 32 * j < n4) {
          const float4 x = v[h][j];
          s2 = fmaf(x.x - mu, x.x - mu, s2);
          s2 = fmaf(x.y - mu, x.y - mu, s2);
          s2 = fmaf(x.z - mu, x.z - mu, s2);
          s2 = fmaf(x.w - mu, x.w - mu, s2);
        }
      }
      const float rstd = rsqrtf(warp_sum(s2) / D + kEps);
      // ((x - mu) * rstd) * w + b, each step rounded as the plain version
      // rounds it (no contraction), then to bf16
      auto ln = [&](float x, float wv, float bv) {
        return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mu), rstd), wv),
                         bv);
      };
#pragma unroll
      for (int j = 0; j < kMaxLnVec; ++j) {
        const int i = lane + 32 * j;
        if (i < n4) {
          const float4 x = v[h][j];
          dst[i] = make_uint2(
              pack_bf16x2(ln(x.x, w[j].x, bias[j].x),
                          ln(x.y, w[j].y, bias[j].y)),
              pack_bf16x2(ln(x.z, w[j].z, bias[j].z),
                          ln(x.w, w[j].w, bias[j].w)));
        }
      }
    }
  }
}

// Stage columns k0 .. k0 + K of bf16 rows [B, ld] (device memory) at
// `a_sm` (row stride 2K + kRowPad), rows B .. 16-padded zero
__device__ __noinline__ void stage_rows(const bf16* src, int ld, int k0,
                                        int K, int B, char* a_sm) {
  const int per_row = K / kVec, as = row_stride(K);
  const int rows = (B + 15) / 16 * 16;
  for (int o = threadIdx.x; o < rows * per_row; o += kConsumers) {
    const int r = o / per_row, c = o % per_row;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < B)
      v = __ldcg(reinterpret_cast<const uint4*>(
          src + static_cast<long long>(r) * ld + k0) + c);
    *reinterpret_cast<uint4*>(a_sm + r * as + c * 16) = v;
  }
}

// This warp's partial sums of A [rows, K] . W^T [K, 16] over its share of
// the 32-deep groups (A and W bf16 in shared memory, row strides 2K +
// kRowPad; m16n8k16 fragments as in mma_rows.cuh), stored in its part of
// red (row_groups * 256 floats a warp)
__device__ __noinline__ void item_product(const char* a_sm,
                                          const char* w_sm, int K,
                                          int row_groups, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int st = row_stride(K);
  MmaAcc acc;
#pragma unroll
  for (int mg = 0; mg < kMmaRowGroups; ++mg)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mg][nt][e] = 0.f;
  const int groups = K / 32;
  const int kg0 = warp * groups / kWarps, kg1 = (warp + 1) * groups / kWarps;
  for (int kg = kg0; kg < kg1; ++kg) {
    const int off = (kg * 32 + 8 * t) * 2;
    const uint4 wa = *reinterpret_cast<const uint4*>(w_sm + g * st + off);
    const uint4 wb =
        *reinterpret_cast<const uint4*>(w_sm + (8 + g) * st + off);
    const uint32_t bw[2][4] = {{wa.x, wa.y, wa.z, wa.w},
                               {wb.x, wb.y, wb.z, wb.w}};
#pragma unroll
    for (int mg = 0; mg < kMmaRowGroups; ++mg) {
      if (mg < row_groups) {
        const uint4 a0 = *reinterpret_cast<const uint4*>(
            a_sm + (mg * 16 + g) * st + off);
        const uint4 a1 = *reinterpret_cast<const uint4*>(
            a_sm + (mg * 16 + 8 + g) * st + off);
        const uint32_t ua[2][4] = {{a0.x, a0.y, a0.z, a0.w},
                                   {a1.x, a1.y, a1.z, a1.w}};
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
  }
  float* mine = red + warp * row_groups * 256;
#pragma unroll
  for (int mg = 0; mg < kMmaRowGroups; ++mg)
    if (mg < row_groups)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mine[((mg * 2 + nt) * 32 + lane) * 4 + e] = acc[mg][nt][e];
}

// What an item does with each of its B x 16 sums
struct Epi {
  int kind, n0, D;
  float scale;        // kQkv: hd^-0.5
  const float* bias;  // the layer's bias of the product
  const float* src;   // kOut: the layer's input residual
  float* f0;          // kQkv: q; kOut: R; kProj: this chunk's partials
  float* f1;          // kQkv: v (fp32)
  bf16* h0;           // kQkv: k_new; kFc: the MLP activations
  bf16* h1;           // kQkv: v_new
};

// Add the 8 warps' partials in red (warp 0 first) and store each output
// (row r < B, column n0 + c) as `e` says
__device__ __noinline__ void item_outputs(const float* red, int B,
                                          int row_groups, Epi e) {
  const int per_warp = row_groups * 256;
  for (int o = threadIdx.x; o < B * kCols; o += kConsumers) {
    const int r = o / kCols, c = o % kCols;
    const int mg = r / 16, rr = r % 16, nt = c / 8, cc = c % 8;
    const int idx = ((mg * 2 + nt) * 32 + (rr % 8) * 4 + cc / 2) * 4 +
                    (rr / 8) * 2 + cc % 2;
    float sum = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) sum += red[wi * per_warp + idx];
    const int n = e.n0 + c;
    switch (e.kind) {
      case kQkv: {
        const float v = sum + e.bias[n];
        const int part = n / e.D;
        const long long j = static_cast<long long>(r) * e.D + n % e.D;
        if (part == 0) {
          e.f0[j] = v * e.scale;
        } else if (part == 1) {
          e.h0[j] = __float2bfloat16(v);
        } else {
          e.f1[j] = v;
          e.h1[j] = __float2bfloat16(v);
        }
        break;
      }
      case kOut: {
        const long long j = static_cast<long long>(r) * e.D + n;
        e.f0[j] = __ldcg(e.src + j) + (sum + e.bias[n]);
        break;
      }
      case kFc: {
        const float f = sum + e.bias[n];
        e.h0[static_cast<long long>(r) * 4 * e.D + n] =
            __float2bfloat16(f * (1.f / (1.f + expf(-1.702f * f))));
        break;
      }
      default:
        e.f0[static_cast<long long>(r) * e.D + n] = sum;
    }
  }
}

// The proj split-K tail: this item's partials are written; the last of
// the tile's kProjSplit items to count itself adds them in chunk order,
// y = (R + sum) + b, and publishes the tile's flag
__device__ __noinline__ void proj_tail(unsigned* cnt, const float* part,
                                       const float* res, const float* bias,
                                       float* y, int B, int D, int n0,
                                       unsigned* flag, unsigned stamp,
                                       int* last_flag) {
  consumers_sync();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned old = atomicAdd(cnt, 1u);
    const int last = old == static_cast<unsigned>(kProjSplit - 1);
    if (last) atomicExch(cnt, 0u);
    __threadfence();
    *last_flag = last;
  }
  consumers_sync();
  if (!*last_flag) return;
  const long long bd = static_cast<long long>(B) * D;
  for (int o = threadIdx.x; o < B * kCols; o += kConsumers) {
    const int r = o / kCols, n = n0 + o % kCols;
    const long long j = static_cast<long long>(r) * D + n;
    float sum = __ldcg(part + j);
#pragma unroll
    for (int s = 1; s < kProjSplit; ++s) sum += __ldcg(part + s * bd + j);
    y[j] = (__ldcg(res + j) + sum) + bias[n];
  }
  publish(flag, stamp);
}

// the threads of attention team `team` meet (named barriers 2 and 3)
__device__ __forceinline__ void team_sync(int team) {
  named_sync(2 + team, kTeam);
}

// max or sum over the team's threads, in each
__device__ __forceinline__ float team_reduce(float v, float* sh, bool max,
                                             int team) {
  const int warp = (threadIdx.x % kTeam) / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = max ? fmaxf(v, o) : v + o;
  }
  team_sync(team);  // sh may still be read by an earlier reduction
  if (lane == 0) sh[warp] = v;
  team_sync(team);
  v = sh[0];
  for (int i = 1; i < kTeam / 32; ++i) v = max ? fmaxf(v, sh[i]) : v + sh[i];
  return v;
}

// sum over aligned groups of `width` lanes (a power of two), in each lane
__device__ __forceinline__ float group_sum(float v, int width) {
  for (int off = width / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void load16(const bf16* p, float* out,
                                       bool fresh) {
  const uint4* src = reinterpret_cast<const uint4*>(p);
  const uint4 raw = fresh ? __ldcg(src) : __ldg(src);
  const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int e = 0; e < kVec; ++e) out[e] = __bfloat162float(v[e]);
}

// Attention of batch row b, head h, by the 128 threads of team `team`
// (the phased kernel's item on half the block, so that a block runs two
// at once): the current token over its cache rows < pos, seeded by the
// token itself; the context rounded to bf16.  smem: kTeamFloats.
__device__ void attention_item(const Args& a, const Scratch& sc,
                               const bf16* ck, const bf16* cv,
                               const bf16* knew, int h, int b, float* smem,
                               int team) {
  const int D = a.D, hd = D / a.heads, pos = a.pos;
  const int tt = threadIdx.x % kTeam;
  float* s = smem;  // [pos] logits, then probabilities
  float* part = smem + kMaxPos;
  float* sh = part + kTeam * kVec;
  const int lanes = hd / kVec;               // lanes per row: 4 or 8
  const int c = tt % lanes;                  // this lane's 16-byte slice
  const int rows = kTeam / lanes;            // rows per pass
  const int r0 = tt / lanes;
  const long long head0 = static_cast<long long>(b) * D + h * hd;
  float qf[kVec], qr[kVec], kn[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) qf[e] = __ldcg(sc.q32 + head0 + c * kVec + e);
  load16(knew + head0 + c * kVec, kn, true);
  float cur = 0.f;
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    qr[e] = __bfloat162float(__float2bfloat16(qf[e]));
    cur = fmaf(qf[e], kn[e], cur);
  }
  cur = group_sum(cur, lanes);  // the current token's logit: fp32 q
  const long long cache0 =
      static_cast<long long>(b) * a.W * D + h * hd + c * kVec;
  // kPasses passes of `rows` cache rows at a time: every thread's loads
  // of a group are in flight together
  constexpr int kPasses = 16;
  float m = cur;
  for (int j0 = 0; j0 < pos; j0 += kPasses * rows) {
    uint4 raw[kPasses];
#pragma unroll
    for (int q = 0; q < kPasses; ++q) {
      const int j = j0 + q * rows + r0;
      raw[q] = j < pos ? __ldg(reinterpret_cast<const uint4*>(
                             ck + cache0 + static_cast<long long>(j) * D))
                       : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int q = 0; q < kPasses; ++q) {
      const int j = j0 + q * rows + r0;
      const bf16* kv = reinterpret_cast<const bf16*>(&raw[q]);
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        dot = fmaf(qr[e], __bfloat162float(kv[e]), dot);
      dot = group_sum(dot, lanes);
      if (j < pos) {
        if (c == 0) s[j] = dot;
        m = fmaxf(m, dot);
      }
    }
  }
  m = team_reduce(m, sh, true, team);  // also orders the s[] writes
  float lsum = 0.f;
  for (int j = tt; j < pos; j += kTeam) {
    const float pj = expf(s[j] - m);
    s[j] = pj;
    lsum += pj;
  }
  const float pc = expf(cur - m);
  const float l = pc + team_reduce(lsum, sh, false, team);
  float acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
  for (int j0 = 0; j0 < pos; j0 += kPasses * rows) {
    uint4 raw[kPasses];
#pragma unroll
    for (int q = 0; q < kPasses; ++q) {
      const int j = j0 + q * rows + r0;
      raw[q] = j < pos ? __ldg(reinterpret_cast<const uint4*>(
                             cv + cache0 + static_cast<long long>(j) * D))
                       : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int q = 0; q < kPasses; ++q) {
      const int j = j0 + q * rows + r0;
      if (j < pos) {
        const float pj = __bfloat162float(__float2bfloat16(s[j]));
        const bf16* vv = reinterpret_cast<const bf16*>(&raw[q]);
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          acc[e] = fmaf(pj, __bfloat162float(vv[e]), acc[e]);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) part[r0 * hd + c * kVec + e] = acc[e];
  team_sync(team);
  if (tt < hd) {
    const int d = tt;
    float sum = pc * __ldcg(sc.v32 + head0 + d);
    for (int i = 0; i < rows; ++i) sum += part[i * hd + d];
    sc.ctx[head0 + d] = __float2bfloat16(sum / l);
  }
}

// The producer warp: the weight rows of the block's items, every layer,
// into the ring
__device__ void produce(const Args& a, uint32_t ring, uint32_t bars) {
  const int lane = threadIdx.x % 32;
  const Layout lay(a);
  const int slot_bytes = kCols * row_stride(a.D);
  int it = 0;
  for (int l = 0; l < a.n_layers; ++l) {
    for (int u = blockIdx.x; u < lay.total; u += gridDim.x) {
      int kind, i;
      lay.at(u, kind, i);
      if (kind == kAttn) continue;
      const Slice sl = slice_of(a, l, kind, i);
      const int slot = it % a.slots;
      const uint32_t full = bars + 8 * slot;
      const uint32_t empty = bars + 8 * (kMaxSlots + slot);
      if (it >= a.slots) mbar_wait(empty, ((it / a.slots) & 1) ^ 1);
      if (lane == 0) mbar_arrive_expect_tx(full, kCols * 2 * sl.K);
      __syncwarp();
      if (lane < kCols)
        bulk_copy(ring + slot * slot_bytes + lane * row_stride(sl.K),
                  sl.w + static_cast<long long>(sl.n0 + lane) * sl.ldw +
                      sl.k0,
                  2 * sl.K, full);
      ++it;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    artv_step_kernel_sm90(Args a) {
  extern __shared__ __align__(128) char smem[];
  const uint32_t base = smem_addr(smem);
  const uint32_t bars = base;  // full[kMaxSlots], empty[kMaxSlots]
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.slots; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kMaxSlots + s), kWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();  // the last block-wide barrier: the producer runs ahead
  if (threadIdx.x >= kConsumers) {
    produce(a, base + a.ring_off, bars);
    return;
  }

  const int B = a.B, D = a.D, hd = D / a.heads;
  const int tid = threadIdx.x, lane = tid % 32;
  const Layout lay(a);
  const Sync sy(a);
  const Scratch sc(a);
  const int row_groups = (B + 15) / 16;
  const int tiles = D / kCols;
  int* last_flag = reinterpret_cast<int*>(smem + kBarBytes);
  char* a_sm = smem + kMisc;  // staged rows, then the warps' partials
  float* red = reinterpret_cast<float*>(
      a_sm + row_groups * 16 * row_stride(D));
  float* attn_sm = reinterpret_cast<float*>(a_sm);  // aliases both
  const char* ring = smem + a.ring_off;
  const int slot_bytes = kCols * row_stride(D);
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  const long long bd = static_cast<long long>(B) * D;
  int it = 0;          // weight items consumed
  int staged = -1;     // what a_sm holds: (layer, kind, chunk)

  for (int l = 0; l < a.n_layers; ++l) {
    const unsigned stamp = a.stamp0 + l + 1;
    const float* x_in = l == 0 ? a.x : a.y;
    bf16* knew = a.knew + l * bd;
    bf16* vnew = a.vnew + l * bd;
    const long long cl = static_cast<long long>(l) * B * a.W * D;
    for (int u = blockIdx.x; u < lay.total; u += gridDim.x) {
      int kind, i;
      lay.at(u, kind, i);
      if (kind == kAttn) {
        // this item on team 0 and, when the block's next item is one
        // too, that one on team 1 at the same time
        int kind2 = -1, i2 = 0;
        if (u + static_cast<int>(gridDim.x) < lay.total)
          lay.at(u + gridDim.x, kind2, i2);
        const int n_items = kind2 == kAttn ? 2 : 1;
        if (tid < 32)  // the heads' q, k and v tiles
          for (int k = 0; k < n_items; ++k)
            for (int part = 0; part < 3; ++part)
              poll_flags(sy.qkv + (part * D + (k ? i2 : i) / B * hd) / kCols,
                         hd / kCols, stamp);
        consumers_sync();
        const int team = tid / kTeam;
        if (team < n_items) {
          const int item = team ? i2 : i;
          attention_item(a, sc, a.cache_k + cl, a.cache_v + cl, knew,
                         item / B, item % B, attn_sm + team * kTeamFloats,
                         team);
        }
        staged = -1;
        consumers_sync();
        if (tid == 0) {
          flag_release(sy.attn + i, stamp);
          if (n_items == 2) flag_release(sy.attn + i2, stamp);
        }
        if (n_items == 2) u += gridDim.x;
        continue;
      }
      // what the item reads, staged in a_sm once per (layer, kind, chunk)
      const Slice sl = slice_of(a, l, kind, i);
      const int chunk = kind == kProj ? i % kProjSplit : 0;
      const int key = (l * 8 + kind) * 8 + chunk;
      if (key != staged) {
        if (kind == kQkv) {
          if (l > 0) wait_flags(sy.projf, tiles, stamp - 1);
          stage_ln(x_in, a.ln1_w + l * D, a.ln1_b + l * D, B, D, a_sm);
        } else if (kind == kOut) {
          wait_flags(sy.attn, a.heads * B, stamp);
          stage_rows(sc.ctx, D, 0, D, B, a_sm);
        } else if (kind == kFc) {
          wait_flags(sy.outf, tiles, stamp);
          stage_ln(sc.res, a.ln2_w + l * D, a.ln2_b + l * D, B, D, a_sm);
        } else {
          wait_flags(sy.fc + sl.k0 / kCols, sl.K / kCols, stamp);
          stage_rows(sc.g, 4 * D, sl.k0, sl.K, B, a_sm);
        }
        staged = key;
        consumers_sync();
      }
      const int slot = it % a.slots;
      mbar_wait(base + 8 * slot, (it / a.slots) & 1);
      item_product(a_sm, ring + slot * slot_bytes, sl.K, row_groups, red);
      __syncwarp();
      if (lane == 0) mbar_arrive(base + 8 * (kMaxSlots + slot));
      ++it;
      consumers_sync();
      Epi e{kind, sl.n0, D, scale, nullptr, x_in, nullptr, nullptr, nullptr,
            nullptr};
      unsigned* flag = nullptr;
      if (kind == kQkv) {
        e.bias = a.b_qkv + l * 3 * D;
        e.f0 = sc.q32;
        e.f1 = sc.v32;
        e.h0 = knew;
        e.h1 = vnew;
        flag = sy.qkv + i;
      } else if (kind == kOut) {
        e.bias = a.b_out + l * D;
        e.f0 = sc.res;
        flag = sy.outf + i;
      } else if (kind == kFc) {
        e.bias = a.b_fc + l * 4 * D;
        e.h0 = sc.g;
        flag = sy.fc + i;
      } else {
        e.f0 = sc.part_p + chunk * bd;
      }
      item_outputs(red, B, row_groups, e);
      if (flag != nullptr)
        publish(flag, stamp);
      else
        proj_tail(sy.cnt_proj + sl.n0 / kCols, sc.part_p, sc.res,
                  a.b_proj + l * D, a.y, B, D, sl.n0,
                  sy.projf + sl.n0 / kCols, stamp, last_flag);
      consumers_sync();  // a_sm and red are reused by the next item
    }
  }
}

}  // namespace
}  // namespace mmvid

// bf16 only.  x [B, D] fp32; per-layer params stacked on a leading
// n_layers axis (LN params and biases fp32, weights [out, in] bf16);
// caches [n_layers, B, W, D] bf16, rows < pos read.  Writes y [B, D] fp32
// and k_new, v_new [n_layers, B, D] bf16.  scratch: 10 B D floats; sync:
// mmvid_artv_decode_sync_words(B, D, heads) uints, zeroed once before the
// first call and kept (flags and counters); stamp0: no flag word may hold
// a value in (stamp0, stamp0 + n_layers], which a caller gets by starting
// at 0 on the zeroed words and adding n_layers a call.  All contiguous and
// 16-byte aligned; D / heads in {32, 64}, D a multiple of 32 up to 1024,
// 1 <= B <= 64, pos <= min(W, 8192).  Returns the launch's error, then
// cudaGetLastError().
extern "C" int mmvid_artv_decode_sync_words(int B, int D, int heads) {
  return mmvid::kMaxTiles + 9 * (D / mmvid::kCols) + heads * B;
}

extern "C" int mmvid_artv_decode_step_sm90(
    const void* x, int n_layers, int B, int D, int heads, int W, int pos,
    const void* ln1_w, const void* ln1_b, const void* ln2_w,
    const void* ln2_b, const void* w_qkv, const void* b_qkv,
    const void* w_out, const void* b_out, const void* w_fc, const void* b_fc,
    const void* w_proj, const void* b_proj, const void* cache_k,
    const void* cache_v, void* y, void* knew, void* vnew, void* scratch,
    void* sync, unsigned stamp0, void* stream) {
  using namespace mmvid;
  if (heads <= 0 || D % heads != 0) return cudaErrorInvalidValue;
  const int hd = D / heads;
  if ((hd != 32 && hd != 64) || D % 32 != 0 || D > 4 * 32 * kMaxLnVec ||
      B < 1 || B > kMmaMaxRows || pos < 0 || pos > W || pos > kMaxPos ||
      n_layers < 1)
    return cudaErrorInvalidValue;
  const int row_groups = (B + 15) / 16;
  const int stride = 2 * D + kRowPad;
  const int a_bytes = row_groups * 16 * stride +
                      row_groups * 2 * 32 * 4 * kWarps * 4;
  const int attn_bytes = kAttnFloats * 4;
  const int ring_off =
      (kMisc + (a_bytes > attn_bytes ? a_bytes : attn_bytes) + 127) & ~127;
  const int slot_bytes = kCols * stride;
  static std::atomic<int> max_smem[kMaxDevices], sms[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (max_smem[dev].load(std::memory_order_relaxed) == 0) {
    int opt = 0, n = 0;
    if ((err = cudaDeviceGetAttribute(
             &opt, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
        cudaSuccess)
      return err;
    if ((err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    if ((err = cudaFuncSetAttribute(
             artv_step_kernel_sm90,
             cudaFuncAttributeMaxDynamicSharedMemorySize, opt)) !=
        cudaSuccess)
      return err;
    sms[dev].store(n, std::memory_order_relaxed);
    max_smem[dev].store(opt, std::memory_order_relaxed);
  }
  const int avail = max_smem[dev].load(std::memory_order_relaxed);
  int slots = (avail - ring_off) / slot_bytes;
  if (slots > kMaxSlots) slots = kMaxSlots;
  if (slots < 2) return cudaErrorInvalidValue;
  const int smem = ring_off + slots * slot_bytes;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto h = [](const void* p) { return static_cast<const bf16*>(p); };
  Args a{f(x),           n_layers,
         B,              D,
         heads,          W,
         pos,            f(ln1_w),
         f(ln1_b),       f(ln2_w),
         f(ln2_b),       h(w_qkv),
         f(b_qkv),       h(w_out),
         f(b_out),       h(w_fc),
         f(b_fc),        h(w_proj),
         f(b_proj),      h(cache_k),
         h(cache_v),     static_cast<float*>(y),
         static_cast<bf16*>(knew), static_cast<bf16*>(vnew),
         static_cast<float*>(scratch), static_cast<unsigned*>(sync),
         stamp0,
         slots,          ring_off};
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(artv_step_kernel_sm90),
      dim3(sms[dev].load(std::memory_order_relaxed)), dim3(kThreads), args,
      smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
