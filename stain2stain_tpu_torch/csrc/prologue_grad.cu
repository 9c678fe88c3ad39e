// K4: the prologue's gradient for Hopper (sm_90a).
//
// Replaces the TPU kernel stain2stain_tpu/ops/pallas_conv.py::_prologue_grad_kernel
// (launched by ::prologue_grad). Same function: given x and dn (the gradient of
// n = dropout(act(x*scale + shift))), both (B, H, W, C) bf16,
//     dz = dn * act'(z) * mask,  dx = bf16(dz * scale),
//     dscale[b, c] = sum_hw dz * x,  dshift[b, c] = sum_hw dz      (f32)
// with the mask regenerated from the hash of conv_common.cuh, as K2 made it.
//
// Bound on the H100: elementwise, 3 * 2 bytes per element (x and dn read, dx
// written) at 3.35 TB/s: 0.481 ms at the flagship's first level (B 32,
// 256x256, C 128, 1.61e9 bytes), 0.060 ms at its lowest (B 32, 32x32, C 1024).
// Its ~30 operations per element (two of them on the MUFU: the exponential and
// the reciprocal of the sigmoid) take about half of that if they overlap the
// loads, so the design is about keeping bytes in flight and the math free of
// branches. On the H100 it reaches 92 % of the time a torch.add of the same
// bytes takes (PERF.md, PR 6):
//   * the prologue's Kind is picked once (with_kind), so the loop is straight-
//     line code with no flag tests; a thread's 8 channels load their scale and
//     shift once (channel_factors); the sigmoid is conv_common.cuh's, as in K2
//     and K5 (ex2.approx.ftz and an approximate reciprocal);
//   * a block of 128 threads covers 64 channels (8 lanes x 16 bytes) of 16
//     pixel lanes, 4 pixels a thread: 64 pixels a step. The next step's x and
//     dn (8 x 16 bytes a thread) are copied into shared memory by cp.async
//     while a step is computed, so loads stay in flight through the math
//     without registers to hold them (80 registers and 34 KB a block: 6
//     blocks an SM; scripts/torch_kernel_variants.py times the alternative);
//   * the block walks one slice of one image's pixels; the slice length comes
//     from ops/conv.py::prologue_grad_geometry, which cuts the pixels finely
//     enough to fill the card several times over at every flagship shape;
//   * two deterministic passes, no atomics, so two runs give the same bits:
//     each block adds its lanes' sums by warp shuffles (a fixed butterfly) and
//     its 4 warps through shared memory in order, and writes one f32 partial
//     per (image, slice, channel); then a block per (sum, image, 32 channels)
//     adds the slices' partials, 8 warps over interleaved slices and then the
//     warps in order (one thread per (image, channel) would leave most of the
//     card idle: 16 blocks at the first level).
// Launches on the caller's stream, allocates nothing (the wrapper allocates
// the partials), and returns cudaGetLastError().

#include "conv_common.cuh"
#include "mma_common.cuh"

namespace {

using namespace s2s_conv;
using s2s_mma::cp_async16;
using s2s_mma::cp_async_commit;
using s2s_mma::cp_async_wait;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCh = 64;                   // channels of a block
constexpr int kVecs = kCh / 8;            // 16-byte vectors across them: lanes 0-7, 8-15, ... of a warp
constexpr int kLanes = kThreads / kVecs;  // pixel lanes, 4 a warp
constexpr int kUnroll = 4;                // pixels of a thread a step
constexpr int kStep = kLanes * kUnroll;   // pixels of a block step (ops/conv.py: _K4_STEP_PX)
constexpr int kLoads = 2 * kUnroll;       // 16-byte loads of a thread a step: x and dn

// dz of 8 channels of one pixel; writes dx and adds dz*x and dz to the sums.
template <class K>
__device__ __forceinline__ uint4 grad8(K, uint4 xr, uint4 dr, const Prologue& p, const float (&s)[8],
                                       const float (&t)[8], uint32_t index, float (&sum_scale)[8],
                                       float (&sum_shift)[8]) {
  const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&xr);
  const __nv_bfloat162* dv = reinterpret_cast<const __nv_bfloat162*>(&dr);
  uint4 out;
  __nv_bfloat162* ov = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 xf = __bfloat1622float2(xv[j]);
    const float2 df = __bfloat1622float2(dv[j]);
    const float xs[2] = {xf.x, xf.y};
    float dz[2] = {df.x, df.y};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ch = 2 * j + e;
      if constexpr (K::silu) {
        float z = xs[e];  // z*s + t rounds as the plain version rounds it (no FMA contraction)
        if constexpr (K::affine) z = __fadd_rn(__fmul_rn(z, s[ch]), t[ch]);
        const float sg = sigmoid(z);
        dz[e] = dz[e] * (sg * (1.f + z * (1.f - sg)));
      }
      if constexpr (K::dropout) dz[e] = dz[e] * keep(p, index + ch);
      sum_scale[ch] += dz[e] * xs[e];
      sum_shift[ch] += dz[e];
      if constexpr (K::affine) dz[e] = dz[e] * s[ch];
    }
    ov[j] = __floats2bfloat162_rn(dz[0], dz[1]);
  }
  return out;
}

__global__ void __launch_bounds__(kThreads)
prologue_grad_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dn,
                     __nv_bfloat16* __restrict__ dx, float* __restrict__ part_scale,
                     float* __restrict__ part_shift, int HW, int C, int slice_px, int slices, Prologue pro) {
  __shared__ __align__(16) uint4 buf[2][kLoads][kThreads];  // 32 KB: two steps of x and dn
  __shared__ float red[kWarps][2][kCh];

  // blocks in (image, slice, channel block) order: neighbours read the same pixels
  const int chunks = C / kCh;
  const int bs = blockIdx.x / chunks;
  const int chunk = blockIdx.x - bs * chunks;
  const int b = bs / slices;
  const int sl = bs - b * slices;
  const int tid = threadIdx.x;
  const int v = tid % kVecs;
  const int lane = tid / kVecs;
  const int c = chunk * kCh + 8 * v;

  float sc[8], sh[8];
  channel_factors(pro, b, c, C, sc, sh);
  float sum_scale[8], sum_shift[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) sum_scale[e] = sum_shift[e] = 0.f;

  const int p_end = min(HW, (sl + 1) * slice_px);
  // Step i's x and dn land in buf[i % 2] by cp.async while step i - 1 is
  // computed: the loads stay in flight through the math, at no register cost.
  // A thread reads back only the chunks it copied itself, so waiting for its
  // own copies is enough. Pixels past the slice are zero-filled: their dz is
  // 0 and adds nothing.
  auto issue = [&](int stage, int p0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + u * kLanes;
      const bool valid = p < p_end;
      const int64_t off = valid ? (static_cast<int64_t>(b) * HW + p) * C + c : 0;
      cp_async16(&buf[stage][2 * u][tid], x + off, valid);
      cp_async16(&buf[stage][2 * u + 1][tid], dn + off, valid);
    }
    cp_async_commit();
  };
  int p0 = sl * slice_px + lane;
  issue(0, p0);
  with_kind(pro, [&](auto kind) {
    for (int stage = 0; p0 < p_end; p0 += kStep, stage ^= 1) {
      issue(stage ^ 1, p0 + kStep);
      cp_async_wait<1>();  // this step's copies have landed
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = p0 + u * kLanes;
        const uint32_t pix = static_cast<uint32_t>(b * HW + p);
        const uint4 out = grad8(kind, buf[stage][2 * u][tid], buf[stage][2 * u + 1][tid], pro, sc, sh,
                                pix * static_cast<uint32_t>(C) + static_cast<uint32_t>(c), sum_scale, sum_shift);
        if (p < p_end) *reinterpret_cast<uint4*>(dx + static_cast<int64_t>(pix) * C + c) = out;
      }
    }
  });
  cp_async_wait<0>();  // the last, empty step's copies: none are left in flight

  // the warp's 4 pixel lanes (lanes 8 apart) by a butterfly, then the warps in order
#pragma unroll
  for (int e = 0; e < 8; ++e) {
#pragma unroll
    for (int off = kVecs; off < 32; off <<= 1) {
      sum_scale[e] += __shfl_xor_sync(0xffffffffu, sum_scale[e], off);
      sum_shift[e] += __shfl_xor_sync(0xffffffffu, sum_shift[e], off);
    }
  }
  const int warp = tid >> 5;
  if ((tid & 31) < kVecs) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      red[warp][0][8 * v + e] = sum_scale[e];
      red[warp][1][8 * v + e] = sum_shift[e];
    }
  }
  __syncthreads();
  static_assert(kThreads == 2 * kCh, "one thread per (sum, channel)");
  const int which = tid / kCh;
  const int ch = tid - which * kCh;
  float total = red[0][which][ch];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) total += red[w][which][ch];
  float* part = which ? part_shift : part_scale;
  part[(static_cast<int64_t>(b) * slices + sl) * C + chunk * kCh + ch] = total;
}

constexpr int kRedCh = 32;     // channels of a reduce block: one a lane
constexpr int kRedWarps = 8;   // slice lanes: warp w adds slices w, w + 8, ...

// Pass 2: one block per (sum, image, 32 channels). Warp w adds the partials
// of slices w, w + 8, ... in order, then the 8 warps' sums are added in warp
// order: a fixed order, so two runs give the same bits.
__global__ void __launch_bounds__(32 * kRedWarps)
prologue_grad_reduce(const float* __restrict__ partial, float* __restrict__ sums, int B, int C, int slices) {
  __shared__ float red[kRedWarps][kRedCh];
  const int groups = C / kRedCh;
  const int which_b = blockIdx.x / groups;  // (sum, image): dscale rows, then dshift rows
  const int c = (blockIdx.x - which_b * groups) * kRedCh + (threadIdx.x & 31);
  const int w = threadIdx.x >> 5;
  const float* src = partial + static_cast<int64_t>(which_b) * slices * C + c;
  float total = 0.f;
#pragma unroll 4
  for (int s = w; s < slices; s += kRedWarps) total += src[static_cast<int64_t>(s) * C];
  red[w][threadIdx.x & 31] = total;
  __syncthreads();
  if (w == 0) {
    float sum = red[0][threadIdx.x];
#pragma unroll
    for (int i = 1; i < kRedWarps; ++i) sum += red[i][threadIdx.x];
    sums[static_cast<int64_t>(which_b) * C + c] = sum;
  }
}

}  // namespace

// x, dn, dx (B, HW, C) bf16; partial (2, B, slices, C) f32 scratch, slices =
// ceil(HW / slice_px); sums (2, B, C) f32: dscale then dshift. slice_px is a
// multiple of 64. Returns a cudaError_t (0 = success).
extern "C" int s2s_prologue_grad(const void* x, const void* dn, void* dx, void* partial, void* sums, int B,
                                 int HW, int C, int slice_px, const void* scale, const void* shift, int silu,
                                 int dropout, uint32_t seed, uint32_t keep_threshold, float keep_scale,
                                 void* stream) {
  if (B <= 0 || HW <= 0 || C <= 0 || C % kCh || slice_px <= 0 || slice_px % kStep)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((scale == nullptr) != (shift == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const int slices = (HW + slice_px - 1) / slice_px;
  const int64_t blocks = static_cast<int64_t>(B) * slices * (C / kCh);
  if (blocks >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const Prologue pro = make_prologue(static_cast<const float*>(scale), static_cast<const float*>(shift), silu,
                                     dropout, seed, keep_threshold, keep_scale);
  float* part_scale = static_cast<float*>(partial);
  float* part_shift = part_scale + static_cast<int64_t>(B) * slices * C;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  prologue_grad_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dn),
      static_cast<__nv_bfloat16*>(dx), part_scale, part_shift, HW, C, slice_px, slices, pro);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  prologue_grad_reduce<<<2 * B * (C / kRedCh), 32 * kRedWarps, 0, s>>>(part_scale, static_cast<float*>(sums), B, C,
                                                                       slices);
  return static_cast<int>(cudaGetLastError());
}
