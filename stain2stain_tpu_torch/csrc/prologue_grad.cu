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
// 256x256, C 128, 1.61e9 bytes); its 2 exponentials and ~30 operations per
// element stay below that.
//
// Design. The TPU kernel walks an image's rows in order and accumulates
// dscale/dshift in an output block it revisits; Hopper's blocks run in no
// order. So two deterministic passes without atomics:
//   1. one block per (image, slice of `slice_px` pixels, 64 channels): 8
//      threads cover the 64 channels 16 bytes each, 32 pixel lanes walk the
//      slice; each thread writes dx and keeps 16 f32 sums in registers, the
//      block adds its lanes in a fixed order through shared memory and writes
//      one f32 partial per (image, slice, channel);
//   2. one thread per (image, channel) adds the slices' partials in order.
// Launches on the caller's stream, allocates nothing (the wrapper allocates
// the partials), and returns cudaGetLastError().

#include "conv_common.cuh"

namespace {

using namespace s2s_conv;

constexpr int kThreads = 256;
constexpr int kCh = 64;                        // channels of a block
constexpr int kVecs = kCh / 8;                 // 16-byte vectors across them
constexpr int kLanes = kThreads / kVecs;       // pixel lanes

__global__ void __launch_bounds__(kThreads)
prologue_grad_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dn,
                     __nv_bfloat16* __restrict__ dx, float* __restrict__ part_scale,
                     float* __restrict__ part_shift, int HW, int C, int slice_px, int slices, Prologue pro) {
  __shared__ float red[2][kLanes][kCh + 1];

  const int b = blockIdx.x / slices;
  const int s = blockIdx.x - b * slices;
  const int tid = threadIdx.x;
  const int v = tid % kVecs;
  const int lane = tid / kVecs;
  const int c = blockIdx.y * kCh + 8 * v;

  float a[8];  // d(affine)/dx: scale, or 1
#pragma unroll
  for (int e = 0; e < 8; ++e) a[e] = pro.scale ? __ldg(pro.scale + b * C + c + e) : 1.f;
  float sum_scale[8], sum_shift[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) sum_scale[e] = sum_shift[e] = 0.f;

  const int p_end = min(HW, (s + 1) * slice_px);
  for (int p = s * slice_px + lane; p < p_end; p += kLanes) {
    const uint32_t pix = static_cast<uint32_t>(b * HW + p);
    const int64_t off = static_cast<int64_t>(pix) * C + c;
    const uint4 xr = __ldg(reinterpret_cast<const uint4*>(x + off));
    const uint4 dr = __ldg(reinterpret_cast<const uint4*>(dn + off));
    const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&xr);
    const __nv_bfloat162* dv = reinterpret_cast<const __nv_bfloat162*>(&dr);
    const uint32_t index = pix * static_cast<uint32_t>(C) + static_cast<uint32_t>(c);
    uint4 out;
    __nv_bfloat162* ov = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 xf = __bfloat1622float2(xv[j]);
      const float2 df = __bfloat1622float2(dv[j]);
      const float xs[2] = {xf.x, xf.y};
      const float ds[2] = {df.x, df.y};
      float dxs[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ch = 2 * j + e;
        float dz = ds[e];
        if (pro.silu) {
          const float z = affine(pro, xs[e], b * C + c + ch);
          const float sg = sigmoid(z);
          dz = dz * (sg * (1.f + z * (1.f - sg)));
        }
        if (pro.dropout) dz = dz * keep(pro, index + ch);
        dxs[e] = dz * a[ch];
        sum_scale[ch] += dz * xs[e];
        sum_shift[ch] += dz;
      }
      ov[j] = __floats2bfloat162_rn(dxs[0], dxs[1]);
    }
    *reinterpret_cast<uint4*>(dx + off) = out;
  }

#pragma unroll
  for (int e = 0; e < 8; ++e) {
    red[0][lane][8 * v + e] = sum_scale[e];
    red[1][lane][8 * v + e] = sum_shift[e];
  }
  __syncthreads();
  if (tid < 2 * kCh) {
    const int which = tid / kCh;
    const int ch = tid - which * kCh;
    float total = 0.f;
    for (int l = 0; l < kLanes; ++l) total += red[which][l][ch];
    float* part = which ? part_shift : part_scale;
    part[(static_cast<int64_t>(b) * slices + s) * C + blockIdx.y * kCh + ch] = total;
  }
}

__global__ void __launch_bounds__(kThreads)
prologue_grad_reduce(const float* __restrict__ part_scale, const float* __restrict__ part_shift,
                     float* __restrict__ dscale, float* __restrict__ dshift, int B, int C, int slices) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= B * C) return;
  const int b = i / C;
  const int c = i - b * C;
  float ts = 0.f, tt = 0.f;
  for (int s = 0; s < slices; ++s) {
    const int64_t j = (static_cast<int64_t>(b) * slices + s) * C + c;
    ts += part_scale[j];
    tt += part_shift[j];
  }
  dscale[i] = ts;
  dshift[i] = tt;
}

}  // namespace

// x, dn, dx (B, HW, C) bf16; partial (2, B, slices, C) f32 scratch; sums
// (2, B, C) f32: dscale then dshift. Returns a cudaError_t (0 = success).
extern "C" int s2s_prologue_grad(const void* x, const void* dn, void* dx, void* partial, void* sums, int B,
                                 int HW, int C, int slice_px, const void* scale, const void* shift, int silu,
                                 int dropout, uint32_t seed, uint32_t keep_threshold, float keep_scale,
                                 void* stream) {
  if (B <= 0 || HW <= 0 || C <= 0 || C % kCh || slice_px <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((scale == nullptr) != (shift == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const int slices = (HW + slice_px - 1) / slice_px;
  const Prologue pro = make_prologue(static_cast<const float*>(scale), static_cast<const float*>(shift), silu,
                                     dropout, seed, keep_threshold, keep_scale);
  float* part_scale = static_cast<float*>(partial);
  float* part_shift = part_scale + static_cast<int64_t>(B) * slices * C;
  float* dscale = static_cast<float*>(sums);
  float* dshift = dscale + static_cast<int64_t>(B) * C;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(B) * slices, C / kCh);
  prologue_grad_kernel<<<grid, kThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                 static_cast<const __nv_bfloat16*>(dn),
                                                 static_cast<__nv_bfloat16*>(dx), part_scale, part_shift, HW, C,
                                                 slice_px, slices, pro);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  prologue_grad_reduce<<<(B * C + kThreads - 1) / kThreads, kThreads, 0, s>>>(part_scale, part_shift, dscale,
                                                                             dshift, B, C, slices);
  return static_cast<int>(cudaGetLastError());
}
