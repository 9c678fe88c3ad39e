// Shared by the fused-conv kernels: K2/K3 (conv3x3_fwd.cu), K4 (prologue_grad.cu)
// and K5 (conv3x3_wgrad.cu).
//
// The prologue n = dropout(act(x*scale + shift)) of one element, and the
// dropout hash. The hash is the murmur3 finalizer of ops/dropout.py applied to
// the NHWC element index ((b*H + h)*W + w)*C + c plus the seed, mod 2^32: a
// pure function of the element, so every kernel (and every tile or halo that
// loads the element) regenerates the same mask, and the unfused path's
// FastDropout with the same seed drops the same units. The TPU kernels drew
// their masks from the TPU's hardware PRNG (pallas_conv.py::_keep_mask), which
// no GPU reproduces.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace s2s_conv {

struct Prologue {
  const float* scale;        // (B, C) f32, or null: no affine
  const float* shift;        // (B, C) f32, null iff scale is null
  int silu;                  // 1: SiLU, 0: identity
  int dropout;               // 1: hash dropout
  uint32_t seed;
  uint32_t keep_threshold;   // keep iff hash < keep_threshold
  float keep_scale;          // 1 / (1 - rate)

  __device__ __forceinline__ bool identity() const { return scale == nullptr && !silu && !dropout; }
};

__device__ __forceinline__ uint32_t mix32(uint32_t v) {
  v ^= v >> 16;
  v *= 0x85EBCA6Bu;
  v ^= v >> 13;
  v *= 0xC2B2AE35u;
  v ^= v >> 16;
  return v;
}

__device__ __forceinline__ float sigmoid(float z) { return __frcp_rn(1.f + __expf(-z)); }

// z = x*scale + shift rounded as the plain version rounds it (no FMA contraction).
__device__ __forceinline__ float affine(const Prologue& p, float x, int bc) {
  return p.scale ? __fadd_rn(__fmul_rn(x, __ldg(p.scale + bc)), __ldg(p.shift + bc)) : x;
}

// The element's keep factor: keep_scale or 0. `index` is the NHWC element index.
__device__ __forceinline__ float keep(const Prologue& p, uint32_t index) {
  return mix32(index + p.seed) < p.keep_threshold ? p.keep_scale : 0.f;
}

// Eight consecutive channels c..c+7 of pixel `pix` (flat (b*H + h)*W + w) of
// image b, raw bf16 -> normalized bf16.
__device__ __forceinline__ uint4 prologue8(uint4 raw, const Prologue& p, int b, int c, int C, uint32_t pix) {
  if (p.identity()) return raw;
  const __nv_bfloat162* in = reinterpret_cast<const __nv_bfloat162*>(&raw);
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
  const uint32_t index = pix * static_cast<uint32_t>(C) + static_cast<uint32_t>(c);
  const int bc = b * C + c;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 v = __bfloat1622float2(in[j]);
    float n[2] = {affine(p, v.x, bc + 2 * j), affine(p, v.y, bc + 2 * j + 1)};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (p.silu) n[e] = n[e] * sigmoid(n[e]);
      if (p.dropout) n[e] = n[e] * keep(p, index + 2 * j + e);
    }
    o[j] = __floats2bfloat162_rn(n[0], n[1]);
  }
  return out;
}

inline Prologue make_prologue(const float* scale, const float* shift, int silu, int dropout, uint32_t seed,
                              uint32_t keep_threshold, float keep_scale) {
  Prologue p;
  p.scale = scale;
  p.shift = shift;
  p.silu = silu;
  p.dropout = dropout;
  p.seed = seed;
  p.keep_threshold = keep_threshold;
  p.keep_scale = keep_scale;
  return p;
}

}  // namespace s2s_conv
