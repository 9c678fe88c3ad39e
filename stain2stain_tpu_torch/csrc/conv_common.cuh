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
};

__device__ __forceinline__ uint32_t mix32(uint32_t v) {
  v ^= v >> 16;
  v *= 0x85EBCA6Bu;
  v ^= v >> 13;
  v *= 0xC2B2AE35u;
  v ^= v >> 16;
  return v;
}

// 2^x, flushing a result below 2^-126 to 0 (1 + that is 1 either way in the
// sigmoid below): the single MUFU op, without __expf's denormal fix-up.
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 1 / (1 + e^-z) with the approximate exponential and reciprocal: about 2 ulp
// of f32, far below the bf16 rounding of n or dx. Below z = -88, e^-z is inf
// and the result 0. The one sigmoid of K2, K4 and K5.
__device__ __forceinline__ float sigmoid(float z) {
  return __fdividef(1.f, 1.f + ex2_ftz(z * -1.4426950408889634f));
}

// The element's keep factor: keep_scale or 0. `index` is the NHWC element index.
__device__ __forceinline__ float keep(const Prologue& p, uint32_t index) {
  return mix32(index + p.seed) < p.keep_threshold ? p.keep_scale : 0.f;
}

// The affine factors of channels c..c+7 of image b: (scale, shift), or (1, 0)
// when the prologue has no affine part. A kernel whose thread always
// normalizes the same eight channels loads them once, not once per element.
__device__ __forceinline__ void channel_factors(const Prologue& p, int b, int c, int C, float (&s)[8],
                                                float (&t)[8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float4 sv = make_float4(1.f, 1.f, 1.f, 1.f);
    float4 tv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p.scale) {  // (B, C) rows are 16-byte aligned: the wrapper checks the pointers, C % 8 == 0
      sv = __ldg(reinterpret_cast<const float4*>(p.scale + b * C + c) + h);
      tv = __ldg(reinterpret_cast<const float4*>(p.shift + b * C + c) + h);
    }
    s[4 * h] = sv.x, s[4 * h + 1] = sv.y, s[4 * h + 2] = sv.z, s[4 * h + 3] = sv.w;
    t[4 * h] = tv.x, t[4 * h + 1] = tv.y, t[4 * h + 2] = tv.z, t[4 * h + 3] = tv.w;
  }
}

// Which parts of the prologue run, as compile-time flags. A kernel picks its
// Kind once (with_kind) and runs a loop without branches around it, so the
// scheduler overlaps the elements' exponentials and hashes. Tested per
// element, the flags would make every pair of elements a basic block of its
// own, and each warp would stall on every MUFU result in turn.
template <bool kAffine, bool kSilu, bool kDropout>
struct Kind {
  static constexpr bool affine = kAffine;
  static constexpr bool silu = kSilu;
  static constexpr bool dropout = kDropout;
  static constexpr bool identity = !kAffine && !kSilu && !kDropout;
};

// f(Kind<...>{}) for the prologue p describes.
template <typename F>
__device__ __forceinline__ void with_kind(const Prologue& p, F&& f) {
  const int k = (p.scale ? 4 : 0) + (p.silu ? 2 : 0) + (p.dropout ? 1 : 0);
  switch (k) {
    case 7: f(Kind<true, true, true>{}); break;
    case 6: f(Kind<true, true, false>{}); break;
    case 5: f(Kind<true, false, true>{}); break;
    case 4: f(Kind<true, false, false>{}); break;
    case 3: f(Kind<false, true, true>{}); break;
    case 2: f(Kind<false, true, false>{}); break;
    case 1: f(Kind<false, false, true>{}); break;
    default: f(Kind<false, false, false>{}); break;
  }
}

// Eight consecutive channels of one pixel, raw bf16 -> normalized bf16, with
// the channels' factors from channel_factors; `index` is the NHWC element
// index of the first. z*s + t rounds as the plain version rounds it (no FMA
// contraction).
template <class K>
__device__ __forceinline__ uint4 prologue8(K, uint4 raw, const Prologue& p, const float (&s)[8],
                                           const float (&t)[8], uint32_t index) {
  if constexpr (K::identity) {
    return raw;
  } else {
    const __nv_bfloat162* in = reinterpret_cast<const __nv_bfloat162*>(&raw);
    uint4 out;
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 v = __bfloat1622float2(in[j]);
      float n[2] = {v.x, v.y};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if constexpr (K::affine) n[e] = __fadd_rn(__fmul_rn(n[e], s[2 * j + e]), t[2 * j + e]);
        if constexpr (K::silu) n[e] = n[e] * sigmoid(n[e]);
        if constexpr (K::dropout) n[e] = n[e] * keep(p, index + 2 * j + e);
      }
      o[j] = __floats2bfloat162_rn(n[0], n[1]);
    }
    return out;
  }
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
