// Shared by the bf16 tensor-core paths of K1-fwd (attention_fwd.cu) and K1-bwd
// (attention_bwd.cu): one block of 4 warps works on 64 rows (queries or keys)
// of one (batch*head) slice, each warp on 16 of them, while 64-row tiles of the
// other operand stream through shared memory.
//
// Two warp-level products cover every GEMM of the forward and the backward:
//   * warp_abt: S (16 x 64, f32) = A . B^T, A a warp's 16 rows held as mma
//     fragments in registers, B a staged 64-row tile (ldmatrix);
//   * warp_pb:  acc (16 x D, f32) += P . B, P a 16 x 64 f32 result of warp_abt
//     rounded to bf16 in registers (the m16n8 accumulator layout of two
//     adjacent n-tiles is the m16n8k16 A layout), B a staged 64-row tile read
//     transposed (ldmatrix.trans).
// Staged tiles are 64 rows of D bf16 padded to D + 8 elements (48, 80 or 144
// bytes at D 16, 32, 64), so the 8 rows of every ldmatrix phase fall in 8
// distinct 16-byte bank groups. They arrive by cp.async; rows past T are
// zero-filled.
//
// K1's kernels at head dim 72 (DiT-XL/2's) are attention_d72.cuh's. Here d 72
// serves one path alone: K1-bwd's prep pass recomputing the lse when the
// caller gives none (softmax_rows without p.v; no training path does). It
// takes one more k-step over d, whose upper 8 columns are zero: in the A
// fragments (registers, never loaded) and in the staged tiles (columns D..D+7
// of every row, which no copy writes, zeroed once when a kernel starts:
// zero_pad). Its rows are padded to D + 16 (176 bytes: an odd count of 16-byte
// groups, so ldmatrix stays free of bank conflicts). The instances at D 16, 32
// and 64 compile to the SASS they had before d 72.
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4): an accumulator
// tile holds (row g, columns 2t, 2t+1) in elements 0, 1 and (row g + 8, the
// same columns) in 2, 3.

#pragma once

#include <math.h>

#include "mma_common.cuh"

namespace s2s_attn {

using namespace s2s_mma;
using bf16 = __nv_bfloat16;

constexpr int kTile = 64;               // rows of a block, rows of a staged tile
constexpr int kWarps = 4;               // 16 rows each
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
constexpr int kKSteps = (D + 15) / 16;  // 16-wide k-steps over d; the last half zero where D % 16 == 8
template <int D>
constexpr int kRowElems = D % 16 == 0 ? D + 8 : D + 16;  // a staged row
template <int D>
constexpr int kTileElems = kTile * kRowElems<D>;  // a staged tile: 64 padded rows

// Columns D..D+7 of the 128 rows of a double-buffered staged tile to zero, where
// D % 16 == 8: the last k-step of a product over d reads them. No copy writes
// them, so once before the first barrier of a kernel is enough.
template <int D>
__device__ __forceinline__ void zero_pad(bf16* tiles, int tid) {
  static_assert(D % 8 == 0, "head dim a multiple of 8");
  if constexpr (D % 16 != 0) {
    static_assert(2 * kTile == kThreads, "one row of the two tiles a thread");
    *reinterpret_cast<uint4*>(tiles + tid * kRowElems<D> + D) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Start the cp.async copies of rows [row0, row0 + 64) of a contiguous (T, D)
// bf16 slice into a padded shared tile; rows past T are zero-filled.
template <int D>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* __restrict__ src, int row0, int t_len, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks of a row
  constexpr int kTotal = kTile * kChunks;
  constexpr bool kEven = kTotal % kThreads == 0;  // else (D 72: 4.5 a thread) the last round is partial
#pragma unroll
  for (int it = 0; it < (kTotal + kThreads - 1) / kThreads; ++it) {
    const int i = tid + it * kThreads;
    if (kEven || i < kTotal) {
      const int r = i / kChunks;
      const int c = i - r * kChunks;
      const int row = row0 + r;
      const bool valid = row < t_len;
      cp_async16(dst + r * kRowElems<D> + 8 * c, src + static_cast<int64_t>(valid ? row : 0) * D + 8 * c, valid);
    }
  }
}

// The A fragments (one 16 x 16 slice of D per entry) of rows [r0, r0 + 16) of
// a contiguous (T, D) bf16 slice, read from device memory; rows past T are 0,
// and so are columns past D (the upper half of the last k-step at D 72).
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[kKSteps<D>][4], const bf16* __restrict__ src, int r0,
                                             int t_len, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    const uint32_t* p = reinterpret_cast<const uint32_t*>(src + static_cast<int64_t>(row) * D + 2 * t);
#pragma unroll
    for (int ks = 0; ks < kKSteps<D>; ++ks) {
      a[ks][h] = row < t_len ? __ldg(p + 8 * ks) : 0u;  // columns 16ks + 2t, +1
      if (16 * ks + 8 < D) {
        a[ks][h + 2] = row < t_len ? __ldg(p + 8 * ks + 4) : 0u;  // columns 16ks + 8 + 2t, +1
      } else {
        a[ks][h + 2] = 0u;
      }
    }
  }
}

// s = A . B^T: A (16 x D) as fragments, B a staged tile of 64 rows x D.
template <int D>
__device__ __forceinline__ void warp_abt(float (&s)[8][4], const uint32_t (&a)[kKSteps<D>][4], const bf16* b,
                                         int lane) {
  const int lr = lane & 7;
  const int lj = lane >> 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kKSteps<D>; ++ks) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      // matrices {rows 0-7: k lo, k hi}, {rows 8-15: k lo, k hi} of B's 16-row group np
      uint32_t f[4];
      ldsm_x4(f, b + (np * 16 + lr + ((lj >> 1) << 3)) * kRowElems<D> + ks * 16 + ((lj & 1) << 3));
      mma_bf16(s[2 * np], a[ks], f[0], f[1]);
      mma_bf16(s[2 * np + 1], a[ks], f[2], f[3]);
    }
  }
}

// acc += bf16(p) . B: p (16 x 64) as f32 accumulator tiles, B a staged tile of
// 64 rows x D read transposed, so the product runs over B's rows.
template <int D>
__device__ __forceinline__ void warp_pb(float (&acc)[D / 8][4], const float (&p)[8][4], const bf16* b, int lane) {
  static_assert(D % 16 == 0, "two n-tiles per ldmatrix");
  const int lr = lane & 7;
  const int lj = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]), pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      // matrices {k 0-7, k 8-15} x {columns lo, columns hi} of B rows 16kk..16kk+15
      uint32_t f[4];
      ldsm_x4_trans(f, b + (kk * 16 + lr + ((lj & 1) << 3)) * kRowElems<D> + dp * 16 + ((lj >> 1) << 3));
      mma_bf16(acc[2 * dp], a, f[0], f[1]);
      mma_bf16(acc[2 * dp + 1], a, f[2], f[3]);
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The forward's online softmax for one warp's 16 query rows (fragments qa)
// over every key of a (T, D) slice: m (row max of the raw scores) and l (this
// thread's share of the row sum of exp2((s - m) * c)) for rows g and g + 8 of
// the warp; with kPV also acc += p . v, rescaled with every new max. k and v
// stream through the double-buffered shared tiles ks and vs (two tiles each):
// tile j + 1's cp.async copies are in flight while tile j is used. Every warp
// of the block must call this (it synchronizes the block).
//
// c = scale * log2(e): p = exp2(s * c - m * c), one FFMA and one MUFU ex2 per
// score. The ex2 rate bounds this loop at d 32; emulating part of the
// exponentials with a polynomial on the FMA pipes is later work.
template <int D, bool kPV>
__device__ __forceinline__ void softmax_rows(const bf16* __restrict__ k, const bf16* __restrict__ v, int t_len,
                                             float c, const uint32_t (&qa)[kKSteps<D>][4], bf16* ks, bf16* vs,
                                             float (&m)[2], float (&l)[2], float (&acc)[D / 8][4]) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int t = lane & 3;
  const int n_tiles = (t_len + kTile - 1) / kTile;
  stage_tile<D>(ks, k, 0, t_len, tid);
  if constexpr (kPV) stage_tile<D>(vs, v, 0, t_len, tid);
  cp_async_commit();
  for (int j = 0; j < n_tiles; ++j) {
    const int cur = (j & 1) * kTileElems<D>;
    if (j + 1 < n_tiles) {
      const int nxt = kTileElems<D> - cur;
      stage_tile<D>(ks + nxt, k, (j + 1) * kTile, t_len, tid);
      if constexpr (kPV) stage_tile<D>(vs + nxt, v, (j + 1) * kTile, t_len, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile j has landed (this thread's copies) ...
    __syncthreads();     // ... and every thread's

    float s[8][4];
    warp_abt<D>(s, qa, ks + cur, lane);
    const int key0 = j * kTile;
    if (key0 + kTile > t_len) {  // keys past T score -inf
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + 8 * nt + 2 * t + (e & 1) >= t_len) s[nt][e] = -INFINITY;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
      // key 0 lies in tile 0, so m_new is finite from the start and
      // alpha = exp2(-inf) = 0 clears the empty sum and accumulator
      const float m_new = fmaxf(m[h], quad_max(mx));
      const float alpha = exp2f((m[h] - m_new) * c);
      const float mc = m_new * c;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(fmaf(s[nt][2 * h + e], c, -mc));
          s[nt][2 * h + e] = p;
          sum += p;
        }
      l[h] = l[h] * alpha + sum;
      if constexpr (kPV) {
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          acc[nt][2 * h] *= alpha;
          acc[nt][2 * h + 1] *= alpha;
        }
      }
      m[h] = m_new;
    }
    if constexpr (kPV) warp_pb<D>(acc, s, vs + cur, lane);
    __syncthreads();  // tile j is consumed before its buffer is refilled
  }
}

}  // namespace s2s_attn
