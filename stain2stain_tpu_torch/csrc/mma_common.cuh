// Warp-level tensor-core and asynchronous-copy primitives for Hopper (sm_90a),
// used by the attention kernels (attention_fwd.cu, attention_bwd.cu): ldmatrix,
// mma.sync m16n8k16 bf16 and m16n8k8 tf32 with f32 accumulators, the 3xTF32
// split of an f32 value, and 16-byte cp.async with zero fill, which K4
// (prologue_grad.cu) uses too. The conv kernels K2/K3 and K5 use the warpgroup
// primitives of wgmma_common.cuh instead.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace s2s_mma {

// ldmatrix: four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a * b on the tensor cores: a 16x16 (row), b 16x8 (col), bf16 in, f32 out.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b on the tensor cores: a 16x8 (row), b 8x8 (col), tf32 in, f32 out.
// Fragments (g = lane / 4, t = lane % 4): a holds (row g, column t), (g + 8,
// t), (g, t + 4), (g + 8, t + 4); b (row t, column g), (t + 4, g).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to tf32 (10 mantissa bits, ties away from zero: the value of
// cvt.rna.tf32.f32 for every finite x below the largest float), as integer
// operations: adding half a tf32 ulp to the magnitude's bits carries into
// the kept bits exactly when the dropped 13 bits are at least half.
__device__ __forceinline__ uint32_t tf32_rna(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

// The 3xTF32 split: x = big + small + r with big = tf32(x), small =
// tf32(x - big) and |r| <= 2^-22 |x|; x - big is exact in f32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// d += a * b in 3xTF32, with a and b split: small.big + big.small + big.big
// (the small.small term, at most 2^-22 |ab|, is dropped). The three products
// go into a fresh f32 partial, which is then added to d by an f32 add that
// rounds to nearest: the tensor cores round each mma's sum toward zero, and
// over a long contraction that bias, accumulated in d itself, would leave
// f32's accuracy (PERF.md).
__device__ __forceinline__ void mma3_tf32(float (&d)[4], const uint32_t (&a_big)[4], const uint32_t (&a_small)[4],
                                          uint32_t b_big0, uint32_t b_big1, uint32_t b_small0, uint32_t b_small1) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(part, a_small, b_big0, b_big1);
  mma_tf32(part, a_big, b_small0, b_small1);
  mma_tf32(part, a_big, b_big0, b_big1);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += part[e];
}

// Two f32 values rounded into one bf16x2 register, `lo` in the low half (the
// lower column of an mma fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 16 bytes device memory -> shared memory, asynchronously (cp.async.cg: through
// L2 only). With `valid` false nothing is read and the 16 bytes are zeroed.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace s2s_mma
