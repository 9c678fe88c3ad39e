// Hopper (sm_90a) primitives shared by the fused-conv kernels (conv3x3_fwd.cu
// for K2/K3, conv3x3_wgrad.cu for K5) and K1 at head dim 72
// (attention_d72.cuh): shared-memory matrix descriptors for the 128-, 64- and
// 32-byte swizzled layouts, wgmma m64nNk16 bf16 -> f32 with both operands from
// shared memory or A from registers and the fences and waits around it, and
// TMA tile and bulk copies completed on mbarriers (with the host-side tensor
// maps).
//
// The layout. A tile is stored as rows of 128 bytes (64 bf16); eight rows make
// one 1024-byte swizzle atom, whose base must be 1024-byte aligned. The
// 16-byte chunk j of row r sits at chunk j ^ (r & 7) of that row (swz128), so
// the eight rows of an atom spread one logical column over all bank groups.
// This is the layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B (64B: the
// same with 64-byte rows, see swz64); threads that write such a tile use the
// same address function.
//
// Two ways to read such a tile as a wgmma operand (PTX ISA, "Matrix
// Descriptor"; CUTLASS's make_gmma_desc):
//   * K-major (the reduction dimension K runs along the 128-byte row): rows
//     are M (or N) indices, 8-row groups at SBO = 1024 bytes; a k16 step
//     inside the 64-wide row moves the start address by 32 bytes. Used with
//     trans = 0.
//   * MN-major (M or N runs along the row): rows are K indices, the 64 M (or
//     N) values of a row contiguous; 8-row K groups at SBO = 1024 bytes, a k16
//     step moves the start by two atoms (2048 bytes); one atom is exactly 64
//     wide, so LBO (the stride between 64-wide column panels) is never used.
//     Used with trans = 1 (bf16 allows it for both A and B). The hardware
//     applies the swizzle by shared-memory address, as TMA does, so such an
//     operand may start at any 128-byte row of a tile, not only at an atom
//     boundary (with the descriptor's base-offset field left 0): K5 reads
//     each 3x3 tap's window of g at a row offset of its own.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (header only: the encoder is fetched at run time)
#include <cuda_runtime.h>
#include <stdint.h>

namespace s2s_wgmma {

// Byte offset of 16-byte chunk `chunk` (0..7) of row `row` in a 128-byte
// swizzled tile whose base is 1024-byte aligned.
__device__ __forceinline__ uint32_t swz128(uint32_t row, uint32_t chunk) {
  return row * 128u + ((chunk ^ (row & 7u)) << 4);
}

// The same for a 64-byte swizzled tile (rows of 64 bytes, 512-byte atoms of
// 8 rows): chunk j (0..3) of row r sits at chunk j ^ ((r / 2) & 3).
__device__ __forceinline__ uint32_t swz64(uint32_t row, uint32_t chunk) {
  return row * 64u + ((chunk ^ ((row >> 1) & 3u)) << 4);
}

// Descriptor of a K-major 64-byte swizzled operand (8-row groups 512 bytes
// apart; a k16 step moves the start by 32 bytes within the 64-byte row).
__device__ __forceinline__ uint64_t desc_sw64(const void* smem) {
  const uint64_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  uint64_t d = (addr & 0x3FFFFull) >> 4;
  d |= static_cast<uint64_t>(1) << 16;          // LBO: unused
  d |= static_cast<uint64_t>(512 >> 4) << 32;   // SBO
  d |= static_cast<uint64_t>(2) << 62;          // 64-byte swizzle
  return d;
}

// The 32-byte swizzle (rows of 32 bytes, 256-byte atoms of 8 rows): chunk j
// (0..1) of row r sits at chunk j ^ ((r / 4) & 1). K-major, a row is exactly
// one k16 step; MN-major, a row holds 16 M (or N) values and a k16 step moves
// the start by two atoms (512 bytes). 8-row groups 256 bytes apart either way.
__device__ __forceinline__ uint64_t desc_sw32(const void* smem) {
  const uint64_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  uint64_t d = (addr & 0x3FFFFull) >> 4;
  d |= static_cast<uint64_t>(1) << 16;         // LBO: unused
  d |= static_cast<uint64_t>(256 >> 4) << 32;  // SBO
  d |= static_cast<uint64_t>(3) << 62;         // 32-byte swizzle
  return d;
}

// Descriptor of a 128-byte swizzled operand starting at `smem` (16-byte
// aligned; atoms 1024-byte aligned), 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_sw128(const void* smem) {
  const uint64_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  uint64_t d = (addr & 0x3FFFFull) >> 4;        // start address, 16-byte units
  d |= static_cast<uint64_t>(1) << 16;          // LBO: unused by these layouts
  d |= static_cast<uint64_t>(1024 >> 4) << 32;  // SBO
  d |= static_cast<uint64_t>(1) << 62;          // 128-byte swizzle
  return d;
}

// Make this thread's generic-proxy shared-memory writes (st.shared, cp.async)
// visible to the async proxy that wgmma reads through. Call after the writes
// and before the barrier that precedes the wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

// Wait until at most N of this warpgroup's committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products (the registers are the wgmma's until the wait). The
// wgmma statements themselves clobber "memory", so the shared-memory work a
// kernel interleaves with them stays where the source puts it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for A fragments held in registers (wgmma reads them until the wait).
template <int K, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[K][N]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

// d (64 x 64 f32, the warpgroup's fragments) += A (64 x 16) * B (16 x 64),
// both bf16 from shared memory; TA/TB = 1: the operand is MN-major.
// Fragment: warp w, lane l holds rows 16w + l/4 (+8) and columns
// 8i + 2(l%4) (+1) in d[4i + {0,1,2,3}] = (r, c), (r, c+1), (r+8, c), (r+8, c+1).
// With scale_d 0 the product overwrites d instead (a fresh sum, no zeroing).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %34, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "n"(TA), "n"(TB), "r"(scale_d)
      : "memory");
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db) {
  wgmma_m64n64k16<TA, TB>(d, da, db, 1);
}

// As above with N = 128: d[4i + e] for column tiles i = 0..15.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %66, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "n"(TA), "n"(TB), "r"(scale_d)
      : "memory");
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  wgmma_m64n128k16<TA, TB>(d, da, db, 1);
}

// d (64 x 64 f32) += A (64 x 16, bf16 from registers) * B (16 x 64, shared
// memory; TB = 1: MN-major). A's fragment is mma.m16n8k16's A for each warp's
// 16 rows (warp w: rows 16w + l/4 (+8), columns 2(l%4) (+1) (+8)): a[0] (r,
// c..c+1), a[1] (r+8, c..), a[2] (r, c+8..), a[3] (r+8, c+8..), the layout of
// two adjacent column tiles of an accumulator rounded to bf16 pairs.
template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %37;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB), "r"(1)
      : "memory");
}

// As above with N = 8: d[0..3] for the one column tile.
template <int TB>
__device__ __forceinline__ void wgmma_m64n8k16_rs(float (&d)[4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, %9;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB), "r"(1)
      : "memory");
}

// Warp specialization: a warpgroup that only issues copies gives registers
// back (dec), and the warpgroups that compute take them (inc); every warp of
// the warpgroup executes it. The block starts with the kernel's launch count
// a thread (ptxas' "Used N registers"), and inc waits until dec has freed
// enough: 128 * (N - dec) >= (number of inc warpgroups) * 128 * (inc - N).
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Tensor Memory Accelerator copies: one thread asks for a whole box of a
// tensor (described by a CUtensorMap) to be copied into shared memory; the
// hardware zero-fills what lies outside the tensor (negative coordinates
// included) and reports the bytes to an mbarrier in shared memory.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(bar))),
               "r"(count)
               : "memory");
}

// Arrive once, announcing `bytes` of copies that complete the phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(bar))),
               "r"(bytes)
               : "memory");
}

// Arrive once (a consumer releasing a buffer).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(bar)))
               : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// The box of a 4-d tensor map at coordinates (c0 innermost .. c3) into `smem`.
__device__ __forceinline__ void tma_load_4d(void* smem, const CUtensorMap* map, int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];\n" ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(smem))),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(static_cast<uint32_t>(__cvta_generic_to_shared(bar)))
      : "memory");
}

// `bytes` (a multiple of 16) of contiguous device memory into `smem` (both
// 16-byte aligned), completed on `bar` as the tile copies are.
__device__ __forceinline__ void bulk_load(void* smem, const void* gmem, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem))),
               "l"(gmem), "r"(bytes), "r"(static_cast<uint32_t>(__cvta_generic_to_shared(bar)))
               : "memory");
}

// Host: the tensor map of a 4-d bf16 tensor, dims innermost first, with the
// row strides of a contiguous tensor, a box of `box` elements and the given
// swizzle. cuTensorMapEncodeTiled is looked up through the CUDA runtime, so
// the libraries link against nothing but cudart.
inline cudaError_t make_map_4d(CUtensorMap* map, const void* base, const uint64_t (&dims)[4],
                               const uint32_t (&box)[4], CUtensorMapSwizzle swizzle) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                              const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                              CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t gdim[4] = {dims[0], dims[1], dims[2], dims[3]};
  const cuuint64_t stride[3] = {dims[0] * 2, dims[0] * dims[1] * 2, dims[0] * dims[1] * dims[2] * 2};
  const cuuint32_t bdim[4] = {box[0], box[1], box[2], box[3]};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), gdim, stride, bdim,
                            estride, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The smallest 1024-byte aligned address at or above `p` (dynamic shared
// memory carries no alignment the swizzle atoms can rely on).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return p + ((1024u - (a & 1023u)) & 1023u);
}

}  // namespace s2s_wgmma
