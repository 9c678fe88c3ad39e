// K2 (and K3): fused prologue + 3x3 SAME convolution for Hopper (sm_90a).
//
// Replaces the TPU kernel stain2stain_tpu/ops/pallas_conv.py::_conv_kernel
// (launched by ::fused_conv3x3, and by ::conv3x3_input_grad with tap-flipped,
// channel-swapped weights and no prologue). Same function:
//     y = conv3x3_SAME(n, w) + bias,   n = dropout(act(x*scale + shift))
// x (B, H, W, C) bf16 NHWC; w given here as (9 taps, D, C) bf16; bias (D,) f32;
// scale/shift (B, C) f32 or null. n is rounded to bf16 before the product; the
// products accumulate in f32; y = bf16(acc + bias). SAME padding applies to n:
// taps outside the image contribute 0, not act(shift).
//
// Bound on the H100: 2*B*H*W*9*C*D operations on the bf16 tensor cores (at the
// flagship's first level, B 32, 256x256, C = D = 128: 6.18e11, 0.625 ms at
// 989 TFLOP/s) against 2*B*H*W*(C + D) bytes (0.32 ms at 3.35 TB/s): the
// products bound it at every flagship shape.
//
// Design (first, simple and right; no wgmma or TMA yet). An implicit GEMM with
// M = output pixels, N = D, K = 9*C:
//   * a block owns 8 rows x 16 columns of one image (M = 128) and 128 output
//     channels (N), 8 warps of 32 pixels x 64 channels each;
//   * per step of 32 input channels it stages the (8+2) x (16+2) halo of x into
//     shared memory through the prologue (affine, SiLU, hash mask, bf16), so
//     the normalized tensor never reaches device memory and each element's
//     prologue runs 1.4 times per 128 output channels, not 9 times; and the 9
//     taps' weights (9 x 128 x 32 bf16);
//   * the 9 taps then read shifted windows of the one halo: ldmatrix x4 into
//     mma.sync.m16n8k16 bf16 with f32 accumulators in registers;
//   * shared rows are padded to 80 bytes, so the 8 rows of an ldmatrix phase
//     fall in 8 distinct 16-byte bank groups.
// Staging and products do not overlap within a block (no cp.async pipeline);
// two blocks per SM overlap each other. C and D are multiples of 128 and W of
// 16 (ops/conv.py::supported); a ragged last row tile is masked.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include "conv_common.cuh"
#include "mma_common.cuh"

namespace {

using namespace s2s_conv;
using namespace s2s_mma;

constexpr int kTH = 8;                 // output rows of a block
constexpr int kTW = 16;                // output columns of a block (one m16 tile per row)
constexpr int kHH = kTH + 2;           // halo rows
constexpr int kHW = kTW + 2;           // halo columns
constexpr int kBN = 128;               // output channels of a block
constexpr int kBK = 32;                // input channels per step
constexpr int kLd = kBK + 8;           // shared row pitch in bf16 (80 bytes)
constexpr int kThreads = 256;
constexpr int kAElems = kHH * kHW * kLd;
constexpr int kBElems = 9 * kBN * kLd;
constexpr int kSmemBytes = (kAElems + kBElems) * 2;  // 106,560 bytes

__global__ void __launch_bounds__(kThreads, 2)
conv3x3_fwd_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                   const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                   int H, int W, int C, int D, int tiles_h, int tiles_w, Prologue pro) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* as = smem;             // [kHH * kHW][kLd]: the normalized halo
  __nv_bfloat16* bs = smem + kAElems;   // [9 * kBN][kLd]: weights, input channels contiguous

  const int tiles = tiles_h * tiles_w;
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  const int h0 = (tile / tiles_w) * kTH;
  const int w0 = (tile % tiles_w) * kTW;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp & 3;   // tile rows 2*warp_m and 2*warp_m + 1
  const int warp_n = warp >> 2;  // output channels n0 + 64*warp_n ... + 63
  const int lr = lane & 7;       // ldmatrix: row within a matrix
  const int lj = lane >> 3;      // ldmatrix: which of the four matrices

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int k0 = 0; k0 < C; k0 += kBK) {
    __syncthreads();  // the previous step's tiles are consumed
    for (int i = tid; i < kHH * kHW * (kBK / 8); i += kThreads) {
      const int pix = i >> 2;  // kBK / 8 == 4 vectors of 8 channels per pixel
      const int v = i & 3;
      const int hr = pix / kHW;
      const int hc = pix - hr * kHW;
      const int h = h0 + hr - 1;
      const int wc = w0 + hc - 1;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (h >= 0 && h < H && wc >= 0 && wc < W) {
        const int c = k0 + 8 * v;
        const uint32_t p = static_cast<uint32_t>((b * H + h) * W + wc);
        val = __ldg(reinterpret_cast<const uint4*>(x + static_cast<int64_t>(p) * C + c));
        val = prologue8(val, pro, b, c, C, p);
      }
      *reinterpret_cast<uint4*>(as + pix * kLd + 8 * v) = val;
    }
    for (int i = tid; i < 9 * kBN * (kBK / 8); i += kThreads) {
      const int row = i >> 2;  // tap * kBN + n
      const int v = i & 3;
      const int tap = row / kBN;
      const int n = row - tap * kBN;
      const uint4 val = __ldg(reinterpret_cast<const uint4*>(
          w + (static_cast<int64_t>(tap) * D + n0 + n) * C + k0 + 8 * v));
      *reinterpret_cast<uint4*>(bs + row * kLd + 8 * v) = val;
    }
    __syncthreads();

    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap - 3 * dy;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        // A (pixels x channels): matrices {rows 0-7, 8-15} x {k 0-7, 8-15}
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int hr = 2 * warp_m + mt + dy;
          const int col = lr + ((lj & 1) << 3) + dx;
          ldsm_x4(a[mt], as + (hr * kHW + col) * kLd + kk + ((lj >> 1) << 3));
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          // B (k x n) from [n][k] rows: matrices {n 0-7: k lo, k hi}, {n 8-15: k lo, k hi}
          const int n = warp_n * 64 + np * 16 + lr + ((lj >> 1) << 3);
          uint32_t bf[4];
          ldsm_x4(bf, bs + (tap * kBN + n) * kLd + kk + ((lj & 1) << 3));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(acc[mt][2 * np], a[mt], bf[0], bf[1]);
            mma_bf16(acc[mt][2 * np + 1], a[mt], bf[2], bf[3]);
          }
        }
      }
    }
  }

  // accumulator fragment: (pixel g, channels 2t, 2t+1) and (pixel g + 8, ...)
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int h = h0 + 2 * warp_m + mt;
    if (h >= H) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t p = static_cast<int64_t>(b * H + h) * W + w0 + g + 8 * half;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = n0 + warp_n * 64 + nt * 8 + 2 * t;
        const float v0 = acc[mt][nt][2 * half] + __ldg(bias + n);
        const float v1 = acc[mt][nt][2 * half + 1] + __ldg(bias + n + 1);
        *reinterpret_cast<__nv_bfloat162*>(y + p * D + n) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

}  // namespace

// x (B,H,W,C) bf16, w (9,D,C) bf16, bias (D,) f32, y (B,H,W,D) bf16; the
// prologue as in conv_common.cuh. Returns a cudaError_t (0 = success).
extern "C" int s2s_conv3x3_fwd(const void* x, const void* w, const void* bias, void* y, int B, int H, int W,
                               int C, int D, const void* scale, const void* shift, int silu, int dropout,
                               uint32_t seed, uint32_t keep_threshold, float keep_scale, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || W % kTW || C % kBK || C <= 0 || D % kBN || D <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((scale == nullptr) != (shift == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(conv3x3_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_h = (H + kTH - 1) / kTH;
  const int tiles_w = W / kTW;
  const dim3 grid(static_cast<unsigned>(B) * tiles_h * tiles_w, D / kBN);
  const Prologue pro = make_prologue(static_cast<const float*>(scale), static_cast<const float*>(shift), silu,
                                     dropout, seed, keep_threshold, keep_scale);
  conv3x3_fwd_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), H, W, C, D, tiles_h, tiles_w, pro);
  return static_cast<int>(cudaGetLastError());
}
