// K5: the fused conv's weight and bias gradients for Hopper (sm_90a).
//
// Replaces the TPU kernel stain2stain_tpu/ops/pallas_conv.py::_wgrad_kernel
// (launched by ::conv3x3_weight_grad). Same function:
//     dW[tap, c, d] = sum_{b,h,w} n[b, h+dy-1, w+dx-1, c] * g[b, h, w, d]   (f32)
//     dbias[d]      = sum_{b,h,w} g[b, h, w, d]                             (f32)
// with tap = 3*dy + dx, n = dropout(act(x*scale + shift)) recomputed from raw
// x (bf16-rounded, zero outside the image, the mask regenerated from the hash
// of conv_common.cuh) instead of read from memory, g = dy (B, H, W, D) bf16.
//
// Bound on the H100: 2*B*H*W*9*C*D operations on the bf16 tensor cores (0.625 ms
// at the flagship's first level, B 32, 256x256, C = D = 128) against
// 2*B*H*W*(C + D) bytes read (0.32 ms): the products bound it.
//
// Design. The TPU kernel accumulates dW over the whole grid in VMEM; Hopper's
// blocks run in no order. So a split over pixels and two deterministic passes
// without atomics:
//   1. one block per (32 input channels, 64 output channels, split): per tile
//      of 8 x 16 output pixels in its share it stages the (8+2) x (16+2) halo
//      of n (through the prologue) and the tile of g into shared memory, then
//      each of 9 warps, one per tap, adds n at its tap's offset times g into
//      its 32 x 64 f32 accumulators: mma.sync.m16n8k16 bf16 with K = pixels,
//      both operands through ldmatrix.trans, since K runs across shared rows.
//      So each element's prologue runs about 1.4 times per 64 output channels
//      (the halo), not once per tap. Each warp writes its tap's f32 tile to the
//      split's partial; the blocks of the first channel tile also sum g's
//      columns for dbias;
//   2. one thread per output adds the splits' partials in order.
// Staging and products do not overlap within a block (no cp.async pipeline);
// two blocks per SM overlap each other. C is a multiple of 32, D of 64 and W
// of 16 (ops/conv.py::supported); a ragged last row tile is masked.
// Launches on the caller's stream, allocates nothing (the wrapper allocates
// the partials), and returns cudaGetLastError().

#include "conv_common.cuh"
#include "mma_common.cuh"

namespace {

using namespace s2s_conv;
using namespace s2s_mma;

constexpr int kTH = 8;          // output rows of a pixel tile
constexpr int kTW = 16;         // output columns of a pixel tile (one k16 step per row)
constexpr int kHH = kTH + 2;    // halo rows
constexpr int kHW = kTW + 2;    // halo columns
constexpr int kBC = 32;         // input channels of a block (GEMM M)
constexpr int kBD = 64;         // output channels of a block (GEMM N)
constexpr int kLdN = kBC + 8;   // shared row pitch of n in bf16 (80 bytes)
constexpr int kLdG = kBD + 8;   // shared row pitch of g in bf16 (144 bytes)
constexpr int kThreads = 9 * 32;  // one warp per tap

__global__ void __launch_bounds__(kThreads, 2)
conv3x3_wgrad_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                     float* __restrict__ partial, int H, int W, int C, int D, int tiles_h, int tiles_w,
                     int n_ptiles, int splits, Prologue pro) {
  __shared__ __align__(16) __nv_bfloat16 ns[kHH * kHW * kLdN];  // normalized halo, pixel-major
  __shared__ __align__(16) __nv_bfloat16 gs[kTH * kTW * kLdG];  // g, pixel-major
  __shared__ float bias_red[4][kBD];

  const int split = blockIdx.x;
  const int c_tiles = C / kBC;
  const int c0 = (blockIdx.y % c_tiles) * kBC;
  const int d0 = (blockIdx.y / c_tiles) * kBD;
  const bool bias_block = c0 == 0;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tap = tid >> 5;  // this warp's tap
  const int dy = tap / 3;
  const int dx = tap - 3 * dy;
  const int lr = lane & 7;
  const int lj = lane >> 3;

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  float bsum = 0.f;  // bias blocks, tid < 256: column tid % 64 over a quarter of each tile

  const int tiles = tiles_h * tiles_w;
  for (int pt = split; pt < n_ptiles; pt += splits) {
    const int b = pt / tiles;
    const int tile = pt - b * tiles;
    const int h0 = (tile / tiles_w) * kTH;
    const int w0 = (tile % tiles_w) * kTW;
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kHH * kHW * (kBC / 8); i += kThreads) {
      const int pix = i >> 2;  // kBC / 8 == 4 vectors per pixel
      const int v = i & 3;
      const int hr = pix / kHW;
      const int hc = pix - hr * kHW;
      const int h = h0 + hr - 1;
      const int wc = w0 + hc - 1;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (h >= 0 && h < H && wc >= 0 && wc < W) {
        const int c = c0 + 8 * v;
        const uint32_t p = static_cast<uint32_t>((b * H + h) * W + wc);
        val = __ldg(reinterpret_cast<const uint4*>(x + static_cast<int64_t>(p) * C + c));
        val = prologue8(val, pro, b, c, C, p);
      }
      *reinterpret_cast<uint4*>(ns + pix * kLdN + 8 * v) = val;
    }
    for (int i = tid; i < kTH * kTW * (kBD / 8); i += kThreads) {
      const int m = i >> 3;  // kBD / 8 == 8 vectors per pixel
      const int v = i & 7;
      const int h = h0 + m / kTW;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (h < H) {
        const int64_t p = static_cast<int64_t>(b * H + h) * W + w0 + (m % kTW);
        val = __ldg(reinterpret_cast<const uint4*>(g + p * D + d0 + 8 * v));
      }
      *reinterpret_cast<uint4*>(gs + m * kLdG + 8 * v) = val;
    }
    __syncthreads();

    if (bias_block && tid < 4 * kBD) {
      const int d = tid % kBD;
      const int m0 = (tid / kBD) * (kTH * kTW / 4);
      for (int m = m0; m < m0 + kTH * kTW / 4; ++m) bsum += __bfloat162float(gs[m * kLdG + d]);
    }

#pragma unroll 2
    for (int r = 0; r < kTH; ++r) {  // one k16 step: the 16 pixels of tile row r
      // A (c x pixels) from [pixel][c] rows, transposed: {c lo, c hi} x {px lo, px hi}
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int px = lr + ((lj >> 1) << 3);
        const int c = mt * 16 + ((lj & 1) << 3);
        ldsm_x4_trans(a[mt], ns + ((r + dy) * kHW + px + dx) * kLdN + c);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        // B (pixels x d) from [pixel][d] rows, transposed: {d lo: px lo, px hi}, {d hi: ...}
        const int px = lr + ((lj & 1) << 3);
        const int d = np * 16 + ((lj >> 1) << 3);
        uint32_t bf[4];
        ldsm_x4_trans(bf, gs + (r * kTW + px) * kLdG + d);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], bf[0], bf[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], bf[2], bf[3]);
        }
      }
    }
  }

  // accumulator fragment: (c row gr, d columns 2t, 2t+1) and (c row gr + 8, ...)
  const int gr = lane >> 2;
  const int t = lane & 3;
  const int64_t stride = 9LL * C * D + D;
  float* out = partial + split * stride + static_cast<int64_t>(tap) * C * D;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = c0 + mt * 16 + gr + 8 * half;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int d = d0 + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(out + static_cast<int64_t>(c) * D + d) =
            make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
      }
    }
  }
  if (bias_block) {
    if (tid < 4 * kBD) bias_red[tid / kBD][tid % kBD] = bsum;
    __syncthreads();
    if (tid < kBD) {
      partial[split * stride + 9LL * C * D + d0 + tid] =
          (bias_red[0][tid] + bias_red[1][tid]) + (bias_red[2][tid] + bias_red[3][tid]);
    }
  }
}

__global__ void __launch_bounds__(256)
wgrad_reduce(const float* __restrict__ partial, float* __restrict__ dw, float* __restrict__ dbias,
             int64_t n_w, int D, int splits) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  const int64_t stride = n_w + D;
  if (i >= stride) return;
  float total = 0.f;
  for (int s = 0; s < splits; ++s) total += partial[s * stride + i];
  if (i < n_w) {
    dw[i] = total;
  } else {
    dbias[i - n_w] = total;
  }
}

}  // namespace

// x (B,H,W,C) bf16, g (B,H,W,D) bf16; partial (splits, 9*C*D + D) f32 scratch;
// dw (3,3,C,D) f32, dbias (D,) f32. Returns a cudaError_t (0 = success).
extern "C" int s2s_conv3x3_wgrad(const void* x, const void* g, void* partial, void* dw, void* dbias, int B,
                                 int H, int W, int C, int D, int splits, const void* scale, const void* shift,
                                 int silu, int dropout, uint32_t seed, uint32_t keep_threshold, float keep_scale,
                                 void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || W % kTW || C <= 0 || D <= 0 || C % kBC || D % kBD || splits <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((scale == nullptr) != (shift == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const Prologue pro = make_prologue(static_cast<const float*>(scale), static_cast<const float*>(shift), silu,
                                     dropout, seed, keep_threshold, keep_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles_h = (H + kTH - 1) / kTH;
  const int tiles_w = W / kTW;
  const int n_ptiles = B * tiles_h * tiles_w;
  const dim3 grid(splits, (C / kBC) * (D / kBD));
  conv3x3_wgrad_kernel<<<grid, kThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                 static_cast<const __nv_bfloat16*>(g), static_cast<float*>(partial),
                                                 H, W, C, D, tiles_h, tiles_w, n_ptiles, splits, pro);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_w = 9LL * C * D;
  const int64_t blocks = (n_w + D + 255) / 256;
  wgrad_reduce<<<static_cast<unsigned>(blocks), 256, 0, s>>>(static_cast<const float*>(partial),
                                                             static_cast<float*>(dw), static_cast<float*>(dbias),
                                                             n_w, D, splits);
  return static_cast<int>(cudaGetLastError());
}
