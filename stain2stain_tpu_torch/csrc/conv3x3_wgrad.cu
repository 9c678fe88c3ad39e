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
// Design. Per tap a GEMM with M = input channels, N = output channels and
// K = pixels, written with the shift on g instead of n:
//     dW[tap] = sum_q n[q]^T g[q - (dy-1, dx-1)]   over the image pixels q,
// g zero outside the image. So n is needed only on the image's own pixels:
// each element's prologue runs once per block that holds it (D / 64 blocks),
// without the 1.41x halo of an n window, and it is stored once. The shifted
// operand, g, needs no thread work at all: TMA writes it.
//   1. One block of three warpgroups per (64 input channels, 64 output
//      channels, split) walks its share of the 8 x 16 pixel tiles q. Per tile:
//      the raw x tile arrives by TMA (128-byte swizzled rows, one a pixel) and
//      is normalized in place (affine, SiLU, hash mask, bf16); g arrives by
//      TMA as one window of 10 x 18 pixels (rows and columns -1 .. +1 around
//      the tile, zero-filled outside the image).
//   2. Warpgroup dy owns the taps (dy, 0..2): per tile row one wgmma
//      m64n64k16 a tap, A = n^T and B = the g window, both MN-major by
//      descriptor (wgmma_common.cuh); 96 f32 accumulators a thread. A tap's
//      16 g rows start at window pixel row (r + 2 - dy) * 18 + 2 - dx: any
//      row, not an 8-row atom boundary. The hardware applies the 128-byte
//      swizzle by shared-memory address, as TMA wrote it, so a descriptor may
//      start at any 128-byte row: one window serves all nine taps.
//   3. The pipeline: x tiles in a ring of three (tile j + 2's TMA starts while
//      tile j's products run), g windows in a ring of two, each on its own
//      mbarriers. Each warpgroup issues the 12 products of tile j's rows
//      0..3, normalizes tile j + 1 (its share of the chunks, straight-line
//      code of the Kind the prologue has, conv_common.cuh) while the tensor
//      cores run them, issues the 12 of rows 4..7, then waits.
//   4. dbias: the block of channel tile ci sums g (the window's inner 8 x 16
//      pixels) over every C/64-th of its pixel tiles (ci, ci + C/64, ...), so
//      each tile's g is summed once and every block does its share.
//   5. One thread per output adds the splits' partials (and the channel tiles'
//      dbias parts) in a fixed order: two runs give the same bits. No atomics.
// C and D are multiples of 64 and W of 16 (ops/conv.py::supported); a ragged
// last row tile is masked (n zeroed there, g zero-filled by TMA). Launches on
// the caller's stream, allocates nothing (the wrapper allocates the partials;
// ops/conv.py::wgrad_geometry picks the split count), and returns
// cudaGetLastError().

#include "conv_common.cuh"
#include "wgmma_common.cuh"

namespace {

using namespace s2s_conv;
using namespace s2s_wgmma;

constexpr int kTH = 8;                       // rows of a pixel tile
constexpr int kTW = 16;                      // columns of a pixel tile: one k16 step a row
constexpr int kGH = kTH + 2;                 // rows of the g window (dy shifts)
constexpr int kGW = kTW + 2;                 // columns of the g window (dx shifts)
constexpr int kBC = 64;                      // input channels of a block (GEMM M, one 128-byte row)
constexpr int kBD = 64;                      // output channels of a block (GEMM N)
constexpr int kThreads = 3 * 128;            // warpgroup dy holds taps (dy, 0..2)
constexpr int kNBytes = kTH * kTW * 128;     // an x / n tile: 128 rows, 16 atoms
constexpr int kGLoad = kGH * kGW * 128;      // the g window: 180 rows
constexpr int kGBytes = (kGLoad + 1023) / 1024 * 1024;  // its ring slot, whole atoms
constexpr int kChunks = kTH * kTW * 8;       // 16-byte chunks of an n tile
constexpr int kSlices = (kChunks + kThreads - 1) / kThreads;  // 3 a thread
constexpr int kBiasThreads = 256;            // dbias: 8 channels x 32 pixels a tile each
constexpr int kSmemBytes = 3 * kNBytes + 2 * kGBytes + kBiasThreads / 8 * kBD * 4 + 5 * 8 + 1024;  // 105,512

struct Tile {
  int b, h0, w0;
};

__device__ __forceinline__ Tile tile_of(int pt, int tiles_h, int tiles_w) {
  const int tiles = tiles_h * tiles_w;
  const int b = pt / tiles;
  const int t = pt - b * tiles;
  return {b, (t / tiles_w) * kTH, (t % tiles_w) * kTW};
}

__global__ void __launch_bounds__(kThreads, 1)
conv3x3_wgrad_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap g_map,
                     float* __restrict__ partial, int H, int W, int C, int D, int tiles_h, int tiles_w,
                     int n_ptiles, int splits, Prologue pro) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  unsigned char* nbuf = base;                    // [3][128 rows][128 B]: x, then n in place
  unsigned char* gbuf = nbuf + 3 * kNBytes;      // [2][180 rows][128 B]
  float* bias_red = reinterpret_cast<float*>(gbuf + 2 * kGBytes);   // [32][64]
  uint64_t* xbar = reinterpret_cast<uint64_t*>(bias_red + kBiasThreads / 8 * kBD);  // [3]: tile j's x on xbar[j % 3]
  uint64_t* gbar = xbar + 3;                                         // [2]: tile j's g on gbar[j % 2]

  const int split = blockIdx.x;
  const int c_tiles = C / kBC;
  const int ci = blockIdx.y % c_tiles;
  const int c0 = ci * kBC;
  const int d0 = (blockIdx.y / c_tiles) * kBD;
  const int tid = threadIdx.x;
  const int dy = tid >> 7;  // this warpgroup's row of taps
  const int n_mine = split < n_ptiles ? (n_ptiles - split + splits - 1) / splits : 0;  // tiles j = 0 .. n_mine - 1
  auto tile = [&](int j) { return tile_of(split + j * splits, tiles_h, tiles_w); };
  auto load_x = [&](int j) {  // tile j's raw x (channels c0..) into n buffer j % 3
    if (tid == 0 && j < n_mine) {
      const Tile t = tile(j);
      mbar_expect_tx(xbar + j % 3, kNBytes);
      tma_load_4d(nbuf + (j % 3) * kNBytes, &x_map, c0, t.w0, t.h0, t.b, xbar + j % 3);
    }
  };
  auto load_g = [&](int j) {  // tile j's g window (channels d0.., rows h0 - 1.., columns w0 - 1..)
    if (tid == 0 && j < n_mine) {
      const Tile t = tile(j);
      mbar_expect_tx(gbar + j % 2, kGLoad);
      tma_load_4d(gbuf + (j % 2) * kGBytes, &g_map, d0, t.w0 - 1, t.h0 - 1, t.b, gbar + j % 2);
    }
  };
  // Tile j's raw x normalized in place: chunk i is pixel i / 8, channels
  // 8 * (i % 8). A thread's chunks all hold the channels c0 + 8 * (tid % 8)
  // (kThreads % 8 == 0), whose factors are loaded once a tile.
  auto prologue = [&](int j) {
    const Tile t = tile(j);
    const int c = c0 + 8 * (tid & 7);
    unsigned char* ns = nbuf + (j % 3) * kNBytes;
    float sc[8], sh[8];
    channel_factors(pro, t.b, c, C, sc, sh);
    with_kind(pro, [&](auto kind) {
      uint4 raw[kSlices];
#pragma unroll
      for (int k = 0; k < kSlices; ++k) {
        const int i = tid + k * kThreads;
        if (i < kChunks) raw[k] = *reinterpret_cast<const uint4*>(ns + swz128(i >> 3, i & 7));
      }
#pragma unroll
      for (int k = 0; k < kSlices; ++k) {
        const int i = tid + k * kThreads;
        if (i < kChunks) {
          const int m = i >> 3;
          const int h = t.h0 + m / kTW;
          uint4 val = make_uint4(0u, 0u, 0u, 0u);  // rows past H: SAME padding applies to n
          if (h < H) {
            const uint32_t p = static_cast<uint32_t>((t.b * H + h) * W + t.w0 + m % kTW);
            val = prologue8(kind, raw[k], pro, sc, sh, p * static_cast<uint32_t>(C) + static_cast<uint32_t>(c));
          }
          *reinterpret_cast<uint4*>(ns + swz128(m, i & 7)) = val;
        }
      }
    });
  };

  float acc[3][32];
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[dx][e] = 0.f;
  float bsum[8] = {};  // tid < kBiasThreads: channels d0 + 8 (tid % 8) .. + 7 over its pixels

  if (tid == 0) {
    for (int k = 0; k < 3; ++k) mbar_init(xbar + k, 1);
    for (int k = 0; k < 2; ++k) mbar_init(gbar + k, 1);
    fence_proxy_async();
  }
  __syncthreads();
  load_x(0);
  load_x(1);
  load_g(0);
  load_g(1);
  if (n_mine > 0) {
    mbar_wait(xbar, 0);
    prologue(0);
    fence_proxy_async();
  }

  for (int j = 0; j < n_mine; ++j) {
    unsigned char* ns = nbuf + (j % 3) * kNBytes;
    unsigned char* gs = gbuf + (j % 2) * kGBytes;
    mbar_wait(gbar + j % 2, (j / 2) & 1);  // tile j's g window has landed
    __syncthreads();  // tile j's n is complete; tile j - 1's products are done everywhere
    load_x(j + 2);    // into the n buffer tile j - 1 used
    const bool next = j + 1 < n_mine;
    if (next) mbar_wait(xbar + (j + 1) % 3, ((j + 1) / 3) & 1);
    // Tile j's products: tile rows 0..3 issued, then tile j + 1's prologue
    // while the tensor cores run them, then rows 4..7.
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) fence_regs(acc[dx]);
    wgmma_fence();
#pragma unroll
    for (int r = 0; r < kTH; ++r) {
      const uint64_t da = desc_sw128(ns + r * 2048);
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        wgmma_m64n64k16<1, 1>(acc[dx], da, desc_sw128(gs + ((r + 2 - dy) * kGW + 2 - dx) * 128));
      }
      if (r == kTH / 2 - 1 && next) prologue(j + 1);
    }
    wgmma_commit();
    fence_proxy_async();
    if (j % c_tiles == ci && tid < kBiasThreads) {  // this block's share of dbias: the window's inner pixels
#pragma unroll
      for (int k = 0; k < kTH * kTW / (kBiasThreads / 8); ++k) {  // pixel tid / 8 + 32 k, channels 8 (tid % 8)
        const int q = (tid >> 3) + k * (kBiasThreads / 8);
        const int m = (1 + q / kTW) * kGW + 1 + q % kTW;
        const uint4 v = *reinterpret_cast<const uint4*>(gs + swz128(m, tid & 7));
        const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(p[e]);
          bsum[2 * e] += f.x;
          bsum[2 * e + 1] += f.y;
        }
      }
    }
    wgmma_wait<0>();  // tile j's products are done (this warpgroup's)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) fence_regs(acc[dx]);
    __syncthreads();  // ... everyone's: tile j's g buffer is free
    load_g(j + 2);
  }

  // accumulator fragment of warp w: (c row 16w + gr (+8), d columns 8i + 2t, +1)
  const int lane = tid & 31;
  const int w = (tid >> 5) & 3;
  const int gr = lane >> 2;
  const int t = lane & 3;
  const int64_t stride = 9LL * C * D + static_cast<int64_t>(c_tiles) * D;
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    float* out = partial + split * stride + static_cast<int64_t>(3 * dy + dx) * C * D;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = c0 + 16 * w + gr + 8 * half;
        const int d = d0 + 8 * i + 2 * t;
        *reinterpret_cast<float2*>(out + static_cast<int64_t>(c) * D + d) =
            make_float2(acc[dx][4 * i + 2 * half], acc[dx][4 * i + 2 * half + 1]);
      }
    }
  }
  if (tid < kBiasThreads) {
#pragma unroll
    for (int e = 0; e < 8; ++e) bias_red[(tid >> 3) * kBD + 8 * (tid & 7) + e] = bsum[e];
  }
  __syncthreads();
  if (tid < kBD) {  // the 32 row groups, in order
    float total = 0.f;
    for (int r = 0; r < kBiasThreads / 8; ++r) total += bias_red[r * kBD + tid];
    partial[split * stride + 9LL * C * D + static_cast<int64_t>(ci) * D + d0 + tid] = total;
  }
}

// dw = sum over splits; dbias = sum over splits and C tiles; in a fixed order.
__global__ void __launch_bounds__(256)
wgrad_reduce(const float* __restrict__ partial, float* __restrict__ dw, float* __restrict__ dbias,
             int64_t n_w, int D, int c_tiles, int splits) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  const int64_t stride = n_w + static_cast<int64_t>(c_tiles) * D;
  if (i >= n_w + D) return;
  float total = 0.f;
  if (i < n_w) {
    for (int s = 0; s < splits; ++s) total += partial[s * stride + i];
    dw[i] = total;
  } else {
    for (int s = 0; s < splits; ++s) {
      for (int c = 0; c < c_tiles; ++c) total += partial[s * stride + n_w + static_cast<int64_t>(c) * D + (i - n_w)];
    }
    dbias[i - n_w] = total;
  }
}

}  // namespace

// x (B,H,W,C) bf16, g (B,H,W,D) bf16; partial (splits, 9*C*D + (C/64)*D) f32
// scratch; dw (3,3,C,D) f32, dbias (D,) f32. Returns a cudaError_t (0 = success).
extern "C" int s2s_conv3x3_wgrad(const void* x, const void* g, void* partial, void* dw, void* dbias, int B,
                                 int H, int W, int C, int D, int splits, const void* scale, const void* shift,
                                 int silu, int dropout, uint32_t seed, uint32_t keep_threshold, float keep_scale,
                                 void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || W % kTW || C <= 0 || D <= 0 || C % kBC || D % kBD || splits <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((scale == nullptr) != (shift == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(conv3x3_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Prologue pro = make_prologue(static_cast<const float*>(scale), static_cast<const float*>(shift), silu,
                                     dropout, seed, keep_threshold, keep_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles_h = (H + kTH - 1) / kTH;
  const int tiles_w = W / kTW;
  const int n_ptiles = B * tiles_h * tiles_w;
  const uint64_t b = static_cast<uint64_t>(B), h = static_cast<uint64_t>(H), w = static_cast<uint64_t>(W);
  CUtensorMap x_map, g_map;  // boxes of 64 channels: the 8 x 16 x tile; the 10 x 18 g window
  err = make_map_4d(&x_map, x, {static_cast<uint64_t>(C), w, h, b}, {kBC, kTW, kTH, 1}, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = make_map_4d(&g_map, g, {static_cast<uint64_t>(D), w, h, b}, {kBD, kGW, kGH, 1}, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(splits, (C / kBC) * (D / kBD));
  conv3x3_wgrad_kernel<<<grid, kThreads, kSmemBytes, s>>>(x_map, g_map, static_cast<float*>(partial), H, W, C, D,
                                                          tiles_h, tiles_w, n_ptiles, splits, pro);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_w = 9LL * C * D;
  const int64_t blocks = (n_w + D + 255) / 256;
  wgrad_reduce<<<static_cast<unsigned>(blocks), 256, 0, s>>>(static_cast<const float*>(partial),
                                                             static_cast<float*>(dw), static_cast<float*>(dbias),
                                                             n_w, D, C / kBC, splits);
  return static_cast<int>(cudaGetLastError());
}
