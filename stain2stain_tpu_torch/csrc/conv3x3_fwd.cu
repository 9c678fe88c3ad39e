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
// Design. An implicit GEMM with M = output pixels, N = D, K = 9*C, on wgmma:
//   * a persistent block (one per SM, two warpgroups) walks work items of
//     16 x 16 output pixels (M = 256) and 128 output channels, so every
//     staged weight feeds 256 pixels (2.4 GB of weights staged per call at
//     the first level; 512-pixel items would halve that, but their
//     accumulators do not fit two warpgroups);
//   * a K step is (32 input channels, one column shift dx): the 18 x 16
//     window of n shifted by dx, exactly 16 pixels wide, so each row tap dy is
//     a whole number of 8-row swizzle atoms; and the weights of the three taps
//     (dy, dx), 3 x 128 x 32. Both are K-major with 64-byte rows, swizzled
//     (wgmma_common.cuh); each warpgroup runs 2 x m64n128k16 per tap and k16,
//     both operands by descriptor, 128 f32 accumulators a thread;
//   * every copy is a TMA tile copy on an mbarrier, in rings three steps deep:
//     step q + 2's weights (and, for K3, its window of dy, raw, straight into
//     its final layout, zero outside the image) are requested while step q's
//     products run, by one thread, with no thread work per byte;
//   * K2: the raw 18 x 18 halo of a channel step arrives by TMA two channel
//     steps ahead; the prologue (affine, SiLU, hash mask, bf16) runs on it
//     once per element (x 1.27 for the halo, not x 3.4 as one pass per
//     window would) and stores each result into the dx windows that hold it,
//     a third of the halo after the second tap's products of each step, as
//     straight-line code of the prologue's Kind (conv_common.cuh), so it
//     overlaps the tensor cores; six window slots hold the channel step in use
//     and the next. It still costs about as much as the products (K2 takes
//     about twice K3's time at the flagship's shapes): overlapping it fully
//     would take warps of their own for it;
//   * one barrier per step; the steps of consecutive work items run back to
//     back, so one item's epilogue overlaps the next item's copies.
// C is a multiple of 32 and D of 128; W a multiple of 16 (ops/conv.py::supported:
// C and D multiples of 128); a ragged last row tile is masked (zero-filled by
// TMA, its outputs not stored).
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include "conv_common.cuh"
#include "wgmma_common.cuh"

namespace {

using namespace s2s_conv;
using namespace s2s_wgmma;

constexpr int kTH = 16;                // output rows of a work item
constexpr int kTW = 16;                // output columns of a work item (one m64 = 4 rows)
constexpr int kHH = kTH + 2;           // window and halo rows
constexpr int kHW = kTW + 2;           // halo columns
constexpr int kBN = 128;               // output channels of a work item
constexpr int kBK = 32;                // input channels of a K step (one 64-byte row)
constexpr int kThreads = 256;          // two warpgroups of 8 rows x 16 pixels each
constexpr int kABytes = kHH * kTW * 64;        // a window: 288 rows of 64 bytes, 36 atoms
constexpr int kTapBytes = kBN * 64;            // one tap's weights: 128 rows, 16 atoms
constexpr int kBBytes = 3 * kTapBytes;         // the three taps (dy, dx) of a step
constexpr int kBSlots = 3;                     // weights ring: steps q, q + 1 in use, q + 2 landing
// windows ring: K3 as the weights; K2 two groups of three (the dx of one
// channel step in use, the next channel step's being normalized into place)
template <bool kPrologue>
constexpr int kASlots = kPrologue ? 6 : 3;
constexpr int kHaloBytes = kHH * kHW * 64;     // K2: a raw halo of 32 channels, plain [pixel][64 B]
template <bool kPrologue>
constexpr int kSmemBytes = kASlots<kPrologue> * kABytes + kBSlots * kBBytes + (kPrologue ? 2 * kHaloBytes : 0) +
                           5 * 8 + 1024;  // 226,856 / 130,088
constexpr int kSubRows = kHH / 3;              // halo rows a K2 step normalizes (one third)
constexpr int kSubChunks = kSubRows * kHW * (kBK / 8);  // 432 16-byte chunks
constexpr int kSubIters = (kSubChunks + kThreads - 1) / kThreads;  // 2 a thread

struct Step {
  int b, h0, w0, n0;  // the work item
  int kb, dx;         // channels kb*32.., column shift dx
};

__device__ __forceinline__ Step step_of(int q, int steps, int tiles_h, int tiles_w, int n_tiles) {
  const int work = blockIdx.x + (q / steps) * gridDim.x;
  const int s = q - (q / steps) * steps;
  const int pt = work / n_tiles;
  const int tiles = tiles_h * tiles_w;
  const int b = pt / tiles;
  const int t = pt - b * tiles;
  return {b, (t / tiles_w) * kTH, (t % tiles_w) * kTW, (work - pt * n_tiles) * kBN, s / 3, s - 3 * (s / 3)};
}

__device__ __forceinline__ bool in_image(int h, int wc, int H, int W) { return h >= 0 && h < H && wc >= 0 && wc < W; }

template <bool kPrologue>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_fwd_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap halo_map,
                   const __grid_constant__ CUtensorMap w_map, const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ y, int H, int W, int C, int D, int tiles_h, int tiles_w, int n_items,
                   Prologue pro) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* abuf = align1024(smem_raw);                  // [kASlots][288 rows][64 B], swizzled
  unsigned char* bbuf = abuf + kASlots<kPrologue> * kABytes;  // [3][3 taps][128 rows][64 B], swizzled
  unsigned char* hbuf = bbuf + kBSlots * kBBytes;             // K2: [2][324 pixels][64 B]
  uint64_t* bars = reinterpret_cast<uint64_t*>(hbuf + (kPrologue ? 2 * kHaloBytes : 0));  // [3]: step q on bars[q % 3]
  uint64_t* hbars = bars + kBSlots;                                                       // [2]: halo g on hbars[g % 2]

  const int tid = threadIdx.x;
  const int wg = tid >> 7;  // warpgroup: output rows 8*wg .. 8*wg + 7
  const int n_tiles = D / kBN;
  const int steps = 3 * (C / kBK);  // a multiple of 3: a channel step's dx never straddles items
  const int my_items = (n_items - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
                       static_cast<int>(gridDim.x);
  const int total = my_items * steps;
  auto a_slot = [&](int q) { return abuf + (kPrologue ? 3 * ((q / 3) & 1) + q % 3 : q % 3) * kABytes; };
  auto b_slot = [&](int q) { return bbuf + (q % kBSlots) * kBBytes; };
  // Step q's three taps' weights (dy = 0..2 at its dx; 128 output channels x
  // 32 input channels each) and, for K3, its window of dy (rows -1 .. 16,
  // columns dx - 1 .., zero outside the image), by TMA on bars[q % 3].
  auto copies = [&](int q) {
    if (tid == 0 && q < total) {
      const Step st = step_of(q, steps, tiles_h, tiles_w, n_tiles);
      uint64_t* bar = bars + q % kBSlots;
      mbar_expect_tx(bar, kBBytes + (kPrologue ? 0 : kABytes));
      tma_load_4d(b_slot(q), &w_map, st.kb * kBK, st.n0, st.dx, 0, bar);
      if (!kPrologue) tma_load_4d(a_slot(q), &x_map, st.kb * kBK, st.w0 + st.dx - 1, st.h0 - 1, st.b, bar);
    }
  };
  // K2: the raw halo (rows -1 .. 16, columns -1 .. 16, zero outside the
  // image) of channel step g (steps 3g .. 3g + 2) into halo buffer g % 2
  auto load_halo = [&](int g) {
    if (kPrologue && tid == 0 && 3 * g < total) {
      const Step st = step_of(3 * g, steps, tiles_h, tiles_w, n_tiles);
      mbar_expect_tx(hbars + g % 2, kHaloBytes);
      tma_load_4d(hbuf + (g % 2) * kHaloBytes, &halo_map, st.kb * kBK, st.w0 - 1, st.h0 - 1, st.b, hbars + g % 2);
    }
  };
  if (tid == 0) {
    for (int k = 0; k < kBSlots + 2; ++k) mbar_init(bars + k, 1);
    fence_proxy_async();
  }
  __syncthreads();

  // K2: the halo rows [6r, 6r + 6) of channel step g, normalized once and
  // stored into the three dx windows that hold them. A thread's chunks all
  // hold the channels 8 * (tid % 4) of the step (kThreads % 4 == 0).
  auto prologue_part = [&](int g, int r) {
    if constexpr (kPrologue) {
      if (3 * g >= total) return;
      if (r == 0) mbar_wait(hbars + g % 2, (g / 2) & 1);
      const Step st = step_of(3 * g, steps, tiles_h, tiles_w, n_tiles);
      const unsigned char* halo = hbuf + (g % 2) * kHaloBytes;
      const int c = st.kb * kBK + 8 * (tid & 3);
      float sc[8], sh[8];
      channel_factors(pro, st.b, c, C, sc, sh);
      with_kind(pro, [&](auto kind) {  // straight-line code: the chunks' loads first, then their math
        uint4 raw[kSubIters];
#pragma unroll
        for (int k = 0; k < kSubIters; ++k) {
          const int i = kSubChunks * r + tid + k * kThreads;
          if (i < kSubChunks * (r + 1)) raw[k] = *reinterpret_cast<const uint4*>(halo + i * 16);
        }
#pragma unroll
        for (int k = 0; k < kSubIters; ++k) {
          const int i = kSubChunks * r + tid + k * kThreads;
          if (i >= kSubChunks * (r + 1)) continue;
          const int pix = i >> 2;  // halo pixel hr * 18 + hc
          const int hr = pix / kHW;
          const int hc = pix - hr * kHW;
          const int h = st.h0 + hr - 1;
          const int wc = st.w0 + hc - 1;
          uint4 val = make_uint4(0u, 0u, 0u, 0u);  // SAME padding applies to n
          if (in_image(h, wc, H, W)) {
            const uint32_t p = static_cast<uint32_t>((st.b * H + h) * W + wc);
            val = prologue8(kind, raw[k], pro, sc, sh, p * static_cast<uint32_t>(C) + static_cast<uint32_t>(c));
          }
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int col = hc - dx;  // the window for dx holds halo columns dx .. dx + 15
            if (col >= 0 && col < kTW) {
              *reinterpret_cast<uint4*>(a_slot(3 * g + dx) + swz64(hr * kTW + col, i & 3)) = val;
            }
          }
        }
      });
    }
  };

  // prime the rings: steps 0 and 1 in flight; K2: channel step 0 normalized
  // whole, channel step 1's halo in flight
  copies(0);
  copies(1);
  load_halo(0);
  load_halo(1);
  for (int r = 0; r < 3; ++r) prologue_part(0, r);

  float acc[2][64];
  for (int item = 0; item < my_items; ++item) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[mi][e] = 0.f;
    for (int s = 0; s < steps; ++s) {
      const int q = item * steps + s;
      unsigned char* as = a_slot(q);
      unsigned char* bs = b_slot(q);
      mbar_wait(bars + q % kBSlots, (q / kBSlots) & 1);  // step q's copies have landed
      fence_proxy_async();  // (K2: this thread's windows, stored by the generic proxy)
      __syncthreads();  // step q's operands are in place, everyone's; step q - 1's products are done
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) fence_regs(acc[mi]);  // the zeroing stays before the products
      wgmma_fence();
      // the products of tap dy, then a share of the staging work while they run
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint64_t db = desc_sw64(bs + dy * kTapBytes + kk * 32);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            wgmma_m64n128k16<0, 0>(acc[mi], desc_sw64(as + (8 * wg + 4 * mi + dy) * (kTW * 64) + kk * 32), db);
          }
        }
        if (dy == 0) {
          copies(q + 2);  // into step q - 1's slots
          if (q % 3 == 0) load_halo(q / 3 + 2);  // into the halo buffer channel step q/3 used
        }
        // a third of channel step q/3 + 1, into its windows (step q - 1's group's)
        if (dy == 1) prologue_part(q / 3 + 1, q % 3);
      }
      wgmma_commit();
      wgmma_wait<0>();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) fence_regs(acc[mi]);

    // fragment of warp wl: pixel row 8*wg + 4*mi + wl, column gr (+8); channels 8i + 2t, +1
    const Step st = step_of(item * steps, steps, tiles_h, tiles_w, n_tiles);
    const int lane = tid & 31;
    const int wl = (tid >> 5) & 3;
    const int gr = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int h = st.h0 + 8 * wg + 4 * mi + wl;
      if (h >= H) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int64_t p = static_cast<int64_t>(st.b * H + h) * W + st.w0 + gr + 8 * half;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int n = st.n0 + 8 * i + 2 * t;
          const float v0 = acc[mi][4 * i + 2 * half] + __ldg(bias + n);
          const float v1 = acc[mi][4 * i + 2 * half + 1] + __ldg(bias + n + 1);
          *reinterpret_cast<__nv_bfloat162*>(y + p * D + n) = __floats2bfloat162_rn(v0, v1);
        }
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
  const Prologue pro = make_prologue(static_cast<const float*>(scale), static_cast<const float*>(shift), silu,
                                     dropout, seed, keep_threshold, keep_scale);
  const bool identity = scale == nullptr && !silu && !dropout;
  auto kernel = identity ? conv3x3_fwd_kernel<false> : conv3x3_fwd_kernel<true>;
  const int smem = identity ? kSmemBytes<false> : kSmemBytes<true>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint64_t b = static_cast<uint64_t>(B), h = static_cast<uint64_t>(H), wd = static_cast<uint64_t>(W);
  const uint64_t c = static_cast<uint64_t>(C), d = static_cast<uint64_t>(D);
  CUtensorMap x_map, halo_map, w_map;  // boxes of 32 input channels: a 18 x 16 window (K3), the 18 x 18
                                      // halo (K2), 3 taps x 128 output channels
  err = make_map_4d(&x_map, x, {c, wd, h, b}, {kBK, kTW, kHH, 1}, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = make_map_4d(&halo_map, x, {c, wd, h, b}, {kBK, kHW, kHH, 1}, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = make_map_4d(&w_map, w, {c, d, 3, 3}, {kBK, kBN, 1, 3}, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_h = (H + kTH - 1) / kTH;
  const int tiles_w = W / kTW;
  const int n_items = B * tiles_h * tiles_w * (D / kBN);
  const int grid = n_items < sms ? n_items : sms;  // persistent: one block an SM
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x_map, halo_map, w_map, static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(y), H, W, C, D, tiles_h, tiles_w, n_items, pro);
  return static_cast<int>(cudaGetLastError());
}
