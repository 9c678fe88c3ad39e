// K1 at head dim 72 in bf16 (DiT-XL/2's heads): the forward (attention_fwd.cu)
// and the backward's dk/dv and dq passes (attention_bwd.cu) on Hopper's
// warpgroup MMA (wgmma) fed by TMA. The bf16 kernels at d 16, 32 and 64 stay
// on mma.sync (attention_common.cuh); nothing here is shared with them.
//
// What bounds it. At the DiT's training shape (BH 512 = batch 32 x 16 heads,
// T 1024) the forward's two products are 4*BH*T^2*72 = 155 GFLOP (0.156 ms at
// 989 TFLOP/s) and its BH*T^2 = 537 M exponentials take about 0.14 ms on the
// MUFU units; the backward's five products 10*BH*T^2*72 = 387 GFLOP (0.39 ms).
// q, k, v, o, do and the gradients are 0.3 GB at most (0.1 ms at 3.35 TB/s).
// So the tensor cores bound both, and only wgmma reaches their full rate:
// mma.sync, which the d 16/32/64 kernels use, issues a 16 x 8 x 16 product
// per warp from registers and tops out well below it (the earlier mma.sync
// kernels at d 72 ran at about 220 TFLOP/s).
//
// The design (FlashAttention-3's shape):
//   * one block of 384 threads: two consumer warpgroups (warps 0-3, 4-7), each
//     on 64 rows of a 128-row block tile (queries in the forward and the dq
//     pass, keys in the dk/dv pass), and a producer warpgroup (warps 8-11) of
//     which one thread issues every copy. The block starts with 168 registers
//     a thread (each SM sub-partition holds three of its warps); the producer
//     gives all but 40 back (setmaxnreg) and each consumer takes 232, room for
//     the dk/dv pass's six live tiles (dk and dv sums, s^T, dp^T and their
//     bf16 operands: 168 values a thread) without spilling;
//   * persistent blocks, one an SM, walk the (bh, 128-row) work items in
//     order; the item's resident tiles (q; k and v; q and do) are double
//     buffered, so the next item's arrive while this one's last products run;
//   * the other operand streams through a ring of three stages in shared
//     memory (kFwdStages, kBwdStages): TMA tile copies completed on a `full`
//     mbarrier, and a stage is refilled once each consumer warp has arrived on
//     its `empty` one. Two stages took 1.4x the time at the DiT's shape (a
//     warpgroup waits for the tile the other still holds), four no less than
//     three; shared memory is 161, 144 and 141 KB (forward, dk/dv, dq);
//   * d 72 in panels. A 144-byte row does not fit the 128-byte swizzle atom,
//     so every (BH, T, 72) tensor has two tensor maps: columns 0-63 (128-byte
//     rows, 128-byte swizzle) and columns 64-79 (32-byte rows, 32-byte
//     swizzle); the maps' inner extent is 72, so TMA zero-fills columns 72-79,
//     and rows past T (of each bh: the maps are (72, T, BH)). A tile of R rows
//     is its panel 0 (R x 128 B) followed by its panel 1 (R x 32 B);
//   * products over d (s = q.k^T, dp = do.v^T and their transposes) take four
//     k16 steps in panel 0 and one in panel 1 (its upper 8 columns zero), both
//     operands K-major from shared memory; products with d as N (p.v, dv, dk,
//     dq) take m64n64 on panel 0 plus m64n8 on panel 1 (its first 8 columns of
//     each 32-byte row), B MN-major: the padding costs 80/72 of the products
//     over d alone. (m64n16 there, columns 72-79 dropped, took 3 % more of the
//     forward's time);
//   * p and ds are rounded to bf16 in registers and are the A operand of the
//     next product: an accumulator's two adjacent 8-column tiles are the
//     m64k16 A fragment, so nothing goes through shared memory;
//   * the forward's online softmax stays in registers as in the mma.sync
//     kernels (row max and sum over a quad by shuffles, exp2 with
//     scale * log2(e) folded into one FFMA, the sum rescaled per key tile);
//     its key tiles are 128 wide, its rows' statistics f32;
//   * each warpgroup's loop is software-pipelined (the next tile's products
//     over d are asked for before this tile's last product is waited on), and
//     the two warpgroups run independently, so one's exponentials overlap the
//     other's products and the tensor cores have work queued across waits.
//
// The backward keeps the mma.sync kernels' passes and contract: prep (delta
// and lse2, attention_bwd.cu), then dk/dv by 128-key block (queries streamed
// 64 at a time with their (lse2, delta) rows: s^T = k.q^T, p^T, dv += p^T.do,
// dp^T = v.do^T, ds^T, dk += ds^T.q), then dq by 128-query block (keys
// streamed 64 at a time: s, p, dp, ds, dq += ds.k); no atomics, every
// gradient written once in bf16, the result the same bit for bit on every run.
//
// Launches on the caller's stream, allocates nothing, and returns the first
// launch error (cudaGetLastError) so the Python wrapper can raise on it.

#pragma once

#include <math.h>
#include <stdint.h>

#include "mma_common.cuh"    // pack_bf16
#include "wgmma_common.cuh"  // descriptors, wgmma, mbarriers, TMA

namespace s2s_attn_d72 {

using namespace s2s_wgmma;
using bf16 = __nv_bfloat16;
using s2s_mma::pack_bf16;

constexpr int kD = 72;
constexpr int kPanel1 = 64;             // first column of panel 1
constexpr int kBlockRows = 128;         // rows of a work item: 64 a consumer warpgroup
constexpr int kConsumerWarps = 8;       // two warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 128;  // and the producer warpgroup
constexpr int kProducerThread = 32 * kConsumerWarps;  // the one thread that issues copies
// Registers a thread: the block starts at 168 (65,536 / 384), the producer
// warpgroup gives back all but kProducerRegs and the consumers take them:
// 128 * (168 - 40) = 256 * (232 - 168).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kBoxRows = 64;            // rows of one TMA box
constexpr int kStreamRows = 64;         // backward: rows of a streamed tile
constexpr int kFwdKeys = 128;           // forward: keys of a streamed tile
constexpr int kFwdStages = 3;           // ring depths
constexpr int kBwdStages = 3;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Bytes of a tile of R rows: panel 0 (R x 128) then panel 1 (R x 32); both
// start 1024-byte aligned where the tile does (R a multiple of 8).
template <int R>
constexpr uint32_t kTileBytes = R * (128 + 32);

// The two tensor maps of a (BH, T, 72) bf16 tensor.
struct PanelMaps {
  CUtensorMap p0;  // columns 0-63, boxes of 64 x 64, 128-byte swizzle
  CUtensorMap p1;  // columns 64-79, boxes of 16 x 64, 32-byte swizzle, 72-79 zero
};

// Rows [row0, row0 + R) of slice bh into an R-row tile, on `bar`.
template <int R>
__device__ __forceinline__ void load_tile(unsigned char* tile, const PanelMaps& m, int row0, int bh, uint64_t* bar) {
#pragma unroll
  for (int b = 0; b < R / kBoxRows; ++b) {
    tma_load_4d(tile + b * kBoxRows * 128, &m.p0, 0, row0 + b * kBoxRows, bh, 0, bar);
    tma_load_4d(tile + R * 128 + b * kBoxRows * 32, &m.p1, kPanel1, row0 + b * kBoxRows, bh, 0, bar);
  }
}

// The two panels of a run of a tile's rows, as wgmma operands: an A operand
// reads its first 64 rows, the B operand of product_abt<N> its first N.
struct Rows {
  const unsigned char* p0;
  const unsigned char* p1;
};

// The rows of an R-row tile from row 64w on (w = 0: the whole tile).
template <int R>
__device__ __forceinline__ Rows rows_of(const unsigned char* tile, int w = 0) {
  return {tile + w * 64 * 128, tile + R * 128 + w * 64 * 32};
}

// s (64 x N f32; N/2 values a thread) = A . B^T over d: A the warpgroup's 64
// rows, B N rows (N = 64 or 128, from rows_of<N>), both K-major.
template <int N>
__device__ __forceinline__ void product_abt(float (&s)[N / 2], Rows a, Rows b) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if constexpr (N == 128) {
      wgmma_m64n128k16<0, 0>(s, desc_sw128(a.p0 + 32 * ks), desc_sw128(b.p0 + 32 * ks), ks);
    } else {
      wgmma_m64n64k16<0, 0>(s, desc_sw128(a.p0 + 32 * ks), desc_sw128(b.p0 + 32 * ks), ks);
    }
  }
  if constexpr (N == 128) {
    wgmma_m64n128k16<0, 0>(s, desc_sw32(a.p1), desc_sw32(b.p1), 1);
  } else {
    wgmma_m64n64k16<0, 0>(s, desc_sw32(a.p1), desc_sw32(b.p1), 1);
  }
}

// (acc0 | acc1) (64 x 64 | 64 x 8) += P . B: P (64 x 16K) as bf16 A
// fragments, B 16K rows x 72 (MN-major: d along the rows).
template <int K16>
__device__ __forceinline__ void product_pb(float (&acc0)[32], float (&acc1)[4], const uint32_t (&a)[K16][4], Rows b) {
#pragma unroll
  for (int kk = 0; kk < K16; ++kk) {
    wgmma_m64n64k16_rs<1>(acc0, a[kk], desc_sw128(b.p0 + kk * 16 * 128));
    wgmma_m64n8k16_rs<1>(acc1, a[kk], desc_sw32(b.p1 + kk * 16 * 32));
  }
}

// An accumulator (64 x 16K) rounded to bf16 as the A fragments of K16 k-steps.
template <int K16>
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[K16][4], const float (&s)[8 * K16]) {
#pragma unroll
  for (int kk = 0; kk < K16; ++kk) {
    a[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);          // row r, columns 16kk + 2t, +1
    a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);      // row r + 8
    a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);      // row r, columns 16kk + 8 + 2t, +1
    a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);      // row r + 8
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// 2^x on the MUFU unit in one instruction. exp2f adds a range test and two
// multiplies to keep results below 2^-126; flushing those to 0 changes no sum
// here, where every row's largest p is at least 1/T.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Store a thread's share of one row of a 64 x 72 sum (acc0 | acc1, times f),
// in bf16: columns 8i + 2t, +1 of panel 0 and 64 + 2t, +1; h selects the
// fragment's row (r or r + 8).
__device__ __forceinline__ void store_row(bf16* out, const float (&acc0)[32], const float (&acc1)[4], int h, int t,
                                          float f) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    *reinterpret_cast<__nv_bfloat162*>(out + 8 * i + 2 * t) =
        __floats2bfloat162_rn(acc0[4 * i + 2 * h] * f, acc0[4 * i + 2 * h + 1] * f);
  }
  *reinterpret_cast<__nv_bfloat162*>(out + kPanel1 + 2 * t) =
      __floats2bfloat162_rn(acc1[2 * h] * f, acc1[2 * h + 1] * f);
}

// The barriers of a kernel: the resident tiles' two buffers and the ring.
template <int kStages>
struct Barriers {
  uint64_t res_full[2];
  uint64_t res_empty[2];
  uint64_t full[kStages];
  uint64_t empty[kStages];

  __device__ void init() {
    for (int b = 0; b < 2; ++b) {
      mbar_init(res_full + b, 1);
      mbar_init(res_empty + b, kConsumerWarps);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
  }
};

// The producer's and the consumers' walk: a block's n-th work item and, over
// all its items, its j-th streamed tile. Stage j % kStages holds tile j; its
// u-th use (u = j / kStages) completes phase u of `full` and is released by
// phase u of `empty`. Resident buffer n % 2 the same with u = n / 2.
__device__ __forceinline__ int item_of(int n) { return static_cast<int>(blockIdx.x) + n * static_cast<int>(gridDim.x); }

__device__ __forceinline__ int items_of_block(int n_items) {
  return (n_items - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) / static_cast<int>(gridDim.x);
}

// Producer: wait until use u of a buffer may begin (use u - 1 released).
__device__ __forceinline__ void acquire(uint64_t* empty_bar, int u) {
  if (u > 0) mbar_wait(empty_bar, (u - 1) & 1);
}

// Consumer: release a buffer after this warp's last product on it.
__device__ __forceinline__ void release(uint64_t* empty_bar) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty_bar);
}

// ---- forward -----------------------------------------------------------------

constexpr uint32_t kFwdQBytes = kTileBytes<kBlockRows>;
constexpr uint32_t kFwdKVBytes = kTileBytes<kFwdKeys>;
constexpr uint32_t kFwdStageBytes = 2 * kFwdKVBytes;  // k, v
template <int kStages>
constexpr int kFwdSmem = 1024 + 2 * kFwdQBytes + kStages * kFwdStageBytes + sizeof(Barriers<kStages>);

// The online softmax of one key tile of 128 (scores sc, keys key0 ..): keys
// past T score -inf; m becomes the rows' new max, sc their p = exp2((s - m) c),
// l the rescaled sum plus this tile's, alpha the factor the p.v sum takes.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], int key0, int t_len, int t, float c, float (&m)[2],
                                             float (&l)[2], float (&alpha)[2]) {
  if (key0 + kFwdKeys > t_len) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (key0 + 8 * i + 2 * t + (e & 1) >= t_len) sc[4 * i + e] = -INFINITY;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < 16; ++i) mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * h], sc[4 * i + 2 * h + 1]));
    // key 0 lies in tile 0, so m_new is finite from the start and
    // alpha = exp2(-inf) = 0 clears the empty sum and accumulator
    const float m_new = fmaxf(m[h], quad_max(mx));
    alpha[h] = exp2_ftz((m[h] - m_new) * c);
    const float mc = m_new * c;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = exp2_ftz(fmaf(sc[4 * i + 2 * h + e], c, -mc));
        sc[4 * i + 2 * h + e] = p;
        sum += p;
      }
    l[h] = l[h] * alpha[h] + sum;
    m[h] = m_new;
  }
}

// A warpgroup's loop over the key tiles is software-pipelined: the scores of
// tile j + 1 are asked for before p_j.v_j, so that tile's softmax runs while
// the tensor cores do p_j.v_j; the o sum is rescaled once p_j.v_j is done.
template <int kStages>
__global__ void __launch_bounds__(kThreads, 1)
attention_fwd_wgmma_kernel(const __grid_constant__ PanelMaps qm, const __grid_constant__ PanelMaps km,
                           const __grid_constant__ PanelMaps vm, bf16* __restrict__ o, float* __restrict__ lse,
                           int t_len, int n_qtiles, int n_items, float c) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qbuf = align1024(smem_raw);               // [2][128-row q tile]
  unsigned char* ring = qbuf + 2 * kFwdQBytes;             // [kStages][k tile, v tile], 128 keys
  Barriers<kStages>& bar = *reinterpret_cast<Barriers<kStages>*>(ring + kStages * kFwdStageBytes);
  auto stage = [&](int j) { return ring + (j % kStages) * kFwdStageBytes; };
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int n_k = (t_len + kFwdKeys - 1) / kFwdKeys;
  const int my_items = items_of_block(n_items);
  if (tid == 0) {
    bar.init();
    fence_proxy_async();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {  // the producer warpgroup
    setmaxnreg_dec<kProducerRegs>();
    if (tid == kProducerThread) {
      int j = 0;
      for (int n = 0; n < my_items; ++n) {
        const int item = item_of(n);
        const int bh = item / n_qtiles;
        const int q0 = (item - bh * n_qtiles) * kBlockRows;
        acquire(bar.res_empty + (n & 1), n >> 1);
        mbar_expect_tx(bar.res_full + (n & 1), kFwdQBytes);
        load_tile<kBlockRows>(qbuf + (n & 1) * kFwdQBytes, qm, q0, bh, bar.res_full + (n & 1));
        for (int kt = 0; kt < n_k; ++kt, ++j) {
          uint64_t* full = bar.full + j % kStages;
          acquire(bar.empty + j % kStages, j / kStages);
          mbar_expect_tx(full, kFwdStageBytes);
          load_tile<kFwdKeys>(stage(j), km, kt * kFwdKeys, bh, full);
          load_tile<kFwdKeys>(stage(j) + kFwdKVBytes, vm, kt * kFwdKeys, bh, full);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int wg = warp >> 2;
  const int lane = tid & 31;
  const int t = lane & 3;
  int j = 0;  // key tiles consumed, over every item
  for (int n = 0; n < my_items; ++n) {
    const int item = item_of(n);
    const int bh = item / n_qtiles;
    const int q0 = (item - bh * n_qtiles) * kBlockRows;
    const Rows qa = rows_of<kBlockRows>(qbuf + (n & 1) * kFwdQBytes, wg);
    float acc0[32], acc1[4];  // o, columns 0-63 and 64-71
    zero(acc0);
    zero(acc1);
    float m[2] = {-INFINITY, -INFINITY};  // rows r and r + 8: the max of the raw scores
    float l[2] = {0.f, 0.f};              // this thread's share of the row sum of exp2((s - m) c)
    float alpha[2];
    float sc[64];  // s = q.k^T, then p: rows r, r + 8; keys 8i + 2t, +1 of the tile
    uint32_t pa[8][4];
    mbar_wait(bar.res_full + (n & 1), (n >> 1) & 1);
    mbar_wait(bar.full + j % kStages, (j / kStages) & 1);
    wgmma_fence();
    product_abt<kFwdKeys>(sc, qa, rows_of<kFwdKeys>(stage(j)));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    softmax_tile(sc, 0, t_len, t, c, m, l, alpha);
    to_a_frags(pa, sc);
    // tile j's p.v beside tile j + 1's scores; the last tile's p.v alone
    for (int kt = 1; kt < n_k; ++kt, ++j) {
      fence_regs(sc);
      fence_regs(pa);
      fence_regs(acc0);
      fence_regs(acc1);
      mbar_wait(bar.full + (j + 1) % kStages, ((j + 1) / kStages) & 1);
      wgmma_fence();
      product_abt<kFwdKeys>(sc, qa, rows_of<kFwdKeys>(stage(j + 1)));  // s_{j+1}
      wgmma_commit();
      product_pb<8>(acc0, acc1, pa, rows_of<kFwdKeys>(stage(j) + kFwdKVBytes));  // o += p_j.v_j
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);
      softmax_tile(sc, kt * kFwdKeys, t_len, t, c, m, l, alpha);
      wgmma_wait<0>();
      fence_regs(acc0);
      fence_regs(acc1);
      fence_regs(pa);
      release(bar.empty + j % kStages);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc0[4 * i + 2 * h] *= alpha[h];
          acc0[4 * i + 2 * h + 1] *= alpha[h];
        }
        acc1[2 * h] *= alpha[h];
        acc1[2 * h + 1] *= alpha[h];
      }
      to_a_frags(pa, sc);
    }
    fence_regs(pa);
    fence_regs(acc0);
    fence_regs(acc1);
    wgmma_fence();
    product_pb<8>(acc0, acc1, pa, rows_of<kFwdKeys>(stage(j) + kFwdKVBytes));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);
    fence_regs(pa);
    release(bar.empty + j % kStages);
    ++j;
    release(bar.res_empty + (n & 1));

    const int r0 = q0 + 64 * wg + 16 * (warp & 3) + (lane >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float sum = quad_sum(l[h]);
      const int row = r0 + 8 * h;
      if (row >= t_len) continue;
      store_row(o + (static_cast<int64_t>(bh) * t_len + row) * kD, acc0, acc1, h, t, 1.f / sum);
      if (lse != nullptr && t == 0) lse[static_cast<int64_t>(bh) * t_len + row] = (m[h] * c + log2f(sum)) * kLn2;
    }
  }
}

// ---- backward ----------------------------------------------------------------

constexpr uint32_t kBwdResBytes = kTileBytes<kBlockRows>;           // one resident tensor, 128 rows
constexpr uint32_t kBwdTileBytes = kTileBytes<kStreamRows>;         // one streamed tensor, 64 rows
constexpr uint32_t kStatBytes = kStreamRows * 8;                    // 64 (lse2, delta) pairs
constexpr uint32_t kDkdvStageBytes = 2 * kBwdTileBytes + 1024;      // q, do, their stats (1024-aligned)
constexpr uint32_t kDqStageBytes = 2 * kBwdTileBytes;               // k, v
template <int kStages>
constexpr int kDkdvSmem = 1024 + 2 * 2 * kBwdResBytes + kStages * kDkdvStageBytes + sizeof(Barriers<kStages>);
template <int kStages>
constexpr int kDqSmem = 1024 + 2 * 2 * kBwdResBytes + kStages * kDqStageBytes + sizeof(Barriers<kStages>);

// Both passes pipeline a warpgroup's loop as the forward does: the two
// products over d of tile j + 1 are asked for right after tile j's last
// product, so the tensor cores have work queued while the warpgroup waits,
// releases the stage and turns the next scores into p. Every product is
// waited on in the iteration that asks for it: an accumulator still being
// written across the loop's back edge makes ptxas serialize every wgmma.

// dk/dv: a work item is (bh, 128 keys); queries stream 64 at a time with their
// stats rows (T_pad = T rounded up to 64 of them exist; rows past T hold
// lse2 = +inf, so their p is 0).
template <int kStages>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_dkdv_wgmma_kernel(const __grid_constant__ PanelMaps qm, const __grid_constant__ PanelMaps km,
                                const __grid_constant__ PanelMaps vm, const __grid_constant__ PanelMaps dom,
                                const float2* __restrict__ stats, bf16* __restrict__ dk, bf16* __restrict__ dv,
                                int t_len, int t_pad, int n_ktiles, int n_items, float c, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* res = align1024(smem_raw);  // [2][k tile, v tile], 128 rows
  unsigned char* ring = res + 4 * kBwdResBytes;  // [kStages][q tile, do tile, stats], 64 rows
  Barriers<kStages>& bar = *reinterpret_cast<Barriers<kStages>*>(ring + kStages * kDkdvStageBytes);
  auto stage = [&](int j) { return ring + (j % kStages) * kDkdvStageBytes; };
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int n_q = t_pad / kStreamRows;
  const int my_items = items_of_block(n_items);
  if (tid == 0) {
    bar.init();
    fence_proxy_async();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    setmaxnreg_dec<kProducerRegs>();
    if (tid == kProducerThread) {
      int j = 0;
      for (int n = 0; n < my_items; ++n) {
        const int item = item_of(n);
        const int bh = item / n_ktiles;
        const int k0 = (item - bh * n_ktiles) * kBlockRows;
        unsigned char* rb = res + (n & 1) * 2 * kBwdResBytes;
        acquire(bar.res_empty + (n & 1), n >> 1);
        mbar_expect_tx(bar.res_full + (n & 1), 2 * kBwdResBytes);
        load_tile<kBlockRows>(rb, km, k0, bh, bar.res_full + (n & 1));
        load_tile<kBlockRows>(rb + kBwdResBytes, vm, k0, bh, bar.res_full + (n & 1));
        for (int qt = 0; qt < n_q; ++qt, ++j) {
          uint64_t* full = bar.full + j % kStages;
          acquire(bar.empty + j % kStages, j / kStages);
          mbar_expect_tx(full, 2 * kBwdTileBytes + kStatBytes);
          load_tile<kStreamRows>(stage(j), qm, qt * kStreamRows, bh, full);
          load_tile<kStreamRows>(stage(j) + kBwdTileBytes, dom, qt * kStreamRows, bh, full);
          bulk_load(stage(j) + 2 * kBwdTileBytes, stats + static_cast<int64_t>(bh) * t_pad + qt * kStreamRows,
                    kStatBytes, full);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int wg = warp >> 2;
  const int lane = tid & 31;
  const int t = lane & 3;
  int j = 0;
  for (int n = 0; n < my_items; ++n) {
    const int item = item_of(n);
    const int bh = item / n_ktiles;
    const int k0 = (item - bh * n_ktiles) * kBlockRows;
    const unsigned char* rb = res + (n & 1) * 2 * kBwdResBytes;
    const Rows ka = rows_of<kBlockRows>(rb, wg);
    const Rows va = rows_of<kBlockRows>(rb + kBwdResBytes, wg);
    float dv0[32], dv1[4], dk0[32], dk1[4];
    zero(dv0);
    zero(dv1);
    zero(dk0);
    zero(dk1);
    float p[32], ds[32];  // p^T, dp^T then ds^T: this warpgroup's 64 keys x a tile's 64 queries (8i + 2t, +1)
    uint32_t pa[4][4], da[4][4];
    auto stats_of = [&](int jj) { return reinterpret_cast<const float2*>(stage(jj) + 2 * kBwdTileBytes); };
    auto issue_s_dp = [&](int jj) {  // s^T = k.q^T, dp^T = v.do^T of tile jj
      product_abt<kStreamRows>(p, ka, rows_of<kStreamRows>(stage(jj)));
      wgmma_commit();
      product_abt<kStreamRows>(ds, va, rows_of<kStreamRows>(stage(jj) + kBwdTileBytes));
      wgmma_commit();
    };
    auto exp_p = [&](int jj) {  // p^T = exp2(s^T c - lse2) of tile jj, and its bf16 fragments
      fence_regs(p);
      const float2* sts = stats_of(jj);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 q2 = *reinterpret_cast<const float4*>(sts + 8 * i + 2 * t);  // queries 8i + 2t, +1
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          p[4 * i + 2 * h] = exp2_ftz(fmaf(p[4 * i + 2 * h], c, -q2.x));
          p[4 * i + 2 * h + 1] = exp2_ftz(fmaf(p[4 * i + 2 * h + 1], c, -q2.z));
        }
      }
      to_a_frags(pa, p);
    };
    auto ds_frags = [&](int jj) {  // ds^T = p^T (dp^T - delta) of tile jj, as bf16 fragments
      fence_regs(ds);
      const float2* sts = stats_of(jj);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 q2 = *reinterpret_cast<const float4*>(sts + 8 * i + 2 * t);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          ds[4 * i + 2 * h] = p[4 * i + 2 * h] * (ds[4 * i + 2 * h] - q2.y);
          ds[4 * i + 2 * h + 1] = p[4 * i + 2 * h + 1] * (ds[4 * i + 2 * h + 1] - q2.w);
        }
      }
      to_a_frags(da, ds);
    };
    auto issue_dv = [&](int jj) {  // dv += p^T.do
      fence_regs(pa);
      fence_regs(dv0);
      fence_regs(dv1);
      wgmma_fence();
      product_pb<4>(dv0, dv1, pa, rows_of<kStreamRows>(stage(jj) + kBwdTileBytes));
      wgmma_commit();
    };
    auto retire = [&](int jj) {  // tile jj's dv and dk products are done
      fence_regs(dv0);
      fence_regs(dv1);
      fence_regs(dk0);
      fence_regs(dk1);
      fence_regs(pa);
      fence_regs(da);
      release(bar.empty + jj % kStages);
    };
    mbar_wait(bar.res_full + (n & 1), (n >> 1) & 1);
    mbar_wait(bar.full + j % kStages, (j / kStages) & 1);
    wgmma_fence();
    issue_s_dp(j);
    wgmma_wait<1>();
    exp_p(j);
    wgmma_wait<0>();
    // tile j's dv and dk products, then tile j + 1's two over d behind them; the
    // last tile's alone. Every product issued in an iteration is waited on in it.
    for (int qt = 1; qt < n_q; ++qt, ++j) {
      issue_dv(j);
      ds_frags(j);
      fence_regs(da);
      fence_regs(dk0);
      fence_regs(dk1);
      fence_regs(p);
      fence_regs(ds);
      mbar_wait(bar.full + (j + 1) % kStages, ((j + 1) / kStages) & 1);
      wgmma_fence();
      product_pb<4>(dk0, dk1, da, rows_of<kStreamRows>(stage(j)));  // dk += ds^T.q
      wgmma_commit();
      issue_s_dp(j + 1);
      wgmma_wait<2>();
      retire(j);
      wgmma_wait<1>();
      exp_p(j + 1);
      wgmma_wait<0>();
    }
    issue_dv(j);
    ds_frags(j);
    fence_regs(da);
    fence_regs(dk0);
    fence_regs(dk1);
    wgmma_fence();
    product_pb<4>(dk0, dk1, da, rows_of<kStreamRows>(stage(j)));
    wgmma_commit();
    wgmma_wait<0>();
    retire(j);
    ++j;
    release(bar.res_empty + (n & 1));

    const int r0 = k0 + 64 * wg + 16 * (warp & 3) + (lane >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row >= t_len) continue;
      const int64_t off = (static_cast<int64_t>(bh) * t_len + row) * kD;
      store_row(dk + off, dk0, dk1, h, t, scale);
      store_row(dv + off, dv0, dv1, h, t, 1.f);
    }
  }
}

// dq: a work item is (bh, 128 queries); keys stream 64 at a time.
template <int kStages>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_dq_wgmma_kernel(const __grid_constant__ PanelMaps qm, const __grid_constant__ PanelMaps km,
                              const __grid_constant__ PanelMaps vm, const __grid_constant__ PanelMaps dom,
                              const float2* __restrict__ stats, bf16* __restrict__ dq, int t_len, int t_pad,
                              int n_qtiles, int n_items, float c, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* res = align1024(smem_raw);  // [2][q tile, do tile], 128 rows
  unsigned char* ring = res + 4 * kBwdResBytes;  // [kStages][k tile, v tile], 64 rows
  Barriers<kStages>& bar = *reinterpret_cast<Barriers<kStages>*>(ring + kStages * kDqStageBytes);
  auto stage = [&](int j) { return ring + (j % kStages) * kDqStageBytes; };
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int n_k = (t_len + kStreamRows - 1) / kStreamRows;
  const int my_items = items_of_block(n_items);
  if (tid == 0) {
    bar.init();
    fence_proxy_async();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    setmaxnreg_dec<kProducerRegs>();
    if (tid == kProducerThread) {
      int j = 0;
      for (int n = 0; n < my_items; ++n) {
        const int item = item_of(n);
        const int bh = item / n_qtiles;
        const int q0 = (item - bh * n_qtiles) * kBlockRows;
        unsigned char* rb = res + (n & 1) * 2 * kBwdResBytes;
        acquire(bar.res_empty + (n & 1), n >> 1);
        mbar_expect_tx(bar.res_full + (n & 1), 2 * kBwdResBytes);
        load_tile<kBlockRows>(rb, qm, q0, bh, bar.res_full + (n & 1));
        load_tile<kBlockRows>(rb + kBwdResBytes, dom, q0, bh, bar.res_full + (n & 1));
        for (int kt = 0; kt < n_k; ++kt, ++j) {
          uint64_t* full = bar.full + j % kStages;
          acquire(bar.empty + j % kStages, j / kStages);
          mbar_expect_tx(full, kDqStageBytes);
          load_tile<kStreamRows>(stage(j), km, kt * kStreamRows, bh, full);
          load_tile<kStreamRows>(stage(j) + kBwdTileBytes, vm, kt * kStreamRows, bh, full);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int wg = warp >> 2;
  const int lane = tid & 31;
  const int t = lane & 3;
  int j = 0;
  for (int n = 0; n < my_items; ++n) {
    const int item = item_of(n);
    const int bh = item / n_qtiles;
    const int q0 = (item - bh * n_qtiles) * kBlockRows;
    const unsigned char* rb = res + (n & 1) * 2 * kBwdResBytes;
    const Rows qa = rows_of<kBlockRows>(rb, wg);
    const Rows doa = rows_of<kBlockRows>(rb + kBwdResBytes, wg);
    const int r0 = q0 + 64 * wg + 16 * (warp & 3) + (lane >> 2);
    float nlse[2], dlt[2];  // rows r0, r0 + 8 (past T: p = 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      const float2 st = row < t_len ? stats[static_cast<int64_t>(bh) * t_pad + row] : make_float2(INFINITY, 0.f);
      nlse[h] = -st.x;
      dlt[h] = st.y;
    }
    float dq0[32], dq1[4];
    zero(dq0);
    zero(dq1);
    float p[32], ds[32];  // p, dp then ds: this warpgroup's 64 queries x a tile's 64 keys
    uint32_t da[4][4];
    auto issue_s_dp = [&](int jj) {  // s = q.k^T, dp = do.v^T of tile jj
      product_abt<kStreamRows>(p, qa, rows_of<kStreamRows>(stage(jj)));
      wgmma_commit();
      product_abt<kStreamRows>(ds, doa, rows_of<kStreamRows>(stage(jj) + kBwdTileBytes));
      wgmma_commit();
    };
    auto exp_p = [&](int kt) {  // p = exp2(s c - lse2) of key tile kt; zero-filled keys past T get 0
      fence_regs(p);
      const int key0 = kt * kStreamRows;
      if (key0 + kStreamRows > t_len) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (key0 + 8 * i + 2 * t + (e & 1) >= t_len) p[4 * i + e] = -INFINITY;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) p[i] = exp2_ftz(fmaf(p[i], c, nlse[(i >> 1) & 1]));
    };
    auto ds_frags = [&]() {  // ds = p (dp - delta), as bf16 fragments
      fence_regs(ds);
#pragma unroll
      for (int i = 0; i < 32; ++i) ds[i] = p[i] * (ds[i] - dlt[(i >> 1) & 1]);
      to_a_frags(da, ds);
    };
    auto issue_dq = [&](int jj) {  // dq += ds.k
      fence_regs(da);
      fence_regs(dq0);
      fence_regs(dq1);
      fence_regs(p);
      fence_regs(ds);
      wgmma_fence();
      product_pb<4>(dq0, dq1, da, rows_of<kStreamRows>(stage(jj)));
      wgmma_commit();
    };
    auto retire = [&](int jj) {
      fence_regs(dq0);
      fence_regs(dq1);
      fence_regs(da);
      release(bar.empty + jj % kStages);
    };
    mbar_wait(bar.res_full + (n & 1), (n >> 1) & 1);
    mbar_wait(bar.full + j % kStages, (j / kStages) & 1);
    wgmma_fence();
    issue_s_dp(j);
    wgmma_wait<1>();
    exp_p(0);
    wgmma_wait<0>();
    ds_frags();
    // tile j's dq product, then tile j + 1's two over d behind it; the last
    // tile's alone. Every product issued in an iteration is waited on in it.
    for (int kt = 1; kt < n_k; ++kt, ++j) {
      mbar_wait(bar.full + (j + 1) % kStages, ((j + 1) / kStages) & 1);
      issue_dq(j);
      issue_s_dp(j + 1);
      wgmma_wait<2>();
      retire(j);
      wgmma_wait<1>();
      exp_p(kt);
      wgmma_wait<0>();
      ds_frags();
    }
    issue_dq(j);
    wgmma_wait<0>();
    retire(j);
    ++j;
    release(bar.res_empty + (n & 1));

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row < t_len) store_row(dq + (static_cast<int64_t>(bh) * t_len + row) * kD, dq0, dq1, h, t, scale);
    }
  }
}

// ---- launch --------------------------------------------------------------------

inline cudaError_t make_maps(PanelMaps* m, const void* x, int bh, int t_len) {
  const uint64_t dims[4] = {kD, static_cast<uint64_t>(t_len), static_cast<uint64_t>(bh), 1};
  cudaError_t err = make_map_4d(&m->p0, x, dims, {64, kBoxRows, 1, 1}, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess) err = make_map_4d(&m->p1, x, dims, {16, kBoxRows, 1, 1}, CU_TENSOR_MAP_SWIZZLE_32B);
  return err;
}

// Blocks for n_items work items: one an SM at most (persistent).
inline cudaError_t persistent_grid(int n_items, int* grid) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  *grid = n_items < sms ? n_items : sms;
  return err;
}

// o (and lse, if not null) of bf16 (BH, T, 72) q, k, v.
template <int kStages = kFwdStages>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int t_len,
                              float scale, cudaStream_t stream) {
  PanelMaps qm, km, vm;
  cudaError_t err = make_maps(&qm, q, bh, t_len);
  if (err == cudaSuccess) err = make_maps(&km, k, bh, t_len);
  if (err == cudaSuccess) err = make_maps(&vm, v, bh, t_len);
  if (err != cudaSuccess) return err;
  const int n_qtiles = (t_len + kBlockRows - 1) / kBlockRows;
  const int n_items = bh * n_qtiles;
  int grid = 0;
  err = persistent_grid(n_items, &grid);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(attention_fwd_wgmma_kernel<kStages>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kFwdSmem<kStages>);
  }
  if (err != cudaSuccess) return err;
  attention_fwd_wgmma_kernel<kStages><<<grid, kThreads, kFwdSmem<kStages>, stream>>>(qm, km, vm, static_cast<bf16*>(o), lse, t_len,
                                                                      n_qtiles, n_items, scale * kLog2e);
  return cudaGetLastError();
}

// dq, dk, dv of bf16 (BH, T, 72) q, k, v, do, given the prep pass's stats
// ((lse2, delta) for T_pad rows of each slice).
template <int kStages = kBwdStages>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout, const float2* stats,
                              void* dq, void* dk, void* dv, int bh, int t_len, int t_pad, float scale,
                              cudaStream_t stream) {
  PanelMaps qm, km, vm, dom;
  cudaError_t err = make_maps(&qm, q, bh, t_len);
  if (err == cudaSuccess) err = make_maps(&km, k, bh, t_len);
  if (err == cudaSuccess) err = make_maps(&vm, v, bh, t_len);
  if (err == cudaSuccess) err = make_maps(&dom, dout, bh, t_len);
  if (err != cudaSuccess) return err;
  const float c = scale * kLog2e;
  const int n_tiles = (t_len + kBlockRows - 1) / kBlockRows;
  const int n_items = bh * n_tiles;
  int grid = 0;
  err = persistent_grid(n_items, &grid);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(attention_bwd_dkdv_wgmma_kernel<kStages>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDkdvSmem<kStages>);
  }
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_wgmma_kernel<kStages><<<grid, kThreads, kDkdvSmem<kStages>, stream>>>(
      qm, km, vm, dom, stats, static_cast<bf16*>(dk), static_cast<bf16*>(dv), t_len, t_pad, n_tiles, n_items, c, scale);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(attention_bwd_dq_wgmma_kernel<kStages>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDqSmem<kStages>);
  }
  if (err != cudaSuccess) return err;
  attention_bwd_dq_wgmma_kernel<kStages><<<grid, kThreads, kDqSmem<kStages>, stream>>>(qm, km, vm, dom, stats, static_cast<bf16*>(dq),
                                                                        t_len, t_pad, n_tiles, n_items, c, scale);
  return cudaGetLastError();
}

}  // namespace s2s_attn_d72
