// K1-bwd: fused self-attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel stain2stain_tpu/ops/pallas_attention.py::_bwd_kernel
// (launched by ::_fused_attention_bwd). Same function: per (batch*head) slice,
// given q, k, v, the forward's output o and the cotangent do,
//     s = q . k^T * scale,  p = softmax(s) = exp(s - lse)
//     delta = rowsum(do * o)                      (o as stored, in q's dtype)
//     dv = p^T . do,  ds = p * (do . v^T - delta)
//     dq = ds . k * scale,  dk = ds^T . q * scale
// with f32 sums; dq, dk and dv are written once, in the inputs' dtype. Inputs
// are contiguous (BH, T, D) f32 or bf16; D is 16, 32 or 64, and 72 for bf16
// alone (the 3xTF32 passes take multiples of 16 only). The row
// log-sum-exp lse (natural log, f32 (BH, T)) comes from K1-fwd, or is
// recomputed here when the caller passes none.
//
// Bound on the H100 at the 256-px training shape (BH 512 = 16 heads x batch
// 32, T 1024, D 32: the mid block): 10*BH*T^2*D = 172 GFLOP of products
// (0.17 ms on bf16 tensor cores at 989 TFLOP/s, 2.6 ms of f32 work on the
// FP32 pipes at 67 TFLOP/s, 1.04 ms as 3xTF32 on the tensor cores at 494),
// BH*T^2 = 537 M exponentials (~0.13 ms on the MUFU units), and 8*BH*T*D
// elements of q/k/v/o/do/dq/dk/dv (0.27 GB in bf16, ~0.08 ms). So the products
// bound it. At the 512-px f32 training shape (BH 96 = 16 heads x batch 6,
// T 4096, D 32): 515 GFLOP, 7.7 ms on the FP32 pipes, 3.1 ms in 3xTF32.
//
// The TPU kernel walks the q blocks of one (batch*head) in order on one core
// and accumulates dk/dv in the output block across those steps; Hopper blocks
// run in no order, so the work is split into passes, deterministic and without
// atomics (the result repeats bit for bit):
//   1. prep: one block per (bh, 64 rows). delta = rowsum(do*o) and lse in log2
//      units (lse * log2 e) into an f32 (BH, T_pad, 2) scratch the wrapper
//      allocates, T_pad = T rounded up to 64; rows past T get (+inf, 0), so
//      their p is 0. Without a given lse (no main path: training hands K1-fwd's
//      over), bf16 recomputes it on the tensor cores (K1-fwd's online softmax
//      without p.v) and f32 on the FP32 pipes, one query row a thread.
//   2. dk/dv: one block per (bh, 64 keys).
//   3. dq: one block per (bh, 64 queries).
//
// bf16 at D 16, 32, 64 (attention_common.cuh; mma.sync.m16n8k16 bf16 -> f32
// throughout, 4 warps of 16 rows, 64-row tiles of the other operand streaming
// through padded shared memory by cp.async, double buffered):
//   2. each warp holds 16 keys' k and v fragments in registers and walks the
//      query tiles (q, do and their (lse, delta) rows staged):
//        s^T = k.q^T, p^T = exp2(s^T c - lse2), dv += p^T.do,
//        dp^T = v.do^T, ds^T = p^T (dp^T - delta), dk += ds^T.q;
//   3. each warp holds 16 queries' q and do fragments, walks the key tiles:
//        s = q.k^T, p = exp2(s c - lse2), dp = do.v^T, ds = p (dp - delta),
//        dq += ds.k.
//   p and ds are rounded to bf16 as the A operand of the next product. Seven
//   products against the bound's five (s and dp are computed in both passes):
//   14*BH*T^2*D, about 0.24 ms at the training shape, the price of no atomics
//   (SDPA's FlashAttention-2 backward adds dq with f32 atomics).
// bf16 at D 72 (the DiT's heads): the prep pass above, then passes 2 and 3 on
//   wgmma fed by TMA (attention_d72.cuh: persistent blocks of a producer
//   warpgroup and two consumer warpgroups of 64 keys or queries, 64-row q/do
//   or k/v tiles streaming through a three-stage mbarrier ring, the same seven
//   products and passes, no atomics). The mma.sync passes ran at about 220
//   TFLOP/s there (2.429 ms at (512, 1024, 72), slower than SDPA's backward);
//   D 16, 32 and 64 keep them, for the reasons K1-fwd gives.
// f32 (the f32 training path's kernel: trainer.precision 32, the default):
// the same two passes and products on the tensor cores in 3xTF32, mma.sync
// m16n8k8 tf32 -> f32 (mma_common.cuh). Every f32 operand x is split into
// big = tf32(x) and small = tf32(x - big), both rounded to nearest, ties away
// (cvt.rna's rounding, as integer operations), and a product a.b is summed as
// small_a.big_b + big_a.small_b + big_a.big_b in f32: the split leaves at most
// 2^-22 |x|, the dropped small.small term at most 2^-22 |ab|, so each product
// keeps close to f32 accuracy (2e-5 of max|ref| end to end; big.big alone, as
// 1xTF32, misses that). The tensor cores round each mma's sum toward zero,
// so the three products go into a fresh partial that an f32 add takes into
// the accumulator (mma3_tf32); one accumulator carried through the mma's
// drifts with T (2.5e-5 of max|ref| at T 4096). 21 tensor-core products a
// tile pair where bf16 runs 7: 722 GFLOP at the 256-px shape (1.46 ms at 494
// TFLOP/s) against 172 of f32 work on the FP32 pipes, whose rate is 7.4x
// less. The design:
//   * a warp walks each staged 64-row tile one 8-row column at a time: a
//     16 x 8 s (or s^T), p, dp and ds, each product's slices of D in turn,
//     then dv/dk (or dq) += over those 8 rows. Only one column's p and ds
//     are live beside the resident rows and the accumulators, and the
//     column loop is not unrolled, so the compiler's schedule stays within
//     the registers;
//   * resident rows (a warp's 16 keys' k and v in pass 2, 16 queries' q and
//     do in pass 3) are loaded once as f32 A fragments and split at each use
//     (half the registers of keeping both halves, and no slower: PERF.md);
//     p and ds are split as the A operand of the next product;
//   * staged operands (q and do in pass 2, k and v in pass 3) are split once
//     a tile, where they land: each thread splits the 16-byte chunks it
//     copied by cp.async, the big halves in place and the small ones into a
//     tile of their own, so the 4 warps that read a tile do not each split
//     it again (10 % faster than splitting at each read). At D 64, where the
//     fragments of both halves in flight would spill, a warp splits what it
//     reads (Tf32Layout::kSplitStaged);
//   * the A fragment of tf32 holds columns (t, t + 4) and the accumulator
//     (2t, 2t + 1): p and ds feed the next product as they sit, the
//     contraction index permuted instead (pb_tf32);
//   * staged rows are padded to D + 4 floats: ldmatrix reads the (row g,
//     column t) B fragments of q.k^T-type products, 8 rows in 8 distinct bank
//     groups, and the (row 2t, column g) B reads of p.B-type products fall in
//     32 distinct banks.
//
// Launches on the caller's stream, allocates nothing, and returns the first
// launch error (cudaGetLastError) so the Python wrapper can raise on it.

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_common.cuh"
#include "attention_d72.cuh"

namespace {

using namespace s2s_attn;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const bf16* p) { return __bfloat162float(*p); }

// ---- pass 1: delta and lse2 ------------------------------------------------

// lse_in: natural-log lse (BH, T) from K1-fwd, or null: bf16 recomputes it here.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_prep_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ o,
                          const T* __restrict__ dout, const float* __restrict__ lse_in, float2* __restrict__ stats,
                          int t_len, int t_pad, int n_tiles, float c) {
  const int bh = blockIdx.x / n_tiles;
  const int tile = blockIdx.x - bh * n_tiles;
  const int tid = threadIdx.x;
  const int64_t base = static_cast<int64_t>(bh) * t_len * D;
  float2* st = stats + static_cast<int64_t>(bh) * t_pad;

  {  // delta: two threads a row, half of D each
    const int row = tile * kTile + (tid >> 1);
    const int half = tid & 1;
    float dlt = 0.f;
    if (row < t_len) {
      const int64_t off = base + static_cast<int64_t>(row) * D + half * (D / 2);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dlt = fmaf(load_f32(dout + off + i), load_f32(o + off + i), dlt);
    }
    dlt += __shfl_xor_sync(0xffffffffu, dlt, 1);
    if (half == 0) {
      st[row].y = dlt;
      if (row >= t_len) {
        st[row].x = INFINITY;  // p = 0 for queries past T
      } else if (lse_in != nullptr) {
        st[row].x = lse_in[static_cast<int64_t>(bh) * t_len + row] * kLog2e;
      }
    }
  }

  if constexpr (std::is_same<T, bf16>::value) {
    if (lse_in == nullptr) {  // recompute lse on the tensor cores
      __shared__ __align__(16) bf16 ks[2 * kTileElems<D>];
      zero_pad<D>(ks, tid);
      const int lane = tid & 31;
      const int r0 = tile * kTile + (tid >> 5) * 16;
      uint32_t qa[kKSteps<D>][4];
      load_a_frags<D>(qa, q + base, r0, t_len, lane);
      float m[2] = {-INFINITY, -INFINITY};
      float l[2] = {0.f, 0.f};
      float unused[D / 8][4];
      softmax_rows<D, false>(k + base, nullptr, t_len, c, qa, ks, nullptr, m, l, unused);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float sum = quad_sum(l[h]);
        const int row = r0 + (lane >> 2) + 8 * h;
        if (row < t_len && (lane & 3) == 0) st[row].x = m[h] * c + log2f(sum);
      }
    }
  }
}

// f32 without a given lse: one query row a thread recomputes it (online max
// and sum over 16-key chunks, as K1-fwd's f32 kernel) with delta.
constexpr int kF32Rows = 64;   // rows (queries or keys) per block, one per thread
constexpr int kF32Keys = 64;   // keys staged in shared memory per step
constexpr int kChunk = 16;     // keys scored per online-softmax update

template <int D>
__device__ __forceinline__ float dot_row(const float* a, const float* smem_row) {
  const float4* r = reinterpret_cast<const float4*>(smem_row);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < D / 4; ++i) {
    const float4 x = r[i];
    acc = fmaf(a[4 * i + 0], x.x, acc);
    acc = fmaf(a[4 * i + 1], x.y, acc);
    acc = fmaf(a[4 * i + 2], x.z, acc);
    acc = fmaf(a[4 * i + 3], x.w, acc);
  }
  return acc;
}

// Stage rows [r0, r0 + n_rows) of a (T, D) f32 slice; rows past T are zero.
template <int D, int N_ROWS>
__device__ __forceinline__ void stage_rows(float (*dst)[D], const float* __restrict__ src, int64_t base, int r0,
                                           int t_len, int tid) {
  for (int idx = tid; idx < N_ROWS * D; idx += kF32Rows) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int row = r0 + r;
    dst[r][c] = row < t_len ? src[base + static_cast<int64_t>(row) * D + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Rows)
attention_bwd_stats_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ o, const float* __restrict__ dout,
                               float2* __restrict__ stats, int t_len, int t_pad, int n_tiles, float q_scale) {
  static_assert(D % 4 == 0, "head dim must be a multiple of 4");
  __shared__ __align__(16) float ks[kF32Keys][D];

  const int bh = blockIdx.x / n_tiles;
  const int tile = blockIdx.x - bh * n_tiles;
  const int tid = threadIdx.x;
  const int row = tile * kF32Rows + tid;
  const bool row_valid = row < t_len;
  const int64_t base = static_cast<int64_t>(bh) * t_len * D;
  const int64_t row_off = base + static_cast<int64_t>(row) * D;

  float qr[D];
  float dlt = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    qr[i] = row_valid ? q[row_off + i] * q_scale : 0.f;
    if (row_valid) dlt = fmaf(dout[row_off + i], o[row_off + i], dlt);
  }
  float m = -INFINITY;
  float l = 0.f;

  for (int j0 = 0; j0 < t_len; j0 += kF32Keys) {
    __syncthreads();  // the previous tile is fully consumed
    stage_rows<D, kF32Keys>(ks, k, base, j0, t_len, tid);
    __syncthreads();
    const int n_keys = min(kF32Keys, t_len - j0);
    for (int c0 = 0; c0 < n_keys; c0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        s[j] = (c0 + j < n_keys) ? dot_row<D>(qr, &ks[c0 + j][0]) : -INFINITY;
        cmax = fmaxf(cmax, s[j]);
      }
      // Key 0 is in the first chunk, so m_new is finite from the start and
      // exp2(-inf) = 0 clears the empty sum.
      const float m_new = fmaxf(m, cmax);
      l *= exp2f(m - m_new);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) l += exp2f(s[j] - m_new);
      m = m_new;
    }
  }
  stats[static_cast<int64_t>(bh) * t_pad + row] = row_valid ? make_float2(m + log2f(l), dlt)
                                                            : make_float2(INFINITY, 0.f);
}

// ---- bf16 passes 2 and 3: tensor cores ---------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                              const bf16* __restrict__ dout, const float2* __restrict__ stats,
                              bf16* __restrict__ dk, bf16* __restrict__ dv, int t_len, int t_pad, int n_tiles,
                              float c, float scale) {
  __shared__ __align__(16) bf16 qs[2 * kTileElems<D>];
  __shared__ __align__(16) bf16 dos[2 * kTileElems<D>];
  __shared__ __align__(16) float2 sts[2 * kTile];  // (lse2, delta) of each staged query

  const int bh = blockIdx.x / n_tiles;
  const int tile = blockIdx.x - bh * n_tiles;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int t = lane & 3;
  const int r0 = tile * kTile + (tid >> 5) * 16;  // this warp's keys
  const int64_t base = static_cast<int64_t>(bh) * t_len * D;
  const bf16* qb = q + base;
  const bf16* dob = dout + base;
  const float2* stb = stats + static_cast<int64_t>(bh) * t_pad;

  zero_pad<D>(qs, tid);  // both feed products over d (warp_abt)
  zero_pad<D>(dos, tid);
  uint32_t ka[kKSteps<D>][4], va[kKSteps<D>][4];
  load_a_frags<D>(ka, k + base, r0, t_len, lane);
  load_a_frags<D>(va, v + base, r0, t_len, lane);
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nt][e] = dv_acc[nt][e] = 0.f;

  // 64 (lse2, delta) pairs = 32 chunks of 16 bytes; T_pad rows always exist
  auto stage_stats = [&](float2* dst, int row0) {
    if (tid < kTile / 2) cp_async16(dst + 2 * tid, stb + row0 + 2 * tid, true);
  };
  const int n_q = (t_len + kTile - 1) / kTile;
  stage_tile<D>(qs, qb, 0, t_len, tid);
  stage_tile<D>(dos, dob, 0, t_len, tid);
  stage_stats(sts, 0);
  cp_async_commit();
  for (int i = 0; i < n_q; ++i) {
    const int cur = i & 1;
    if (i + 1 < n_q) {
      const int nxt = (cur ^ 1) * kTileElems<D>;
      stage_tile<D>(qs + nxt, qb, (i + 1) * kTile, t_len, tid);
      stage_tile<D>(dos + nxt, dob, (i + 1) * kTile, t_len, tid);
      stage_stats(sts + (cur ^ 1) * kTile, (i + 1) * kTile);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* qt = qs + cur * kTileElems<D>;
    const bf16* dot = dos + cur * kTileElems<D>;
    const float2* stt = sts + cur * kTile;

    float p[8][4];  // p^T: this warp's 16 keys x the tile's 64 queries
    warp_abt<D>(p, ka, qt, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float4 st = *reinterpret_cast<const float4*>(stt + 8 * nt + 2 * t);  // queries 2t, 2t + 1
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        p[nt][2 * h] = exp2f(fmaf(p[nt][2 * h], c, -st.x));
        p[nt][2 * h + 1] = exp2f(fmaf(p[nt][2 * h + 1], c, -st.z));
      }
    }
    warp_pb<D>(dv_acc, p, dot, lane);  // dv += p^T . do
    float ds[8][4];
    warp_abt<D>(ds, va, dot, lane);  // dp^T = v . do^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float4 st = *reinterpret_cast<const float4*>(stt + 8 * nt + 2 * t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ds[nt][2 * h] = p[nt][2 * h] * (ds[nt][2 * h] - st.y);
        ds[nt][2 * h + 1] = p[nt][2 * h + 1] * (ds[nt][2 * h + 1] - st.w);
      }
    }
    warp_pb<D>(dk_acc, ds, qt, lane);  // dk += ds^T . q
    __syncthreads();  // the tile is consumed before its buffer is refilled
  }

  const int g = lane >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row >= t_len) continue;
    const int64_t off = base + static_cast<int64_t>(row) * D + 2 * t;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * nt) =
          __floats2bfloat162_rn(dk_acc[nt][2 * h] * scale, dk_acc[nt][2 * h + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * nt) =
          __floats2bfloat162_rn(dv_acc[nt][2 * h], dv_acc[nt][2 * h + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                            const bf16* __restrict__ dout, const float2* __restrict__ stats,
                            bf16* __restrict__ dq, int t_len, int t_pad, int n_tiles, float c, float scale) {
  __shared__ __align__(16) bf16 ks[2 * kTileElems<D>];
  __shared__ __align__(16) bf16 vs[2 * kTileElems<D>];

  const int bh = blockIdx.x / n_tiles;
  const int tile = blockIdx.x - bh * n_tiles;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = tile * kTile + (tid >> 5) * 16;  // this warp's queries
  const int64_t base = static_cast<int64_t>(bh) * t_len * D;
  const bf16* kb = k + base;
  const bf16* vb = v + base;

  zero_pad<D>(ks, tid);  // both feed products over d (warp_abt)
  zero_pad<D>(vs, tid);
  uint32_t qa[kKSteps<D>][4], doa[kKSteps<D>][4];
  load_a_frags<D>(qa, q + base, r0, t_len, lane);
  load_a_frags<D>(doa, dout + base, r0, t_len, lane);
  float nlse[2], dlt[2];  // rows g and g + 8 (rows past T: lse2 = +inf, so p = 0)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float2 st = stats[static_cast<int64_t>(bh) * t_pad + r0 + g + 8 * h];
    nlse[h] = -st.x;
    dlt[h] = st.y;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  const int n_k = (t_len + kTile - 1) / kTile;
  stage_tile<D>(ks, kb, 0, t_len, tid);
  stage_tile<D>(vs, vb, 0, t_len, tid);
  cp_async_commit();
  for (int j = 0; j < n_k; ++j) {
    const int cur = (j & 1) * kTileElems<D>;
    if (j + 1 < n_k) {
      const int nxt = kTileElems<D> - cur;
      stage_tile<D>(ks + nxt, kb, (j + 1) * kTile, t_len, tid);
      stage_tile<D>(vs + nxt, vb, (j + 1) * kTile, t_len, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float p[8][4];
    warp_abt<D>(p, qa, ks + cur, lane);  // s = q . k^T
    const int key0 = j * kTile;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = key0 + 8 * nt + 2 * t + (e & 1) < t_len;  // zero-filled keys past T get p = 0
        p[nt][e] = valid ? exp2f(fmaf(p[nt][e], c, nlse[e >> 1])) : 0.f;
      }
    float ds[8][4];
    warp_abt<D>(ds, doa, vs + cur, lane);  // dp = do . v^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[nt][e] = p[nt][e] * (ds[nt][e] - dlt[e >> 1]);
    warp_pb<D>(acc, ds, ks + cur, lane);  // dq += ds . k
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row >= t_len) continue;
    bf16* out = dq + base + static_cast<int64_t>(row) * D + 2 * t;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * nt) =
          __floats2bfloat162_rn(acc[nt][2 * h] * scale, acc[nt][2 * h + 1] * scale);
    }
  }
}

// ---- f32 passes 2 and 3: tensor cores in 3xTF32 ------------------------------

// Shared-memory layout of an f32 pass, in floats, rows padded to D + 4: two
// staged operands (q and do in pass 2, k and v in pass 3), two 64-row tiles
// each (cp.async double buffering); at D 16 and 32 the tile in use holds
// its big halves in place and one more tile each its small halves
// (kSplitStaged); then pass 2's (lse2, delta) pairs of two query tiles. 31,
// 55 and 69 KB at D 16, 32, 64. At D 64 the staged tiles are split where a
// warp reads them instead (no small tiles): holding both halves' fragments
// in flight there leaves no registers to spare beside the accumulators
// (ptxas spilled).
template <int D>
struct Tf32Layout {
  static constexpr bool kSplitStaged = D <= 32;
  static constexpr int kRow = D + 4;
  static constexpr int kTileFloats = kTile * kRow;
  static constexpr int kX = 0;                    // q or k
  static constexpr int kY = 2 * kTileFloats;      // do or v
  static constexpr int kXSmall = 4 * kTileFloats;
  static constexpr int kYSmall = 5 * kTileFloats;
  static constexpr int kStats = (kSplitStaged ? 6 : 4) * kTileFloats;  // float2 x 2 tiles
  static constexpr int kBytes = 4 * (kStats + 2 * 2 * kTile);
};

// Start the cp.async copies of rows [row0, row0 + 64) of a contiguous (T, D)
// f32 slice into a padded tile; rows past T are zero-filled.
template <int D>
__device__ __forceinline__ void stage_f32(float* dst, const float* __restrict__ src, int row0, int t_len, int tid) {
  constexpr int kChunks = D / 4;  // 16-byte chunks of a row
  static_assert(kTile * kChunks % kThreads == 0, "every thread copies the same number of chunks");
#pragma unroll
  for (int it = 0; it < kTile * kChunks / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    const int row = row0 + r;
    const bool valid = row < t_len;
    cp_async16(dst + r * Tf32Layout<D>::kRow + 4 * c, src + static_cast<int64_t>(valid ? row : 0) * D + 4 * c,
               valid);
  }
}

// Split the chunks this thread copied into a staged tile (stage_f32, after
// cp_async_wait): the tile keeps the big halves, `small` gets the small ones.
// A thread sees its own copies after the wait, so no barrier is needed before.
template <int D>
__device__ __forceinline__ void split_staged(float* tile, float* small, int tid) {
  if constexpr (Tf32Layout<D>::kSplitStaged) {
    constexpr int kChunks = D / 4;
#pragma unroll
    for (int it = 0; it < kTile * kChunks / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / kChunks;
      const int off = r * Tf32Layout<D>::kRow + 4 * (i - r * kChunks);
      const float4 x = *reinterpret_cast<const float4*>(tile + off);
      uint4 big, sml;
      split_tf32(x.x, big.x, sml.x);
      split_tf32(x.y, big.y, sml.y);
      split_tf32(x.z, big.z, sml.z);
      split_tf32(x.w, big.w, sml.w);
      *reinterpret_cast<uint4*>(tile + off) = big;
      *reinterpret_cast<uint4*>(small + off) = sml;
    }
  }
}

// B fragments of two m16n8k8 products, big and small halves, from a staged
// tile: four 8 x 8 b16 matrices (8 rows x 4 floats each), whose ldmatrix
// layout is the tf32 fragment (row g, column t).
template <int D>
__device__ __forceinline__ void b_frags_x4(uint32_t (&big)[4], uint32_t (&small)[4], const float* tile_big,
                                           const float* tile_small, int off) {
  ldsm_x4(big, tile_big + off);
  if constexpr (Tf32Layout<D>::kSplitStaged) {
    ldsm_x4(small, tile_small + off);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(big[e]), big[e], small[e]);
  }
}

// One B element, big and small halves, from a staged tile.
template <int D>
__device__ __forceinline__ void b_elem(uint32_t& big, uint32_t& small, const float* tile_big,
                                       const float* tile_small, int off) {
  if constexpr (Tf32Layout<D>::kSplitStaged) {
    big = __float_as_uint(tile_big[off]);
    small = __float_as_uint(tile_small[off]);
  } else {
    split_tf32(tile_big[off], big, small);
  }
}

// The f32 A fragments of m16n8k8 (one 16 x 8 slice of D per entry: (row g,
// column t), (g + 8, t), (g, t + 4), (g + 8, t + 4)) of a warp's 16 resident
// rows [r0, r0 + 16) (k and v in pass 2, q and do in pass 3), read once from
// device memory; rows past T are 0. They stay f32 and are split at each use:
// half the registers of keeping both halves, and no slower.
template <int D>
__device__ __forceinline__ void load_a_f32(float (&a)[D / 8][4], const float* __restrict__ src, int r0, int t_len,
                                           int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    const float* p = src + static_cast<int64_t>(row) * D + t;
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      a[ks][h] = row < t_len ? __ldg(p + 8 * ks) : 0.f;          // column 8ks + t
      a[ks][h + 2] = row < t_len ? __ldg(p + 8 * ks + 4) : 0.f;  // column 8ks + t + 4
    }
  }
}

// 8-row n-tiles of a column: the staged rows a warp's step takes.
constexpr int kColTiles = 1;

// s (16 x 8NT) = A . B^T over D in 3xTF32: A a warp's resident rows, B the
// staged rows [n0, n0 + 8NT) of a tile, two slices of D per ldmatrix pair.
template <int D, int NT>
__device__ __forceinline__ void abt_tf32(float (&s)[NT][4], const float (&a)[D / 8][4], const float* big,
                                         const float* small, int n0, int lane) {
  static_assert(D % 16 == 0, "two slices of D per ldmatrix pair");
  const int lj = lane >> 3;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 8; ks += 2) {
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(a[ks + h][e], ab[h][e], as[h][e]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      // matrices {slice ks: columns 8ks..+3, 8ks+4..+7}, {slice ks + 1: the same}
      const int off = (n0 + 8 * n + (lane & 7)) * Tf32Layout<D>::kRow + 8 * (ks + (lj >> 1)) + 4 * (lj & 1);
      uint32_t fb[4], fs[4];
      b_frags_x4<D>(fb, fs, big, small, off);
#pragma unroll
      for (int h = 0; h < 2; ++h) mma3_tf32(s[n], ab[h], as[h], fb[2 * h], fb[2 * h + 1], fs[2 * h], fs[2 * h + 1]);
    }
  }
}

// acc (16 x D) += P . B over the staged rows [k0, k0 + 8NT) of a tile in
// 3xTF32, P (16 x 8NT) f32 accumulator tiles of abt_tf32. The tf32 A fragment
// holds columns (t, t + 4) where an accumulator tile holds (2t, 2t + 1), so
// the contraction index is permuted instead of the registers: A's column t
// is row 2t of B's 8 rows, column t + 4 row 2t + 1. With rows of D + 4
// floats, the 32 lanes' B reads (row 2t, column g) fall in 32 distinct banks.
template <int D, int NT>
__device__ __forceinline__ void pb_tf32(float (&acc)[D / 8][4], const float (&p)[NT][4], const float* big,
                                        const float* small, int k0, int lane) {
  constexpr int kRow = Tf32Layout<D>::kRow;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    uint32_t ab[4], as[4];
    split_tf32(p[n][0], ab[0], as[0]);  // (row g, column 2t)
    split_tf32(p[n][2], ab[1], as[1]);  // (row g + 8, column 2t)
    split_tf32(p[n][1], ab[2], as[2]);  // (row g, column 2t + 1)
    split_tf32(p[n][3], ab[3], as[3]);  // (row g + 8, column 2t + 1)
    const int off = (k0 + 8 * n + 2 * t) * kRow + g;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      uint32_t bb0, bb1, bs0, bs1;
      b_elem<D>(bb0, bs0, big, small, off + 8 * dn);
      b_elem<D>(bb1, bs1, big, small, off + kRow + 8 * dn);
      mma3_tf32(acc[dn], ab, as, bb0, bb1, bs0, bs1);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                               const float* __restrict__ dout, const float2* __restrict__ stats,
                               float* __restrict__ dk, float* __restrict__ dv, int t_len, int t_pad, int n_tiles,
                               float c, float scale) {
  using L = Tf32Layout<D>;
  extern __shared__ __align__(16) float smem[];
  float2* sts = reinterpret_cast<float2*>(smem + L::kStats);

  const int bh = blockIdx.x / n_tiles;
  const int tile = blockIdx.x - bh * n_tiles;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int t = lane & 3;
  const int r0 = tile * kTile + (tid >> 5) * 16;  // this warp's keys
  const int64_t base = static_cast<int64_t>(bh) * t_len * D;
  const float* qb = q + base;
  const float* dob = dout + base;
  const float2* stb = stats + static_cast<int64_t>(bh) * t_pad;

  float ka[D / 8][4], va[D / 8][4];
  load_a_f32<D>(ka, k + base, r0, t_len, lane);
  load_a_f32<D>(va, v + base, r0, t_len, lane);
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nt][e] = dv_acc[nt][e] = 0.f;

  // 64 (lse2, delta) pairs = 32 chunks of 16 bytes; T_pad rows always exist
  auto stage_stats = [&](float2* dst, int row0) {
    if (tid < kTile / 2) cp_async16(dst + 2 * tid, stb + row0 + 2 * tid, true);
  };
  const int n_q = (t_len + kTile - 1) / kTile;
  stage_f32<D>(smem + L::kX, qb, 0, t_len, tid);
  stage_f32<D>(smem + L::kY, dob, 0, t_len, tid);
  stage_stats(sts, 0);
  cp_async_commit();
  for (int i = 0; i < n_q; ++i) {
    const int cur = i & 1;
    if (i + 1 < n_q) {
      const int nxt = (cur ^ 1) * L::kTileFloats;
      stage_f32<D>(smem + L::kX + nxt, qb, (i + 1) * kTile, t_len, tid);
      stage_f32<D>(smem + L::kY + nxt, dob, (i + 1) * kTile, t_len, tid);
      stage_stats(sts + (cur ^ 1) * kTile, (i + 1) * kTile);
    }
    cp_async_commit();
    cp_async_wait<1>();
    float* qt = smem + L::kX + cur * L::kTileFloats;
    float* dot = smem + L::kY + cur * L::kTileFloats;
    const float* qs = smem + L::kXSmall;
    const float* dos = smem + L::kYSmall;
    split_staged<D>(qt, smem + L::kXSmall, tid);
    split_staged<D>(dot, smem + L::kYSmall, tid);
    __syncthreads();  // every thread's split (and stats) landed
    const float2* stt = sts + cur * kTile;

    // one column of 8 queries of the tile at a time: the live registers stay
    // those of one 16 x 8 p and ds beside the resident rows and the accumulators
#pragma unroll 1
    for (int q0 = 0; q0 < kTile; q0 += 8 * kColTiles) {
      float p[kColTiles][4];  // p^T: this warp's 16 keys x the column's queries
      abt_tf32<D, kColTiles>(p, ka, qt, qs, q0, lane);  // s^T = k . q^T
#pragma unroll
      for (int n = 0; n < kColTiles; ++n) {
        const float4 st = *reinterpret_cast<const float4*>(stt + q0 + 8 * n + 2 * t);  // queries 2t, 2t + 1
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          p[n][2 * h] = exp2f(fmaf(p[n][2 * h], c, -st.x));
          p[n][2 * h + 1] = exp2f(fmaf(p[n][2 * h + 1], c, -st.z));
        }
      }
      pb_tf32<D, kColTiles>(dv_acc, p, dot, dos, q0, lane);  // dv += p^T . do
      float ds[kColTiles][4];
      abt_tf32<D, kColTiles>(ds, va, dot, dos, q0, lane);  // dp^T = v . do^T
#pragma unroll
      for (int n = 0; n < kColTiles; ++n) {
        const float4 st = *reinterpret_cast<const float4*>(stt + q0 + 8 * n + 2 * t);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          ds[n][2 * h] = p[n][2 * h] * (ds[n][2 * h] - st.y);
          ds[n][2 * h + 1] = p[n][2 * h + 1] * (ds[n][2 * h + 1] - st.w);
        }
      }
      pb_tf32<D, kColTiles>(dk_acc, ds, qt, qs, q0, lane);  // dk += ds^T . q
    }
    __syncthreads();  // the tile and the small halves are consumed before they are refilled
  }

  const int g = lane >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row >= t_len) continue;
    const int64_t off = base + static_cast<int64_t>(row) * D + 2 * t;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      *reinterpret_cast<float2*>(dk + off + 8 * nt) =
          make_float2(dk_acc[nt][2 * h] * scale, dk_acc[nt][2 * h + 1] * scale);
      *reinterpret_cast<float2*>(dv + off + 8 * nt) = make_float2(dv_acc[nt][2 * h], dv_acc[nt][2 * h + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                             const float* __restrict__ dout, const float2* __restrict__ stats,
                             float* __restrict__ dq, int t_len, int t_pad, int n_tiles, float c, float scale) {
  using L = Tf32Layout<D>;
  extern __shared__ __align__(16) float smem[];

  const int bh = blockIdx.x / n_tiles;
  const int tile = blockIdx.x - bh * n_tiles;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = tile * kTile + (tid >> 5) * 16;  // this warp's queries
  const int64_t base = static_cast<int64_t>(bh) * t_len * D;
  const float* kb = k + base;
  const float* vb = v + base;

  float qa[D / 8][4], doa[D / 8][4];
  load_a_f32<D>(qa, q + base, r0, t_len, lane);
  load_a_f32<D>(doa, dout + base, r0, t_len, lane);
  float nlse[2], dlt[2];  // rows g and g + 8 (rows past T: lse2 = +inf, so p = 0)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float2 st = stats[static_cast<int64_t>(bh) * t_pad + r0 + g + 8 * h];
    nlse[h] = -st.x;
    dlt[h] = st.y;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  const int n_k = (t_len + kTile - 1) / kTile;
  stage_f32<D>(smem + L::kX, kb, 0, t_len, tid);
  stage_f32<D>(smem + L::kY, vb, 0, t_len, tid);
  cp_async_commit();
  for (int j = 0; j < n_k; ++j) {
    const int cur = (j & 1) * L::kTileFloats;
    if (j + 1 < n_k) {
      const int nxt = L::kTileFloats - cur;
      stage_f32<D>(smem + L::kX + nxt, kb, (j + 1) * kTile, t_len, tid);
      stage_f32<D>(smem + L::kY + nxt, vb, (j + 1) * kTile, t_len, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    float* kt = smem + L::kX + cur;
    float* vt = smem + L::kY + cur;
    const float* ks = smem + L::kXSmall;
    const float* vs = smem + L::kYSmall;
    split_staged<D>(kt, smem + L::kXSmall, tid);
    split_staged<D>(vt, smem + L::kYSmall, tid);
    __syncthreads();

    // one column of 8 keys of the tile at a time
#pragma unroll 1
    for (int k0 = 0; k0 < kTile; k0 += 8 * kColTiles) {
      float p[kColTiles][4];
      abt_tf32<D, kColTiles>(p, qa, kt, ks, k0, lane);  // s = q . k^T
      float ds[kColTiles][4];
      abt_tf32<D, kColTiles>(ds, doa, vt, vs, k0, lane);  // dp = do . v^T
#pragma unroll
      for (int n = 0; n < kColTiles; ++n) {
        const int key = j * kTile + k0 + 8 * n + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // zero-filled keys past T get p = 0
          const float pe = key + (e & 1) < t_len ? exp2f(fmaf(p[n][e], c, nlse[e >> 1])) : 0.f;
          ds[n][e] = pe * (ds[n][e] - dlt[e >> 1]);
        }
      }
      pb_tf32<D, kColTiles>(acc, ds, kt, ks, k0, lane);  // dq += ds . k
    }
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row >= t_len) continue;
    float* out = dq + base + static_cast<int64_t>(row) * D + 2 * t;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<float2*>(out + 8 * nt) = make_float2(acc[nt][2 * h] * scale, acc[nt][2 * h + 1] * scale);
  }
}

// ---- launch ------------------------------------------------------------------

template <int D>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout, const float* lse,
                bf16* dq, bf16* dk, bf16* dv, float2* stats, int bh, int t_len, int t_pad, float scale,
                cudaStream_t stream) {
  const float c = scale * kLog2e;
  const int n_tiles = t_pad / kTile;
  const unsigned grid = static_cast<unsigned>(bh) * n_tiles;
  attention_bwd_prep_kernel<bf16, D><<<grid, kThreads, 0, stream>>>(q, k, o, dout, lse, stats, t_len, t_pad,
                                                                     n_tiles, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkdv_mma_kernel<D><<<grid, kThreads, 0, stream>>>(q, k, v, dout, stats, dk, dv, t_len, t_pad,
                                                                  n_tiles, c, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dq_mma_kernel<D><<<grid, kThreads, 0, stream>>>(q, k, v, dout, stats, dq, t_len, t_pad, n_tiles,
                                                                c, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const float* q, const float* k, const float* v, const float* o, const float* dout, const float* lse,
               float* dq, float* dk, float* dv, float2* stats, int bh, int t_len, int t_pad, float scale,
               cudaStream_t stream) {
  static_assert(kF32Rows == kTile, "one grid for every pass");
  const float c = scale * kLog2e;  // softmax via exp2
  const int n_tiles = t_pad / kTile;
  const unsigned grid = static_cast<unsigned>(bh) * n_tiles;
  if (lse != nullptr) {
    attention_bwd_prep_kernel<float, D><<<grid, kThreads, 0, stream>>>(q, k, o, dout, lse, stats, t_len, t_pad,
                                                                       n_tiles, c);
  } else {
    attention_bwd_stats_f32_kernel<D><<<grid, kF32Rows, 0, stream>>>(q, k, o, dout, stats, t_len, t_pad, n_tiles, c);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int bytes = Tf32Layout<D>::kBytes;
  err = cudaFuncSetAttribute(attention_bwd_dkdv_tf32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkdv_tf32_kernel<D><<<grid, kThreads, bytes, stream>>>(q, k, v, dout, stats, dk, dv, t_len, t_pad,
                                                                       n_tiles, c, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attention_bwd_dq_tf32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dq_tf32_kernel<D><<<grid, kThreads, bytes, stream>>>(q, k, v, dout, stats, dq, t_len, t_pad,
                                                                     n_tiles, c, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
           void* dq, void* dk, void* dv, float2* stats, int bh, int t_len, int t_pad, bool bf16_in, float scale,
           cudaStream_t stream) {
  if (bf16_in) {
    return launch_bf16<D>(static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                          static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse,
                          static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), stats, bh,
                          t_len, t_pad, scale, stream);
  }
  return launch_f32<D>(static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
                       static_cast<const float*>(o), static_cast<const float*>(dout), lse,
                       static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), stats, bh, t_len,
                       t_pad, scale, stream);
}

// bf16 at head dim 72: the prep pass, then the dk/dv and dq passes of attention_d72.cuh.
int launch_d72(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout, const float* lse,
               void* dq, void* dk, void* dv, float2* stats, int bh, int t_len, int t_pad, float scale,
               cudaStream_t stream) {
  const int n_tiles = t_pad / kTile;
  attention_bwd_prep_kernel<bf16, 72><<<static_cast<unsigned>(bh) * n_tiles, kThreads, 0, stream>>>(
      q, k, o, dout, lse, stats, t_len, t_pad, n_tiles, scale * kLog2e);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(s2s_attn_d72::launch_bwd(q, k, v, dout, stats, dq, dk, dv, bh, t_len, t_pad, scale, stream));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse: natural-log (BH, T) f32 from K1-fwd,
// or null to recompute it. stats: f32 (BH, T_pad, 2) scratch, T_pad = T
// rounded up to 64. bf16 rows must start 16-byte aligned (contiguous tensors
// do). Returns a cudaError_t (0 = success).
extern "C" int s2s_attention_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                 const void* lse, void* dq, void* dk, void* dv, void* stats, int bh, int t_len,
                                 int d, int dtype, float scale, void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (bh <= 0 || t_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int t_pad = (t_len + kTile - 1) / kTile * kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(lse);
  float2* sp = static_cast<float2*>(stats);
  const bool bf = dtype == 1;
  switch (d) {
    case 16:
      return launch<16>(q, k, v, o, dout, lp, dq, dk, dv, sp, bh, t_len, t_pad, bf, scale, s);
    case 32:
      return launch<32>(q, k, v, o, dout, lp, dq, dk, dv, sp, bh, t_len, t_pad, bf, scale, s);
    case 64:
      return launch<64>(q, k, v, o, dout, lp, dq, dk, dv, sp, bh, t_len, t_pad, bf, scale, s);
    case 72:  // bf16 alone, on its own route
      if (!bf) return static_cast<int>(cudaErrorInvalidValue);
      return launch_d72(static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                        static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lp, dq, dk, dv, sp, bh, t_len,
                        t_pad, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
