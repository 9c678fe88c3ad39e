// K1-fwd: fused self-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel stain2stain_tpu/ops/pallas_attention.py::_fwd_kernel
// (launched by ::_fwd). Same function: per (batch*head) slice,
//     o = softmax(q . k^T * scale) . v
// with the logits, the row max and the row sum in f32 and the p.v sum in f32,
// output in q's dtype; the (T, T) logits never reach device memory. Inputs are
// contiguous (BH, T, D) f32 or bf16 tensors; D is 16, 32 or 64, and 72 for
// bf16 alone (DiT-XL/2's heads; the f32 kernel's register tiling takes
// multiples of 16 only). Optionally
// also each row's log-sum-exp of the scaled logits, f32 (BH, T), which K1-bwd
// takes instead of recomputing it (the JAX VJP recomputes it only because lane
// padding made such arrays 128x larger on the TPU, pallas_attention.py:22-27).
//
// Bound on the H100 at the 256-px serving shape (BH 256, T 1024, D 32, one
// tile batch of 16 through the mid block): 4*BH*T^2*D = 34.4 GFLOP of products
// (about 35 us at 989 TFLOP/s on bf16 tensor cores), BH*T^2 = 268 M
// exponentials (about 65-70 us on the MUFU units, 132 SMs x 16/clk), and 67 MB
// of bf16 q/k/v/o (about 20 us at 3.35 TB/s). So with bf16 tensor cores the
// exponential sets the bound, not the products or the bytes. For f32 inputs,
// which keep f32 products, the 67 TFLOP/s of the FP32 pipes set it: 0.513 ms
// (134 MB of f32 q/k/v/o take 0.040 ms, the exponentials 0.064 ms).
//
// bf16 design (attention_common.cuh; FlashAttention-2's shape): one block of 4
// warps per (bh, 64-query tile), each warp 16 query rows whose q fragments load
// once into registers; 64-key k and v tiles stream through padded shared
// memory by cp.async, double buffered; s = q.k^T on mma.sync.m16n8k16 bf16 ->
// f32 (products of bf16 values are exact, so s differs from f32 logits only in
// summation order); the online softmax stays in registers (row max and sum over
// the quad by shuffles, exp2 with scale*log2(e) folded into one FFMA, the
// accumulator rescaled per tile); p is rounded to bf16 in registers and is
// the A operand of p.v, v read by ldmatrix.trans. Keys past T score -inf; rows
// past T compute but do not store.
//
// bf16 at D 72 (the DiT's heads, 28 calls a training step) takes a route of its
// own, attention_d72.cuh: wgmma fed by TMA through a three-stage mbarrier ring,
// a producer warpgroup and two consumer warpgroups of 64 query rows, d in a
// 64-column and an 8-column panel (the source note there has the design).
// mma.sync cannot reach the tensor cores' full rate on this card, and at D 72
// the mma.sync kernel ran at 22 % of its bound (0.706 ms at (512, 1024, 72),
// slower than SDPA). D 16, 32 and 64 stay on mma.sync: the flagship's K1 at
// D 32 is about 0.1 % of its training step, so no cell could show a gain from
// moving it, and its results are pinned bit for bit.
//
// f32 design (the serving path's kernel; FlashAttention-2's shape on the FP32
// pipes: f32 serving keeps f32 products, its tolerance is 5e-5, so no TF32).
// Its bound is the FP32 FMA rate, 0.513 ms at the serving shape. What keeps a
// SIMT attention from it is shared-memory traffic per FFMA (one thread per
// query row reads one broadcast float4 per 4 FFMAs: a third of the bound on
// the H100). So both products are register-tiled:
//   * a block of 128 threads: thread (g, j), g = tid/8 its row group, j its
//     lane in the group; a group owns R query rows, R = 8 at D 16 and 32
//     (128-row blocks) and 4 at D 64 (64-row blocks), where 8 rows' scores
//     and accumulators would not fit the registers;
//   * q, pre-scaled by scale*log2(e), is staged once into shared memory; the
//     64-key k and v tiles stream in by 16-byte cp.async, double buffered.
//     Staged rows are padded to D + 4 floats, so the 8 rows that a quarter
//     warp reads at one column fall in 8 distinct 4-bank groups, and q's rows
//     are stored permuted (q_slot) so that a warp's 4 row groups read 4
//     consecutive rows too;
//   * s = q.k^T: a thread owns R rows x 8 keys (keys j + 8i, interleaved for
//     the banks); per 4 columns of d it reads R q and 8 k float4s for 32R
//     FFMAs (256 per 16 reads at R 8); the loop is unrolled by 2, not fully,
//     which is faster (254 registers at D 32, 168 at D 64);
//   * the online softmax: the row max over the 8 lanes of a group by shuffles,
//     one exp2 per score, the accumulator rescaled once per tile; each lane
//     keeps its share of the row sum, added across the group at the end;
//   * p.v: p goes to shared memory transposed (key-major, rows of R*16 + 4
//     floats), and a thread owns its R rows x D/8 columns of the output: per
//     key R/4 p float4s and D/32 v float4s (a float2 at D 16). A group's p^T
//     rows are written and read by its own lanes, one warp, so a __syncwarp
//     orders them: one block barrier per tile.
// Shared memory is 63, 87 and 102 KB at D 16, 32, 64 (2 blocks an SM).
// Measured choices against the alternatives are in PERF.md (PR 6). Keys past
// T are zero-filled and score -inf; rows past T are zero and not stored.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "attention_d72.cuh"

namespace {

using namespace s2s_attn;

// ---- bf16: tensor cores ----------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
attention_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                         bf16* __restrict__ o, float* __restrict__ lse, int t_len, int n_qtiles, float c) {
  __shared__ __align__(16) bf16 ks[2 * kTileElems<D>];
  __shared__ __align__(16) bf16 vs[2 * kTileElems<D>];

  const int bh = blockIdx.x / n_qtiles;
  const int qtile = blockIdx.x - bh * n_qtiles;
  const int lane = threadIdx.x & 31;
  const int r0 = qtile * kTile + (threadIdx.x >> 5) * 16;
  const int64_t base = static_cast<int64_t>(bh) * t_len * D;

  zero_pad<D>(ks, threadIdx.x);  // before softmax_rows' first barrier
  uint32_t qa[kKSteps<D>][4];
  load_a_frags<D>(qa, q + base, r0, t_len, lane);
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  softmax_rows<D, true>(k + base, v + base, t_len, c, qa, ks, vs, m, l, acc);

  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float sum = quad_sum(l[h]);
    const int row = r0 + g + 8 * h;
    if (row >= t_len) continue;
    const float inv = 1.f / sum;
    bf16* out = o + base + static_cast<int64_t>(row) * D + 2 * t;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * nt) =
          __floats2bfloat162_rn(acc[nt][2 * h] * inv, acc[nt][2 * h + 1] * inv);
    }
    if (lse != nullptr && t == 0) lse[static_cast<int64_t>(bh) * t_len + row] = (m[h] * c + log2f(sum)) * kLn2;
  }
}

// ---- f32: FP32 pipes, register-tiled ---------------------------------------

constexpr int kF32Threads = 128;  // 16 row groups x 8 lanes
constexpr int kF32Pad = 4;        // floats of padding after each staged row

// Query rows of a thread: 8 (a 128-row block) at D 16 and 32; 4 (64 rows) at
// D 64, where 8 rows' accumulators and scores would not fit the registers.
template <int D>
constexpr int kF32RowsPerThread = D == 64 ? 4 : 8;
template <int D>
constexpr int kF32BlockRows = 16 * kF32RowsPerThread<D>;

// Shared-memory row of the block's query row r: row group g's rows R*g + i
// are stored at i*16 + g, so the 4 row groups of a warp, reading their i-th
// rows at once, read 4 consecutive padded rows (distinct banks).
template <int D>
__device__ __forceinline__ int q_slot(int r) {
  constexpr int R = kF32RowsPerThread<D>;
  return (r % R) * 16 + r / R;
}

// Shared-memory layout of the f32 kernel, in floats: q (the block's rows), k
// and v (two 64-row tiles each), rows of D + 4; then p^T (64 keys x the
// block's rows + 4).
template <int D>
struct F32Layout {
  static constexpr int kRow = D + kF32Pad;
  static constexpr int kPRow = kF32BlockRows<D> + kF32Pad;
  static constexpr int kTileFloats = kTile * kRow;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kF32BlockRows<D> * kRow;
  static constexpr int kV = kK + 2 * kTileFloats;
  static constexpr int kP = kV + 2 * kTileFloats;
  static constexpr int kBytes = 4 * (kP + kTile * kPRow);
};

// Start the cp.async copies of rows [row0, row0 + 64) of a contiguous (T, D)
// f32 slice into a padded tile; rows past T are zero-filled.
template <int D>
__device__ __forceinline__ void stage_f32(float* dst, const float* __restrict__ src, int row0, int t_len, int tid) {
  constexpr int kChunks = D / 4;  // 16-byte chunks of a row
  static_assert(kTile * kChunks % kF32Threads == 0, "every thread copies the same number of chunks");
#pragma unroll
  for (int it = 0; it < kTile * kChunks / kF32Threads; ++it) {
    const int i = tid + it * kF32Threads;
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    const int row = row0 + r;
    const bool valid = row < t_len;
    cp_async16(dst + r * F32Layout<D>::kRow + 4 * c, src + static_cast<int64_t>(valid ? row : 0) * D + 4 * c, valid);
  }
}

// Column e (of D / 8) of lane j's share of a p.v output row: float4 groups
// 32h + 4j (D 32, 64) or the pair 2j (D 16), so a quarter warp's 8 lanes read
// 128 (64) contiguous bytes of a v row.
template <int D>
__device__ __forceinline__ int out_col(int j, int e) {
  if constexpr (D == 16) {
    return 2 * j + e;
  } else {
    return 32 * (e / 4) + 4 * j + (e % 4);
  }
}

template <int D>
__device__ __forceinline__ void load_cols(float (&dst)[D / 8], const float* row, int j) {
  if constexpr (D == 16) {
    const float2 t = *reinterpret_cast<const float2*>(row + 2 * j);
    dst[0] = t.x, dst[1] = t.y;
  } else {
#pragma unroll
    for (int h = 0; h < D / 32; ++h) {
      const float4 t = *reinterpret_cast<const float4*>(row + 32 * h + 4 * j);
      dst[4 * h] = t.x, dst[4 * h + 1] = t.y, dst[4 * h + 2] = t.z, dst[4 * h + 3] = t.w;
    }
  }
}

__device__ __forceinline__ float group8_max(float x) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group8_sum(float x) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, 2)
attention_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                         float* __restrict__ o, float* __restrict__ lse, int t_len, int n_qtiles, float c) {
  static_assert(D % 16 == 0 && D <= 64, "head dim 16, 32 or 64");
  using L = F32Layout<D>;
  constexpr int R = kF32RowsPerThread<D>;
  constexpr int kRows = kF32BlockRows<D>;
  constexpr int kCols = D / 8;  // output columns of a thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem + L::kQ;
  float* pt = smem + L::kP;  // p^T: pt[key * kPRow + row]

  const int bh = blockIdx.x / n_qtiles;
  const int qtile = blockIdx.x - bh * n_qtiles;
  const int tid = threadIdx.x;
  const int g = tid >> 3;  // rows R*g .. R*g + R-1 of the block
  const int j = tid & 7;   // keys j + 8i of s; output columns out_col(j, .)
  const int q0 = qtile * kRows;
  const int64_t base = static_cast<int64_t>(bh) * t_len * D;
  const int n_tiles = (t_len + kTile - 1) / kTile;

  stage_f32<D>(smem + L::kK, k + base, 0, t_len, tid);
  stage_f32<D>(smem + L::kV, v + base, 0, t_len, tid);
  cp_async_commit();
  // q, pre-scaled by scale*log2(e) so that a score is a log2 weight; rows past T are 0
#pragma unroll
  for (int it = 0; it < kRows * (D / 4) / kF32Threads; ++it) {
    const int i = tid + it * kF32Threads;
    const int r = i / (D / 4);
    const int col = 4 * (i - r * (D / 4));
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < t_len) val = __ldg(reinterpret_cast<const float4*>(q + base + static_cast<int64_t>(q0 + r) * D + col));
    val.x *= c, val.y *= c, val.z *= c, val.w *= c;
    *reinterpret_cast<float4*>(qs + q_slot<D>(r) * L::kRow + col) = val;
  }

  float m[R], l[R], acc[R][kCols];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;  // running max of the row's scores (log2 units)
    l[r] = 0.f;        // this lane's share of the row's sum of exp2(s - m)
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[r][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int cur = (t & 1) * L::kTileFloats;
    cp_async_wait<0>();  // tile t has landed (this thread's copies) ...
    __syncthreads();     // ... and every thread's; tile t - 1 is consumed everywhere
    if (t + 1 < n_tiles) {  // into the buffers tile t - 1 used
      stage_f32<D>(smem + L::kK + L::kTileFloats - cur, k + base, (t + 1) * kTile, t_len, tid);
      stage_f32<D>(smem + L::kV + L::kTileFloats - cur, v + base, (t + 1) * kTile, t_len, tid);
    }
    cp_async_commit();

    // s = q . k^T for rows R*g + r, keys j + 8i
    const float* kt = smem + L::kK + cur;
    float s[R][8];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < 8; ++i) s[r][i] = 0.f;
#pragma unroll 2
    for (int col = 0; col < D; col += 4) {
      float4 qv[R], kv[8];
#pragma unroll
      for (int r = 0; r < R; ++r) qv[r] = *reinterpret_cast<const float4*>(qs + (r * 16 + g) * L::kRow + col);
#pragma unroll
      for (int i = 0; i < 8; ++i) kv[i] = *reinterpret_cast<const float4*>(kt + (j + 8 * i) * L::kRow + col);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s[r][i] = fmaf(qv[r].x, kv[i].x, s[r][i]);
          s[r][i] = fmaf(qv[r].y, kv[i].y, s[r][i]);
          s[r][i] = fmaf(qv[r].z, kv[i].z, s[r][i]);
          s[r][i] = fmaf(qv[r].w, kv[i].w, s[r][i]);
        }
    }
    const int key0 = t * kTile;
    if (key0 + kTile > t_len) {  // keys past T score -inf
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (key0 + j + 8 * i >= t_len)
#pragma unroll
          for (int r = 0; r < R; ++r) s[r][i] = -INFINITY;
    }

    // online softmax; key0 < T, so lane 0 of every group holds a finite score
    // and m_new is finite; at t = 0, alpha = exp2(-inf) = 0 clears the empty sums
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mx = s[r][0];
#pragma unroll
      for (int i = 1; i < 8; ++i) mx = fmaxf(mx, s[r][i]);
      const float m_new = fmaxf(m[r], group8_max(mx));
      const float alpha = exp2f(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s[r][i] = exp2f(s[r][i] - m_new);
        sum += s[r][i];
      }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int e = 0; e < kCols; ++e) acc[r][e] *= alpha;
      m[r] = m_new;
    }

#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < R / 4; ++h)
        *reinterpret_cast<float4*>(pt + (j + 8 * i) * L::kPRow + R * g + 4 * h) =
            make_float4(s[4 * h][i], s[4 * h + 1][i], s[4 * h + 2][i], s[4 * h + 3][i]);
    // p^T complete for this row group: its rows are written and read by the
    // group's own 8 lanes, which lie in one warp
    __syncwarp();

    // acc += p . v for rows R*g + r, columns out_col(j, .)
    const float* vt = smem + L::kV + cur;
#pragma unroll 8
    for (int key = 0; key < kTile; ++key) {
      float p[R];
#pragma unroll
      for (int h = 0; h < R / 4; ++h) {
        const float4 ph = *reinterpret_cast<const float4*>(pt + key * L::kPRow + R * g + 4 * h);
        p[4 * h] = ph.x, p[4 * h + 1] = ph.y, p[4 * h + 2] = ph.z, p[4 * h + 3] = ph.w;
      }
      float vv[kCols];
      load_cols<D>(vv, vt + key * L::kRow, j);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int e = 0; e < kCols; ++e) acc[r][e] = fmaf(p[r], vv[e], acc[r][e]);
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float sum = group8_sum(l[r]);
    const int row = q0 + R * g + r;
    if (row >= t_len) continue;
    const float inv = 1.f / sum;
    float* out = o + base + static_cast<int64_t>(row) * D;
    if constexpr (D == 16) {
      *reinterpret_cast<float2*>(out + 2 * j) = make_float2(acc[r][0] * inv, acc[r][1] * inv);
    } else {
#pragma unroll
      for (int h = 0; h < D / 32; ++h)
        *reinterpret_cast<float4*>(out + out_col<D>(j, 4 * h)) =
            make_float4(acc[r][4 * h] * inv, acc[r][4 * h + 1] * inv, acc[r][4 * h + 2] * inv, acc[r][4 * h + 3] * inv);
    }
    if (lse != nullptr && j == 0) lse[static_cast<int64_t>(bh) * t_len + row] = (m[r] + log2f(sum)) * kLn2;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int t_len,
                   bool bf16_in, float scale, cudaStream_t stream) {
  const float c = scale * kLog2e;  // softmax via exp2
  if (bf16_in) {
    const int n_qtiles = (t_len + kTile - 1) / kTile;
    attention_fwd_mma_kernel<D><<<static_cast<unsigned>(bh) * n_qtiles, kThreads, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), lse, t_len, n_qtiles, c);
  } else {
    constexpr int bytes = F32Layout<D>::kBytes;
    const cudaError_t err =
        cudaFuncSetAttribute(attention_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    const int n_qtiles = (t_len + kF32BlockRows<D> - 1) / kF32BlockRows<D>;
    attention_fwd_f32_kernel<D><<<static_cast<unsigned>(bh) * n_qtiles, kF32Threads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), lse, t_len, n_qtiles, c);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse: f32 (BH, T) output, or null to skip
// it. Rows must start 16-byte aligned (contiguous tensors do). Returns a
// cudaError_t (0 = success).
extern "C" int s2s_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                                 int t_len, int d, int dtype, float scale, void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (bh <= 0 || t_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lp = static_cast<float*>(lse);
  switch (d) {
    case 16:
      return static_cast<int>(launch<16>(q, k, v, o, lp, bh, t_len, dtype == 1, scale, s));
    case 32:
      return static_cast<int>(launch<32>(q, k, v, o, lp, bh, t_len, dtype == 1, scale, s));
    case 64:
      return static_cast<int>(launch<64>(q, k, v, o, lp, bh, t_len, dtype == 1, scale, s));
    case 72:  // bf16 alone, on its own route (attention_d72.cuh)
      if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(s2s_attn_d72::launch_fwd(q, k, v, o, lp, bh, t_len, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
