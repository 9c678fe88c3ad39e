// K1-fwd: fused self-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel stain2stain_tpu/ops/pallas_attention.py::_fwd_kernel
// (launched by ::_fwd). Same function: per (batch*head) slice,
//     o = softmax(q . k^T * scale) . v
// with the logits, the row max and the row sum in f32 and the p.v sum in f32,
// output in q's dtype; the (T, T) logits never reach device memory. Inputs are
// contiguous (BH, T, D) f32 or bf16 tensors; D is 16, 32 or 64. Optionally
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
// which keep f32 products, the 67 TFLOP/s of the FP32 pipes set it (~0.5 ms).
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
// f32 design: one thread per query row, 64-thread blocks, q (pre-scaled by
// scale*log2(e)) and the accumulator in registers, 64-key k/v tiles staged as
// f32 in shared memory (every thread reads the same key row: broadcast), an
// online softmax over 16-key chunks; plain FMAs on the FP32 pipes, since f32
// serving keeps f32 products (its tolerance is 5e-5).
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

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

  uint32_t qa[D / 16][4];
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

// ---- f32: FP32 pipes -------------------------------------------------------

constexpr int kF32Rows = 64;   // queries per block, one per thread
constexpr int kF32Keys = 64;   // keys staged in shared memory per step
constexpr int kChunk = 16;     // keys scored per online-softmax update

template <int D>
__global__ void __launch_bounds__(kF32Rows)
attention_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                         float* __restrict__ o, float* __restrict__ lse, int t_len, int n_qtiles, float q_scale) {
  static_assert(D % 4 == 0, "head dim must be a multiple of 4");
  __shared__ __align__(16) float ks[kF32Keys][D];
  __shared__ __align__(16) float vs[kF32Keys][D];

  const int bh = blockIdx.x / n_qtiles;
  const int qtile = blockIdx.x - bh * n_qtiles;
  const int tid = threadIdx.x;
  const int row = qtile * kF32Rows + tid;
  const bool row_valid = row < t_len;
  const int64_t base = static_cast<int64_t>(bh) * t_len * D;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    qr[i] = row_valid ? q[base + static_cast<int64_t>(row) * D + i] * q_scale : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY;  // running max of the (log2-scaled) scores
  float l = 0.f;        // running sum of exp2(score - m)

  for (int j0 = 0; j0 < t_len; j0 += kF32Keys) {
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = tid; idx < kF32Keys * D; idx += kF32Rows) {
      const int r = idx / D;
      const int col = idx - r * D;
      const int key = j0 + r;
      float kv = 0.f, vv = 0.f;
      if (key < t_len) {
        const int64_t off = base + static_cast<int64_t>(key) * D + col;
        kv = k[off];
        vv = v[off];
      }
      ks[r][col] = kv;
      vs[r][col] = vv;
    }
    __syncthreads();

    const int n_keys = min(kF32Keys, t_len - j0);
    for (int c0 = 0; c0 < n_keys; c0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float4* kr = reinterpret_cast<const float4*>(&ks[c0 + j][0]);
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < D / 4; ++i) {
          const float4 kk = kr[i];
          dot = fmaf(qr[4 * i + 0], kk.x, dot);
          dot = fmaf(qr[4 * i + 1], kk.y, dot);
          dot = fmaf(qr[4 * i + 2], kk.z, dot);
          dot = fmaf(qr[4 * i + 3], kk.w, dot);
        }
        s[j] = (c0 + j < n_keys) ? dot : -INFINITY;
        cmax = fmaxf(cmax, s[j]);
      }
      // The first chunk of the first tile always holds key 0, so m_new is
      // finite and alpha = exp2(-inf) = 0 clears the empty accumulator.
      const float m_new = fmaxf(m, cmax);
      const float alpha = exp2f(m - m_new);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < D; ++i) acc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = exp2f(s[j] - m_new);
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(&vs[c0 + j][0]);
#pragma unroll
        for (int i = 0; i < D / 4; ++i) {
          const float4 vv = vr[i];
          acc[4 * i + 0] = fmaf(p, vv.x, acc[4 * i + 0]);
          acc[4 * i + 1] = fmaf(p, vv.y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(p, vv.z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(p, vv.w, acc[4 * i + 3]);
        }
      }
      m = m_new;
    }
  }

  if (row_valid) {
    const float inv_l = 1.f / l;
    float* out = o + base + static_cast<int64_t>(row) * D;
#pragma unroll
    for (int i = 0; i < D; ++i) out[i] = acc[i] * inv_l;
    if (lse != nullptr) lse[static_cast<int64_t>(bh) * t_len + row] = (m + log2f(l)) * kLn2;
  }
}

template <int D>
void launch(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int t_len, bool bf16_in,
            float scale, cudaStream_t stream) {
  const float c = scale * kLog2e;  // softmax via exp2
  if (bf16_in) {
    const int n_qtiles = (t_len + kTile - 1) / kTile;
    attention_fwd_mma_kernel<D><<<static_cast<unsigned>(bh) * n_qtiles, kThreads, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), lse, t_len, n_qtiles, c);
  } else {
    const int n_qtiles = (t_len + kF32Rows - 1) / kF32Rows;
    attention_fwd_f32_kernel<D><<<static_cast<unsigned>(bh) * n_qtiles, kF32Rows, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), lse, t_len, n_qtiles, c);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse: f32 (BH, T) output, or null to skip
// it. bf16 rows must start 16-byte aligned (contiguous tensors do). Returns a
// cudaError_t (0 = success).
extern "C" int s2s_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                                 int t_len, int d, int dtype, float scale, void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (bh <= 0 || t_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lp = static_cast<float*>(lse);
  switch (d) {
    case 16:
      launch<16>(q, k, v, o, lp, bh, t_len, dtype == 1, scale, s);
      break;
    case 32:
      launch<32>(q, k, v, o, lp, bh, t_len, dtype == 1, scale, s);
      break;
    case 64:
      launch<64>(q, k, v, o, lp, bh, t_len, dtype == 1, scale, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
