// K1-fwd: fused self-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel stain2stain_tpu/ops/pallas_attention.py::_fwd_kernel
// (launched by ::_fwd). Same function: per (batch*head) slice,
//     o = softmax(q . k^T * scale) . v
// with the logits, the row max and the row sum in f32 and the p.v sum in f32,
// output in q's dtype; the (T, T) logits never reach device memory. Inputs are
// contiguous (BH, T, D) f32 or bf16 tensors; D is 16, 32 or 64.
//
// Bound on the H100 at the 256-px serving shape (BH 256, T 1024, D 32, one
// tile batch of 16 through the mid block): 4*BH*T^2*D = 34.4 GFLOP of products
// (about 35 us at 989 TFLOP/s on bf16 tensor cores), BH*T^2 = 268 M
// exponentials (about 65-70 us on the MUFU units, 132 SMs x 16/clk), and 67 MB
// of bf16 q/k/v/o (about 20 us at 3.35 TB/s). So with bf16 tensor cores the
// exponential sets the bound, not the products or the bytes. For f32 inputs,
// which keep f32 products, the 67 TFLOP/s of the FP32 pipes set it (~0.5 ms).
//
// Design (first, simple and right; not a copy of the Pallas blocking, which
// holds the full-T k/v in VMEM and one (q_block, T) logits block):
//   * one block of 64 threads per (bh, 64-query tile); each thread owns one
//     query row: q (pre-scaled by scale*log2(e)) and the f32 accumulator live
//     in registers;
//   * k/v tiles of 64 keys are converted to f32 and staged through shared
//     memory; every thread reads the same key row, so the reads broadcast;
//   * online softmax over chunks of 16 keys (running max m and sum l, the
//     accumulator rescaled once per chunk) with exp2f, so the logits exist
//     only as 16 registers per thread;
//   * a ragged T is masked: out-of-range keys load as 0 and score -inf,
//     out-of-range query rows compute but do not store.
// The products run as plain FMAs on the FP32 pipes, so this kernel is bound by
// FMA throughput (2*BH*T^2*D FMAs), well above the exponential bound: a wgmma/TMA
// design that moves the products to the tensor cores, and then works on the
// exponential (e.g. part of it emulated on the FMA pipes), is later work.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;  // queries per block, one per thread
constexpr int kBlockK = 64;  // keys staged in shared memory per step
constexpr int kChunk = 16;   // keys scored per online-softmax update

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int D>
__global__ void __launch_bounds__(kBlockQ)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     int t_len, int n_qtiles, float q_scale) {
  static_assert(D % 4 == 0, "head dim must be a multiple of 4");
  __shared__ __align__(16) float ks[kBlockK][D];
  __shared__ __align__(16) float vs[kBlockK][D];

  const int bh = blockIdx.x / n_qtiles;
  const int qtile = blockIdx.x - bh * n_qtiles;
  const int tid = threadIdx.x;
  const int row = qtile * kBlockQ + tid;
  const bool row_valid = row < t_len;
  const int64_t base = static_cast<int64_t>(bh) * t_len * D;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    qr[i] = row_valid ? load_f32(q + base + static_cast<int64_t>(row) * D + i) * q_scale : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY;  // running max of the (log2-scaled) scores
  float l = 0.f;        // running sum of exp2(score - m)

  for (int j0 = 0; j0 < t_len; j0 += kBlockK) {
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = tid; idx < kBlockK * D; idx += kBlockQ) {
      const int r = idx / D;
      const int c = idx - r * D;
      const int key = j0 + r;
      float kv = 0.f, vv = 0.f;
      if (key < t_len) {
        const int64_t off = base + static_cast<int64_t>(key) * D + c;
        kv = load_f32(k + off);
        vv = load_f32(v + off);
      }
      ks[r][c] = kv;
      vs[r][c] = vv;
    }
    __syncthreads();

    const int n_keys = min(kBlockK, t_len - j0);
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
    T* out = o + base + static_cast<int64_t>(row) * D;
#pragma unroll
    for (int i = 0; i < D; ++i) store_f32(out + i, acc[i] * inv_l);
  }
}

template <typename T>
void launch_for_dim(const void* q, const void* k, const void* v, void* o, int bh,
                    int t_len, int d, float q_scale, cudaStream_t stream) {
  const int n_qtiles = (t_len + kBlockQ - 1) / kBlockQ;
  const dim3 grid(static_cast<unsigned>(bh) * n_qtiles);
  const dim3 block(kBlockQ);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  switch (d) {
    case 16:
      attention_fwd_kernel<T, 16><<<grid, block, 0, stream>>>(qp, kp, vp, op, t_len, n_qtiles, q_scale);
      break;
    case 32:
      attention_fwd_kernel<T, 32><<<grid, block, 0, stream>>>(qp, kp, vp, op, t_len, n_qtiles, q_scale);
      break;
    case 64:
      attention_fwd_kernel<T, 64><<<grid, block, 0, stream>>>(qp, kp, vp, op, t_len, n_qtiles, q_scale);
      break;
    default:
      break;  // rejected below
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success).
extern "C" int s2s_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                 int bh, int t_len, int d, int dtype, float scale,
                                 void* stream) {
  if (d != 16 && d != 32 && d != 64) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (bh <= 0 || t_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float q_scale = scale * 1.4426950408889634f;  // log2(e): softmax via exp2
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_for_dim<float>(q, k, v, o, bh, t_len, d, q_scale, s);
  } else {
    launch_for_dim<__nv_bfloat16>(q, k, v, o, bh, t_len, d, q_scale, s);
  }
  return static_cast<int>(cudaGetLastError());
}
