// K1-bwd: fused self-attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel stain2stain_tpu/ops/pallas_attention.py::_bwd_kernel
// (launched by ::_fused_attention_bwd). Same function: per (batch*head) slice,
// given q, k, v, the forward's output o and the cotangent do,
//     s = q . k^T * scale,  p = softmax(s)        (recomputed, not saved)
//     delta = rowsum(do * o)                      (o as stored, in q's dtype)
//     dv = p^T . do,  ds = p * (do . v^T - delta)
//     dq = ds . k * scale,  dk = ds^T . q * scale
// with every product and sum in f32; dq, dk and dv are written once, in the
// inputs' dtype. Inputs are contiguous (BH, T, D) f32 or bf16; D is 16, 32 or 64.
//
// Bound on the H100 at the 256-px training shape (BH 512 = 16 heads x batch
// 32, T 1024, D 32: the mid block): 10*BH*T^2*D = 172 GFLOP of products
// (0.17 ms on bf16 tensor cores at 989 TFLOP/s, 2.6 ms on the FP32 pipes at
// 67 TFLOP/s), BH*T^2 = 537 M exponentials (~0.13 ms on the MUFU units), and
// 8*BH*T*D elements of q/k/v/o/do/dq/dk/dv (0.27 GB in bf16, ~0.08 ms). So the
// products bound it: on the tensor cores for bf16, on the FP32 pipes for f32.
//
// Design (first, simple and right). The TPU kernel walks the q blocks of one
// (batch*head) in order on one core and accumulates dk/dv in the output block
// across those steps; Hopper blocks run in no order, so the work is split into
// three passes, deterministic and without atomics:
//   1. stats: one block of 64 threads per (bh, 64-query tile), one query row a
//      thread. It recomputes the row's log-sum-exp over all keys (online max
//      and sum over 16-key chunks, as K1-fwd) and delta = rowsum(do*o), into an
//      f32 (BH, T) scratch pair that the wrapper allocates.
//   2. dk/dv: one block per (bh, 64-key tile), one key row a thread; k_j, v_j
//      and the f32 dk_j/dv_j accumulators live in registers. The block walks
//      every query in tiles staged in shared memory (q, do, lse, delta; every
//      thread reads the same query, so the reads broadcast) and writes dk/dv
//      once.
//   3. dq: one block per (bh, 64-query tile), one query row a thread; q_i, do_i
//      and the dq_i accumulator in registers, 64-key k/v tiles in shared memory.
// A ragged T is masked: staged rows past T load as zero, queries past T get
// lse = +inf (so p = 0), keys past T score p = 0 in pass 3, and rows past T
// compute but do not store.
// Everything runs as plain FMAs on the FP32 pipes (8*D FMAs per (query, key)
// pair over the three passes, against the 5*D of the bound's products), so
// the kernel is FMA-bound well above the bound for bf16. At D = 64 the 4*D
// registers of pass 2 exceed the 255 a thread may hold and ptxas spills; the
// main path runs D = 32. Tensor cores (mma.sync, then wgmma/TMA) are later work.
//
// Launches on the caller's stream, allocates nothing, and returns the first
// launch error (cudaGetLastError) so the Python wrapper can raise on it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;    // rows (queries or keys) per block, one per thread
constexpr int kKeyTile = 64; // keys staged in shared memory per step (passes 1, 3)
constexpr int kQTile = 32;   // queries staged in shared memory per step (pass 2)
constexpr int kChunk = 16;   // keys scored per online-softmax update (pass 1)

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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

template <int D>
__device__ __forceinline__ void axpy_row(float* acc, float alpha, const float* smem_row) {
  const float4* r = reinterpret_cast<const float4*>(smem_row);
#pragma unroll
  for (int i = 0; i < D / 4; ++i) {
    const float4 x = r[i];
    acc[4 * i + 0] = fmaf(alpha, x.x, acc[4 * i + 0]);
    acc[4 * i + 1] = fmaf(alpha, x.y, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(alpha, x.z, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(alpha, x.w, acc[4 * i + 3]);
  }
}

// Stage rows [r0, r0 + n_rows) of a (T, D) slice as f32; rows past T are zero.
template <typename T, int D, int N_ROWS, int N_THREADS>
__device__ __forceinline__ void stage_rows(float (*dst)[D], const T* __restrict__ src,
                                           int64_t base, int r0, int t_len, int tid) {
  for (int idx = tid; idx < N_ROWS * D; idx += N_THREADS) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int row = r0 + r;
    dst[r][c] = row < t_len ? load_f32(src + base + static_cast<int64_t>(row) * D + c) : 0.f;
  }
}

// Pass 1: per query row, lse (log2 domain, scores pre-scaled by scale*log2 e)
// and delta = rowsum(do * o).
template <typename T, int D>
__global__ void __launch_bounds__(kRows)
attention_bwd_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ o, const T* __restrict__ dout,
                           float* __restrict__ lse, float* __restrict__ delta,
                           int t_len, int n_tiles, float q_scale) {
  static_assert(D % 4 == 0, "head dim must be a multiple of 4");
  __shared__ __align__(16) float ks[kKeyTile][D];

  const int bh = blockIdx.x / n_tiles;
  const int tile = blockIdx.x - bh * n_tiles;
  const int tid = threadIdx.x;
  const int row = tile * kRows + tid;
  const bool row_valid = row < t_len;
  const int64_t base = static_cast<int64_t>(bh) * t_len * D;
  const int64_t row_off = base + static_cast<int64_t>(row) * D;

  float qr[D];
  float dlt = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    qr[i] = row_valid ? load_f32(q + row_off + i) * q_scale : 0.f;
    if (row_valid) dlt = fmaf(load_f32(dout + row_off + i), load_f32(o + row_off + i), dlt);
  }
  float m = -INFINITY;
  float l = 0.f;

  for (int j0 = 0; j0 < t_len; j0 += kKeyTile) {
    __syncthreads();  // the previous tile is fully consumed
    stage_rows<T, D, kKeyTile, kRows>(ks, k, base, j0, t_len, tid);
    __syncthreads();
    const int n_keys = min(kKeyTile, t_len - j0);
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
  if (row_valid) {
    const int64_t idx = static_cast<int64_t>(bh) * t_len + row;
    lse[idx] = m + log2f(l);
    delta[idx] = dlt;
  }
}

// Pass 2: dk and dv, one key row per thread, every query staged in turn.
template <typename T, int D>
__global__ void __launch_bounds__(kRows)
attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv,
                          int t_len, int n_tiles, float q_scale, float scale) {
  __shared__ __align__(16) float qs[kQTile][D];
  __shared__ __align__(16) float dos[kQTile][D];
  __shared__ float lses[kQTile];
  __shared__ float dlts[kQTile];

  const int bh = blockIdx.x / n_tiles;
  const int tile = blockIdx.x - bh * n_tiles;
  const int tid = threadIdx.x;
  const int key = tile * kRows + tid;
  const bool key_valid = key < t_len;
  const int64_t base = static_cast<int64_t>(bh) * t_len * D;
  const int64_t key_off = base + static_cast<int64_t>(key) * D;
  const int64_t stat_base = static_cast<int64_t>(bh) * t_len;

  float kr[D], vr[D], dkr[D], dvr[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    kr[i] = key_valid ? load_f32(k + key_off + i) * q_scale : 0.f;
    vr[i] = key_valid ? load_f32(v + key_off + i) : 0.f;
    dkr[i] = 0.f;
    dvr[i] = 0.f;
  }

  for (int i0 = 0; i0 < t_len; i0 += kQTile) {
    __syncthreads();
    stage_rows<T, D, kQTile, kRows>(qs, q, base, i0, t_len, tid);
    stage_rows<T, D, kQTile, kRows>(dos, dout, base, i0, t_len, tid);
    if (tid < kQTile) {
      const int row = i0 + tid;
      lses[tid] = row < t_len ? lse[stat_base + row] : INFINITY;  // p = 0 past T
      dlts[tid] = row < t_len ? delta[stat_base + row] : 0.f;
    }
    __syncthreads();
    const int n_q = min(kQTile, t_len - i0);
#pragma unroll 2
    for (int i = 0; i < n_q; ++i) {
      const float p = exp2f(dot_row<D>(kr, &qs[i][0]) - lses[i]);
      const float ds = p * (dot_row<D>(vr, &dos[i][0]) - dlts[i]);
      axpy_row<D>(dvr, p, &dos[i][0]);
      axpy_row<D>(dkr, ds, &qs[i][0]);
    }
  }
  if (key_valid) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      store_f32(dk + key_off + i, dkr[i] * scale);
      store_f32(dv + key_off + i, dvr[i]);
    }
  }
}

// Pass 3: dq, one query row per thread, every key staged in turn.
template <typename T, int D>
__global__ void __launch_bounds__(kRows)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, int t_len, int n_tiles, float q_scale, float scale) {
  __shared__ __align__(16) float ks[kKeyTile][D];
  __shared__ __align__(16) float vs[kKeyTile][D];

  const int bh = blockIdx.x / n_tiles;
  const int tile = blockIdx.x - bh * n_tiles;
  const int tid = threadIdx.x;
  const int row = tile * kRows + tid;
  const bool row_valid = row < t_len;
  const int64_t base = static_cast<int64_t>(bh) * t_len * D;
  const int64_t row_off = base + static_cast<int64_t>(row) * D;
  const int64_t stat = static_cast<int64_t>(bh) * t_len + row;

  float qr[D], dor[D], acc[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    qr[i] = row_valid ? load_f32(q + row_off + i) * q_scale : 0.f;
    dor[i] = row_valid ? load_f32(dout + row_off + i) : 0.f;
    acc[i] = 0.f;
  }
  const float lse_i = row_valid ? lse[stat] : INFINITY;
  const float dlt_i = row_valid ? delta[stat] : 0.f;

  for (int j0 = 0; j0 < t_len; j0 += kKeyTile) {
    __syncthreads();
    stage_rows<T, D, kKeyTile, kRows>(ks, k, base, j0, t_len, tid);
    stage_rows<T, D, kKeyTile, kRows>(vs, v, base, j0, t_len, tid);
    __syncthreads();
    const int n_keys = min(kKeyTile, t_len - j0);
#pragma unroll 2
    for (int j = 0; j < n_keys; ++j) {
      const float p = exp2f(dot_row<D>(qr, &ks[j][0]) - lse_i);
      const float ds = p * (dot_row<D>(dor, &vs[j][0]) - dlt_i);
      axpy_row<D>(acc, ds, &ks[j][0]);
    }
  }
  if (row_valid) {
#pragma unroll
    for (int i = 0; i < D; ++i) store_f32(dq + row_off + i, acc[i] * scale);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           void* dq, void* dk, void* dv, float* lse, float* delta, int bh, int t_len,
           float scale, cudaStream_t stream) {
  const float q_scale = scale * 1.4426950408889634f;  // log2(e): softmax via exp2
  const int n_tiles = (t_len + kRows - 1) / kRows;
  const dim3 grid(static_cast<unsigned>(bh) * n_tiles);
  const dim3 block(kRows);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* op = static_cast<const T*>(o);
  const T* dop = static_cast<const T*>(dout);

  attention_bwd_stats_kernel<T, D><<<grid, block, 0, stream>>>(qp, kp, op, dop, lse, delta,
                                                               t_len, n_tiles, q_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkdv_kernel<T, D><<<grid, block, 0, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), t_len, n_tiles,
      q_scale, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dq_kernel<T, D><<<grid, block, 0, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dq), t_len, n_tiles, q_scale, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_for_dim(int d, const void* q, const void* k, const void* v, const void* o,
                   const void* dout, void* dq, void* dk, void* dv, float* lse, float* delta,
                   int bh, int t_len, float scale, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, o, dout, dq, dk, dv, lse, delta, bh, t_len, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, dout, dq, dk, dv, lse, delta, bh, t_len, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, dout, dq, dk, dv, lse, delta, bh, t_len, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse and delta: f32 (BH, T) scratch.
// Returns a cudaError_t (0 = success).
extern "C" int s2s_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                 const void* dout, void* dq, void* dk, void* dv, void* lse,
                                 void* delta, int bh, int t_len, int d, int dtype, float scale,
                                 void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (bh <= 0 || t_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lp = static_cast<float*>(lse);
  float* dp = static_cast<float*>(delta);
  if (dtype == 0) {
    return launch_for_dim<float>(d, q, k, v, o, dout, dq, dk, dv, lp, dp, bh, t_len, scale, s);
  }
  return launch_for_dim<__nv_bfloat16>(d, q, k, v, o, dout, dq, dk, dv, lp, dp, bh, t_len,
                                       scale, s);
}
