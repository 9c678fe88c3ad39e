// The DiT's LayerNorm-modulate for Hopper (sm_90a), forward and backward:
// y = T(((x - mean) * rstd) * (1 + scale[b]) + shift[b]) over the channels C of
// each token row of a (B, T, C) x, with (B, C) scale and shift per sample.
//
// Replaces no TPU kernel: the JAX package has no DiT. In plain PyTorch
// (ops/norms.py::_LayerNormModulate) the op is a chain of about 20 elementwise
// and reduction kernels, each a full pass over the f32 residual stream: at the
// DiT-XL/2 training shape (32, 1024, 1152), f32 x and bf16 y, 2.385 ms a call
// forward and backward on the H100 against the 0.18 ms that the bytes need.
//
// Bound on the H100: bytes. The forward reads x once and writes y, mean and
// rstd; the backward reads x, dy, mean and rstd once and writes dx and the
// (B, C) gradients of scale and shift. With f32 x and bf16 y that is 16 bytes
// an element, 0.60 GB a call at (32, 1024, 1152): 0.180 ms at 3.35 TB/s.
// The design is about that single pass:
//   * one warp holds one whole row in registers: lane l loads the 16-byte
//     vectors l, l + 32, ... of the row (K of them, K a template parameter
//     from C), so x is read once and every statistic comes from registers;
//   * the statistics are f32 and centred, as torch.var_mean's: the mean, then
//     the mean of (x - mean)^2 over the same registers (no E[x^2] - E[x]^2);
//     the warp sums are butterflies, so every lane holds the same bits;
//   * the backward recomputes x^ from (x, mean, rstd), the forward's saved
//     tensors, and takes dx = rstd * (g - mean(g) - x^ * mean(g * x^)) with
//     g = dy * (1 + scale), all in f32, rounded once to x's dtype;
//   * dscale[b, c] = sum_t dy * x^ and dshift[b, c] = sum_t dy without float
//     atomics: a block takes rows_per_block rows of one sample, each lane adds
//     its channels over its warp's rows into the warp's own slice of shared
//     memory (16-byte accesses, no bank conflict), the slices are added in
//     warp order, and a second small kernel adds the blocks of each sample in
//     block order. So the gradients are the same bits from run to run.
// scale and shift are read through the L1 cache (a block's rows share one
// sample), f32 or bf16, with any row stride that keeps 16-byte alignment (the
// wrapper passes the adaLN dense layer's chunks as they are).
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // rows in flight a block, a warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxChannels = 1152;  // DiT-XL/2's width, the widest DiT

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// V consecutive elements, loaded or stored in accesses of at most 16 bytes
template <typename T, int V>
struct alignas(sizeof(T) * V < 16 ? sizeof(T) * V : 16) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&out)[V]) {
  const Pack<T, V> pack = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = to_float(pack.v[i]);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&in)[V]) {
  if constexpr (sizeof(T) == 2) {  // bf16 in pairs, each pair one 32-bit register (no partial writes)
    Pack<__nv_bfloat162, V / 2> pack;
#pragma unroll
    for (int i = 0; i < V / 2; ++i) pack.v[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    *reinterpret_cast<Pack<__nv_bfloat162, V / 2>*>(p) = pack;
  } else {
    Pack<T, V> pack;
#pragma unroll
    for (int i = 0; i < V; ++i) pack.v[i] = in[i];
    *reinterpret_cast<Pack<T, V>*>(p) = pack;
  }
}

// V per-sample parameters at element `offset` of an f32 (bf16 == 0) or bf16 array
template <int V>
__device__ __forceinline__ void load_param(const void* p, int bf16, int64_t offset, float (&out)[V]) {
  if (bf16)
    load<__nv_bfloat16, V>(static_cast<const __nv_bfloat16*>(p) + offset, out);
  else
    load<float, V>(static_cast<const float*>(p) + offset, out);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// x (rows, C) with rows = B * tokens; y likewise; mean, rstd (rows,) f32.
// Lane l holds the vectors l + 32 k, k < K, of its warp's row.
template <typename TX, typename TY, int K>
__global__ void __launch_bounds__(kThreads) ln_modulate_fwd_kernel(
    const TX* __restrict__ x, TY* __restrict__ y, const void* __restrict__ scale, const void* __restrict__ shift,
    int64_t param_stride, int param_bf16, float* __restrict__ mean_out, float* __restrict__ rstd_out, int64_t rows,
    int tokens, int channels, float eps) {
  constexpr int V = 16 / sizeof(TX);
  const int lane = threadIdx.x % 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int vectors = channels / V;
  const TX* xr = x + row * channels;
  float v[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = lane + 32 * k;
    if (q < vectors) {
      load<TX, V>(xr + q * V, v[k]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[k][i] = 0.f;
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) sum += v[k][i];
  const float mean = warp_sum(sum) / channels;
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (lane + 32 * k < vectors) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = v[k][i] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / channels + eps);
  const int64_t base = (row / tokens) * param_stride;
  TY* yr = y + row * channels;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = lane + 32 * k;
    if (q >= vectors) continue;
    float s[V], h[V], out[V];
    load_param<V>(scale, param_bf16, base + q * V, s);
    load_param<V>(shift, param_bf16, base + q * V, h);
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = ((v[k][i] - mean) * rstd) * (1.f + s[i]) + h[i];
    store<TY, V>(yr + q * V, out);
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// Block (b, j) takes rows j * rows_per_block ... of sample b: dx for each, and
// the block's partial sums (2, C) = (sum dy * x^, sum dy) over them into
// partial[b][j]. Each warp adds its rows' terms into its own (2, C) slice of
// shared memory (a lane owns its channels there: no race), and the slices are
// added in warp order at the end. Dynamic shared memory: kWarps * 2 * C floats.
template <typename TX, typename TY, int K>
__global__ void __launch_bounds__(kThreads) ln_modulate_bwd_kernel(
    const TX* __restrict__ x, const TY* __restrict__ dy, const void* __restrict__ scale, int64_t param_stride,
    int param_bf16, const float* __restrict__ mean, const float* __restrict__ rstd, TX* __restrict__ dx,
    float* __restrict__ partial, int tokens, int channels, int rows_per_block, int blocks_per_sample) {
  constexpr int V = 16 / sizeof(TX);
  extern __shared__ __align__(16) float fold[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x / blocks_per_sample;
  const int first = (blockIdx.x - b * blocks_per_sample) * rows_per_block;
  const int end = min(first + rows_per_block, tokens);
  const int vectors = channels / V;
  const int64_t base = static_cast<int64_t>(b) * param_stride;
  for (int c = threadIdx.x; c < kWarps * 2 * channels; c += kThreads) fold[c] = 0.f;
  __syncthreads();
  float* dscale = fold + warp * 2 * channels;  // this warp's slice: (sum dy * x^, sum dy)
  float* dshift = dscale + channels;

  for (int t = first + warp; t < end; t += kWarps) {
    const int64_t row = static_cast<int64_t>(b) * tokens + t;
    float xh[K][V], g[K][V];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = lane + 32 * k;
      if (q < vectors) {
        load<TX, V>(x + row * channels + q * V, xh[k]);
        load<TY, V>(dy + row * channels + q * V, g[k]);
      }
    }
    const float m = mean[row], r = rstd[row];
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = lane + 32 * k;
      if (q >= vectors) continue;
      float s[V], ps[V], pb[V];
      load_param<V>(scale, param_bf16, base + q * V, s);
      load<float, V>(dscale + q * V, ps);
      load<float, V>(dshift + q * V, pb);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float xhat = (xh[k][i] - m) * r;
        const float d = g[k][i];
        ps[i] += d * xhat;
        pb[i] += d;
        const float gi = d * (1.f + s[i]);
        xh[k][i] = xhat;
        g[k][i] = gi;
        sg += gi;
        sgx += gi * xhat;
      }
      store<float, V>(dscale + q * V, ps);
      store<float, V>(dshift + q * V, pb);
    }
    const float mg = warp_sum(sg) / channels;
    const float mgx = warp_sum(sgx) / channels;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = lane + 32 * k;
      if (q >= vectors) continue;
      float out[V];
#pragma unroll
      for (int i = 0; i < V; ++i) out[i] = r * ((g[k][i] - mg) - xh[k][i] * mgx);
      store<TX, V>(dx + row * channels + q * V, out);
    }
  }
  __syncthreads();
  float* out = partial + static_cast<int64_t>(blockIdx.x) * 2 * channels;
  for (int c = threadIdx.x; c < 2 * channels; c += kThreads) {
    float sum = fold[c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum += fold[w * 2 * channels + c];
    out[c] = sum;
  }
}

// dscale[b, c] and dshift[b, c]: the blocks' partials of sample b added in block
// order, written in the parameters' dtype (f32, or bf16 if out_bf16).
__global__ void __launch_bounds__(256) ln_modulate_bwd_sum_kernel(const float* __restrict__ partial,
                                                                  void* __restrict__ dscale,
                                                                  void* __restrict__ dshift, int out_bf16,
                                                                  int batch, int channels, int blocks_per_sample) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= 2LL * batch * channels) return;
  const int64_t b = i / (2 * channels);
  const int e = static_cast<int>(i - b * 2 * channels);  // (which, c) within the sample
  const float* p = partial + b * blocks_per_sample * 2 * channels + e;
  float sum = 0.f;
  for (int j = 0; j < blocks_per_sample; ++j) sum += p[static_cast<int64_t>(j) * 2 * channels];
  const int which = e / channels;
  const int64_t o = b * channels + (e - which * channels);
  void* dst = which == 0 ? dscale : dshift;
  if (out_bf16)
    static_cast<__nv_bfloat16*>(dst)[o] = __float2bfloat16_rn(sum);
  else
    static_cast<float*>(dst)[o] = sum;
}

template <typename TX>
constexpr int kMaxK = (kMaxChannels + 32 * (16 / sizeof(TX)) - 1) / (32 * (16 / sizeof(TX)));

struct FwdArgs {
  const void* x;
  void* y;
  const void* scale;
  const void* shift;
  int64_t param_stride;
  int param_bf16;
  float* mean;
  float* rstd;
  int64_t rows;
  int tokens;
  int channels;
  float eps;
};

struct BwdArgs {
  const void* x;
  const void* dy;
  const void* scale;
  int64_t param_stride;
  int param_bf16;
  const float* mean;
  const float* rstd;
  void* dx;
  float* partial;
  int batch;
  int tokens;
  int channels;
  int rows_per_block;
  int blocks_per_sample;
};

template <typename TX, typename TY, int K = 1>
int launch_fwd(int k, const FwdArgs& a, cudaStream_t stream) {
  if constexpr (K > kMaxK<TX>) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (k != K) return launch_fwd<TX, TY, K + 1>(k, a, stream);
    const int64_t blocks = (a.rows + kWarps - 1) / kWarps;
    ln_modulate_fwd_kernel<TX, TY, K><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const TX*>(a.x), static_cast<TY*>(a.y), a.scale, a.shift, a.param_stride, a.param_bf16, a.mean,
        a.rstd, a.rows, a.tokens, a.channels, a.eps);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename TX, typename TY, int K = 1>
int launch_bwd(int k, const BwdArgs& a, cudaStream_t stream) {
  if constexpr (K > kMaxK<TX>) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (k != K) return launch_bwd<TX, TY, K + 1>(k, a, stream);
    const unsigned blocks = static_cast<unsigned>(a.batch) * static_cast<unsigned>(a.blocks_per_sample);
    const size_t smem = sizeof(float) * kWarps * 2 * a.channels;
    ln_modulate_bwd_kernel<TX, TY, K><<<blocks, kThreads, smem, stream>>>(
        static_cast<const TX*>(a.x), static_cast<const TY*>(a.dy), a.scale, a.param_stride, a.param_bf16, a.mean,
        a.rstd, static_cast<TX*>(a.dx), a.partial, a.tokens, a.channels, a.rows_per_block, a.blocks_per_sample);
    return static_cast<int>(cudaGetLastError());
  }
}

// K = vectors a lane: ceil(C / (32 * V)), V = 16 / sizeof(TX)
template <typename TX>
int lane_vectors(int channels) {
  constexpr int per_pass = 32 * (16 / static_cast<int>(sizeof(TX)));
  return (channels + per_pass - 1) / per_pass;
}

bool bad_shape(int64_t rows, int tokens, int channels) {
  return rows <= 0 || tokens <= 0 || rows % tokens || channels <= 0 || channels % 8 || channels > kMaxChannels;
}

}  // namespace

// Dtype codes: 0 float32, 1 bfloat16. x (rows, C) and y contiguous, rows =
// B * tokens; scale and shift (B, C) with row stride param_stride elements, one
// dtype; mean and rstd (rows,) f32, written. C a multiple of 8 up to 1152; every
// pointer 16-byte aligned and param_stride a multiple of 8.
extern "C" int s2s_ln_modulate_fwd(const void* x, void* y, int x_dtype, int y_dtype, const void* scale,
                                   const void* shift, int64_t param_stride, int param_dtype, float* mean, float* rstd,
                                   int64_t rows, int tokens, int channels, float eps, void* stream) {
  if (bad_shape(rows, tokens, channels) || param_dtype < 0 || param_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a{x, y, scale, shift, param_stride, param_dtype, mean, rstd, rows, tokens, channels, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype * 2 + y_dtype) {
    case 0: return launch_fwd<float, float>(lane_vectors<float>(channels), a, s);
    case 1: return launch_fwd<float, __nv_bfloat16>(lane_vectors<float>(channels), a, s);
    case 2: return launch_fwd<__nv_bfloat16, float>(lane_vectors<__nv_bfloat16>(channels), a, s);
    case 3: return launch_fwd<__nv_bfloat16, __nv_bfloat16>(lane_vectors<__nv_bfloat16>(channels), a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x, dy (B * tokens, C) contiguous, dy in y's dtype; dx written in x's dtype;
// scale as the forward's; `partial` f32 scratch of B * ceil(tokens /
// rows_per_block) * 2 * C floats; dscale and dshift (B, C) contiguous, written in
// the parameters' dtype. Two launches: the rows, then the per-sample sums.
extern "C" int s2s_ln_modulate_bwd(const void* x, const void* dy, int x_dtype, int y_dtype, const void* scale,
                                   int64_t param_stride, int param_dtype, const float* mean, const float* rstd,
                                   void* dx, float* partial, void* dscale, void* dshift, int batch, int tokens,
                                   int channels, int rows_per_block, void* stream) {
  if (batch <= 0 || rows_per_block <= 0 || bad_shape(static_cast<int64_t>(batch) * tokens, tokens, channels) ||
      param_dtype < 0 || param_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks_per_sample = (tokens + rows_per_block - 1) / rows_per_block;
  const BwdArgs a{x, dy, scale, param_stride, param_dtype, mean, rstd, dx, partial,
                  batch, tokens, channels, rows_per_block, blocks_per_sample};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (x_dtype * 2 + y_dtype) {
    case 0: err = launch_bwd<float, float>(lane_vectors<float>(channels), a, s); break;
    case 1: err = launch_bwd<float, __nv_bfloat16>(lane_vectors<float>(channels), a, s); break;
    case 2: err = launch_bwd<__nv_bfloat16, float>(lane_vectors<__nv_bfloat16>(channels), a, s); break;
    case 3: err = launch_bwd<__nv_bfloat16, __nv_bfloat16>(lane_vectors<__nv_bfloat16>(channels), a, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  const int64_t outputs = 2LL * batch * channels;
  ln_modulate_bwd_sum_kernel<<<static_cast<unsigned>((outputs + 255) / 256), 256, 0, s>>>(
      partial, dscale, dshift, param_dtype, batch, channels, blocks_per_sample);
  return static_cast<int>(cudaGetLastError());
}
