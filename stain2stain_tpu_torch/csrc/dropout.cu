// The hash dropout of the unfused ResBlocks for Hopper (sm_90a): y = x * mask(seed).
//
// Replaces no TPU kernel: the JAX package's hash dropout
// (stain2stain_tpu/ops/dropout.py::hash_dropout) is plain jnp, which XLA fused
// into one pass on the TPU. In plain PyTorch (ops/dropout.py::hash_mask) the
// same mask takes about 20 elementwise kernels over full-size int32 and f32
// tensors, and index terms built on the host and copied to the card, each copy
// a wait for the stream. This kernel applies that mask in one pass: the
// murmur3 finalizer (conv_common.cuh's mix32) of the NHWC element index
// ((b*H + h)*W + w)*C + c plus the seed, mod 2^32, the element kept iff the
// hash lies below the threshold. So the mask is hash_mask's and that of the
// fused kernels K2, K4 and K5, bit for bit. It is a pure function of the seed:
// the forward (x) and the backward (dy) are the same call.
//
// y = T(float(x) * m), m = keep ? s_T : 0, with s_T = T(float(1 / (1 - rate)))
// rounded by the wrapper: what torch's x * (keep.to(T) * scale) gives, dropped
// elements included (x * 0, so signed zeros and NaNs as torch's).
//
// Bound on the H100: one read and one write of x, 2 * sizeof(T) bytes an
// element at 3.35 TB/s: 0.641 ms at the mask net's first level (8, 128, 512,
// 512) in f32 (2.15e9 bytes). The design is about keeping bytes in flight:
//   * the NCHW offset of an element is p * HW + hw, with plane p = b*C + c, and
//     its NHWC index b*C*HW + hw*C + c: only the plane needs a division. A
//     block's work item is a chunk of one plane, so a 64-bit division is paid
//     once an item (kChunk vectors) and never an element;
//   * 16-byte vectors along the plane (4 f32, 8 bf16 or f16) where HW is a
//     multiple of the vector and both pointers are 16-byte aligned; one element
//     a thread otherwise (odd shapes, an offset view);
//   * each thread loads its kUnroll vectors before it hashes any; a
//     grid-stride loop over the items, with at most kBlocksPerSm blocks on
//     each SM; no shared memory;
//   * about 14 integer and float operations an element (index, hash, compare,
//     product, rounding) against the ~35 that the memory time leaves an SM.
// A plane shorter than a chunk leaves threads of its item idle: from HW/V
// below 512 vectors, the UNet's smallest levels, whose bytes are few.
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_fp16.h>

#include "conv_common.cuh"

namespace {

using s2s_conv::mix32;

constexpr int kThreads = 256;
constexpr int kUnroll = 2;                  // vectors of a thread an item
constexpr int kChunk = kThreads * kUnroll;  // vectors of an item
constexpr int kBlocksPerSm = 8;             // 2048 threads: an SM's most

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }
template <>
__device__ __forceinline__ __half from_float<__half>(float v) { return __float2half_rn(v); }

// V consecutive elements, loaded and stored as one access of V * sizeof(T) bytes
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// x, y: NCHW, contiguous; `planes` = B*C planes of `hw` = H*W elements; V divides hw
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) hash_dropout_kernel(const T* __restrict__ x, T* __restrict__ y,
                                                                int64_t planes, int64_t hw, uint32_t channels,
                                                                uint32_t seed, uint32_t threshold, float scale) {
  using P = Pack<T, V>;
  const int64_t vectors = hw / V;  // of a plane
  const int64_t chunks = (vectors + kChunk - 1) / kChunk;
  const int64_t items = planes * chunks;
  // the NHWC index mod 2^32: b * (C*HW) + hw * C + c, in wrapping uint32 arithmetic
  const uint32_t image_stride = channels * static_cast<uint32_t>(hw);
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    const int64_t p = item / chunks;
    const int64_t first = (item - p * chunks) * kChunk + threadIdx.x;
    const int64_t b = p / channels;
    const uint32_t base = static_cast<uint32_t>(b) * image_stride + static_cast<uint32_t>(p - b * channels) + seed;
    const P* xp = reinterpret_cast<const P*>(x + p * hw);
    P* yp = reinterpret_cast<P*>(y + p * hw);
    P in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t q = first + u * kThreads;
      if (q < vectors) in[u] = xp[q];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t q = first + u * kThreads;
      if (q >= vectors) continue;
      uint32_t index = base + static_cast<uint32_t>(q * V) * channels;
      P out;
#pragma unroll
      for (int k = 0; k < V; ++k, index += channels) {
        const float m = mix32(index) < threshold ? scale : 0.f;
        out.v[k] = from_float<T>(__fmul_rn(to_float(in[u].v[k]), m));
      }
      yp[q] = out;
    }
  }
}

template <typename T>
int launch(const void* x, void* y, int64_t planes, int64_t hw, int channels, uint32_t seed, uint32_t threshold,
           float scale, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vector = hw % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int64_t vectors = vector ? hw / kVec : hw;
  const int64_t items = planes * ((vectors + kChunk - 1) / kChunk);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = items < int64_t{sms} * kBlocksPerSm ? items : int64_t{sms} * kBlocksPerSm;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const uint32_t c = static_cast<uint32_t>(channels);
  if (vector)
    hash_dropout_kernel<T, kVec><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(xt, yt, planes, hw, c, seed,
                                                                                         threshold, scale);
  else
    hash_dropout_kernel<T, 1><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(xt, yt, planes, hw, c, seed,
                                                                                      threshold, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. x and y (B, C, H, W), contiguous,
// `planes` = B*C, `hw` = H*W; keep iff mix32(NHWC index + seed) < threshold,
// y = x * (keep ? scale : 0) rounded to the dtype.
extern "C" int s2s_hash_dropout(const void* x, void* y, int dtype, int64_t planes, int64_t hw, int channels,
                                uint32_t seed, uint32_t threshold, float scale, void* stream) {
  if (planes <= 0 || hw <= 0 || channels <= 0 || planes % channels) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, y, planes, hw, channels, seed, threshold, scale, s);
    case 1: return launch<__nv_bfloat16>(x, y, planes, hw, channels, seed, threshold, scale, s);
    case 2: return launch<__half>(x, y, planes, hw, channels, seed, threshold, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
