// Eval BatchNorm + ReLU over NHWC, with the conv bias before it fused:
//   z = x                                     (no conv bias)
//   z = round_T(x + round_T(conv_bias[c]))    (conv bias)
//   y = round_T(relu(z * s[c] + t[c]))
// with T the tensor's type (bf16 or fp32; round_T is the identity for
// fp32) and the per-channel constants formed in the kernel, in float32:
//   s = scale / sqrt(var + eps),  t = bias - mean * s.
//
// Replaces the Pallas kernel bn_relu_inference of
// fabric_tpu/ops/pallas_fused.py:77 (relu(x * s + t) with s and t formed
// by XLA beforehand) and, in the unfolded eval forward, the separate conv
// bias add before it (Conv.forward, fabric_tpu_torch/models/blocks.py).
// Every float operation is an _rn intrinsic and the file is built with
// -fmad=false, so the result is bit-equal to the plain PyTorch version
// (ops/bn_relu.py): s and t as _scale_shift forms them, the conv bias
// add as Conv.forward rounds it, the product and the sum rounded apart.
//
// Bound on the H100: bytes.  A launch reads x once and writes y once
// (2 x 2 B per bf16 element, 2 x 4 B per fp32 element) and reads 5 (C,)
// float32 vectors; 3-5 operations per element are far below the card's
// ~20 operations per byte.  At the eval forward's small levels (6^2 and
// 12^2 images) the work is a few microseconds, so the host's cost of a
// launch decides: the wrapper makes this one launch and nothing else
// (no PyTorch launches to form s and t, no separate bias pass).
//
// Design: one thread owns one 16-byte vector of channels (8 bf16 or 4
// fp32) and keeps its s, t and conv bias in registers while it walks rows
// at a grid stride, four 16-byte loads in flight before it computes and
// stores.  A block is (bx, by) threads: bx vectors of a row side by side
// (neighbouring threads on neighbouring addresses), by rows; a grid of
// at most 4 blocks of 256 threads per SM (64 KB of loads in flight per
// SM, and 64 registers a thread, so nothing spills), so that a 6^2 level
// is one small wave and a 96^2 level streams at bandwidth.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cuda_error.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;  // 64 registers a thread
constexpr int kUnroll = 4;

// 16 bytes of T unpacked to float32 and packed back (rounded to T).
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  __device__ static float round(float v) { return v; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint32_t bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(bits(f[0]) | bits(f[1]) << 16,
                      bits(f[2]) | bits(f[3]) << 16,
                      bits(f[4]) | bits(f[5]) << 16,
                      bits(f[6]) | bits(f[7]) << 16);
  }
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// torch.relu: max(v, 0), NaN kept.
__device__ __forceinline__ float relu(float v) {
  return v != v ? v : fmaxf(v, 0.f);
}

template <typename T, bool BIAS>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    bn_relu_kernel(const uint4* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ bias,
                   const float* __restrict__ mean,
                   const float* __restrict__ var, float eps,
                   const float* __restrict__ conv_bias, uint4* __restrict__ y,
                   long long rows, int cv) {
  using V = Vec<T>;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;  // vector of a row
  if (j >= cv) return;
  float s[V::N], t[V::N], b[V::N];
#pragma unroll
  for (int k = 0; k < V::N; ++k) {
    const int c = j * V::N + k;
    s[k] = __fdiv_rn(scale[c], __fsqrt_rn(__fadd_rn(var[c], eps)));
    t[k] = __fsub_rn(bias[c], __fmul_rn(mean[c], s[k]));
    b[k] = BIAS ? V::round(conv_bias[c]) : 0.f;
  }
  const long long stride = (long long)gridDim.x * blockDim.y;
  for (long long r = (long long)blockIdx.x * blockDim.y + threadIdx.y;
       r < rows; r += kUnroll * stride) {
    uint4 in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (r + u * stride < rows) in[u] = __ldg(x + (r + u * stride) * cv + j);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * stride >= rows) continue;
      float f[V::N];
      V::unpack(in[u], f);
#pragma unroll
      for (int k = 0; k < V::N; ++k) {
        float z = BIAS ? V::round(__fadd_rn(f[k], b[k])) : f[k];
        f[k] = relu(__fadd_rn(__fmul_rn(z, s[k]), t[k]));
      }
      y[(r + u * stride) * cv + j] = V::pack(f);
    }
  }
}

template <typename T, bool BIAS>
int launch(const void* x, const float* scale, const float* bias,
           const float* mean, const float* var, float eps,
           const float* conv_bias, void* y, long long rows, int c,
           cudaStream_t stream) {
  const int cv = c / Vec<T>::N;
  const int bx = cv < kThreads ? cv : kThreads;
  const int by = kThreads / bx;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned tiles_c = (unsigned)((cv + bx - 1) / bx);
  long long blocks = (rows + (long long)by * kUnroll - 1) / (by * kUnroll);
  const long long cap = (long long)sms * kBlocksPerSm / tiles_c;
  if (blocks > cap) blocks = cap > 0 ? cap : 1;
  bn_relu_kernel<T, BIAS><<<dim3((unsigned)blocks, tiles_c), dim3(bx, by), 0,
                            stream>>>(
      static_cast<const uint4*>(x), scale, bias, mean, var, eps, conv_bias,
      static_cast<uint4*>(y), rows, cv);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (rows, c) contiguous, 16-byte aligned, bf16 (is_bf16) or fp32;
// c a multiple of 8.  scale, bias, mean, var and (or null) conv_bias:
// (c,) float32.  Launches on `stream`; returns the CUDA error of the
// launch (0 on success).
extern "C" int fabric_bn_relu(const void* x, const void* scale,
                              const void* bias, const void* mean,
                              const void* var, float eps,
                              const void* conv_bias, void* y, long long rows,
                              int c, int is_bf16, void* stream) {
  if (rows <= 0 || c <= 0 || c % 8 || x == nullptr || y == nullptr ||
      scale == nullptr || bias == nullptr || mean == nullptr ||
      var == nullptr || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16)
    return (int)cudaErrorInvalidValue;
  const float* v[5] = {static_cast<const float*>(scale),
                       static_cast<const float*>(bias),
                       static_cast<const float*>(mean),
                       static_cast<const float*>(var),
                       static_cast<const float*>(conv_bias)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return conv_bias ? launch<__nv_bfloat16, true>(x, v[0], v[1], v[2], v[3],
                                                   eps, v[4], y, rows, c, s)
                     : launch<__nv_bfloat16, false>(x, v[0], v[1], v[2], v[3],
                                                    eps, v[4], y, rows, c, s);
  return conv_bias ? launch<float, true>(x, v[0], v[1], v[2], v[3], eps, v[4],
                                         y, rows, c, s)
                   : launch<float, false>(x, v[0], v[1], v[2], v[3], eps, v[4],
                                          y, rows, c, s);
}
