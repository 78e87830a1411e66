// The int8 serving forward's Siamese fusion with its requantization, and
// the 2x2 max-pool of the same encoder level, in one pass.
//
// a: (2n, H, W, C) int8 NHWC, date 1 in images [0, n), date 2 in [n, 2n).
//   f[i, y, x, c] = float(max(int32(a[n + i]) * int32(a[i]), 0)) * m
//     int8 out:  clamp(rint(f), 0, 127)       (f1..f4, the decoder's skips)
//     bf16 out:  f rounded once to bf16       (f5, the upsample's operand)
//     fp32 out:  f
//   p = the 2x2 stride-2 VALID max-pool of a, (2n, H/2, W/2, C) int8 (odd
//     edges cropped), the next encoder level's input; optional.
//
// Replaces what fabric_tpu leaves to XLA in its int8 forward, which fuses
// it into one pass per level: fuse_q and f5 of _make_forward
// (fabric_tpu/infer/quant.py:336-352) and the int8 pool
// (:211-219, lax.reduce_window).  Products are at most 128^2 and exact in
// float32; m is the float32 of the caller's Python float, the multiply is
// __fmul_rn and the file is built with -fmad=false, so every output is
// bit-equal to the plain PyTorch version (ops/fuse_s8.py).
//
// Bound on the H100: bytes.  A launch reads a once (2nHWC bytes) and
// writes f once (nHWC x 1, 2 or 4 bytes) and p once (2n(H/2)(W/2)C
// bytes); a few integer and float operations per byte.
//
// Design: one thread takes 16 channels of a 2x2 pixel quad of image i and
// of image n + i: eight 16-byte loads, all issued before any use, then
// four f stores of 16 bytes per date pair (eight in bf16, sixteen in
// fp32) and two 16-byte p stores (per-byte signed max, __vmaxs4).
// Neighbouring threads take neighbouring channels, then neighbouring
// quads; a grid stride of at most 4 blocks of 256 threads per SM (128 KB
// of loads in flight per SM; 64 registers a thread).  With
// odd H or W the last quad row or column is partial and yields f only.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cuda_error.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;  // 64 registers a thread

enum Out { kInt8 = 0, kBf16 = 1, kFp32 = 2 };

__device__ __forceinline__ float fused(uint32_t w1, uint32_t w2, int byte,
                                       float m) {
  const int d1 = (int)(int8_t)(w1 >> (8 * byte));
  const int d2 = (int)(int8_t)(w2 >> (8 * byte));
  const int prod = d2 * d1;
  return __fmul_rn((float)(prod > 0 ? prod : 0), m);
}

__device__ __forceinline__ uint32_t code(float v) {
  const float q = fminf(fmaxf(rintf(v), 0.f), 127.f);
  return (uint32_t)__float2int_rn(q);
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// f of one pixel's 16 channels, stored at out (16 outputs of OUT).
template <int OUT>
__device__ __forceinline__ void store_f(const uint4& a1, const uint4& a2,
                                        float m, void* out) {
  const uint32_t w1[4] = {a1.x, a1.y, a1.z, a1.w};
  const uint32_t w2[4] = {a2.x, a2.y, a2.z, a2.w};
  if (OUT == kInt8) {
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[i] = code(fused(w1[i], w2[i], 0, m)) |
             code(fused(w1[i], w2[i], 1, m)) << 8 |
             code(fused(w1[i], w2[i], 2, m)) << 16 |
             code(fused(w1[i], w2[i], 3, m)) << 24;
    *static_cast<uint4*>(out) = make_uint4(o[0], o[1], o[2], o[3]);
  } else if (OUT == kBf16) {
    uint32_t o[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = bf16_bits(fused(w1[i], w2[i], 0, m)) |
                 bf16_bits(fused(w1[i], w2[i], 1, m)) << 16;
      o[2 * i + 1] = bf16_bits(fused(w1[i], w2[i], 2, m)) |
                     bf16_bits(fused(w1[i], w2[i], 3, m)) << 16;
    }
    uint4* o4 = static_cast<uint4*>(out);
    o4[0] = make_uint4(o[0], o[1], o[2], o[3]);
    o4[1] = make_uint4(o[4], o[5], o[6], o[7]);
  } else {
    float4* o4 = static_cast<float4*>(out);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o4[i] = make_float4(fused(w1[i], w2[i], 0, m), fused(w1[i], w2[i], 1, m),
                          fused(w1[i], w2[i], 2, m), fused(w1[i], w2[i], 3, m));
  }
}

__device__ __forceinline__ uint4 max4(const uint4& a, const uint4& b) {
  return make_uint4(__vmaxs4(a.x, b.x), __vmaxs4(a.y, b.y),
                    __vmaxs4(a.z, b.z), __vmaxs4(a.w, b.w));
}

template <int OUT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    siamese_s8_kernel(const int8_t* __restrict__ a, void* __restrict__ f,
                      int8_t* __restrict__ p, int n, int h, int w, int c,
                      float m, long long quads) {
  constexpr int kOutBytes = OUT == kInt8 ? 1 : OUT == kBf16 ? 2 : 4;
  const int cv = c / 16, hq = (h + 1) / 2, wq = (w + 1) / 2;
  const long long date = (long long)n * h * w * c;  // a[n] - a[0]
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
       idx < quads; idx += (long long)gridDim.x * kThreads) {
    const int ch = (int)(idx % cv) * 16;
    long long q = idx / cv;
    const int qx = (int)(q % wq);
    q /= wq;
    const int qy = (int)(q % hq);
    const int i = (int)(q / hq);
    // pixel k of the quad: (2qy + k / 2, 2qx + k % 2), at base + off(k)
    const long long base = (((long long)i * h + 2 * qy) * w + 2 * qx) * c + ch;
    const bool row2 = 2 * qy + 1 < h, col2 = 2 * qx + 1 < w;
    auto off = [&](int k) { return (k / 2) * (long long)w * c + (k % 2) * c; };
    auto has = [&](int k) { return (k < 2 || row2) && (k % 2 == 0 || col2); };
    uint4 d1[4], d2[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (has(k)) {
        d1[k] = __ldg(reinterpret_cast<const uint4*>(a + base + off(k)));
        d2[k] = __ldg(reinterpret_cast<const uint4*>(a + date + base + off(k)));
      }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (has(k))
        store_f<OUT>(d1[k], d2[k], m,
                     static_cast<char*>(f) + (base + off(k)) * kOutBytes);
    if (p != nullptr && row2 && col2) {  // a whole quad
      const long long po =
          (((long long)i * (h / 2) + qy) * (w / 2) + qx) * c + ch;
      *reinterpret_cast<uint4*>(p + po) =
          max4(max4(d1[0], d1[1]), max4(d1[2], d1[3]));
      *reinterpret_cast<uint4*>(p + (long long)n * (h / 2) * (w / 2) * c +
                                po) =
          max4(max4(d2[0], d2[1]), max4(d2[2], d2[3]));
    }
  }
}

template <int OUT>
int launch(const void* a, void* f, void* p, int n, int h, int w, int c,
           float m, cudaStream_t stream) {
  const long long quads =
      (long long)n * ((h + 1) / 2) * ((w + 1) / 2) * (c / 16);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (quads + kThreads - 1) / kThreads;
  if (blocks > (long long)sms * kBlocksPerSm)
    blocks = (long long)sms * kBlocksPerSm;
  siamese_s8_kernel<OUT><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(a), f, static_cast<int8_t*>(p), n, h, w, c,
      m, quads);
  return (int)cudaGetLastError();
}

}  // namespace

// a: (2n, h, w, c) int8; f: (n, h, w, c) of type out (0 int8, 1 bf16,
// 2 fp32); p: (2n, h/2, w/2, c) int8, or null for no pool.  c a multiple
// of 16, every pointer 16-byte aligned.  Launches on `stream`; returns
// the CUDA error of the launch (0 on success).
extern "C" int fabric_siamese_fuse_s8(const void* a, void* f, void* p, int n,
                                      int h, int w, int c, float m, int out,
                                      void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || c % 16 || a == nullptr ||
      f == nullptr || reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(f) % 16 ||
      reinterpret_cast<uintptr_t>(p) % 16 || out < kInt8 || out > kFp32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out) {
    case kInt8:
      return launch<kInt8>(a, f, p, n, h, w, c, m, s);
    case kBf16:
      return launch<kBf16>(a, f, p, n, h, w, c, m, s);
    default:
      return launch<kFp32>(a, f, p, n, h, w, c, m, s);
  }
}
