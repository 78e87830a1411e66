// The float32 core of the port's fp32 conv kernels: conv3x3_bias_relu_f32.cu
// (row 1's fp32 form) and double_conv3x3_bias_relu_f32.cu (row 2's).
//
// fp32 has no tensor-core path that keeps fp32 products (TF32 wgmma keeps
// 10 bits of mantissa, the rounding these kernels exist to avoid), so the
// core is a register-blocked implicit GEMM on FFMA: M = output pixels, N =
// output channels, K = input channels x 9 taps.
//
// * A block is PG x CG threads; each owns an 8 x 8 tile of the block's
//   BM = 8 PG pixels x BN = 8 CG channels: pixel slots pg + PG i (i < 8)
//   and channels cg*4 + j, BN/2 + cg*4 + j (j < 4), so that in a warp
//   (4 pixel groups x 8 channel groups) the A reads hit 4 neighbouring
//   pixels and each 16-byte B read 128 contiguous bytes.
// * The input patch of the block's pixels, with its one-pixel zero halo
//   (the SAME padding), is staged KC channels at a time into shared memory
//   by cp.async, pixel-major (KC floats a pixel); the weights of the same
//   KC channels, 9 taps and BN channels beside it.  Two buffers: the next
//   chunk loads while the current one computes.
// * A 3x3 tap is a shift of the patch offset, so the nine taps reuse one
//   staged patch (no im2col buffer).
// * Every output's 9 Cin terms are summed by one fmaf chain in one fixed
//   order, input channel by input channel and within each the taps in row
//   order, whatever the tile, the chunk width KC or the image size.  A band
//   of a scene therefore sums each pixel exactly as the whole scene does
//   (fullconv serving relies on it), and the fused double conv's first conv
//   equals the single conv bit for bit.  Zero-padded channels and the halo
//   add exact zeros.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cuda_error.cuh"

namespace fabric {
namespace f32 {

constexpr int kMaxSmem = 232448;  // 227 KB, the most a block may use

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// The pixels of an M chunk: imgs images x rows x cols, row-major; its
// staged patch is imgs x (rows + 2) x (cols + 2) pixels.
struct Frame {
  int imgs, rows, cols;
};

// Floats of one staged patch of KC channels, rounded to 16 bytes.
__host__ __device__ inline int patch_floats(Frame f, int kc) {
  return round_up(f.imgs * (f.rows + 2) * (f.cols + 2) * kc, 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 or 4 bytes device -> shared, zero-filled when src_bytes is 0.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Thread geometry of a PG x CG block.
template <int PG, int CG>
struct Threads {
  static constexpr int kN = PG * CG, kBN = 8 * CG;
  static_assert(PG % 4 == 0 && CG % 8 == 0, "warps are 4 x 8 threads");
  int pg, cg;
  __device__ __forceinline__ Threads() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    pg = (warp % (PG / 4)) * 4 + (lane & 3);
    cg = (warp / (PG / 4)) * 8 + (lane >> 2);
  }
  // Pixel slot i of this thread.
  __device__ __forceinline__ int slot(int i) const { return pg + PG * i; }
};

// Stage channels [c0, c0 + KC) of the patch of an M chunk whose first
// output pixel is (img0, i0, j0): x is (n, h, w, cin) fp32 NHWC; pixels
// outside the images and channels past cin are zeros.  vec: cin % 4 == 0
// and x 16-byte aligned (16-byte copies where KC >= 4).
template <int KC, int NT>
__device__ __forceinline__ void stage_patch(float* dst, const float* x, int n,
                                            int h, int w, int cin, Frame f,
                                            int img0, int i0, int j0, int c0,
                                            bool vec) {
  const int pc = f.cols + 2, per_img = (f.rows + 2) * pc;
  const int step = KC >= 4 && vec ? 4 : 1, per_px = KC / step;
  const int pieces = f.imgs * per_img * per_px;
  for (int q = threadIdx.x; q < pieces; q += NT) {
    const int p = q / per_px, c = (q - p * per_px) * step;
    const int s = p / per_img, rem = p - s * per_img;
    const int r = rem / pc;
    const int img = img0 + s, i = i0 + r - 1, j = j0 + rem - r * pc - 1;
    const int ch = c0 + c;
    const bool ok = img < n && i >= 0 && i < h && j >= 0 && j < w && ch < cin;
    const float* src =
        ok ? x + (((size_t)img * h + i) * w + j) * cin + ch : x;
    const uint32_t d = smem_addr(dst + p * KC + c);
    if (step == 4)
      cp_async16(d, src, ok ? 16 : 0);
    else
      cp_async4(d, src, ok ? 4 : 0);
  }
}

// Stage the weights of input channels [c0, c0 + KC), all 9 taps, output
// channels [n0, n0 + BN) from the packed [cin_pad][9][cout_pad] layout
// (ops/conv.py pack_weight_f32) into [KC * 9][BN]; zeros past cout_pad.
template <int KC, int BN, int NT>
__device__ __forceinline__ void stage_weights(float* dst, const float* wpk,
                                              int cout_pad, int c0, int n0) {
  constexpr int per_row = BN / 4;
  for (int q = threadIdx.x; q < KC * 9 * per_row; q += NT) {
    const int row = q / per_row, col = (q - row * per_row) * 4;
    const bool ok = n0 + col < cout_pad;
    const float* src =
        ok ? wpk + (size_t)(c0 * 9 + row) * cout_pad + n0 + col : wpk;
    cp_async16(smem_addr(dst + row * BN + col), src, ok ? 16 : 0);
  }
}

// acc[i][j] += the KC channels' 9 taps: A from `a` (pixel p's channel c at
// a[p * pitch + c]; this thread's pixel i's top-left tap at a[poff[i]]),
// rows of the patch pc pixels apart; B from the staged weights.
template <int CG, int KC>
__device__ __forceinline__ void fma_chunk(float (&acc)[8][8], const float* a,
                                          int pitch, const int (&poff)[8],
                                          int pc, const float* wsm, int cg) {
  constexpr int BN = 8 * CG;
#pragma unroll
  for (int c = 0; c < KC; ++c) {
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = ((tap / 3) * pc + tap % 3) * pitch + c;
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = a[poff[i] + shift];
      const float* b = wsm + (c * 9 + tap) * BN + cg * 4;
      const float4 b0 = *reinterpret_cast<const float4*>(b);
      const float4 b1 = *reinterpret_cast<const float4*>(b + BN / 2);
      bv[0] = b0.x, bv[1] = b0.y, bv[2] = b0.z, bv[3] = b0.w;
      bv[4] = b1.x, bv[5] = b1.y, bv[6] = b1.z, bv[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// The two-buffer pipeline over n chunks: stage(q, buffer) issues chunk q's
// copies, compute(q, buffer) consumes them.  Starts with a barrier, so the
// buffers' earlier readers are done before they are refilled.
template <class Stage, class Compute>
__device__ __forceinline__ void pipeline(int n, Stage stage, Compute compute) {
  __syncthreads();
  stage(0, 0);
  cp_async_commit();
  for (int q = 0; q < n; ++q) {
    cp_async_wait_all();
    __syncthreads();  // chunk q landed; chunk q - 1 is no longer read
    if (q + 1 < n) {
      stage(q + 1, (q + 1) & 1);
      cp_async_commit();
    }
    compute(q, q & 1);
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// The bias of this thread's 8 channels from n0 (0 past cout).
template <int CG>
__device__ __forceinline__ void load_bias(float (&bb)[8], const float* bias,
                                          int n0, int cg, int cout) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int ch = n0 + (j < 4 ? 0 : 4 * CG) + cg * 4 + (j & 3);
    bb[j] = ch < cout ? bias[ch] : 0.f;
  }
}

// relu(acc + bias) of this thread's pixel i into `row`, the pixel's cout
// channels (nullptr: no such pixel), from channel n0; 16-byte stores where
// vec (cout % 4 == 0 and the row 16-byte aligned).
template <int CG>
__device__ __forceinline__ void store_px(const float (&acc)[8][8], int i,
                                         const float (&bb)[8], int n0, int cg,
                                         int cout, float* row, bool vec) {
  if (row == nullptr) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int c = n0 + half * 4 * CG + cg * 4;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = fmaxf(acc[i][4 * half + j] + bb[4 * half + j], 0.f);
    if (vec && c + 3 < cout) {
      *reinterpret_cast<float4*>(row + c) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < cout) row[c + j] = v[j];
    }
  }
}

}  // namespace f32
}  // namespace fabric
