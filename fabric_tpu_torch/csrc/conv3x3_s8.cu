// y = conv3x3_SAME(x, W) on NHWC int8 with exact int32 sums: the int8
// serving path's conv, as an implicit GEMM on the int8 tensor cores.
//
// Replaces what fabric_tpu leaves to XLA, the s8 x s8 -> s32 convs of its
// int8 serving path: conv_raw (fabric_tpu/infer/quant.py:176-180) and the
// two convs of up_q (:231-236).  They are the serving use of the same
// contraction as the Pallas int8 matmul of tools/ablate_train.py:346, and
// run on the same GEMM core (int8_gemm.cuh).  The dequantize / bias / ReLU /
// requantize epilogue stays outside, in PyTorch (XLA fuses it outside any
// Pallas kernel in fabric_tpu).
//
// GEMM view: M = output pixels, N = output channels, K = 9 taps x input
// channels.  A block owns 128 output pixels x 64 channels; eight warps split
// it 4 x 2, each computing 32 x 32 with m16n8k32 mma.sync.  Bound on the
// H100: at the serving shapes (patch 64, 256 tiles) the int32 output bounds
// the full-resolution levels (4 bytes per output against 9*Cin*2 operations
// at 1979 TOPS) and the operations the deep ones.  The design keeps the
// operations on the tensor cores and reads the input about once per 64
// output channels: the block stages its pixels plus a one-pixel halo in
// shared memory, 64 channels (bytes) at a time, and the nine taps read that
// one patch (no im2col buffer).  The halo is zero where it falls outside the
// image: an int8 zero is the quantized zero, so this is SAME padding
// exactly.  The weights are packed once, (9, Cout64, Cin32) bytes, input
// channels contiguous, and read through the read-only cache.
//
// Tiles: TR rows x TW columns of NI images, TW the power of two >= W (at
// most 128), TR the power of two >= H that fits, NI = 128 / (TR*TW).  Small
// images (the 4x4 and 8x8 of the deep levels) pack several whole images
// into one tile instead of leaving most of its 128 rows empty; pixels past
// the image, or images past N, are computed from zeros and dropped.
#include "int8_gemm.cuh"

namespace fabric {

__host__ __device__ inline int ceil_log2(int v) {
  int r = 0;
  while ((1 << r) < v) ++r;
  return r;
}

struct TileShape {
  int tw_log2, tr_log2, ni_log2;
};

__host__ __device__ inline TileShape tile_shape(int h, int w) {
  TileShape s;
  const int lw = ceil_log2(w), lh = ceil_log2(h);
  s.tw_log2 = lw < 7 ? lw : 7;
  s.tr_log2 = lh < 7 - s.tw_log2 ? lh : 7 - s.tw_log2;
  s.ni_log2 = 7 - s.tw_log2 - s.tr_log2;
  return s;
}

__global__ void __launch_bounds__(kThreads)
    conv3x3_s8_kernel(const unsigned char* __restrict__ x,
                      const unsigned char* __restrict__ wpk,
                      int* __restrict__ y, int nimg, int h, int w, int cin,
                      int cout, int cin_pad, int cout_pad, TileShape ts,
                      int tiles_h, int tiles_w, bool vec) {
  extern __shared__ uint4 smem_u4[];
  unsigned char* patch = reinterpret_cast<unsigned char*>(smem_u4);

  const int lane = threadIdx.x & 31, wm = (threadIdx.x >> 5) & 3;
  const int wn = threadIdx.x >> 7, g = lane >> 2, t = lane & 3;
  const int tw = 1 << ts.tw_log2, tr = 1 << ts.tr_log2, ni = 1 << ts.ni_log2;
  int tile = blockIdx.x;
  const int tj = tile % tiles_w;
  tile /= tiles_w;
  const int ti = tile % tiles_h;
  const int img0 = (tile / tiles_h) * ni, i0 = ti * tr, j0 = tj * tw;
  const int n0 = blockIdx.y * kBN;
  const int pcols = tw + 2, pimg = (tr + 2) * pcols;

  int px[4];
  int* dst[4];
  bool valid[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int m = wm * 32 + (q >> 1) * 16 + (q & 1) * 8 + g;
    const int s = m >> (ts.tw_log2 + ts.tr_log2);
    const int r = (m >> ts.tw_log2) & (tr - 1), c = m & (tw - 1);
    px[q] = s * pimg + r * pcols + c;  // patch pixel of tap (0, 0)
    const int on = img0 + s, oi = i0 + r, oj = j0 + c;
    valid[q] = on < nimg && oi < h && oj < w;
    dst[q] = y + (((size_t)min(on, nimg - 1) * h + min(oi, h - 1)) * w +
                  min(oj, w - 1)) * cout;
  }

  const int total_px = ni * pimg;
  int acc[2][4][4] = {};
  for (int c0 = 0; c0 < cin_pad; c0 += kChunkS8) {
    const int kc = min(kChunkS8, cin_pad - c0);
    const int groups = kc / 16;
    __syncthreads();  // the previous chunk's reads are done
    // stage NI x (TR+2) x (TW+2) pixels x kc channels, zero outside
    for (int idx = threadIdx.x; idx < total_px * groups; idx += kThreads) {
      const int v = idx % groups, p = idx / groups;
      const int s = p / pimg, rem = p % pimg;
      const int gn = img0 + s, gi = i0 - 1 + rem / pcols,
                gj = j0 - 1 + rem % pcols;
      const int c = c0 + v * 16;
      const bool inside = gn < nimg && gi >= 0 && gi < h && gj >= 0 && gj < w;
      const unsigned char* src =
          x + (((size_t)min(gn, nimg - 1) * h + max(min(gi, h - 1), 0)) * w +
               max(min(gj, w - 1), 0)) * cin + c;
      *reinterpret_cast<uint4*>(patch + (size_t)p * kPitchS8 + v * 16) =
          load16(src, inside ? cin - c : 0, vec);
    }
    __syncthreads();
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * pcols + tap % 3;
      const unsigned char* arow[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        arow[q] = patch + (size_t)(px[q] + shift) * kPitchS8 + t * 4;
      const unsigned char* brow =
          wpk + ((size_t)tap * cout_pad + n0 + wn * 32 + g) * cin_pad + c0 +
          t * 4;
      gemm_warp_tile(acc, arow, brow, cin_pad, kc);
    }
  }
  store_warp_tile(acc, dst, valid, n0 + wn * 32, cout, (cout & 1) == 0);
}

}  // namespace fabric

using namespace fabric;

// Dynamic shared memory of one block for an (h, w) image.
extern "C" int fabric_conv3x3_s8_smem_bytes(int h, int w) {
  const TileShape ts = tile_shape(h, w);
  return (1 << ts.ni_log2) * ((1 << ts.tr_log2) + 2) *
         ((1 << ts.tw_log2) + 2) * kPitchS8;
}

// x (n, h, w, cin) int8; wpk (9, cout_pad, cin_pad) int8, zero-padded, from
// the HWIO kernel; y (n, h, w, cout) int32.  cin_pad is cin rounded up to
// 32 and cout_pad cout rounded up to 64.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int fabric_conv3x3_s8(const void* x, const void* wpk, void* y,
                                 int n, int h, int w, int cin, int cout,
                                 int cin_pad, int cout_pad, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 ||
      cin_pad % 32 || cin_pad < cin || cout_pad % kBN || cout_pad < cout)
    return (int)cudaErrorInvalidValue;
  const TileShape ts = tile_shape(h, w);
  const int tiles_h = (h + (1 << ts.tr_log2) - 1) >> ts.tr_log2;
  const int tiles_w = (w + (1 << ts.tw_log2) - 1) >> ts.tw_log2;
  const long long tiles_n = (n + (1 << ts.ni_log2) - 1) >> ts.ni_log2;
  const long long blocks = tiles_n * tiles_h * tiles_w;
  if (blocks > 0x7fffffffLL || cout_pad / kBN > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const int smem = fabric_conv3x3_s8_smem_bytes(h, w);
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_s8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec = cin % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  dim3 grid((unsigned)blocks, cout_pad / kBN);
  conv3x3_s8_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(x),
      static_cast<const unsigned char*>(wpk), static_cast<int*>(y), n, h, w,
      cin, cout, cin_pad, cout_pad, ts, tiles_h, tiles_w, vec);
  return (int)cudaGetLastError();
}
