// relu(conv3x3_SAME(x, K) + b) on NHWC float32: fp32 products, fp32 sums,
// fp32 out.  The float32 form of conv3x3_bias_relu.cu.
//
// Replaces the Pallas kernel fabric_tpu/ops/pallas_conv.py:91
// (conv3x3_bias_relu -> pl.pallas_call at :109), which computes in its
// input's dtype: its float32 form (fabric_tpu's dtype="float32" serving).
//
// Bound on the H100: a launch does 2 * N*H*W * 9*Cin*Cout operations on
// N*H*W*(Cin+Cout)*4 bytes, ~4.5*Cin*Cout/(Cin+Cout) operations per byte:
// 144 at Cin = Cout = 64, above the card's fp32 ridge (67 TFLOP/s of FFMA
// over 3.35 TB/s, ~20 operations per byte), so every launch of the serving
// path is bound by the FFMA rate except inc's first conv (13 channels in).
//
// Design (the core is conv_tile_f32.cuh): one block computes a 128-pixel
// M chunk of NI whole images x TR rows x TW columns (the bf16 kernel's
// tiles, ops/conv.py tile_geometry) by BN = 64 (Cout <= 64, 128 threads)
// or 128 output channels (256 threads), each thread an 8 x 8 register tile
// on FFMA; the haloed input patch and the weights are staged 8 channels at
// a time by cp.async into two buffers; bias and ReLU in registers, 16-byte
// stores.  Each output's sum runs in a fixed order (channel by channel,
// taps in row order), so a band's pixels equal the whole scene's.
#include "conv_tile_f32.cuh"

namespace fabric {
namespace f32 {

constexpr int kConvKC = 8;  // input channels per staged chunk

// Dynamic shared memory of one block: two patches of frame f and two
// weight stages of kConvKC x 9 x bn floats.
__host__ __device__ inline int conv_smem_bytes(Frame f, int bn) {
  return 2 * 4 * (patch_floats(f, kConvKC) + kConvKC * 9 * bn);
}

// One block per SM (two at 128 threads): a thread's 64 accumulators, 16
// operands and 8 pixel offsets and rows need ~200 registers; capped at
// 128 (two blocks of 256) the tile spilled 2 KB a thread and ran 1.5x
// slower on the H100.
template <int PG, int CG>
__global__ void __launch_bounds__(PG* CG, PG* CG == 256 ? 1 : 2)
    conv3x3_bias_relu_f32_kernel(const float* __restrict__ x,
                                 const float* __restrict__ wpk,
                                 const float* __restrict__ bias,
                                 float* __restrict__ y, int n, int h, int w,
                                 int cin, int cout, int cin_pad, int cout_pad,
                                 Frame f, int tiles_h, int tiles_w,
                                 bool vec_in, bool vec_out) {
  using T = Threads<PG, CG>;
  constexpr int KC = kConvKC, BN = T::kBN;
  extern __shared__ __align__(16) float smem[];
  const int pf = patch_floats(f, KC);
  float* const patch[2] = {smem, smem + pf};
  float* const wst[2] = {smem + 2 * pf, smem + 2 * pf + KC * 9 * BN};

  int tile = blockIdx.x;
  const int j0 = (tile % tiles_w) * f.cols;
  tile /= tiles_w;
  const int i0 = (tile % tiles_h) * f.rows;
  const int img0 = (tile / tiles_h) * f.imgs;
  const int n0 = blockIdx.y * BN;

  const T t;
  const int pc = f.cols + 2, px = f.rows * f.cols;
  int poff[8];
  float* rows[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = t.slot(i), s = m / px, r = (m - s * px) / f.cols;
    const int c = m - s * px - r * f.cols;
    poff[i] = ((s * (f.rows + 2) + r) * pc + c) * KC;
    const int on = img0 + s, oi = i0 + r, oj = j0 + c;
    rows[i] = on < n && oi < h && oj < w
                  ? y + (((size_t)on * h + oi) * w + oj) * cout
                  : nullptr;
  }

  float acc[8][8];
  zero(acc);
  pipeline(
      cin_pad / KC,
      [&](int q, int b) {
        stage_patch<KC, T::kN>(patch[b], x, n, h, w, cin, f, img0, i0, j0,
                               q * KC, vec_in);
        stage_weights<KC, BN, T::kN>(wst[b], wpk, cout_pad, q * KC, n0);
      },
      [&](int, int b) {
        fma_chunk<CG, KC>(acc, patch[b], KC, poff, pc, wst[b], t.cg);
      });

  float bb[8];
  load_bias<CG>(bb, bias, n0, t.cg, cout);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    store_px<CG>(acc, i, bb, n0, t.cg, cout, rows[i], vec_out);
}

template <int PG, int CG>
int launch(const float* x, const float* wpk, const float* bias, float* y,
           int n, int h, int w, int cin, int cout, int cin_pad, int cout_pad,
           Frame f, cudaStream_t stream) {
  constexpr int BN = 8 * CG;
  const int tiles_h = (h + f.rows - 1) / f.rows;
  const int tiles_w = (w + f.cols - 1) / f.cols;
  const long long tiles_n = (n + f.imgs - 1) / f.imgs;
  const long long blocks = tiles_n * tiles_h * tiles_w;
  const int n_tiles = (cout + BN - 1) / BN;
  if (blocks > 0x7fffffffLL || n_tiles > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const int smem = conv_smem_bytes(f, BN);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_bias_relu_f32_kernel<PG, CG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec_in = cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_out =
      cout % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  dim3 grid((unsigned)blocks, n_tiles);
  conv3x3_bias_relu_f32_kernel<PG, CG><<<grid, PG * CG, smem, stream>>>(
      x, wpk, bias, y, n, h, w, cin, cout, cin_pad, cout_pad, f, tiles_h,
      tiles_w, vec_in, vec_out);
  return (int)cudaGetLastError();
}

}  // namespace f32
}  // namespace fabric

using namespace fabric::f32;

// x (n, h, w, cin) fp32; wpk: the weights packed by ops/conv.py
// pack_weight_f32, [cin_pad][9][cout_pad] (cin_pad = cin rounded up to 8,
// cout_pad = cout rounded up to 4); bias (cout,) fp32; y (n, h, w, cout)
// fp32.  bn = 64 or 128 output channels per block; (tw, tr, ni): log2 of
// the tile's columns, rows and images, tw + tr + ni = 7.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int fabric_conv3x3_bias_relu_f32(const void* x, const void* wpk,
                                            const void* bias, void* y, int n,
                                            int h, int w, int cin, int cout,
                                            int cin_pad, int cout_pad, int bn,
                                            int tw, int tr, int ni,
                                            void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 ||
      cin_pad % kConvKC || cin_pad < cin || cout_pad % 4 || cout_pad < cout ||
      (bn != 64 && bn != 128) || tw < 0 || tr < 0 || ni < 0 ||
      tw + tr + ni != 7 || reinterpret_cast<uintptr_t>(wpk) % 16)
    return (int)cudaErrorInvalidValue;
  const Frame f{1 << ni, 1 << tr, 1 << tw};
  const auto* xs = static_cast<const float*>(x);
  const auto* ws = static_cast<const float*>(wpk);
  const auto* bs = static_cast<const float*>(bias);
  auto* ys = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bn == 64 ? launch<16, 8>(xs, ws, bs, ys, n, h, w, cin, cout,
                                  cin_pad, cout_pad, f, s)
                  : launch<16, 16>(xs, ws, bs, ys, n, h, w, cin, cout,
                                   cin_pad, cout_pad, f, s);
}
