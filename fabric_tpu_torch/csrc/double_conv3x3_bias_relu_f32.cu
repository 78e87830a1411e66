// relu(conv3x3(relu(conv3x3(x, K1) + b1), K2) + b2) on NHWC float32, the
// intermediate kept in shared memory: the float32 form of
// double_conv3x3_bias_relu.cu.
//
// Replaces the Pallas kernel fabric_tpu/ops/pallas_double_conv.py:190
// (double_conv3x3_bias_relu -> pl.pallas_call at :212), which computes in
// its input's dtype: its float32 form.
//
// Bound on the H100: the two convs' 2 * N*H*W * 9 * (Cin*Cmid + Cmid*Cout)
// operations at the fp32 FFMA rate (67 TFLOP/s); the bytes are the input
// and the output once (the intermediate never reaches device memory).
//
// Design (the core is conv_tile_f32.cuh): a block holds G whole small
// images (G*H*W <= BM pixels) and their fp32 intermediate, G x (H+2) x
// (W+2) x Cmid with its zero frame, in shared memory.  Phase 1 computes
// conv1 over the G images for each BN-channel tile of Cmid from staged
// input patches and writes relu(acc + b1) into the intermediate; phase 2
// computes conv2 from the intermediate (read in place, no staging) for each
// BN-channel tile of Cout and stores.  The fp32 intermediate is 4 bytes an
// element, so only small images fit (ops/double_conv.py plan_f32: at patch
// 64, down4's 4x4 images two at a time and up1's 8x8 one at a time); the
// thread layout follows the pixel count: BM = 32, 64 or 128 pixels by BN =
// 512, 256 or 128 channels, KC = 2, 4 or 8 channels a chunk, so the weight
// stage stays 36 KB.  Each output's sum runs in the single conv kernel's
// order, so this equals two conv3x3_bias_relu_f32 launches bit for bit.
#include "conv_tile_f32.cuh"

namespace fabric {
namespace f32 {

// Floats of the intermediate: g images x (h+2) x (w+2) pixels of pitch
// cmid_pad + 4 (4 floats of padding move neighbouring pixels to other
// banks).
__host__ __device__ inline int inter_floats(int g, int h, int w,
                                            int cmid_pad) {
  return round_up(g * (h + 2) * (w + 2) * (cmid_pad + 4), 4);
}

// Dynamic shared memory of one block of g images of h x w with cmid_pad
// intermediate channels at bm = 32, 64 or 128 pixel slots (the weight
// stage is kc x 9 x bn floats, bn = 16384 / bm, kc = 1024 / bn).
// ops/double_conv.py smem_bytes_f32 mirrors this formula.
__host__ __device__ inline int double_smem_bytes(int g, int h, int w,
                                                 int cmid_pad, int bm) {
  const int bn = 16384 / bm, kc = 1024 / bn;
  return 4 * (inter_floats(g, h, w, cmid_pad) +
              2 * (patch_floats(Frame{g, h, w}, kc) + kc * 9 * bn));
}

template <int PG, int CG>
__global__ void __launch_bounds__(PG* CG, 1)
    double_conv_f32_kernel(const float* __restrict__ x,
                           const float* __restrict__ w1,
                           const float* __restrict__ b1,
                           const float* __restrict__ w2,
                           const float* __restrict__ b2,
                           float* __restrict__ y, int n, int h, int w,
                           int cin, int cmid, int cout, int cin_pad,
                           int cmid_pad, int cmid_cpad, int cout_pad, int g,
                           bool vec_in, bool vec_out) {
  using T = Threads<PG, CG>;
  constexpr int BN = T::kBN, KC = 1024 / BN, NT = T::kN;
  extern __shared__ __align__(16) float smem[];
  const Frame f{g, h, w};
  const int pitch = cmid_pad + 4, pf = patch_floats(f, KC);
  float* const inter = smem;
  float* const stage0 = smem + inter_floats(g, h, w, cmid_pad);
  float* const patch[2] = {stage0, stage0 + pf};
  float* const wst[2] = {stage0 + 2 * pf, stage0 + 2 * pf + KC * 9 * BN};
  const int img0 = blockIdx.x * g;

  for (int i = threadIdx.x * 4; i < inter_floats(g, h, w, cmid_pad);
       i += NT * 4)
    *reinterpret_cast<float4*>(inter + i) = make_float4(0.f, 0.f, 0.f, 0.f);

  const T t;
  const int pc = w + 2, px = h * w;
  int poff[8];    // pixel offsets in the patch / the intermediate
  int ioff[8];    // where the intermediate keeps pixel i (-1: none)
  float* rows[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = t.slot(i), s = m / px, r = (m - s * px) / w;
    const int c = m - s * px - r * w;
    const bool in = s < g && img0 + s < n;
    poff[i] = s < g ? (s * (h + 2) + r) * pc + c : 0;
    ioff[i] = in ? ((s * (h + 2) + r + 1) * pc + c + 1) * pitch : -1;
    rows[i] = in ? y + (((size_t)(img0 + s) * h + r) * w + c) * cout
                 : nullptr;
  }
  int pa[8], pi[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) pa[i] = poff[i] * KC, pi[i] = poff[i] * pitch;

  float acc[8][8], bb[8];
  // phase 1: conv1 -> the intermediate
  for (int n0 = 0; n0 < cmid; n0 += BN) {
    zero(acc);
    pipeline(
        cin_pad / KC,
        [&](int q, int b) {
          stage_patch<KC, NT>(patch[b], x, n, h, w, cin, f, img0, 0, 0,
                              q * KC, vec_in);
          stage_weights<KC, BN, NT>(wst[b], w1, cmid_cpad, q * KC, n0);
        },
        [&](int, int b) {
          fma_chunk<CG, KC>(acc, patch[b], KC, pa, pc, wst[b], t.cg);
        });
    load_bias<CG>(bb, b1, n0, t.cg, cmid);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      store_px<CG>(acc, i, bb, n0, t.cg, cmid,
                   ioff[i] < 0 ? nullptr : inter + ioff[i], true);
  }
  // phase 2: conv2 from the intermediate (the pipeline's first barrier
  // orders phase 1's writes before these reads)
  for (int n0 = 0; n0 < cout; n0 += BN) {
    zero(acc);
    pipeline(
        cmid_pad / KC,
        [&](int q, int b) {
          stage_weights<KC, BN, NT>(wst[b], w2, cout_pad, q * KC, n0);
        },
        [&](int q, int b) {
          fma_chunk<CG, KC>(acc, inter + q * KC, pitch, pi, pc, wst[b], t.cg);
        });
    load_bias<CG>(bb, b2, n0, t.cg, cout);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      store_px<CG>(acc, i, bb, n0, t.cg, cout, rows[i], vec_out);
  }
}

template <int PG, int CG>
int launch(const float* x, const float* w1, const float* b1, const float* w2,
           const float* b2, float* y, int n, int h, int w, int cin, int cmid,
           int cout, int cin_pad, int cmid_pad, int cmid_cpad, int cout_pad,
           int g, int smem, cudaStream_t stream) {
  const long long blocks = (n + g - 1) / g;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      double_conv_f32_kernel<PG, CG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec_in = cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_out =
      cout % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  double_conv_f32_kernel<PG, CG><<<(unsigned)blocks, PG * CG, smem, stream>>>(
      x, w1, b1, w2, b2, y, n, h, w, cin, cmid, cout, cin_pad, cmid_pad,
      cmid_cpad, cout_pad, g, vec_in, vec_out);
  return (int)cudaGetLastError();
}

}  // namespace f32
}  // namespace fabric

using namespace fabric::f32;

// x (n, h, w, cin) fp32; w1, w2: the weights packed by ops/conv.py
// pack_weight_f32 ([cin_pad][9][cmid_cpad] and [cmid_pad][9][cout_pad]:
// input channels rounded up to 8, output channels to 4); b1 (cmid,), b2
// (cout,) fp32; y (n, h, w, cout) fp32.  g images a block, g*h*w <= bm
// (32, 64 or 128).  Returns the CUDA error of the launch (0 on success).
extern "C" int fabric_double_conv3x3_bias_relu_f32(
    const void* x, const void* w1, const void* b1, const void* w2,
    const void* b2, void* y, int n, int h, int w, int cin, int cmid, int cout,
    int cin_pad, int cmid_pad, int cmid_cpad, int cout_pad, int g, int bm,
    void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cmid <= 0 || cout <= 0 ||
      g <= 0 || cin_pad % 8 || cin_pad < cin || cmid_pad % 8 ||
      cmid_pad < cmid || cmid_cpad % 4 || cmid_cpad < cmid || cout_pad % 4 ||
      cout_pad < cout || (bm != 32 && bm != 64 && bm != 128) ||
      g * h * w > bm || reinterpret_cast<uintptr_t>(w1) % 16 ||
      reinterpret_cast<uintptr_t>(w2) % 16)
    return (int)cudaErrorInvalidValue;
  const int smem = double_smem_bytes(g, h, w, cmid_pad, bm);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const auto* xs = static_cast<const float*>(x);
  const auto* w1s = static_cast<const float*>(w1);
  const auto* b1s = static_cast<const float*>(b1);
  const auto* w2s = static_cast<const float*>(w2);
  const auto* b2s = static_cast<const float*>(b2);
  auto* ys = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FABRIC_LAUNCH(PG, CG)                                                \
  launch<PG, CG>(xs, w1s, b1s, w2s, b2s, ys, n, h, w, cin, cmid, cout,     \
                 cin_pad, cmid_pad, cmid_cpad, cout_pad, g, smem, s)
  return bm == 32 ? FABRIC_LAUNCH(4, 64)
                  : bm == 64 ? FABRIC_LAUNCH(8, 32) : FABRIC_LAUNCH(16, 16);
#undef FABRIC_LAUNCH
}
