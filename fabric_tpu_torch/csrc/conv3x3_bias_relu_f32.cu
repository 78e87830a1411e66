// relu(conv3x3_SAME(x, K) + b) on NHWC float32: float32 products (3xTF32
// on the tensor cores), fp32 sums, fp32 out.  The float32 form of
// conv3x3_bias_relu.cu.
//
// Replaces the Pallas kernel fabric_tpu/ops/pallas_conv.py:91
// (conv3x3_bias_relu -> pl.pallas_call at :109), which computes in its
// input's dtype: its float32 form (fabric_tpu's dtype="float32" serving).
//
// Bound on the H100: a launch does 3 x 2 * N*H*W * 9*Cin*Cout TF32
// operations (three products per float32 product) at 495 TFLOP/s on
// N*H*W*(Cin+Cout)*4 bytes: ~4.5*Cin*Cout/(Cin+Cout) float32 products'
// operations per byte, 144 at Cin = Cout = 64, about three times the
// card's ridge for 3xTF32 (165 TFLOP/s effective over 3.35 TB/s, ~49), so
// every launch of the serving path is bound by the tensor cores except
// inc's first conv (13 channels in), which is bound by its bytes.
//
// What held the first version back (an FFMA core: 8 x 8 register tiles,
// ~200 registers a thread, one block per SM, 51% of the 67 TFLOP/s FFMA
// rate) and what this one does instead (the core is conv_tile_tf32x3.cuh,
// on the bf16 kernel's machinery):
//  - wgmma m64nPNk8 TF32 (PN = 64, or 128 where Cout > 64), three per 8
//    channels of K, from two consumer warpgroups, each 64 of the block's
//    128 output pixels, A split into hi and lo in registers;
//  - the weights, split and packed once (hi and lo planes, the wgmma
//    layout), stream through a ring of 4 shared-memory slots by
//    cp.async.bulk from a producer warpgroup, whose registers go to the
//    consumers (setmaxnreg);
//  - A by ldmatrix from the haloed patch, staged 16 channels at a time by
//    cp.async into two buffers, the next chunk loading during the current
//    one's nine taps;
//  - tiles of NI whole images x TR rows x TW columns (128 pixels);
//  - each 16-channel chunk summed by wgmma from zero and added into a
//    register sum, so every output's order of operations is independent
//    of its tile (banded = whole, the fused double conv = two launches);
//  - bias and ReLU in registers, 16-byte stores.
#include "conv_tile_tf32x3.cuh"

namespace fabric {
namespace x3 {

// Blocks per SM: at PN = 128 one (the consumers' 232 registers hold a
// thread's 64 sums, 64 wgmma accumulators and 32 fragment registers); at
// PN = 64 two (104 registers, a few spilled: on the H100 20-32% faster
// than one block at the main path's PN = 64 convs).
template <int PN>
constexpr int kBlocks = PN == 64 ? 2 : 1;

template <int PN>
__global__ void __launch_bounds__(kThreads, kBlocks<PN>)
    conv3x3_bias_relu_f32_kernel(const float* __restrict__ x,
                                 const float* __restrict__ wpk,
                                 const float* __restrict__ bias,
                                 float* __restrict__ y, int n, int h, int w,
                                 int cin, int cout, int cin_pad, Geo g,
                                 int tiles_h, int tiles_w, int stages,
                                 bool vec_in, bool vec_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int sbytes = stage_bytes(PN), pbytes = patch_bytes(g);
  unsigned char* patch[2] = {smem + stages * sbytes,
                             smem + stages * sbytes + pbytes};
  Ring ring = make_ring(smem, smem + stages * sbytes + 2 * pbytes, stages,
                        sbytes);

  int tile = blockIdx.x;
  const int j0 = (tile % tiles_w) << g.tw;
  tile /= tiles_w;
  const int i0 = (tile % tiles_h) << g.tr;
  const int img0 = (tile / tiles_h) << g.ni;
  const int nt = blockIdx.y;

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup
    regs_dec<Regs<kBlocks<PN>>::producer>();
    if (threadIdx.x == kConsumers)
      produce(ring, wpk, cin_pad * 4, 2 * PN, nt, nt + 1, 1, 1);
    return;
  }
  regs_inc<Regs<kBlocks<PN>>::consumer>();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mbase = (warp >> 2) * 64 + (warp & 3) * 16;
  const uint32_t a_off = patch_row_offset(mbase + (lane & 15), g);
  const int pc = (1 << g.tw) + 2;
  constexpr int KC = kKB / 4;  // fp32 channels per staged chunk

  float sum[PN / 2];
#pragma unroll
  for (int i = 0; i < PN / 2; ++i) sum[i] = 0.f;

  const int n_chunks = (cin_pad + KC - 1) / KC;
  stage_patch<4>(patch[0], x, n, h, w, cin, g, img0, i0, j0, 0,
                 min(KC, cin_pad), vec_in);
  cp_async_commit();
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int c0 = ci * KC, kc = min(KC, cin_pad - c0);
    cp_async_wait_all();
    consumer_sync();  // chunk ci landed; chunk ci - 1 is no longer read
    if (ci + 1 < n_chunks) {
      stage_patch<4>(patch[(ci + 1) & 1], x, n, h, w, cin, g, img0, i0, j0,
                     c0 + KC, min(KC, cin_pad - c0 - KC), vec_in);
      cp_async_commit();
    }
    mma_chunk<PN>(sum, ring, smem_addr(patch[ci & 1]) + a_off, pc * kPitch,
                  kPitch, kc * 4);
  }

  float* rows[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const Px p = chunk_pixel(mbase + (lane >> 2) + 8 * half, g);
    const int on = img0 + p.s, oi = i0 + p.r, oj = j0 + p.c;
    rows[half] = on < n && oi < h && oj < w
                     ? y + (((size_t)on * h + oi) * w + oj) * cout
                     : nullptr;
  }
  store_global<PN>(sum, bias, nt * PN, cout, rows, vec_out);
}

template <int PN>
int launch(const float* x, const float* wpk, const float* bias, float* y,
           int n, int h, int w, int cin, int cout, int cin_pad, Geo g,
           int stages, int smem, cudaStream_t stream) {
  const int tiles_h = (h + (1 << g.tr) - 1) >> g.tr;
  const int tiles_w = (w + (1 << g.tw) - 1) >> g.tw;
  const long long tiles_n = (n + (1 << g.ni) - 1) >> g.ni;
  const long long blocks = tiles_n * tiles_h * tiles_w;
  const int n_tiles = (cout + PN - 1) / PN;
  if (blocks > 0x7fffffffLL || n_tiles > 65535)
    return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_bias_relu_f32_kernel<PN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec_in = cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_out =
      cout % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  dim3 grid((unsigned)blocks, n_tiles);
  conv3x3_bias_relu_f32_kernel<PN><<<grid, kThreads, smem, stream>>>(
      x, wpk, bias, y, n, h, w, cin, cout, cin_pad, g, tiles_h, tiles_w,
      stages, vec_in, vec_out);
  return (int)cudaGetLastError();
}

}  // namespace x3
}  // namespace fabric

using namespace fabric;

// Dynamic shared memory of one block: the weight ring (stages slots of a
// hi and a lo block of pn x 16 fp32 channels), two staged patches of
// geometry (tw, tr, ni) (log2s) and 16 bytes of barriers per slot.
extern "C" int fabric_conv3x3_f32_smem_bytes(int pn, int tw, int tr, int ni,
                                             int stages) {
  return stages * x3::stage_bytes(pn) + 2 * patch_bytes(Geo{tw, tr, ni}) +
         16 * stages;
}

// x (n, h, w, cin) fp32; wpk: the weights split and packed by ops/conv.py
// pack_weight_f32 (cin_pad = cin rounded up to 8, N tiles of pn = 64 or
// 128 channels, a hi and a lo block per tap); bias (cout,) fp32; y (n, h,
// w, cout) fp32.  (tw, tr, ni): log2 of the tile's columns, rows and
// images, tw + tr + ni = 7.  Returns the CUDA error of the launch (0 on
// success).
extern "C" int fabric_conv3x3_bias_relu_f32(const void* x, const void* wpk,
                                            const void* bias, void* y, int n,
                                            int h, int w, int cin, int cout,
                                            int cin_pad, int pn, int tw,
                                            int tr, int ni, int stages,
                                            void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || cin_pad % 8 ||
      cin_pad < cin || (pn != 64 && pn != 128) || tw < 0 || tr < 0 ||
      ni < 0 || tw + tr + ni != 7 || stages < 2 ||
      reinterpret_cast<uintptr_t>(wpk) % 16)
    return (int)cudaErrorInvalidValue;
  const int smem = fabric_conv3x3_f32_smem_bytes(pn, tw, tr, ni, stages);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const Geo g{tw, tr, ni};
  const auto* xs = static_cast<const float*>(x);
  const auto* ws = static_cast<const float*>(wpk);
  const auto* bs = static_cast<const float*>(bias);
  auto* ys = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pn == 64 ? x3::launch<64>(xs, ws, bs, ys, n, h, w, cin, cout,
                                   cin_pad, g, stages, smem, s)
                  : x3::launch<128>(xs, ws, bs, ys, n, h, w, cin, cout,
                                    cin_pad, g, stages, smem, s);
}
