// relu(conv3x3_SAME(x, K) + b) on NHWC bf16, fp32 accumulation.
//
// Replaces the Pallas kernel fabric_tpu/ops/pallas_conv.py:91
// (conv3x3_bias_relu -> pl.pallas_call at :109, body _conv_kernel at :69).
//
// Bound on the H100: a launch does 2 * N*H*W * 9*Cin*Cout operations over
// N*H*W*(Cin+Cout)*2 bytes, ~9*Cin*Cout/(Cin+Cout) operations per byte:
// ~290 at Cin = Cout = 64, the card's ridge (989 TFLOP/s over 3.35 TB/s),
// so the full-resolution launches of the serving path (inc, down1, up4)
// need both the tensor cores and memory near their peaks.  inc's first
// conv (13 channels in) is bound by its bytes.
//
// What held the first version back (mma.sync from B fragments read with
// __ldg right before each mma, scalar A loads, nothing overlapped, four
// warps re-reading the same weights, the patch re-staged per 64 output
// channels) and what this one does instead (the core is conv_tile.cuh):
//  - wgmma m64nPNk16 (PN = 64, or 128 where Cout > 64, so each staged
//    pixel feeds up to 128 channels) from two consumer warpgroups, each
//    64 of the block's 128 output pixels;
//  - the weights, packed once in the wgmma layout, stream through a ring
//    of 4 shared-memory slots by cp.async.bulk from a producer warp, so
//    every warp reads one copy and loads run ahead of the math;
//  - A by ldmatrix from the haloed patch, staged 32 channels at a time by
//    cp.async into two buffers, the next chunk loading during the current
//    one's nine taps;
//  - tiles of NI whole images x TR rows x TW columns (128 pixels), so
//    small images do not leave most of a tile empty;
//  - bias, ReLU and bf16 rounding in registers, 16-byte stores.
#include "conv_tile.cuh"

namespace fabric {

// Blocks per SM, as measured on the H100: at PN = 64 three (the register
// cap this sets makes ptxas serialize some wgmma, yet three blocks beat
// two, since more warpgroups hide each one's barrier and ldmatrix waits);
// at PN = 128 one (two would cap a thread at 96 registers, and the 64
// accumulators spill).
template <int PN>
__global__ void __launch_bounds__(kConvThreads, PN == 64 ? 3 : 1)
    conv3x3_bias_relu_kernel(const __nv_bfloat16* __restrict__ x,
                             const __nv_bfloat16* __restrict__ wpk,
                             const float* __restrict__ bias,
                             __nv_bfloat16* __restrict__ y, int n, int h,
                             int w, int cin, int cout, int cin_pad, Geo g,
                             int tiles_h, int tiles_w, int stages,
                             bool vec_in, bool vec_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int stage_bytes = PN * kKB, pbytes = patch_bytes(g);
  unsigned char* patch[2] = {smem + stages * stage_bytes,
                             smem + stages * stage_bytes + pbytes};
  Ring ring = make_ring(smem, smem + stages * stage_bytes + 2 * pbytes,
                        stages, stage_bytes);

  int tile = blockIdx.x;
  const int j0 = (tile % tiles_w) << g.tw;
  tile /= tiles_w;
  const int i0 = (tile % tiles_h) << g.tr;
  const int img0 = (tile / tiles_h) << g.ni;
  const int nt = blockIdx.y;

  if (threadIdx.x >= kConsumers) {  // the producer warp
    if (threadIdx.x == kConsumers)
      produce(ring, wpk, cin_pad * 2, PN, nt, nt + 1, 1, 1);
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mbase = (warp >> 2) * 64 + (warp & 3) * 16;
  const uint32_t a_off = patch_row_offset(mbase + (lane & 15), g);
  const int pc = (1 << g.tw) + 2;

  float acc[PN / 2];
#pragma unroll
  for (int i = 0; i < PN / 2; ++i) acc[i] = 0.f;

  const int n_chunks = (cin_pad + kKC - 1) / kKC;
  stage_patch<2>(patch[0], x, n, h, w, cin, g, img0, i0, j0, 0,
                 min(kKC, cin_pad), vec_in);
  cp_async_commit();
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int c0 = ci * kKC, kc = min(kKC, cin_pad - c0);
    cp_async_wait_all();
    consumer_sync();  // chunk ci landed; chunk ci - 1 is no longer read
    if (ci + 1 < n_chunks) {
      stage_patch<2>(patch[(ci + 1) & 1], x, n, h, w, cin, g, img0, i0, j0,
                     c0 + kKC, min(kKC, cin_pad - c0 - kKC), vec_in);
      cp_async_commit();
    }
    mma_chunk<PN>(acc, ring, smem_addr(patch[ci & 1]) + a_off,
                  pc * kPitch, kPitch, kc * 2, 0);
  }

  __nv_bfloat16* rows[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const Px p = chunk_pixel(mbase + (lane >> 2) + 8 * half, g);
    const int on = img0 + p.s, oi = i0 + p.r, oj = j0 + p.c;
    rows[half] = on < n && oi < h && oj < w
                     ? y + (((size_t)on * h + oi) * w + oj) * cout
                     : nullptr;
  }
  store_global<PN>(acc, bias, nt * PN, cout, rows, vec_out);
}

template <int PN>
int launch(const void* x, const void* wpk, const void* bias, void* y, int n,
           int h, int w, int cin, int cout, int cin_pad, Geo g, int stages,
           int smem, cudaStream_t stream) {
  const int tiles_h = (h + (1 << g.tr) - 1) >> g.tr;
  const int tiles_w = (w + (1 << g.tw) - 1) >> g.tw;
  const long long tiles_n = (n + (1 << g.ni) - 1) >> g.ni;
  const long long blocks = tiles_n * tiles_h * tiles_w;
  const int n_tiles = (cout + PN - 1) / PN;
  if (blocks > 0x7fffffffLL || n_tiles > 65535)
    return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_bias_relu_kernel<PN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec_in =
      cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_out =
      cout % 8 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  dim3 grid((unsigned)blocks, n_tiles);
  conv3x3_bias_relu_kernel<PN><<<grid, kConvThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wpk), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(y), n, h, w, cin, cout, cin_pad, g,
      tiles_h, tiles_w, stages, vec_in, vec_out);
  return (int)cudaGetLastError();
}

}  // namespace fabric

using namespace fabric;

// Dynamic shared memory of one block: the weight ring (stages slots of pn
// x 32 bf16 channels), two staged patches of geometry (tw, tr, ni) (log2s) and 16
// bytes of barriers per slot.  ops/conv.py mirrors this formula.
extern "C" int fabric_conv3x3_smem_bytes(int pn, int tw, int tr, int ni,
                                         int stages) {
  return stages * pn * kKB + 2 * patch_bytes(Geo{tw, tr, ni}) +
         16 * stages;
}

// x (n, h, w, cin) bf16; wpk: the weights packed by ops/conv.py
// pack_weight (cin_pad = cin rounded up to 16, N tiles of pn = 64 or 128
// channels); bias (cout,) fp32; y (n, h, w, cout) bf16.  (tw, tr, ni):
// log2 of the tile's columns, rows and images, tw + tr + ni = 7.  Returns
// the CUDA error of the launch (0 on success).
extern "C" int fabric_conv3x3_bias_relu(const void* x, const void* wpk,
                                        const void* bias, void* y, int n,
                                        int h, int w, int cin, int cout,
                                        int cin_pad, int pn, int tw, int tr,
                                        int ni, int stages, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 ||
      cin_pad % 16 || cin_pad < cin || (pn != 64 && pn != 128) || tw < 0 ||
      tr < 0 || ni < 0 || tw + tr + ni != 7 || stages < 2 ||
      reinterpret_cast<uintptr_t>(wpk) % 16)
    return (int)cudaErrorInvalidValue;
  const int smem = fabric_conv3x3_smem_bytes(pn, tw, tr, ni, stages);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const Geo g{tw, tr, ni};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pn == 64 ? launch<64>(x, wpk, bias, y, n, h, w, cin, cout, cin_pad,
                               g, stages, smem, s)
                  : launch<128>(x, wpk, bias, y, n, h, w, cin, cout, cin_pad,
                                g, stages, smem, s);
}
