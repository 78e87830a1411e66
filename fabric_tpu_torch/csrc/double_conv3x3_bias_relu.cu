// relu(conv3x3(relu(conv3x3(x, W1) + b1), W2) + b2), SAME padding, on NHWC
// bf16 with fp32 accumulation; the intermediate never leaves the SM.
//
// Replaces the Pallas kernel fabric_tpu/ops/pallas_double_conv.py:190
// (double_conv3x3_bias_relu -> pl.pallas_call at :212, body _kernel at :152).
//
// Bound on the H100: at the levels the serving path sends here (16x16 and
// smaller images, 128-1024 channels) a block does 2*9*(Cin*Cmid +
// Cmid*Cout) operations per pixel against 2*(Cin + Cout) bytes in and
// out: thousands of operations per byte, far above the card's ridge
// (~295), so it is bound by the tensor cores (989 TFLOP/s bf16).  Run as
// two convs it would also write and read back the (N, H, W, Cmid)
// intermediate; that round trip is what the fused kernel removes.
//
// What held the first version back: one block per image looping over
// every tile, N slice and channel chunk of both convs; 128-pixel tiles of
// which a 4x4 image filled 16 rows and an 8x8 one 64 (11 TFLOP/s at 4x4);
// B fragments read from L2 right before each mma.sync, both weight sets
// re-read per image; no overlap of loads and math.  This version (the
// core is conv_tile.cuh):
//  - a block takes G whole images (as the Pallas kernel's group_size) and
//    runs both convs over M chunks of NI whole images x TR rows x TW
//    columns, 128 pixels (the two consumer warpgroups take 64 rows each)
//    or, where G images of 128 pixels would not fit, 64 pixels (both
//    warpgroups on the same rows, each its own N tile): 4 images of 4x4
//    per block at down4, 1 of 8x8 at down3, 2 of 8x8 at up1, 1 of 16x16
//    or 32x32 at down2, up2 and up3;
//  - conv1 (wgmma, A by ldmatrix from the cp.async-staged haloed input
//    patch) writes relu(acc + b1), rounded to bf16, into a G x (H+2) x
//    (W+2) x Cmid intermediate in shared memory whose zero frame is
//    conv2's SAME padding; conv2 reads its A operand from there;
//  - both convs' weights, packed once in the wgmma layout, stream through
//    one ring of 3-4 shared-memory slots fed by a producer warp with
//    cp.async.bulk, each slot read by every warp of the block;
//  - bias, ReLU and bf16 rounding in registers, 16-byte output stores.
// The block's shared memory (intermediate + two input patches + ring) has
// to fit 227 KB; ops/double_conv.py plans G, the chunk and the stages and
// its gate refuses what does not fit (inc, down1 and up4 at patch 64).
#include "conv_tile.cuh"

namespace fabric {

// bf16 per intermediate pixel: channels rounded up to the mma depth (16),
// plus 8 so that neighbouring pixels start in different bank groups.
__host__ __device__ inline int inter_pitch(int cmid) {
  return round_up(cmid, 16) + 8;
}

__host__ __device__ inline long long inter_bytes(int g_imgs, int h, int w,
                                                 int cmid) {
  return round_up((int)((long long)g_imgs * (h + 2) * (w + 2) *
                        inter_pitch(cmid) * 2),
                  128);
}

template <int PN1, int PN2>
__global__ void __launch_bounds__(kConvThreads, 1)
    double_conv_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w1pk,
                       const float* __restrict__ b1,
                       const __nv_bfloat16* __restrict__ w2pk,
                       const float* __restrict__ b2,
                       __nv_bfloat16* __restrict__ y, int n, int h, int w,
                       int cin, int cmid, int cout, int cin_pad, Geo g,
                       int group, int split_n, int stages, int stage_bytes,
                       bool vec_in, bool vec_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int pbytes = patch_bytes(g);
  const long long ibytes = inter_bytes(group, h, w, cmid);
  unsigned char* p0 = smem + stages * stage_bytes;
  unsigned char* patch[2] = {p0, p0 + pbytes};
  __nv_bfloat16* inter = reinterpret_cast<__nv_bfloat16*>(p0 + 2 * pbytes);
  Ring ring = make_ring(smem, p0 + 2 * pbytes + ibytes, stages, stage_bytes);

  const int img0 = blockIdx.x * group;
  const int tiles_h = (h + (1 << g.tr) - 1) >> g.tr;
  const int tiles_w = (w + (1 << g.tw) - 1) >> g.tw;
  const int n_mc = (group >> g.ni) * tiles_h * tiles_w;
  const int cmid16 = round_up(cmid, 16);
  const int n_t1 = (cmid + PN1 - 1) / PN1, n_t2 = (cout + PN2 - 1) / PN2;
  const int t_step = split_n ? 2 : 1;

  if (threadIdx.x >= kConsumers) {  // the producer warp
    if (threadIdx.x == kConsumers) {
      produce(ring, w1pk, cin_pad * 2, PN1, 0, n_t1, t_step, n_mc);
      produce(ring, w2pk, cmid16 * 2, PN2, 0, n_t2, t_step, n_mc);
    }
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int part = split_n ? wg : 0;  // N tile of this warpgroup in a slot
  const int mbase = (split_n ? 0 : wg * 64) + (warp & 3) * 16;
  const int ipitch = inter_pitch(cmid);

  // zero the intermediate: its frame is conv2's padding
  for (long long i = threadIdx.x; i < ibytes / 16; i += kConsumers)
    reinterpret_cast<uint4*>(inter)[i] = make_uint4(0, 0, 0, 0);

  auto chunk_origin = [&](int mc, int& s_off, int& i0, int& j0) {
    j0 = (mc % tiles_w) << g.tw;
    i0 = ((mc / tiles_w) % tiles_h) << g.tr;
    s_off = (mc / (tiles_w * tiles_h)) << g.ni;
  };

  // ---- conv1: input patch -> intermediate ----
  {
    const uint32_t a_off = patch_row_offset(mbase + (lane & 15), g);
    const int pc = (1 << g.tw) + 2;
    const int n_ci = (cin_pad + kKC - 1) / kKC;
    const int n_ts = (n_t1 + t_step - 1) / t_step;
    // patches are staged in the order they are taken: M chunk x N tile
    // step x K chunk; q counts them and picks the buffer
    const int total = n_mc * n_ts * n_ci;
    auto stage = [&](int q) {
      const int ci = q % n_ci;
      int s_off, i0, j0;
      chunk_origin(q / (n_ci * n_ts), s_off, i0, j0);
      stage_patch<2>(patch[q & 1], x, n, h, w, cin, g, img0 + s_off, i0,
                     j0, ci * kKC, min(kKC, cin_pad - ci * kKC), vec_in);
      cp_async_commit();
    };
    stage(0);
    int q = 0;
    for (int mc = 0; mc < n_mc; ++mc) {
      int s_off, i0, j0;
      chunk_origin(mc, s_off, i0, j0);
      for (int ts = 0; ts < n_ts; ++ts) {
        float acc[PN1 / 2];
#pragma unroll
        for (int i = 0; i < PN1 / 2; ++i) acc[i] = 0.f;
        for (int ci = 0; ci < n_ci; ++ci, ++q) {
          cp_async_wait_all();
          consumer_sync();  // patch q landed; patch q - 1 is no longer read
          if (q + 1 < total) stage(q + 1);
          mma_chunk<PN1>(acc, ring, smem_addr(patch[q & 1]) + a_off,
                         pc * kPitch, kPitch,
                         min(kKC, cin_pad - ci * kKC) * 2, part);
        }
        const int t = ts * t_step + part;
        if (t >= n_t1) continue;  // no N tile left for this warpgroup
        __nv_bfloat16* rows[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const Px p = chunk_pixel(mbase + (lane >> 2) + 8 * half, g);
          const int s = s_off + p.s, oi = i0 + p.r, oj = j0 + p.c;
          rows[half] = img0 + s < n && oi < h && oj < w
                           ? inter + ((size_t)(s * (h + 2) + oi + 1) * (w + 2) +
                                      oj + 1) * ipitch
                           : nullptr;
        }
        store_shared<PN1>(acc, b1, t * PN1, cmid, cmid16, rows);
      }
    }
  }
  consumer_sync();  // the whole intermediate is written

  // ---- conv2: intermediate -> y ----
  {
    const int n_ci = (cmid16 + kKC - 1) / kKC;
    for (int mc = 0; mc < n_mc; ++mc) {
      int s_off, i0, j0;
      chunk_origin(mc, s_off, i0, j0);
      // this lane's ldmatrix row, clamped into the image (rows past it are
      // computed and dropped)
      const Px a = chunk_pixel(mbase + (lane & 15), g);
      const int as = min(s_off + a.s, group - 1), ai = min(i0 + a.r, h - 1),
                aj = min(j0 + a.c, w - 1);
      const uint32_t a_addr =
          smem_addr(inter) +
          (((as * (h + 2) + ai) * (w + 2) + aj) * ipitch + (lane >> 4) * 8) *
              2;
      for (int t0 = 0; t0 < n_t2; t0 += t_step) {
        float acc[PN2 / 2];
#pragma unroll
        for (int i = 0; i < PN2 / 2; ++i) acc[i] = 0.f;
        for (int ci = 0; ci < n_ci; ++ci)
          mma_chunk<PN2>(acc, ring, a_addr + ci * kKC * 2,
                         (w + 2) * ipitch * 2, ipitch * 2,
                         min(kKC, cmid16 - ci * kKC) * 2, part);
        const int t = t0 + part;
        if (t >= n_t2) continue;  // no N tile left for this warpgroup
        __nv_bfloat16* rows[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const Px p = chunk_pixel(mbase + (lane >> 2) + 8 * half, g);
          const int on = img0 + s_off + p.s, oi = i0 + p.r, oj = j0 + p.c;
          rows[half] = on < n && oi < h && oj < w
                           ? y + (((size_t)on * h + oi) * w + oj) * cout
                           : nullptr;
        }
        store_global<PN2>(acc, b2, t * PN2, cout, rows, vec_out);
      }
    }
  }
}

template <int PN1, int PN2>
int launch(const void* x, const void* w1pk, const void* b1, const void* w2pk,
           const void* b2, void* y, int n, int h, int w, int cin, int cmid,
           int cout, int cin_pad, Geo g, int group, int split_n, int stages,
           int stage_bytes, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      double_conv_kernel<PN1, PN2>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec_in =
      cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_out =
      cout % 8 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int blocks = (n + group - 1) / group;
  double_conv_kernel<PN1, PN2><<<blocks, kConvThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w1pk), static_cast<const float*>(b1),
      static_cast<const __nv_bfloat16*>(w2pk), static_cast<const float*>(b2),
      static_cast<__nv_bfloat16*>(y), n, h, w, cin, cmid, cout, cin_pad, g,
      group, split_n, stages, stage_bytes, vec_in, vec_out);
  return (int)cudaGetLastError();
}

}  // namespace fabric

using namespace fabric;

// Dynamic shared memory one block needs: the ring (stages slots of the
// wider of the two convs' N tiles x 32 bf16, twice that when the
// warpgroups split N), two staged input patches of the chunk geometry,
// the intermediate of `group` images and 16 bytes of barriers per slot.
// ops/double_conv.py mirrors this formula.
extern "C" long long fabric_double_conv_smem_bytes(int h, int w, int cmid,
                                                   int pn_max, int tw, int tr,
                                                   int ni, int group,
                                                   int split_n, int stages) {
  const long long stage = (long long)pn_max * kKB * (split_n ? 2 : 1);
  return stages * stage + 2LL * patch_bytes(Geo{tw, tr, ni}) +
         inter_bytes(group, h, w, cmid) + 16LL * stages;
}

// x (n, h, w, cin) bf16; w1pk, w2pk: the two kernels packed by ops/conv.py
// pack_weight (cin_pad = cin rounded up to 16; N tiles of pn1, pn2 = 64 or
// 128 channels); b1 (cmid,), b2 (cout,) fp32; y (n, h, w, cout) bf16.
// (tw, tr, ni): log2 of the M chunk's columns, rows and images (7 in all,
// or 6 with split_n); `group` = 1 << ni images per block (several only
// when each chunk holds whole images); `stages` ring slots.  Returns the
// CUDA error of the launch (0 on success); cudaErrorInvalidValue when the
// plan does not hold or the block would need more than 227 KB.
extern "C" int fabric_double_conv3x3_bias_relu(
    const void* x, const void* w1pk, const void* b1, const void* w2pk,
    const void* b2, void* y, int n, int h, int w, int cin, int cmid, int cout,
    int cin_pad, int pn1, int pn2, int tw, int tr, int ni, int group,
    int split_n, int stages, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cmid <= 0 || cout <= 0 ||
      cin_pad % 16 || cin_pad < cin || (pn1 != 64 && pn1 != 128) ||
      (pn2 != 64 && pn2 != 128) || tw < 0 || tr < 0 || ni < 0 ||
      tw + tr + ni != (split_n ? 6 : 7) || group != (1 << ni) ||
      (ni > 0 && ((1 << tw) < w || (1 << tr) < h)) || stages < 2 ||
      reinterpret_cast<uintptr_t>(w1pk) % 16 ||
      reinterpret_cast<uintptr_t>(w2pk) % 16)
    return (int)cudaErrorInvalidValue;
  const int pn_max = pn1 > pn2 ? pn1 : pn2;
  const long long smem = fabric_double_conv_smem_bytes(
      h, w, cmid, pn_max, tw, tr, ni, group, split_n, stages);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int stage_bytes = pn_max * kKB * (split_n ? 2 : 1);
  const Geo g{tw, tr, ni};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FABRIC_LAUNCH(P1, P2)                                                  \
  launch<P1, P2>(x, w1pk, b1, w2pk, b2, y, n, h, w, cin, cmid, cout, cin_pad, \
                 g, group, split_n, stages, stage_bytes, (int)smem, s)
  if (pn1 == 64)
    return pn2 == 64 ? FABRIC_LAUNCH(64, 64) : FABRIC_LAUNCH(64, 128);
  return pn2 == 64 ? FABRIC_LAUNCH(128, 64) : FABRIC_LAUNCH(128, 128);
#undef FABRIC_LAUNCH
}
