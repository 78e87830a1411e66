// relu(conv3x3(relu(conv3x3(x, K1) + b1), K2) + b2) on NHWC float32, the
// fp32 intermediate kept in the shared memory of a thread-block cluster:
// the float32 form of double_conv3x3_bias_relu.cu, on the 3xTF32 core.
//
// Replaces the Pallas kernel fabric_tpu/ops/pallas_double_conv.py:190
// (double_conv3x3_bias_relu -> pl.pallas_call at :212), which computes in
// its input's dtype: its float32 form.
//
// Bound on the H100: the two convs' 3 x 2 * N*H*W * 9 * (Cin*Cmid +
// Cmid*Cout) TF32 operations at 495 TFLOP/s (three products per float32
// product); the bytes are the input, both weights and the output once (the
// intermediate never reaches device memory).
//
// What held the first version back: an FFMA core, and a block that kept
// its G images' whole fp32 intermediate (4 bytes an element) in its own
// shared memory, so only 32-64 pixels fit a block, each block re-read
// every weight of both convs for them, and the fused kernel lost to two
// conv launches (1.40x at down4).  This version (the core is
// conv_tile_tf32x3.cuh):
//  - a cluster of C blocks shares one group of G whole images (the conv
//    kernel's M chunk: G*H*W <= 128 pixels, 8 images of 4x4 at down4, 2 of
//    8x8 at down3 and up1); block r holds T of conv1's N tiles of PN1
//    channels (C = Cmid / (T PN1); ops/double_conv.py plan_f32 picks T);
//  - conv1: block r computes intermediate channels [r T PN1, (r+1) T PN1)
//    of the group from staged input patches (the conv kernel's wgmma loop)
//    into a slice of its own shared memory, G x H x W x (T PN1 + 4) floats;
//  - after a cluster barrier, conv2: block r computes output tiles r, r +
//    C, ..., each 16-channel K chunk staged into its patch buffer from the
//    slice of the block that owns it (distributed shared memory: the
//    slices of the cluster hold C times one block's intermediate), zeros
//    outside the images; a thread loads its pieces of the next chunk into
//    registers before the current chunk's wgmma and stores them after;
//  - each block streams only its own N tiles' weights (1/C of each conv's),
//    through the ring by cp.async.bulk, so a weight byte serves G*H*W
//    pixels, as in the conv kernel;
//  - a second cluster barrier keeps every slice alive until the last read.
// TMA multicast of the weights was the other way to share them: it would
// keep every block's whole intermediate (G = 2 images of 4x4 at down4) and
// leave most of each 64-row wgmma empty.  Each output sums in the conv
// kernel's order (the same 16-channel chunks, taps and 3xTF32 steps, the
// same PN), so this equals two conv3x3_bias_relu_f32 launches bit for bit.
#include "conv_tile_tf32x3.cuh"

namespace fabric {
namespace x3 {

// floats per pixel of a block's intermediate slice: its conv1 tile's PN1
// channels plus 4 (neighbouring pixels start in other banks)
__host__ __device__ inline int slice_pitch(int pn1) { return pn1 + 4; }

__host__ __device__ inline int slice_bytes(int group, int h, int w,
                                           int pn1) {
  return round_up(group * h * w * slice_pitch(pn1) * 4, 128);
}

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return (int)r;
}

// The generic address of p's counterpart in the shared memory of block
// `rank` of the cluster.
__device__ __forceinline__ const float* map_rank(const float* p, int rank) {
  uint64_t r;
  asm volatile("mapa.u64 %0, %1, %2;\n"
               : "=l"(r)
               : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<const float*>(r);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// One conv2 K chunk of the patch of an M chunk, read from a block's slice
// (group_n images of h x w, `pitch` floats a pixel, by generic address:
// this block's or another's in the cluster): channels [coff, coff + kc)
// of the pixels of images s_off.., rows i0 - 1.., columns j0 - 1.., zeros
// outside the images; `total` 16-byte pieces.
struct SliceChunk {
  const float* src;
  int coff, kc, s_off, i0, j0, total;
};

// Piece idx of chunk c: its value into v, its byte offset in the patch.
__device__ __forceinline__ int slice_piece(const SliceChunk& c, int idx,
                                           int group_n, int h, int w,
                                           int pitch, Geo g, uint4& v) {
  const int pc = (1 << g.tw) + 2, pimg = ((1 << g.tr) + 2) * pc;
  const int groups = c.kc / 4;
  const int q = idx % groups, p = idx / groups;
  const int s = p / pimg, rem = p - s * pimg;
  const int gs = c.s_off + s, gi = c.i0 - 1 + rem / pc,
            gj = c.j0 - 1 + rem % pc;
  v = make_uint4(0, 0, 0, 0);
  if (gs < group_n && gi >= 0 && gi < h && gj >= 0 && gj < w)
    v = *reinterpret_cast<const uint4*>(
        c.src + ((size_t)(gs * h + gi) * w + gj) * pitch + c.coff + 4 * q);
  return p * kPitch + q * 16;
}

// Pieces of a chunk a consumer thread loads ahead, into registers, before
// the previous chunk's wgmma, and stores after them: the remote reads'
// latency hides behind the math.
constexpr int kAhead = 8;

template <int PN1, int PN2>
__global__ void __launch_bounds__(kThreads, 1)
    double_conv_f32_kernel(const float* __restrict__ x,
                           const float* __restrict__ w1pk,
                           const float* __restrict__ b1,
                           const float* __restrict__ w2pk,
                           const float* __restrict__ b2,
                           float* __restrict__ y, int n, int h, int w,
                           int cin, int cmid, int cout, int cin_pad,
                           int cmid_pad, Geo g, int group, int tiles1,
                           int stages, int sbytes, bool vec_in,
                           bool vec_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int rank = cluster_rank(), csize = cluster_size();
  const int pbytes = patch_bytes(g);
  unsigned char* p0 = smem + stages * sbytes;
  unsigned char* patch[2] = {p0, p0 + pbytes};
  float* slice = reinterpret_cast<float*>(p0 + 2 * pbytes);
  Ring ring = make_ring(
      smem, p0 + 2 * pbytes + slice_bytes(group, h, w, tiles1 * PN1),
      stages, sbytes);

  const int img0 = (blockIdx.x / csize) * group;
  const int group_n = min(group, n - img0);
  const int tiles_h = (h + (1 << g.tr) - 1) >> g.tr;
  const int tiles_w = (w + (1 << g.tw) - 1) >> g.tw;
  const int n_mc = ((group + (1 << g.ni) - 1) >> g.ni) * tiles_h * tiles_w;
  const int n_t1 = (cmid + PN1 - 1) / PN1, n_t2 = (cout + PN2 - 1) / PN2;
  const int t1_first = rank * tiles1, t1_end = min(t1_first + tiles1, n_t1);
  const int sch = tiles1 * PN1;  // channels of a slice
  const int pitch = slice_pitch(sch);

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup
    regs_dec<Regs<1>::producer>();
    cluster_arrive();  // it writes nothing the cluster reads
    if (threadIdx.x == kConsumers) {
      produce(ring, w1pk, cin_pad * 4, 2 * PN1, t1_first, t1_end, 1, n_mc);
      for (int mc = 0; mc < n_mc; ++mc)
        for (int t = rank; t < n_t2; t += csize)
          produce(ring, w2pk, cmid_pad * 4, 2 * PN2, t, t + 1, 1, 1);
    }
    cluster_wait();
    cluster_arrive();
    cluster_wait();
    return;
  }
  regs_inc<Regs<1>::consumer>();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mbase = (warp >> 2) * 64 + (warp & 3) * 16;
  const uint32_t a_off = patch_row_offset(mbase + (lane & 15), g);
  const int pc = (1 << g.tw) + 2, pimg = ((1 << g.tr) + 2) * pc;
  constexpr int KC = kKB / 4;  // fp32 channels per staged chunk

  auto origin = [&](int mc, int& s_off, int& i0, int& j0) {
    j0 = (mc % tiles_w) << g.tw;
    i0 = ((mc / tiles_w) % tiles_h) << g.tr;
    s_off = (mc / (tiles_w * tiles_h)) << g.ni;
  };

  // ---- conv1: input patches -> this block's slice of the intermediate ----
  {
    const int n_ci = (cin_pad + KC - 1) / KC, n_t = t1_end - t1_first;
    const int total = n_mc * n_t * n_ci;
    // patches are staged in the order they are taken: M chunk x N tile x
    // K chunk; q counts them and picks the buffer
    auto stage = [&](int q) {
      const int ci = q % n_ci;
      int s_off, i0, j0;
      origin(q / (n_ci * n_t), s_off, i0, j0);
      stage_patch<4>(patch[q & 1], x, img0 + group_n, h, w, cin, g,
                     img0 + s_off, i0, j0, ci * KC,
                     min(KC, cin_pad - ci * KC), vec_in);
      cp_async_commit();
    };
    stage(0);
    int q = 0;
    const int t4 = threadIdx.x & 3;
    for (int mc = 0; mc < n_mc; ++mc) {
      int s_off, i0, j0;
      origin(mc, s_off, i0, j0);
      for (int t = t1_first; t < t1_end; ++t) {
        float sum[PN1 / 2];
#pragma unroll
        for (int i = 0; i < PN1 / 2; ++i) sum[i] = 0.f;
        for (int ci = 0; ci < n_ci; ++ci, ++q) {
          cp_async_wait_all();
          consumer_sync();  // patch q landed; patch q - 1 is no longer read
          if (q + 1 < total) stage(q + 1);
          mma_chunk<PN1>(sum, ring, smem_addr(patch[q & 1]) + a_off,
                         pc * kPitch, kPitch,
                         min(KC, cin_pad - ci * KC) * 4);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const Px p = chunk_pixel(mbase + (lane >> 2) + 8 * half, g);
          const int s = s_off + p.s, oi = i0 + p.r, oj = j0 + p.c;
          if (s >= group_n || oi >= h || oj >= w) continue;
          float* row = slice + ((size_t)(s * h + oi) * w + oj) * pitch +
                       (t - t1_first) * PN1;
#pragma unroll
          for (int j = 0; j < PN1 / 8; ++j) {
            const int col = 8 * j + 2 * t4, ch = t * PN1 + col;
            *reinterpret_cast<float2*>(row + col) = make_float2(
                __uint_as_float(relu_bits(sum[4 * j + 2 * half],
                                          ch < cmid ? b1[ch] : 0.f)),
                __uint_as_float(relu_bits(
                    sum[4 * j + 2 * half + 1],
                    ch + 1 < cmid ? b1[ch + 1] : 0.f)));
          }
        }
      }
    }
  }
  cluster_arrive();  // every block's slice is written
  cluster_wait();

  // ---- conv2: the cluster's slices -> y ----
  {
    const int n_ci = (cmid_pad + KC - 1) / KC;
    const int n_mine = rank < n_t2 ? (n_t2 - rank + csize - 1) / csize : 0;
    const int total = n_mc * n_mine * n_ci;
    auto chunk = [&](int q) {
      const int c0 = (q % n_ci) * KC, owner = c0 / sch;
      SliceChunk c;
      c.src = map_rank(slice, owner);
      c.coff = c0 - owner * sch;
      c.kc = min(KC, cmid_pad - c0);
      origin(q / (n_ci * n_mine), c.s_off, c.i0, c.j0);
      c.total = (pimg << g.ni) * (c.kc / 4);
      return c;
    };
    uint4 ahead[kAhead];
    auto load = [&](const SliceChunk& c) {
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int idx = threadIdx.x + u * kConsumers;
        if (idx < c.total)
          slice_piece(c, idx, group_n, h, w, pitch, g, ahead[u]);
      }
    };
    auto store = [&](const SliceChunk& c, unsigned char* buf) {
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int idx = threadIdx.x + u * kConsumers;
        if (idx < c.total) {
          const int groups = c.kc / 4;
          *reinterpret_cast<uint4*>(buf + (idx / groups) * kPitch +
                                    (idx % groups) * 16) = ahead[u];
        }
      }
      for (int idx = threadIdx.x + kAhead * kConsumers; idx < c.total;
           idx += kConsumers) {
        uint4 v;
        const int off = slice_piece(c, idx, group_n, h, w, pitch, g, v);
        *reinterpret_cast<uint4*>(buf + off) = v;
      }
    };
    if (total > 0) {
      const SliceChunk c = chunk(0);
      load(c);
      store(c, patch[0]);
    }
    int q = 0;
    for (int mc = 0; mc < n_mc; ++mc) {
      int s_off, i0, j0;
      origin(mc, s_off, i0, j0);
      for (int tn = rank; tn < n_t2; tn += csize) {
        float sum[PN2 / 2];
#pragma unroll
        for (int i = 0; i < PN2 / 2; ++i) sum[i] = 0.f;
        for (int ci = 0; ci < n_ci; ++ci, ++q) {
          consumer_sync();  // patch q written; patch q - 1 no longer read
          SliceChunk next;
          if (q + 1 < total) {
            next = chunk(q + 1);
            load(next);
          }
          mma_chunk<PN2>(sum, ring, smem_addr(patch[q & 1]) + a_off,
                         pc * kPitch, kPitch,
                         min(KC, cmid_pad - ci * KC) * 4);
          if (q + 1 < total) store(next, patch[(q + 1) & 1]);
        }
        float* rows[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const Px p = chunk_pixel(mbase + (lane >> 2) + 8 * half, g);
          const int s = s_off + p.s, oi = i0 + p.r, oj = j0 + p.c;
          rows[half] = s < group_n && oi < h && oj < w
                           ? y + (((size_t)(img0 + s) * h + oi) * w + oj) *
                                     cout
                           : nullptr;
        }
        store_global<PN2>(sum, b2, tn * PN2, cout, rows, vec_out);
      }
    }
  }
  cluster_arrive();  // no block reads this one's slice any more
  cluster_wait();
}

template <int PN1, int PN2>
int launch(const float* x, const float* w1pk, const float* b1,
           const float* w2pk, const float* b2, float* y, int n, int h, int w,
           int cin, int cmid, int cout, int cin_pad, int cmid_pad, Geo g,
           int group, int tiles1, int csize, int stages, int smem,
           cudaStream_t stream) {
  auto kernel = double_conv_f32_kernel<PN1, PN2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((n + group - 1) / group) * csize;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const bool vec_in = cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_out =
      cout % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int sbytes = stage_bytes(PN1 > PN2 ? PN1 : PN2);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, w1pk, b1, w2pk, b2, y, n, h, w,
                           cin, cmid, cout, cin_pad, cmid_pad, g, group,
                           tiles1, stages, sbytes, vec_in, vec_out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace x3
}  // namespace fabric

using namespace fabric;

// Dynamic shared memory one block needs: the ring (stages slots of a hi
// and a lo block of the wider conv's N tile x 16 fp32 channels), two staged
// patches of geometry (tw, tr, ni) (log2s), the block's slice of the
// intermediate (`group` images, tiles1 N tiles of pn1 channels) and 16
// bytes of barriers per slot.  ops/double_conv.py smem_bytes_f32 mirrors
// this formula.
extern "C" int fabric_double_conv_f32_smem_bytes(int h, int w, int pn1,
                                                 int pn2, int tw, int tr,
                                                 int ni, int group,
                                                 int tiles1, int stages) {
  return stages * x3::stage_bytes(pn1 > pn2 ? pn1 : pn2) +
         2 * patch_bytes(Geo{tw, tr, ni}) +
         x3::slice_bytes(group, h, w, tiles1 * pn1) + 16 * stages;
}

// x (n, h, w, cin) fp32; w1pk, w2pk: the two kernels split and packed by
// ops/conv.py pack_weight_f32 (cin_pad, cmid_pad = cin, cmid rounded up to
// 8; N tiles of pn1, pn2 = 64 or 128 channels); b1 (cmid,), b2 (cout,)
// fp32; y (n, h, w, cout) fp32.  (tw, tr, ni): log2 of the M chunk's
// columns, rows and images, 7 in all; `group` <= 2^ni images per cluster
// of csize = ceil(conv1's N tiles / tiles1) <= 8 blocks, each holding
// tiles1 of them; `stages` ring slots.  Returns the CUDA error of the
// launch (0 on success); cudaErrorInvalidValue when the plan does not hold
// or a block would need more than 227 KB.
extern "C" int fabric_double_conv3x3_bias_relu_f32(
    const void* x, const void* w1pk, const void* b1, const void* w2pk,
    const void* b2, void* y, int n, int h, int w, int cin, int cmid, int cout,
    int cin_pad, int cmid_pad, int pn1, int pn2, int tw, int tr, int ni,
    int group, int tiles1, int csize, int stages, void* stream) {
  const int n_t1 = pn1 > 0 ? (cmid + pn1 - 1) / pn1 : 0;
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cmid <= 0 || cout <= 0 ||
      cin_pad % 8 || cin_pad < cin || cmid_pad % 8 || cmid_pad < cmid ||
      (pn1 != 64 && pn1 != 128) || (pn2 != 64 && pn2 != 128) || tw < 0 ||
      tr < 0 || ni < 0 || tw + tr + ni != 7 || group < 1 ||
      group > (1 << ni) || tiles1 < 1 ||
      csize != (n_t1 + tiles1 - 1) / tiles1 || csize > 8 || stages < 2 ||
      reinterpret_cast<uintptr_t>(w1pk) % 16 ||
      reinterpret_cast<uintptr_t>(w2pk) % 16)
    return (int)cudaErrorInvalidValue;
  const int smem = fabric_double_conv_f32_smem_bytes(
      h, w, pn1, pn2, tw, tr, ni, group, tiles1, stages);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const Geo g{tw, tr, ni};
  const auto* xs = static_cast<const float*>(x);
  const auto* w1s = static_cast<const float*>(w1pk);
  const auto* b1s = static_cast<const float*>(b1);
  const auto* w2s = static_cast<const float*>(w2pk);
  const auto* b2s = static_cast<const float*>(b2);
  auto* ys = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FABRIC_LAUNCH(P1, P2)                                               \
  x3::launch<P1, P2>(xs, w1s, b1s, w2s, b2s, ys, n, h, w, cin, cmid, cout, \
                     cin_pad, cmid_pad, g, group, tiles1, csize, stages,   \
                     smem, s)
  if (pn1 == 64)
    return pn2 == 64 ? FABRIC_LAUNCH(64, 64) : FABRIC_LAUNCH(64, 128);
  return pn2 == 64 ? FABRIC_LAUNCH(128, 64) : FABRIC_LAUNCH(128, 128);
#undef FABRIC_LAUNCH
}
