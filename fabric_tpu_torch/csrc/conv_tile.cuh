// The tensor-core core of the two bf16 3x3 conv kernels
// (conv3x3_bias_relu.cu and double_conv3x3_bias_relu.cu), and the mma.sync
// pieces the int8 kernels share (int8_gemm.cuh, int8_matmul.cu,
// conv3x3_s8.cu).
//
// GEMM view of one 3x3 SAME conv: M = output pixels, N = output channels,
// K = 9 taps x input channels.  A block of the bf16 kernels is three
// roles: two consumer warpgroups that run wgmma (m64nPNk16, fp32
// accumulation) and one producer warp that streams the weights.
//
// * B, the weights, through a ring in shared memory.  The weights are
//   packed once (ops/conv.py pack_weight) into blocks of PN output
//   channels x kc input channels x one tap, each block already in the
//   no-swizzle K-major core-matrix layout wgmma reads (8 x 8 bf16 core
//   matrices of 128 contiguous bytes, K groups 128 bytes apart, N groups
//   kc*16 bytes apart).  The producer moves one block with one
//   cp.async.bulk, tracked by an mbarrier (expect_tx), up to `stages`
//   blocks ahead of the math; consumers release a stage through a second
//   mbarrier.  Every warp of the block reads the one copy.
// * A, the input pixels, from registers: ldmatrix.x4 from a patch in
//   shared memory.  A 3x3 tap is a per-row address shift inside the patch
//   (row m of tap (dy, dx) is patch pixel p(m) + dy*pc + dx), so the nine
//   taps reuse one patch and no im2col buffer exists.  Rows are pixels of
//   an M chunk of NI whole images x TR rows x TW columns (TW, TR, NI
//   powers of two, NI*TR*TW = 64 or 128), so small images fill the chunk
//   instead of leaving most of it empty.
// * The patch is staged with cp.async 32 channels at a time into two
//   buffers: the next chunk loads while the current one computes.  Its
//   zero halo (cp.async with a source size of 0) is the SAME padding.
// * Epilogue in registers: bias, ReLU, one rounding to bf16; four lanes
//   swap their pairs with shuffles so each stores 8 channels (16 bytes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fabric {

// ---- shared with the int8 kernels (mma.sync, 8 warps, 128 x 64 tiles) ----
constexpr int kThreads = 256;
constexpr int kBM = 128;
constexpr int kBN = 64;

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- the bf16 conv core ----
constexpr int kKC = 32;                  // input channels per staged chunk
constexpr int kPitch = kKC + 8;          // bf16 per staged pixel: 80 bytes,
                                         // so 8 consecutive pixels fall on
                                         // distinct 16-byte bank groups
constexpr int kConsumers = 256;          // two warpgroups
constexpr int kConvThreads = kConsumers + 32;  // + the producer warp
constexpr int kMaxSmem = 232448;         // 227 KB, the most a block may use

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// An M chunk: NI images x TR rows x TW columns, as log2s.
struct Geo {
  int tw, tr, ni;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  // the spin loop stays inside the asm block (its labels are local to the
  // block), so the compiler sees no branch between the wgmma instructions
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// One bulk copy of `bytes` (a multiple of 16) from device memory into
// shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 16 bytes device -> shared, zero-filled when src_bytes is 0.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The two consumer warpgroups meet here (named barrier 1; the producer
// warp never does).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Descriptor of a K-major operand in the no-swizzle layout: core matrices
// K-adjacent `lbo` bytes apart, N-adjacent (8 rows) `sbo` bytes apart.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// wgmma m64nNk16, bf16 x bf16 -> fp32, A from registers (the m16n8k16
// A fragment of each warp's 16 rows), B from shared memory by descriptor,
// no transpose.  Operand lists written out for N = 64 and 128.
// acc += A (64 x 16, registers) x B (16 x 64, shared memory via desc).
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// acc += A (64 x 16, registers) x B (16 x 128, shared memory via desc).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int PN>
__device__ __forceinline__ void wgmma_step(float (&d)[PN / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  if constexpr (PN == 64)
    wgmma_m64n64k16(d, a, desc);
  else
    wgmma_m64n128k16(d, a, desc);
}

// Shared memory of one staged patch buffer: NI x (TR+2) x (TW+2) pixels of
// kPitch bf16, rounded up to 128 bytes.
__host__ __device__ inline int patch_bytes(Geo g) {
  return round_up(((((1 << g.tr) + 2) * ((1 << g.tw) + 2)) << g.ni) * kPitch *
                      2,
                  128);
}

// The weight ring: `stages` slots of `stage_bytes`, a full and an empty
// mbarrier per slot, and the position (slot, phase) of its owner.
struct Ring {
  uint32_t base, full, empty;
  int stages, stage_bytes, idx;
  uint32_t phase;
  __device__ __forceinline__ uint32_t slot() const {
    return base + idx * stage_bytes;
  }
  __device__ __forceinline__ void advance() {
    if (++idx == stages) {
      idx = 0;
      phase ^= 1;
    }
  }
};

// Lay out the ring at `base` with its barriers at `bars` (16 bytes per
// stage); thread 0 initialises them and the whole block syncs.
__device__ __forceinline__ Ring make_ring(unsigned char* base,
                                          unsigned char* bars, int stages,
                                          int stage_bytes) {
  Ring r{smem_addr(base), smem_addr(bars), smem_addr(bars) + 8 * stages,
         stages, stage_bytes, 0, 0};
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(r.full + 8 * i, 1);
      mbar_init(r.empty + 8 * i, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The packed block of N tile t, K chunk [c0, c0 + kc) and one tap, for
// weights packed with cin_pad input channels and pn-wide N tiles: blocks
// are laid out [tile][chunk][tap], each pn x kc.
__device__ __forceinline__ const __nv_bfloat16* weight_block(
    const __nv_bfloat16* w, int cin_pad, int pn, int t, int c0, int kc,
    int tap) {
  return w + ((size_t)t * 9 * cin_pad + 9 * c0 + tap * kc) * pn;
}

// Producer (one thread): stream one conv's weight blocks in the order the
// consumers take them: M chunks x N tiles [t_first, t_end) in steps of
// t_step x K chunks x taps.  With t_step 2 (the warpgroups split N) a slot
// holds tiles t and t + 1.
__device__ __forceinline__ void produce(Ring& r, const __nv_bfloat16* w,
                                        int cin_pad, int pn, int t_first,
                                        int t_end, int t_step,
                                        int n_mchunks) {
  for (int mc = 0; mc < n_mchunks; ++mc)
    for (int t = t_first; t < t_end; t += t_step) {
      const int parts = t_step == 2 && t + 1 < t_end ? 2 : 1;
      for (int c0 = 0; c0 < cin_pad; c0 += kKC) {
        const int kc = min(kKC, cin_pad - c0);
        const uint32_t bytes = kc * pn * 2;
        for (int tap = 0; tap < 9; ++tap) {
          mbar_wait(r.empty + 8 * r.idx, r.phase ^ 1);
          const uint32_t full = r.full + 8 * r.idx;
          mbar_expect_tx(full, bytes * parts);
          for (int p = 0; p < parts; ++p)
            bulk_load(r.slot() + p * bytes,
                      weight_block(w, cin_pad, pn, t + p, c0, kc, tap), bytes,
                      full);
          r.advance();
        }
      }
    }
}

// Consumer: acc += the nine taps of one K chunk of KC channels (a
// multiple of 16).  a_addr: shared address of this lane's ldmatrix row
// for tap (0, 0) (its pixel, plus 8 channels for lanes 16-31); a tap moves
// it by dy rows of row_bytes and dx pixels of px_bytes.  `part` picks the
// warpgroup's N tile inside a slot.  Pipelined: while tap t's wgmma runs,
// tap t - 1's slot is released and tap t + 1's A fragments are loaded.
template <int PN, int KC>
__device__ __forceinline__ void mma_chunk(float (&acc)[PN / 2], Ring& r,
                                          uint32_t a_addr, int row_bytes,
                                          int px_bytes, int part) {
  constexpr int KS = KC / 16;
  uint32_t frag[2][KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) ldmatrix_x4(frag[0][s], a_addr + s * 32);
  int prev = 0;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    mbar_wait(r.full + 8 * r.idx, r.phase);
    const uint64_t desc = make_desc(r.slot() + part * KC * PN * 2, 128,
                                    KC * 16);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < KS; ++s)
      wgmma_step<PN>(acc, frag[tap & 1][s], desc + s * (256 >> 4));
    wgmma_commit();
    wgmma_wait<1>();  // tap - 1's wgmma is done with its slot and registers
    if (tap > 0 && (threadIdx.x & 31) == 0) mbar_arrive(r.empty + 8 * prev);
    if (tap < 8) {
      const int t = tap + 1;
      const uint32_t a = a_addr + (t / 3) * row_bytes + (t % 3) * px_bytes;
#pragma unroll
      for (int s = 0; s < KS; ++s)
        ldmatrix_x4(frag[(tap + 1) & 1][s], a + s * 32);
    }
    prev = r.idx;
    r.advance();
  }
  wgmma_wait<0>();
  if ((threadIdx.x & 31) == 0) mbar_arrive(r.empty + 8 * prev);
}

// mma_chunk for a chunk of kc channels, a multiple of 16 up to KC: a full
// chunk, or the shorter last one.
template <int PN, int KC = kKC>
__device__ __forceinline__ void mma_chunk(float (&acc)[PN / 2], Ring& r,
                                          uint32_t a_addr, int row_bytes,
                                          int px_bytes, int kc, int part) {
  if constexpr (KC <= 16) {
    mma_chunk<PN, 16>(acc, r, a_addr, row_bytes, px_bytes, part);
  } else {
    if (kc == KC)
      mma_chunk<PN, KC>(acc, r, a_addr, row_bytes, px_bytes, part);
    else
      mma_chunk<PN, KC - 16>(acc, r, a_addr, row_bytes, px_bytes, kc,
                             part);
  }
}

// Pixel (image, row, column) of row m of an M chunk.
struct Px {
  int s, r, c;
};
__device__ __forceinline__ Px chunk_pixel(int m, Geo g) {
  return {m >> (g.tw + g.tr), (m >> g.tw) & ((1 << g.tr) - 1),
          m & ((1 << g.tw) - 1)};
}

// Byte offset of this lane's ldmatrix row (pixel of row m, channel 0 or 8)
// inside a staged patch of geometry g.
__device__ __forceinline__ uint32_t patch_row_offset(int m, Geo g) {
  const Px p = chunk_pixel(m, g);
  const int pc = (1 << g.tw) + 2, pr = (1 << g.tr) + 2;
  const int lane_k = ((threadIdx.x >> 4) & 1) * 8;
  return (((p.s * pr + p.r) * pc + p.c) * kPitch + lane_k) * 2;
}

// Consumers: stage channels [c0, c0 + kc) of the haloed patch of an M
// chunk (images img.., rows i0 - 1.., columns j0 - 1..) with cp.async,
// zeros outside the image, past image n - 1 and past the last channel.
// `vec`: cin % 8 == 0 and x 16-byte aligned; otherwise plain loads.
__device__ __forceinline__ void stage_patch(__nv_bfloat16* patch,
                                            const __nv_bfloat16* __restrict__ x,
                                            int n, int h, int w, int cin,
                                            Geo g, int img, int i0, int j0,
                                            int c0, int kc, bool vec) {
  const int pc = (1 << g.tw) + 2, pimg = ((1 << g.tr) + 2) * pc;
  const int groups = kc / 8, total = (pimg << g.ni) * groups;
  for (int idx = threadIdx.x; idx < total; idx += kConsumers) {
    const int v = idx % groups, p = idx / groups;
    const int s = p / pimg, rem = p - s * pimg;
    const int gn = img + s, gi = i0 - 1 + rem / pc, gj = j0 - 1 + rem % pc;
    const int c = c0 + v * 8;
    const bool inside =
        gn < n && gi >= 0 && gi < h && gj >= 0 && gj < w && c < cin;
    const __nv_bfloat16* src =
        inside ? x + (((size_t)gn * h + gi) * w + gj) * cin + c : x;
    __nv_bfloat16* dst = patch + p * kPitch + v * 8;
    if (vec) {
      cp_async16(smem_addr(dst), src, inside ? 16 : 0);
    } else {
      union {
        uint4 u;
        unsigned short e[8];
      } val;
      val.u = make_uint4(0, 0, 0, 0);
      if (inside) {
        const unsigned short* s16 =
            reinterpret_cast<const unsigned short*>(src);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (c + e < cin) val.e[e] = s16[e];
      }
      *reinterpret_cast<uint4*>(dst) = val.u;
    }
  }
}

__device__ __forceinline__ uint32_t pick4(const uint32_t (&p)[4], int i) {
  return i == 0 ? p[0] : i == 1 ? p[1] : i == 2 ? p[2] : p[3];
}

__device__ __forceinline__ uint32_t relu_bf16x2(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(fmaxf(a, 0.f), fmaxf(b, 0.f));
  return *reinterpret_cast<uint32_t*>(&v);
}

// Epilogue to device memory: y[row][n0 + col] = bf16(relu(acc + bias)) for
// the warpgroup's 64 x PN tile.  rows[half] points at channel 0 of the
// output pixel of accumulator row g + 8*half (nullptr: not a pixel).
// `vec` (cout % 8 == 0, y 16-byte aligned): the four lanes of a quad swap
// bf16 pairs so that each writes 8 channels with one 16-byte store.
template <int PN>
__device__ __forceinline__ void store_global(const float (&acc)[PN / 2],
                                             const float* __restrict__ bias,
                                             int n0, int cout,
                                             __nv_bfloat16* const (&rows)[2],
                                             bool vec) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    __nv_bfloat16* row = rows[half];
    if (vec) {
#pragma unroll
      for (int jq = 0; jq < PN / 32; ++jq) {
        uint32_t p[4], q[4] = {0, 0, 0, 0};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = jq * 4 + k, col = n0 + 8 * j + 2 * t;
          const float b0 = col < cout ? bias[col] : 0.f;
          const float b1 = col + 1 < cout ? bias[col + 1] : 0.f;
          p[k] = relu_bf16x2(acc[4 * j + 2 * half] + b0,
                             acc[4 * j + 2 * half + 1] + b1);
        }
        // q[k] = lane k's pair of block jq*4 + t: channels 2k, 2k + 1
#pragma unroll
        for (int x = 1; x < 4; ++x) {
          const uint32_t got = __shfl_xor_sync(0xffffffffu, pick4(p, t ^ x), x);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (k == (t ^ x)) q[k] = got;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k == t) q[k] = p[k];
        const int col8 = n0 + 8 * (jq * 4 + t);
        if (row != nullptr && col8 < cout)
          *reinterpret_cast<uint4*>(row + col8) =
              make_uint4(q[0], q[1], q[2], q[3]);
      }
    } else if (row != nullptr) {
#pragma unroll
      for (int j = 0; j < PN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (col < cout)
          row[col] = __float2bfloat16_rn(
              fmaxf(acc[4 * j + 2 * half] + bias[col], 0.f));
        if (col + 1 < cout)
          row[col + 1] = __float2bfloat16_rn(
              fmaxf(acc[4 * j + 2 * half + 1] + bias[col + 1], 0.f));
      }
    }
  }
}

// Epilogue into the double conv's shared intermediate: channels below
// cmid16 (cmid rounded up to 16; the padded ones come out as relu(0) = 0,
// their weights and bias being zero), bf16 pairs.
template <int PN>
__device__ __forceinline__ void store_shared(const float (&acc)[PN / 2],
                                             const float* __restrict__ bias,
                                             int n0, int cmid, int cmid16,
                                             __nv_bfloat16* const (&rows)[2]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    __nv_bfloat16* row = rows[half];
    if (row == nullptr) continue;
#pragma unroll
    for (int j = 0; j < PN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col >= cmid16) continue;
      const float b0 = col < cmid ? bias[col] : 0.f;
      const float b1 = col + 1 < cmid ? bias[col + 1] : 0.f;
      *reinterpret_cast<uint32_t*>(row + col) = relu_bf16x2(
          acc[4 * j + 2 * half] + b0, acc[4 * j + 2 * half + 1] + b1);
    }
  }
}

}  // namespace fabric

extern "C" const char* fabric_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
