// The tensor-core core of every CUDA kernel of the port: the two bf16 3x3
// conv kernels (conv3x3_bias_relu.cu, double_conv3x3_bias_relu.cu), the
// int8 serving conv (conv3x3_s8.cu) and the int8 / bf16 GEMM
// (int8_matmul.cu).
//
// GEMM view of one 3x3 SAME conv: M = output pixels, N = output channels,
// K = 9 taps x input channels.  A block is three roles: two consumer
// warpgroups that run wgmma and one producer warp that streams the
// weights.  The core counts K in BYTES: one wgmma K step is 32 bytes, 16
// bf16 channels (m64nNk16, fp32 sums) or 32 int8 channels (m64nNk32, exact
// int32 sums), and a core matrix is 8 rows x 16 bytes in both, so one
// layout, one loader and one pipeline serve both types.
//
// * B, the weights, through a ring in shared memory.  The weights are
//   packed once (ops/conv.py pack_blocks) into blocks of PN output
//   channels x kb bytes of K x one tap, each block already in the
//   no-swizzle K-major core-matrix layout wgmma reads (core matrices of 8
//   rows x 16 bytes, K groups 128 bytes apart, N groups kb*8 bytes apart;
//   K-major is also the only layout s8 wgmma takes).  The producer moves
//   one block with one cp.async.bulk, tracked by an mbarrier (expect_tx),
//   up to `stages` blocks ahead of the math; consumers release a stage
//   through a second mbarrier.  Every warp of the block reads the one copy.
// * A, the input pixels, from registers: ldmatrix.x4 .b16 from a patch in
//   shared memory, which yields the A fragment of either type.  A 3x3 tap
//   is a per-row address shift inside the patch (row m of tap (dy, dx) is
//   patch pixel p(m) + dy*pc + dx), so the nine taps reuse one patch and
//   no im2col buffer exists.  Rows are pixels of an M chunk of NI whole
//   images x TR rows x TW columns (TW, TR, NI powers of two, NI*TR*TW =
//   64 or 128), so small images fill the chunk instead of leaving most of
//   it empty.
// * The patch is staged with cp.async kKB = 64 bytes of channels at a time
//   into two buffers: the next chunk loads while the current one
//   computes.  Its zero halo (cp.async with a source size of 0) is the
//   SAME padding (an int8 zero is the quantized zero).
// * Epilogues in registers; the four lanes of a quad swap their values
//   with shuffles (quad_transpose) so that each stores 16 bytes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cuda_error.cuh"

namespace fabric {

constexpr int kKB = 64;                  // bytes of K per staged chunk
constexpr int kKC = kKB / 2;             // the same in bf16 channels
constexpr int kPitch = kKB + 16;         // bytes per staged pixel: 80, so
                                         // 8 consecutive pixels fall on
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

// Wait until at most N of this thread's cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// One 32-byte K step: acc (64 x PN) += A (64 x 32 bytes, registers: the
// m16n8k16 / m16n8k32 A fragment of each warp's 16 rows) x B (32 bytes x
// PN, shared memory by descriptor).  bf16 x bf16 -> fp32 (m64nPNk16, no
// transpose) for float accumulators, s8 x s8 -> s32 (m64nPNk32, CUTLASS's
// SM90_64xNx32_S32S8S8_RS_TN) for int ones.  Operand lists written out
// for PN = 64 and 128.
#define FABRIC_ACC8(C, i)                                                 \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), C(d[i + 5]), \
      C(d[i + 6]), C(d[i + 7])
#define FABRIC_ACC32(C, i)                                          \
  FABRIC_ACC8(C, i), FABRIC_ACC8(C, i + 8), FABRIC_ACC8(C, i + 16), \
      FABRIC_ACC8(C, i + 24)
#define FABRIC_REGS32                                    \
  "%0, %1, %2, %3, %4, %5, %6, %7, "                     \
  "%8, %9, %10, %11, %12, %13, %14, %15, "               \
  "%16, %17, %18, %19, %20, %21, %22, %23, "             \
  "%24, %25, %26, %27, %28, %29, %30, %31"
#define FABRIC_REGS64                                    \
  FABRIC_REGS32 ", "                                     \
  "%32, %33, %34, %35, %36, %37, %38, %39, "             \
  "%40, %41, %42, %43, %44, %45, %46, %47, "             \
  "%48, %49, %50, %51, %52, %53, %54, %55, "             \
  "%56, %57, %58, %59, %60, %61, %62, %63"
#define FABRIC_A(a) "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3])

template <int PN>
__device__ __forceinline__ void wgmma_step(float (&d)[PN / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  if constexpr (PN == 64)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{" FABRIC_REGS32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : FABRIC_ACC32("+f", 0)
        : FABRIC_A(a), "l"(desc), "r"(1));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{" FABRIC_REGS64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : FABRIC_ACC32("+f", 0), FABRIC_ACC32("+f", 32)
        : FABRIC_A(a), "l"(desc), "r"(1));
}

template <int PN>
__device__ __forceinline__ void wgmma_step(int (&d)[PN / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  if constexpr (PN == 64)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{" FABRIC_REGS32 "}, {%32, %33, %34, %35}, %36, p;\n}\n"
        : FABRIC_ACC32("+r", 0)
        : FABRIC_A(a), "l"(desc), "r"(1));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{" FABRIC_REGS64 "}, {%64, %65, %66, %67}, %68, p;\n}\n"
        : FABRIC_ACC32("+r", 0), FABRIC_ACC32("+r", 32)
        : FABRIC_A(a), "l"(desc), "r"(1));
}
#undef FABRIC_ACC8
#undef FABRIC_ACC32
#undef FABRIC_REGS32
#undef FABRIC_REGS64
#undef FABRIC_A

// Shared memory of one staged patch buffer: NI x (TR+2) x (TW+2) pixels of
// kPitch bytes, rounded up to 128 bytes.
__host__ __device__ inline int patch_bytes(Geo g) {
  return round_up(((((1 << g.tr) + 2) * ((1 << g.tw) + 2)) << g.ni) * kPitch,
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

// Producer (one thread): stream one conv's (or GEMM's) weight blocks in
// the order the consumers take them: M chunks x N tiles [t_first, t_end)
// in steps of t_step x K chunks of `chunk` bytes x `taps` taps.  The
// weights are packed with kpad bytes of K per tap and pn-wide N tiles,
// blocks laid out [tile][chunk][tap], each pn x kb bytes.  With t_step 2
// (the warpgroups split N) a slot holds tiles t and t + 1.
__device__ __forceinline__ void produce(Ring& r, const void* w, int kpad,
                                        int pn, int t_first, int t_end,
                                        int t_step, int n_mchunks,
                                        int chunk = kKB, int taps = 9) {
  const unsigned char* wb = static_cast<const unsigned char*>(w);
  for (int mc = 0; mc < n_mchunks; ++mc)
    for (int t = t_first; t < t_end; t += t_step) {
      const int parts = t_step == 2 && t + 1 < t_end ? 2 : 1;
      for (int c0 = 0; c0 < kpad; c0 += chunk) {
        const int kb = min(chunk, kpad - c0);
        const uint32_t bytes = kb * pn;
        for (int tap = 0; tap < taps; ++tap) {
          mbar_wait(r.empty + 8 * r.idx, r.phase ^ 1);
          const uint32_t full = r.full + 8 * r.idx;
          mbar_expect_tx(full, bytes * parts);
          for (int p = 0; p < parts; ++p)
            bulk_load(r.slot() + p * bytes,
                      wb + ((size_t)(t + p) * taps * kpad +
                            (size_t)taps * c0 + tap * kb) * pn,
                      bytes, full);
          r.advance();
        }
      }
    }
}

// Consumer: acc += the TAPS taps of one K chunk of KB bytes (a multiple of
// 32).  a_addr: shared address of this lane's ldmatrix row for tap (0, 0)
// (its pixel, plus 16 bytes for lanes 16-31); a tap moves it by dy rows
// of row_bytes and dx pixels of px_bytes.  `part` picks the warpgroup's N
// tile inside a slot.  Pipelined: while tap t's wgmma runs, tap t - 1's
// slot is released and tap t + 1's A fragments are loaded.  At PN = 64,
// whose two or three blocks per SM leave few registers beside the sums,
// the pipeline runs per 32-byte step instead (one step's wgmma in flight
// while the next step's fragment loads: 8 fragment registers, not
// 8 * KB / 32), so that ptxas keeps every wgmma asynchronous.
template <int PN, int KB, int TAPS, typename Acc>
__device__ __forceinline__ void mma_chunk(Acc (&acc)[PN / 2], Ring& r,
                                          uint32_t a_addr, int row_bytes,
                                          int px_bytes, int part) {
  constexpr int KS = KB / 32;
  if constexpr (PN == 64) {
    uint32_t frag[2][4];
    ldmatrix_x4(frag[0], a_addr);
    int prev = 0;
#pragma unroll
    for (int tap = 0; tap < TAPS; ++tap) {
      mbar_wait(r.full + 8 * r.idx, r.phase);
      const uint64_t desc =
          make_desc(r.slot() + part * KB * PN, 128, KB * 8);
      const int t = tap + 1;
      const uint32_t a = a_addr + (tap / 3) * row_bytes + (tap % 3) * px_bytes;
      const uint32_t a_next = a_addr + (t / 3) * row_bytes + (t % 3) * px_bytes;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const int u = tap * KS + s;
        wgmma_fence();
        wgmma_step<PN>(acc, frag[u & 1], desc + s * (256 >> 4));
        wgmma_commit();
        wgmma_wait<1>();  // step u - 1 is done with its fragment (and, at
                          // s = 0, tap - 1 with its slot)
        if (s == 0 && tap > 0 && (threadIdx.x & 31) == 0)
          mbar_arrive(r.empty + 8 * prev);
        if (s + 1 < KS)
          ldmatrix_x4(frag[(u + 1) & 1], a + (s + 1) * 32);
        else if (tap + 1 < TAPS)
          ldmatrix_x4(frag[(u + 1) & 1], a_next);
      }
      prev = r.idx;
      r.advance();
    }
    wgmma_wait<0>();
    if ((threadIdx.x & 31) == 0) mbar_arrive(r.empty + 8 * prev);
    return;
  }
  uint32_t frag[2][KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) ldmatrix_x4(frag[0][s], a_addr + s * 32);
  int prev = 0;
#pragma unroll
  for (int tap = 0; tap < TAPS; ++tap) {
    mbar_wait(r.full + 8 * r.idx, r.phase);
    const uint64_t desc = make_desc(r.slot() + part * KB * PN, 128, KB * 8);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < KS; ++s)
      wgmma_step<PN>(acc, frag[tap & 1][s], desc + s * (256 >> 4));
    wgmma_commit();
    wgmma_wait<1>();  // tap - 1's wgmma is done with its slot and registers
    if (tap > 0 && (threadIdx.x & 31) == 0) mbar_arrive(r.empty + 8 * prev);
    if (tap + 1 < TAPS) {
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

// mma_chunk for a chunk of kb bytes, a multiple of 32 up to KB: a full
// chunk, or a shorter last one.
template <int PN, int KB = kKB, int TAPS = 9, typename Acc>
__device__ __forceinline__ void mma_chunk(Acc (&acc)[PN / 2], Ring& r,
                                          uint32_t a_addr, int row_bytes,
                                          int px_bytes, int kb, int part) {
  if constexpr (KB <= 32) {
    mma_chunk<PN, 32, TAPS>(acc, r, a_addr, row_bytes, px_bytes, part);
  } else {
    if (kb == KB)
      mma_chunk<PN, KB, TAPS>(acc, r, a_addr, row_bytes, px_bytes, part);
    else
      mma_chunk<PN, KB - 32, TAPS>(acc, r, a_addr, row_bytes, px_bytes, kb,
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

// Byte offset of this lane's ldmatrix row (pixel of row m, byte 0 or 16)
// inside a staged patch of geometry g.
__device__ __forceinline__ uint32_t patch_row_offset(int m, Geo g) {
  const Px p = chunk_pixel(m, g);
  const int pc = (1 << g.tw) + 2, pr = (1 << g.tr) + 2;
  return ((p.s * pr + p.r) * pc + p.c) * kPitch +
         ((threadIdx.x >> 4) & 1) * 16;
}

template <int ES>
struct Elem;
template <>
struct Elem<1> {
  using T = unsigned char;
};
template <>
struct Elem<2> {
  using T = unsigned short;
};

// Consumers: stage channels [c0, c0 + kc) of the haloed patch of an M
// chunk (images img.., rows i0 - 1.., columns j0 - 1..) with cp.async,
// zeros outside the image, past image n - 1 and past the last channel.
// x holds elements of ES bytes (2: bf16, 1: int8); kc is a multiple of
// 16 / ES.  `vec`: cin * ES % 16 == 0 and x 16-byte aligned; otherwise
// plain loads.
template <int ES>
__device__ __forceinline__ void stage_patch(unsigned char* patch,
                                            const void* __restrict__ x,
                                            int n, int h, int w, int cin,
                                            Geo g, int img, int i0, int j0,
                                            int c0, int kc, bool vec) {
  constexpr int V = 16 / ES;  // channels per 16 bytes
  using E = typename Elem<ES>::T;
  const int pc = (1 << g.tw) + 2, pimg = ((1 << g.tr) + 2) * pc;
  const int groups = kc / V, total = (pimg << g.ni) * groups;
  for (int idx = threadIdx.x; idx < total; idx += kConsumers) {
    const int v = idx % groups, p = idx / groups;
    const int s = p / pimg, rem = p - s * pimg;
    const int gn = img + s, gi = i0 - 1 + rem / pc, gj = j0 - 1 + rem % pc;
    const int c = c0 + v * V;
    const bool inside =
        gn < n && gi >= 0 && gi < h && gj >= 0 && gj < w && c < cin;
    const E* src = static_cast<const E*>(x) +
                   (inside ? (((size_t)gn * h + gi) * w + gj) * cin + c : 0);
    unsigned char* dst = patch + p * kPitch + v * 16;
    if (vec) {
      cp_async16(smem_addr(dst), src, inside ? 16 : 0);
    } else {
      union {
        uint4 u;
        E e[V];
      } val;
      val.u = make_uint4(0, 0, 0, 0);
      if (inside) {
#pragma unroll
        for (int e = 0; e < V; ++e)
          if (c + e < cin) val.e[e] = src[e];
      }
      *reinterpret_cast<uint4*>(dst) = val.u;
    }
  }
}

// ---- epilogues ----
// A warpgroup's accumulators: acc[4*j + 2*half + e] is row g + 8*half,
// column 8*j + 2*t + e (g = lane / 4, t = lane % 4).

__device__ __forceinline__ uint32_t pick4(const uint32_t (&p)[4], int i) {
  return i == 0 ? p[0] : i == 1 ? p[1] : i == 2 ? p[2] : p[3];
}

// Across the four lanes of a quad: q[k] = lane k's p[t] (t = this lane).
__device__ __forceinline__ void quad_transpose(const uint32_t (&p)[4],
                                               uint32_t (&q)[4]) {
  const int t = threadIdx.x & 3;
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
}

__device__ __forceinline__ uint32_t bf16x2_bits(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t relu_bf16x2(float a, float b) {
  return bf16x2_bits(fmaxf(a, 0.f), fmaxf(b, 0.f));
}

// Store a warpgroup's 64 x PN tile of 16-bit values (bf16) to device
// memory.  val(j, half) gives the lane's two values of block j, row half,
// packed (column 8j + 2t in the low half).  rows[half] points at channel
// 0 of the output pixel of accumulator row g + 8*half (nullptr: not a
// pixel).  `vec` (cout % 8 == 0, rows 16-byte aligned): a quad transposes
// its pairs so that each lane writes 8 channels with one 16-byte store.
template <int PN, class F>
__device__ __forceinline__ void store16(F val, int n0, int cout,
                                        unsigned short* const (&rows)[2],
                                        bool vec) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    unsigned short* row = rows[half];
    if (vec) {
#pragma unroll
      for (int jq = 0; jq < PN / 32; ++jq) {
        uint32_t p[4], q[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) p[k] = val(jq * 4 + k, half);
        quad_transpose(p, q);  // q[k]: lane k's pair of block jq*4 + t
        const int col8 = n0 + 8 * (jq * 4 + t);
        if (row != nullptr && col8 < cout)
          *reinterpret_cast<uint4*>(row + col8) =
              make_uint4(q[0], q[1], q[2], q[3]);
      }
    } else if (row != nullptr) {
#pragma unroll
      for (int j = 0; j < PN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        const uint32_t v = val(j, half);
        if (col < cout) row[col] = (unsigned short)(v & 0xffff);
        if (col + 1 < cout) row[col + 1] = (unsigned short)(v >> 16);
      }
    }
  }
}

// The same for 8-bit values (int8): val(j, half) gives the lane's two
// bytes of block j in the low 16 bits.  `vec` (cout % 16 == 0, rows
// 16-byte aligned): each lane writes 16 channels with one 16-byte store.
template <int PN, class F>
__device__ __forceinline__ void store8(F val, int n0, int cout,
                                       unsigned char* const (&rows)[2],
                                       bool vec) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    unsigned char* row = rows[half];
    if (vec) {
#pragma unroll
      for (int jo = 0; jo < PN / 64; ++jo) {
        uint32_t p[4], q[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          p[k] = val(jo * 8 + 2 * k, half) |
                 (val(jo * 8 + 2 * k + 1, half) << 16);
        // q[x]: lane x's bytes of blocks jo*8 + 2t (low half: columns
        // 16t + 2x, +1 of the group) and jo*8 + 2t + 1 (high: 16t + 8 + 2x)
        quad_transpose(p, q);
        const int col16 = n0 + 64 * jo + 16 * t;
        if (row != nullptr && col16 < cout)
          *reinterpret_cast<uint4*>(row + col16) = make_uint4(
              __byte_perm(q[0], q[1], 0x5410), __byte_perm(q[2], q[3], 0x5410),
              __byte_perm(q[0], q[1], 0x7632),
              __byte_perm(q[2], q[3], 0x7632));
      }
    } else if (row != nullptr) {
#pragma unroll
      for (int j = 0; j < PN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        const uint32_t v = val(j, half);
        if (col < cout) row[col] = (unsigned char)(v & 0xff);
        if (col + 1 < cout) row[col + 1] = (unsigned char)(v >> 8);
      }
    }
  }
}

// The same for 32-bit values (int32, fp32 bits): val(j, half, e) gives the
// lane's value of column 8j + 2t + e.  `vec` (cout % 4 == 0, rows 16-byte
// aligned): each lane writes 8 channels with two 16-byte stores.
template <int PN, class F>
__device__ __forceinline__ void store32(F val, int n0, int cout,
                                        uint32_t* const (&rows)[2],
                                        bool vec) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t* row = rows[half];
    if (vec) {
#pragma unroll
      for (int jq = 0; jq < PN / 32; ++jq) {
        uint32_t lo[4], hi[4], ql[4], qh[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          lo[k] = val(jq * 4 + k, half, 0);
          hi[k] = val(jq * 4 + k, half, 1);
        }
        quad_transpose(lo, ql);  // ql[x], qh[x]: columns 2x, 2x + 1 of
        quad_transpose(hi, qh);  // block jq*4 + t
        const int col8 = n0 + 8 * (jq * 4 + t);
        if (row != nullptr && col8 < cout)
          *reinterpret_cast<uint4*>(row + col8) =
              make_uint4(ql[0], qh[0], ql[1], qh[1]);
        if (row != nullptr && col8 + 4 < cout)
          *reinterpret_cast<uint4*>(row + col8 + 4) =
              make_uint4(ql[2], qh[2], ql[3], qh[3]);
      }
    } else if (row != nullptr) {
#pragma unroll
      for (int j = 0; j < PN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (col < cout) row[col] = val(j, half, 0);
        if (col + 1 < cout) row[col + 1] = val(j, half, 1);
      }
    }
  }
}

// Epilogue of the bf16 convs to device memory: y[row][n0 + col] =
// bf16(relu(acc + bias)) for the warpgroup's 64 x PN tile.
template <int PN>
__device__ __forceinline__ void store_global(const float (&acc)[PN / 2],
                                             const float* __restrict__ bias,
                                             int n0, int cout,
                                             __nv_bfloat16* const (&rows)[2],
                                             bool vec) {
  const int t = threadIdx.x & 3;
  unsigned short* const r16[2] = {reinterpret_cast<unsigned short*>(rows[0]),
                                  reinterpret_cast<unsigned short*>(rows[1])};
  store16<PN>(
      [&](int j, int half) {
        const int col = n0 + 8 * j + 2 * t;
        const float b0 = col < cout ? bias[col] : 0.f;
        const float b1 = col + 1 < cout ? bias[col + 1] : 0.f;
        return relu_bf16x2(acc[4 * j + 2 * half] + b0,
                           acc[4 * j + 2 * half + 1] + b1);
      },
      n0, cout, r16, vec);
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
