// The float32 core of the port's fp32 conv kernels: conv3x3_bias_relu_f32.cu
// (row 1's fp32 form) and double_conv3x3_bias_relu_f32.cu (row 2's).
//
// float32 products at the tensor cores' rate: 3xTF32.  A TF32 operand keeps
// 10 of fp32's 23 mantissa bits, so each float32 a is split into a = hi +
// lo + r, hi = tf32(a), lo = tf32(a - hi) (both rounded to nearest, ties
// away: cvt.rna.tf32.f32; a - hi is exact in fp32), |r| <= 2^-22 |a|; and
// a * b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b, the dropped lo_a lo_b and r
// terms below 2^-21 |a b|.  Each product of two TF32 values is exact in the
// tensor core's fp32 sums.  Three m64nNk8 TF32 wgmma per 8 channels of K
// (495 TFLOP/s of TF32, so ~165 of float32 products on the H100) against
// one FFMA per product (67 TFLOP/s).
//
// The machinery is the bf16 core's (conv_tile.cuh, which counts K in bytes:
// one 32-byte K step is 8 fp32 channels here): two consumer warpgroups, a
// producer streaming weight blocks with cp.async.bulk through an mbarrier
// ring, the haloed input patch staged with cp.async, each 3x3 tap a
// row-address shift inside the patch.
// * A from registers (wgmma's RS form, CUTLASS's
//   SM90_64xNx8_F32TF32TF32_RS_TN): ldmatrix.x4 .b16 of 32 bytes of a
//   pixel row yields the m64k8 TF32 fragment (a0 = row g, k t; a1 = row
//   g + 8; a2, a3 = k t + 4), split into hi and lo in registers.
// * B, the weights, split once at pack time (ops/conv.py pack_weight_f32)
//   into a hi and a lo plane, each block of PN channels x kb bytes of K x
//   one tap in the no-swizzle K-major core-matrix layout (TF32 wgmma reads
//   B only K-major): a ring slot holds the hi block, then the lo block.
// * Per K step, always in this order: lo_a hi_b, hi_a lo_b, hi_a hi_b (the
//   small terms first).
// * Promotion: the tensor core's fp32 sums keep their own rounding, so each
//   K chunk (<= 16 channels x 9 taps) is summed by wgmma alone, from zero,
//   and added into a register fp32 sum with one rounded add.  Chunks are
//   fixed (16 channels from channel 0), so every output's order of
//   operations is the same wherever its pixel falls in a tile: a band of a
//   scene sums each pixel exactly as the whole scene does, the fused double
//   conv's convs equal the single kernel's bit for bit, and a negated
//   kernel gives the exact negation (the splits are sign-symmetric).
#pragma once

#include "conv_tile.cuh"

namespace fabric {

template <>
struct Elem<4> {
  using T = uint32_t;
};

namespace x3 {

// Bytes of one weight block pair (hi then lo) of pn channels x kKB bytes.
__host__ __device__ inline int stage_bytes(int pn) { return 2 * pn * kKB; }

// A block: the two consumer warpgroups and a producer warpgroup, one
// thread of which streams the weights.  ptxas budgets registers by
// warpgroup (a lone producer warp costs a warpgroup's share: 168 a thread
// at one block per SM, where the consumers spilled), so the producer
// warpgroup hands its registers to the consumers with setmaxnreg.  The
// pool is the block's: from the r = 65536 / (384 B) (rounded down to 8)
// each thread starts with at B blocks per SM, the consumers may take what
// the producer gives back, 256 (consumer - r) <= 128 (r - producer), or
// setmaxnreg.inc waits for ever.
constexpr int kThreads = kConsumers + 128;

template <int B>
struct Regs;
template <>
struct Regs<1> {  // r = 168
  static constexpr int producer = 40, consumer = 232;
};
template <>
struct Regs<2> {  // r = 80
  static constexpr int producer = 24, consumer = 104;
};

// Every thread of the warpgroup runs the same one of these.
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// a (4 fp32 bit patterns) -> its TF32 hi and lo parts.
__device__ __forceinline__ void split(const uint32_t (&a)[4],
                                      uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float f = __uint_as_float(a[i]);
    hi[i] = tf32_rna(f);
    lo[i] = tf32_rna(f - __uint_as_float(hi[i]));
  }
}

#define X3_ACC8(C, i)                                                     \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), C(d[i + 5]), \
      C(d[i + 6]), C(d[i + 7])
#define X3_ACC32(C, i) \
  X3_ACC8(C, i), X3_ACC8(C, i + 8), X3_ACC8(C, i + 16), X3_ACC8(C, i + 24)
#define X3_REGS32                                        \
  "%0, %1, %2, %3, %4, %5, %6, %7, "                     \
  "%8, %9, %10, %11, %12, %13, %14, %15, "               \
  "%16, %17, %18, %19, %20, %21, %22, %23, "             \
  "%24, %25, %26, %27, %28, %29, %30, %31"
#define X3_REGS64                                        \
  X3_REGS32 ", "                                         \
  "%32, %33, %34, %35, %36, %37, %38, %39, "             \
  "%40, %41, %42, %43, %44, %45, %46, %47, "             \
  "%48, %49, %50, %51, %52, %53, %54, %55, "             \
  "%56, %57, %58, %59, %60, %61, %62, %63"
#define X3_A(a) "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3])

// One 8-channel K step: d (64 x PN) = (acc ? d : 0) + A (64 x 8 TF32,
// registers) x B (8 x PN TF32, shared memory by descriptor), fp32 sums.
template <int PN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[PN / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int acc) {
  if constexpr (PN == 64)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{" X3_REGS32 "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : X3_ACC32("+f", 0)
        : X3_A(a), "l"(desc), "r"(acc));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{" X3_REGS64 "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : X3_ACC32("+f", 0), X3_ACC32("+f", 32)
        : X3_A(a), "l"(desc), "r"(acc));
}
#undef X3_ACC8
#undef X3_ACC32
#undef X3_REGS32
#undef X3_REGS64
#undef X3_A

// sum += the 9 taps of one K chunk of KB bytes (32 or 64: 8 or 16
// channels), as 3xTF32, summed by wgmma from zero and then added to sum.
// a_addr: shared address of this lane's ldmatrix row for tap (0, 0) (its
// pixel, plus 16 bytes for lanes 16-31); a tap moves it by dy rows of
// row_bytes and dx pixels of px_bytes.  Pipelined as the bf16 core's
// mma_chunk: while tap t's wgmma run, tap t - 1's slot is released and tap
// t + 1's fragments are loaded and split (double-buffered, since the
// wgmma in flight read the current ones).
template <int PN, int KB>
__device__ __forceinline__ void mma_chunk(float (&sum)[PN / 2], Ring& r,
                                          uint32_t a_addr, int row_bytes,
                                          int px_bytes) {
  constexpr int KS = KB / 32;
  float acc[PN / 2];
  uint32_t hi[2][KS][4], lo[2][KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    uint32_t f[4];
    ldmatrix_x4(f, a_addr + s * 32);
    split(f, hi[0][s], lo[0][s]);
  }
  int prev = 0;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int b = tap & 1;
    mbar_wait(r.full + 8 * r.idx, r.phase);
    const uint64_t dh = make_desc(r.slot(), 128, KB * 8);
    const uint64_t dl = make_desc(r.slot() + KB * PN, 128, KB * 8);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const uint64_t step = s * (256 >> 4);
      wgmma_tf32<PN>(acc, lo[b][s], dh + step, tap > 0 || s > 0);
      wgmma_tf32<PN>(acc, hi[b][s], dl + step, 1);
      wgmma_tf32<PN>(acc, hi[b][s], dh + step, 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // tap - 1's wgmma are done with its slot and registers
    if (tap > 0 && (threadIdx.x & 31) == 0) mbar_arrive(r.empty + 8 * prev);
    if (tap + 1 < 9) {
      const int t = tap + 1;
      const uint32_t a = a_addr + (t / 3) * row_bytes + (t % 3) * px_bytes;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        uint32_t f[4];
        ldmatrix_x4(f, a + s * 32);
        split(f, hi[b ^ 1][s], lo[b ^ 1][s]);
      }
    }
    prev = r.idx;
    r.advance();
  }
  wgmma_wait<0>();
  if ((threadIdx.x & 31) == 0) mbar_arrive(r.empty + 8 * prev);
#pragma unroll
  for (int i = 0; i < PN / 2; ++i) sum[i] += acc[i];
}

// mma_chunk for a chunk of kb = 64 or 32 bytes.
template <int PN>
__device__ __forceinline__ void mma_chunk(float (&sum)[PN / 2], Ring& r,
                                          uint32_t a_addr, int row_bytes,
                                          int px_bytes, int kb) {
  if (kb == kKB)
    mma_chunk<PN, kKB>(sum, r, a_addr, row_bytes, px_bytes);
  else
    mma_chunk<PN, 32>(sum, r, a_addr, row_bytes, px_bytes);
}

// The epilogue's value: relu(sum + bias), as fp32 bits.
__device__ __forceinline__ uint32_t relu_bits(float s, float b) {
  return __float_as_uint(fmaxf(s + b, 0.f));
}

// Epilogue to device memory: y[row][n0 + col] = relu(sum + bias) for the
// warpgroup's 64 x PN tile (rows as store32's).
template <int PN>
__device__ __forceinline__ void store_global(const float (&sum)[PN / 2],
                                             const float* __restrict__ bias,
                                             int n0, int cout,
                                             float* const (&rows)[2],
                                             bool vec) {
  const int t = threadIdx.x & 3;
  uint32_t* const r32[2] = {reinterpret_cast<uint32_t*>(rows[0]),
                            reinterpret_cast<uint32_t*>(rows[1])};
  store32<PN>(
      [&](int j, int half, int e) {
        const int col = n0 + 8 * j + 2 * t + e;
        return relu_bits(sum[4 * j + 2 * half + e],
                         col < cout ? bias[col] : 0.f);
      },
      n0, cout, r32, vec);
}

}  // namespace x3
}  // namespace fabric
