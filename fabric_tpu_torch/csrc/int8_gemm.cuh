// The tensor-core GEMM core of the int8 kernels (int8_matmul.cu and
// conv3x3_s8.cu): a warp's 32 x 32 tile of C += A x B, with s8 x s8 -> s32
// mma.sync (m16n8k32) or, for the bf16 form of int8_matmul, bf16 x bf16 ->
// fp32 mma.sync (m16n8k16, conv_tile.cuh's mma16816).
//
// Everything here counts K in BYTES.  The two instructions read their
// fragments from the same bytes: one K step is 32 bytes (32 int8 or 16
// bf16), an A register holds the 4 bytes at byte t*4 (and t*4 + 16) of row
// g or g + 8, a B register the 4 bytes at byte t*4 (and t*4 + 16) of output
// column g, and both accumulate into four 32-bit values at rows g, g + 8 and
// columns t*2, t*2 + 1 (g = lane / 4, t = lane % 4).  So one loader, one
// staging layout and one store serve both; the accumulator type (int or
// float) picks the instruction.
//
// Layouts: A rows are staged in shared memory, kPitchS8 bytes apart; B is
// packed once as [n][k] bytes (K contiguous, zero-padded to a multiple of 32
// bytes), so each B register is one aligned 32-bit load that stays in L1/L2.
#pragma once

#include "conv_tile.cuh"

namespace fabric {

// Bytes per staged A row: 64 bytes of K plus 16 of padding.  80 bytes are 20
// banks, so the 8 rows g of one fragment load start on distinct banks.
constexpr int kChunkS8 = 64;
constexpr int kPitchS8 = kChunkS8 + 16;

__device__ __forceinline__ void mma_step(int (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_step(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  mma16816(d, a, b);
}

// acc[mt][nt] += A x B over `kbytes` bytes of K (a multiple of 32) for the
// warp's 32 x 32 tile.  arow[q] (q = mt*2 + half) points at byte t*4 of the
// warp's A row mt*16 + half*8 + g; brow at byte t*4 of B row (output column)
// g of the warp's first 8 columns; bpitch is the bytes between B rows.
template <typename Acc>
__device__ __forceinline__ void gemm_warp_tile(
    Acc (&acc)[2][4][4], const unsigned char* const (&arow)[4],
    const unsigned char* __restrict__ brow, int bpitch, int kbytes) {
  for (int k = 0; k < kbytes; k += 32) {
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const unsigned char* r0 = arow[mt * 2] + k;      // row g
      const unsigned char* r1 = arow[mt * 2 + 1] + k;  // row g + 8
      a[mt][0] = *reinterpret_cast<const uint32_t*>(r0);
      a[mt][1] = *reinterpret_cast<const uint32_t*>(r1);
      a[mt][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
      a[mt][3] = *reinterpret_cast<const uint32_t*>(r1 + 16);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const unsigned int* bp = reinterpret_cast<const unsigned int*>(
          brow + (size_t)nt * 8 * bpitch + k);
      b[nt][0] = __ldg(bp);
      b[nt][1] = __ldg(bp + 4);  // bytes + 16
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_step(acc[mt][nt], a[mt], b[nt]);
  }
}

__device__ __forceinline__ unsigned int bits(int v) { return (unsigned int)v; }
__device__ __forceinline__ unsigned int bits(float v) {
  return __float_as_uint(v);
}

// Write the warp's tile as it is (no epilogue): row q of the thread goes to
// dst[q] (column 0 of that output row) when valid[q], columns nbase +
// nt*8 + t*2 (+1) below n.  `pairs`: two neighbouring columns may be stored
// as one aligned 8-byte write (n even, dst 8-byte aligned).
template <typename Acc>
__device__ __forceinline__ void store_warp_tile(const Acc (&acc)[2][4][4],
                                                Acc* const (&dst)[4],
                                                const bool (&valid)[4],
                                                int nbase, int n, bool pairs) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (!valid[q]) continue;
    const int mt = q >> 1, half = q & 1;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int o = nbase + nt * 8 + t * 2;
      if (o >= n) continue;
      const Acc v0 = acc[mt][nt][half * 2], v1 = acc[mt][nt][half * 2 + 1];
      if (pairs) {
        *reinterpret_cast<uint2*>(dst[q] + o) = make_uint2(bits(v0), bits(v1));
      } else {
        dst[q][o] = v0;
        if (o + 1 < n) dst[q][o + 1] = v1;
      }
    }
  }
}

// 16 bytes of a row from device memory, zero past `limit` bytes of the row
// (`vec`: the row and its length are 16-byte aligned, one vector load).
__device__ __forceinline__ uint4 load16(const unsigned char* __restrict__ src,
                                        int limit, bool vec) {
  union {
    uint4 u;
    unsigned char b[16];
  } val;
  val.u = make_uint4(0, 0, 0, 0);
  if (limit <= 0) return val.u;
  if (vec) return __ldg(reinterpret_cast<const uint4*>(src));
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if (e < limit) val.b[e] = src[e];
  return val.u;
}

}  // namespace fabric
