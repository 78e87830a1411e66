// C = A @ B on the tensor cores: int8 x int8 -> int32 (wgmma m64nNk32
// s8), or bf16 x bf16 -> fp32 (m64nNk16), for any m, k and n.
//
// Replaces the Pallas kernel of fabric_tpu/tools/ablate_train.py:346
// (microbench_int8_matmul; kernel built by make_pallas at :373-395, with
// pl.pallas_call at :382), the probe of the int8 matrix rate.  Its core
// (conv_tile.cuh) also carries the int8 serving conv (conv3x3_s8.cu) and
// the bf16 convs.
//
// Bound on the H100: at the microbench's shape (m 131072, k = n = 512) the
// product is 2*m*k*n = 68.7 G operations, 35 us at 1979 TOP/s int8 (70 us
// at 989 TFLOP/s bf16), but it moves m*k bytes in (twice that in bf16)
// and 4*m*n bytes out (268 MB of int32 or fp32, 80 us at 3.35 TB/s): the
// output bounds it.  The TPU kernel's 1024-row tiles and whole-K VMEM
// residency do not carry over (a Hopper block has 227 KB of shared
// memory, and many blocks fill 132 SMs).
//
// Design: the GEMM is the conv core's one-tap conv without a halo.  A
// block owns 128 rows x PN (64 or 128) columns of C, two consumer
// warpgroups of 64 rows each.  A is staged by cp.async into five shared
// buffers, 128 bytes of K at a time, four chunks ahead of the math
// (cp.async.wait_group), zeros past m and past k; B is packed once per
// call (ops/int8_matmul.py pack_b, the core-matrix layout of the conv
// weights) and streamed through a 4-slot ring by cp.async.bulk from a
// producer warp.  A reaches wgmma from registers by ldmatrix, as in the
// convs, rather than by a shared-memory descriptor: the one pipeline
// (mma_chunk) serves both, and the padded 144-byte rows that keep
// ldmatrix free of bank conflicts need no core-matrix staging.  C goes
// through shared memory (the ring and A buffers, free once the products
// are done), so that every warp stores whole 512-byte rows.  The chunk,
// the lookahead and the blocks per SM are what tools/sweep_int8_matmul.py
// found fastest on the H100 (PERF.md): one block per SM with four chunks
// of lookahead beat two blocks per SM with one.
#include "conv_tile.cuh"

namespace fabric {

constexpr int kMmKB = 128;            // bytes of K per staged chunk
constexpr int kMmPitch = kMmKB + 16;  // bytes per staged row: an odd number
                                      // of 16-byte groups, so 8 consecutive
                                      // rows fall on distinct bank groups
constexpr int kMmRows = 128;          // rows of A and C per block
constexpr int kMmABuf = 5;            // A chunks in flight: 4 ahead
constexpr int kMmBlocks = 1;          // blocks per SM (launch bound)

__device__ __forceinline__ uint32_t bits(int v) { return (uint32_t)v; }
__device__ __forceinline__ uint32_t bits(float v) {
  return __float_as_uint(v);
}

// Shared memory of one block: the ring and the A buffers, or the staged C
// tile (128 rows of PN + 8 words) where that is larger, then the ring's
// barriers.
__host__ __device__ inline int mm_body_bytes(int pn, int stages) {
  const int loads = stages * pn * kMmKB + kMmABuf * kMmRows * kMmPitch;
  const int out = kMmRows * (pn + 8) * 4;
  return loads > out ? loads : out;
}

template <int PN, typename Acc>
__global__ void __launch_bounds__(kConvThreads, kMmBlocks)
    gemm_kernel(const unsigned char* __restrict__ a,
                const void* __restrict__ bpk, Acc* __restrict__ c, int m,
                int kbytes, int n, int kpad, int stages, bool vec_in,
                bool vec_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int stage_bytes = PN * kMmKB, abytes = kMmRows * kMmPitch;
  unsigned char* abuf = smem + stages * stage_bytes;
  Ring ring = make_ring(smem, smem + mm_body_bytes(PN, stages), stages,
                        stage_bytes);
  const int m0 = blockIdx.x * kMmRows, nt = blockIdx.y;

  if (threadIdx.x >= kConsumers) {  // the producer warp
    if (threadIdx.x == kConsumers)
      produce(ring, bpk, kpad, PN, nt, nt + 1, 1, 1, kMmKB, 1);
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mbase = (warp >> 2) * 64 + (warp & 3) * 16;
  const uint32_t a_off =
      (mbase + (lane & 15)) * kMmPitch + ((lane >> 4) & 1) * 16;

  Acc acc[PN / 2];
#pragma unroll
  for (int i = 0; i < PN / 2; ++i) acc[i] = 0;

  // chunk q of A into buffer q % kMmABuf; one cp.async group per chunk
  // (empty past the last, so that the groups count evenly)
  const int n_chunks = kpad / kMmKB;
  constexpr int kVecs = kMmKB / 16;  // 16-byte vectors per row and chunk
  auto stage = [&](int q) {
    if (q < n_chunks) {
      const int c0 = q * kMmKB;
      unsigned char* buf = abuf + (q % kMmABuf) * abytes;
      for (int idx = threadIdx.x; idx < kMmRows * kVecs;
           idx += kConsumers) {
        const int r = idx / kVecs, v = idx % kVecs, col = c0 + v * 16;
        const bool inside = m0 + r < m && col < kbytes;
        const unsigned char* src =
            a + (inside ? (size_t)(m0 + r) * kbytes + col : 0);
        unsigned char* dst = buf + r * kMmPitch + v * 16;
        if (vec_in) {
          cp_async16(smem_addr(dst), src, inside ? 16 : 0);
        } else {
          union {
            uint4 u;
            unsigned char b[16];
          } val;
          val.u = make_uint4(0, 0, 0, 0);
          if (inside) {
#pragma unroll
            for (int e = 0; e < 16; ++e)
              if (col + e < kbytes) val.b[e] = src[e];
          }
          *reinterpret_cast<uint4*>(dst) = val.u;
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int q = 0; q < kMmABuf - 1; ++q) stage(q);
  for (int q = 0; q < n_chunks; ++q) {
    cp_async_wait_group<kMmABuf - 2>();
    consumer_sync();  // chunk q landed; chunk q - 1's buffer is free
    stage(q + kMmABuf - 1);
    mma_chunk<PN, kMmKB, 1>(acc, ring,
                            smem_addr(abuf + (q % kMmABuf) * abytes) + a_off,
                            0, 0, 0);
  }

  // C through shared memory (rows of PN + 8 words, so that the 8-byte
  // writes of a half-warp fall on distinct banks), then whole rows out
  const int t = lane & 3, n0 = nt * PN;
  uint32_t* tile = reinterpret_cast<uint32_t*>(smem);
  constexpr int kP = PN + 8;
  cp_async_wait_all();
  consumer_sync();  // every A read and B slot is done with
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int j = 0; j < PN / 8; ++j)
      *reinterpret_cast<uint2*>(tile + (mbase + (lane >> 2) + 8 * half) * kP +
                                8 * j + 2 * t) =
          make_uint2(bits(acc[4 * j + 2 * half]),
                     bits(acc[4 * j + 2 * half + 1]));
  consumer_sync();
  for (int idx = threadIdx.x; idx < kMmRows * (PN / 4); idx += kConsumers) {
    const int r = idx / (PN / 4), col = n0 + (idx % (PN / 4)) * 4;
    if (m0 + r >= m || col >= n) continue;
    const uint32_t* src = tile + r * kP + (idx % (PN / 4)) * 4;
    uint32_t* dst = reinterpret_cast<uint32_t*>(c + (size_t)(m0 + r) * n);
    if (vec_out) {
      *reinterpret_cast<uint4*>(dst + col) =
          *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < n) dst[col + e] = src[e];
    }
  }
}

template <int PN, typename Acc>
int launch(const void* a, const void* bpk, void* c, int m, int kbytes, int n,
           int kpad_bytes, int stages, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<PN, Acc>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec_in =
      kbytes % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool vec_out = n % 4 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0;
  dim3 grid((m + kMmRows - 1) / kMmRows, (n + PN - 1) / PN);
  gemm_kernel<PN, Acc><<<grid, kConvThreads, smem, stream>>>(
      static_cast<const unsigned char*>(a), bpk, static_cast<Acc*>(c), m,
      kbytes, n, kpad_bytes, stages, vec_in, vec_out);
  return (int)cudaGetLastError();
}

}  // namespace fabric

using namespace fabric;

// Dynamic shared memory of one block: the ring (stages slots of pn x 128
// bytes) and the staged A chunks (or the staged C tile), and 16 bytes of
// barriers per slot.
extern "C" int fabric_int8_matmul_smem_bytes(int pn, int stages) {
  return mm_body_bytes(pn, stages) + 16 * stages;
}

// a (m, k) row-major; bpk: B (k, n) packed by ops/int8_matmul.py pack_b
// (K zero-padded to kpad elements, a multiple of 128 bytes; N tiles of pn
// = 64 or 128 columns); c (m, n) row-major.  int8 in and int32 out when
// is_int8, else bf16 in and fp32 out.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int fabric_int8_matmul(const void* a, const void* bpk, void* c,
                                  int m, int k, int n, int kpad, int pn,
                                  int stages, int is_int8, void* stream) {
  const int es = is_int8 ? 1 : 2;
  if (m <= 0 || k <= 0 || n <= 0 || kpad < k || (kpad * es) % kMmKB ||
      (pn != 64 && pn != 128) || stages < 2 ||
      reinterpret_cast<uintptr_t>(bpk) % 16 ||
      (long long)(n + pn - 1) / pn > 65535)
    return (int)cudaErrorInvalidValue;
  const int smem = fabric_int8_matmul_smem_bytes(pn, stages);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kb = k * es, kpb = kpad * es;
  if (is_int8)
    return pn == 64 ? launch<64, int>(a, bpk, c, m, kb, n, kpb, stages, smem, s)
                    : launch<128, int>(a, bpk, c, m, kb, n, kpb, stages, smem,
                                       s);
  return pn == 64 ? launch<64, float>(a, bpk, c, m, kb, n, kpb, stages, smem, s)
                  : launch<128, float>(a, bpk, c, m, kb, n, kpb, stages, smem,
                                       s);
}
