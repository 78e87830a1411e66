// C = A @ B on the tensor cores: int8 x int8 -> int32 (mma.sync m16n8k32),
// or bf16 x bf16 -> fp32 (m16n8k16), for any m, k and n.
//
// Replaces the Pallas kernel of fabric_tpu/tools/ablate_train.py:346
// (microbench_int8_matmul; kernel built by make_pallas at :373-395, with
// pl.pallas_call at :382), the probe of the int8 matrix rate.  The same GEMM
// core (int8_gemm.cuh) carries the int8 serving convs (conv3x3_s8.cu).
//
// Bound on the H100: at the microbench's shape (m 131072, k = n = 512) the
// product is 2*m*k*n = 68.7 G operations, 35 us at 1979 TOPS int8, but it
// moves m*k bytes in and 4*m*n bytes out (335 MB, 100 us at 3.35 TB/s): the
// int32 result bounds it.  The design keeps the operations on the tensor
// cores and reads each A byte from device memory once: a block owns 128 rows
// x 64 columns of C; it stages its 128 A rows, 128 bytes of K at a time,
// into shared memory (the next chunk is loaded into registers while the
// current one is multiplied), and reads B from the packed [n][k] copy,
// which stays in L2.  The TPU kernel's 1024-row tiles and whole-K VMEM
// residency do not carry over: a Hopper block has 227 KB of shared memory,
// and many small blocks fill 132 SMs.  Ragged m and k are masked when A is
// staged (zeros past the end); B arrives zero-padded to multiples of 64
// columns and 32 bytes of K; the store masks ragged n.
#include "int8_gemm.cuh"

namespace fabric {

constexpr int kMmChunk = 128;               // bytes of K staged per step
constexpr int kMmPitch = kMmChunk + 16;     // 144 bytes = 36 banks: the 8
                                            // rows of a fragment load start
                                            // on distinct banks
constexpr int kMmVecs = kBM * kMmChunk / 16 / kThreads;  // uint4 per thread

template <typename Acc>
__global__ void __launch_bounds__(kThreads)
    gemm_kernel(const unsigned char* __restrict__ a,
                const unsigned char* __restrict__ bt, Acc* __restrict__ c,
                int m, int kbytes, int n, int kpad, bool vec) {
  __shared__ __align__(16) unsigned char tile[kBM * kMmPitch];

  const int lane = threadIdx.x & 31, wm = (threadIdx.x >> 5) & 3;
  const int wn = threadIdx.x >> 7, g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;

  const unsigned char* arow[4];
  Acc* dst[4];
  bool valid[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = wm * 32 + (q >> 1) * 16 + (q & 1) * 8 + g;
    arow[q] = tile + r * kMmPitch + t * 4;
    valid[q] = m0 + r < m;
    dst[q] = c + (size_t)min(m0 + r, m - 1) * n;
  }
  const unsigned char* brow = bt + (size_t)(n0 + wn * 32 + g) * kpad + t * 4;

  // thread i stages 16-byte vector i, i + 256, ... of the 128 x 128 chunk
  uint4 next[kMmVecs];
  auto fetch = [&](int c0) {
#pragma unroll
    for (int v = 0; v < kMmVecs; ++v) {
      const int idx = threadIdx.x + v * kThreads;
      const int r = idx / (kMmChunk / 16), col = c0 + (idx % (kMmChunk / 16)) * 16;
      const int row = m0 + r;
      next[v] = load16(a + (size_t)min(row, m - 1) * kbytes + col,
                       row < m ? kbytes - col : 0, vec);
    }
  };

  Acc acc[2][4][4] = {};
  fetch(0);
  for (int c0 = 0; c0 < kpad; c0 += kMmChunk) {
    __syncthreads();  // the previous chunk's reads are done
#pragma unroll
    for (int v = 0; v < kMmVecs; ++v) {
      const int idx = threadIdx.x + v * kThreads;
      *reinterpret_cast<uint4*>(tile + (idx / (kMmChunk / 16)) * kMmPitch +
                                (idx % (kMmChunk / 16)) * 16) = next[v];
    }
    __syncthreads();
    if (c0 + kMmChunk < kpad) fetch(c0 + kMmChunk);
    gemm_warp_tile(acc, arow, brow + c0, kpad, min(kMmChunk, kpad - c0));
  }
  store_warp_tile(acc, dst, valid, n0 + wn * 32, n, (n & 1) == 0);
}

}  // namespace fabric

using namespace fabric;

// a (m, k) row-major, bt (ceil64(n), kpad) row-major (B transposed, zero
// past n and k), c (m, n) row-major; int8 in and int32 out when is_int8,
// else bf16 in and fp32 out.  k and kpad count elements; kpad * element
// size is a multiple of 32 bytes.  Returns the CUDA error of the launch.
extern "C" int fabric_int8_matmul(const void* a, const void* bt, void* c,
                                  int m, int k, int n, int kpad, int is_int8,
                                  void* stream) {
  const int es = is_int8 ? 1 : 2;
  if (m <= 0 || k <= 0 || n <= 0 || kpad < k || (kpad * es) % 32)
    return (int)cudaErrorInvalidValue;
  const int kbytes = k * es, kpad_bytes = kpad * es;
  const bool vec = kbytes % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* pa = static_cast<const unsigned char*>(a);
  const unsigned char* pb = static_cast<const unsigned char*>(bt);
  if (is_int8)
    gemm_kernel<int><<<grid, kThreads, 0, s>>>(pa, pb, static_cast<int*>(c), m,
                                               kbytes, n, kpad_bytes, vec);
  else
    gemm_kernel<float><<<grid, kThreads, 0, s>>>(
        pa, pb, static_cast<float*>(c), m, kbytes, n, kpad_bytes, vec);
  return (int)cudaGetLastError();
}
