// The int8 serving path's 3x3 SAME conv on NHWC int8 with exact int32
// sums, and the dequantize / bias / ReLU / requantize epilogue that
// follows it at every conv site, in registers.
//
// Replaces what fabric_tpu leaves to XLA at each int8 conv site: the s8 x
// s8 -> s32 conv conv_raw (fabric_tpu/infer/quant.py:176-180), which
// fabric_tpu fuses with its consumer, conv_q -> ReLU -> q (enc_dc,
// :182-209) or the split decoder conv (up_q, :221-242).  The convs are the
// serving use of the contraction of the Pallas int8 matmul of
// tools/ablate_train.py:346 (int8_matmul.cu), on the same core.
//
// One launch computes, per output channel c (k = sw * sx, the scale
// product in float32, formed by the caller; inv_s = 1 / s_out in float32):
//   raw    int32 acc
//   int8   h = max(bf16(fma(float(acc), k[c], bias[c])), 0);
//          out = clamp(rint(float(h) * inv_s), -127, 127)
//   bf16   h as above, bf16 out
//   split  two K segments (skip x K_skip, then up x K_up) into two
//          accumulator sets: h = max(bf16(fma(float(a), k[c],
//          float(b) * k2[c]) + bias[c]), 0), then int8 as above
//   float32, int8_f32, split_f32: the float32 compute dtype's forms of
//          bf16, int8 and split (fabric_tpu's dtype="float32" int8
//          forward): h without the bf16 rounding, h = max(fma(float(acc),
//          k[c], bias[c]), 0); float32 out, or int8 from that h
// with the float operations spelled as intrinsics, so that each rounds as
// the plain PyTorch version (ops/conv_s8.py) does and nvcc contracts
// nothing else.
//
// Bound on the H100: with int8 in and int8 or bf16 out a launch moves
// N*H*W*(Cin + Cout) bytes (x2 for bf16 out) for 2*N*H*W*9*Cin*Cout
// operations: the full-resolution 64-channel sites sit at the card's
// int8 ridge (1979 TOP/s over 3.35 TB/s, ~590 operations per byte), the
// deeper ones are bound by the tensor cores.  No int32 tensor reaches
// device memory except in raw mode.
//
// Design (the core is conv_tile.cuh): wgmma m64nPNk32 s8 -> s32 from two
// consumer warpgroups, each 64 of the block's 128 output pixels; A by
// ldmatrix from a haloed patch staged 64 int8 channels at a time by
// cp.async into two buffers; the weights, packed once (ops/conv_s8.py
// pack_weight), streamed through a 4-slot ring by cp.async.bulk from a
// producer warp; M chunks of whole small images; PN = 64 (two or three
// blocks per SM) or 128 (one); the split form parks its first segment's
// sums in shared memory, so one register set serves both; 16-byte
// stores.
#include "conv_tile.cuh"

namespace fabric {

// What a launch writes.
enum S8Mode {
  kRaw = 0, kInt8 = 1, kBf16 = 2, kSplit = 3,
  kF32 = 4, kInt8F32 = 5, kSplitF32 = 6
};

// The split forms, and the forms whose h stays float32.
__host__ __device__ constexpr bool s8_split(int mode) {
  return mode == kSplit || mode == kSplitF32;
}
__host__ __device__ constexpr bool s8_f32(int mode) { return mode >= kF32; }

// One K segment: an int8 NHWC input of cin channels and its weights
// packed by ops/conv_s8.py pack_weight (cin_pad = cin rounded up to 32).
struct Seg {
  const void* x;
  const void* w;
  int cin, cin_pad;
  bool vec;
};

// The per-channel epilogue vectors (float32, cout long; k2 for the split
// form's second segment) and the float32 reciprocal of the output scale.
struct Epi {
  const float* k;
  const float* k2;
  const float* bias;
  float inv_s;
};

// Blocks per SM, from the register budget: ptxas keeps every wgmma
// asynchronous only with enough registers beside the accumulators.  Nine
// warps a block put 3 on some SM sub-partition at one block (168
// registers a thread), 5 at two (96), 7 at three (72): PN = 128 one block;
// PN = 64 three, two for the split form (whose parked sums leave a third
// no shared memory).
constexpr int s8_blocks_per_sm(int pn, int mode) {
  return pn == 128 ? 1 : s8_split(mode) ? 2 : 3;
}

// Bytes of shared memory that park the split form's first sums: PN/2
// int32 of each consumer thread.
__host__ __device__ constexpr int park_bytes(int pn) {
  return pn / 2 * kConsumers * 4;
}

// int8 code of a non-negative value h: clamp(rint(h * inv_s)).
__device__ __forceinline__ uint32_t quantize_s8(float h, float inv_s) {
  const float v = fminf(fmaxf(rintf(__fmul_rn(h, inv_s)), -127.f), 127.f);
  return (uint32_t)(unsigned char)(signed char)__float2int_rn(v);
}

template <int PN, int MODE>
__global__ void __launch_bounds__(kConvThreads, s8_blocks_per_sm(PN, MODE))
    conv3x3_s8_kernel(Seg s0, Seg s1, Epi ep, void* __restrict__ y, int n,
                      int h, int w, int cout, Geo g, int tiles_h,
                      int tiles_w, int stages, bool vec_out) {
  constexpr bool kTwo = s8_split(MODE);
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
    if (threadIdx.x == kConsumers) {
      produce(ring, s0.w, s0.cin_pad, PN, nt, nt + 1, 1, 1);
      if (kTwo) produce(ring, s1.w, s1.cin_pad, PN, nt, nt + 1, 1, 1);
    }
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mbase = (warp >> 2) * 64 + (warp & 3) * 16;
  const uint32_t a_off = patch_row_offset(mbase + (lane & 15), g);
  const int pc = (1 << g.tw) + 2;

  int acc[PN / 2];
#pragma unroll
  for (int i = 0; i < PN / 2; ++i) acc[i] = 0;
  // the split form's first sums, element i of this thread at i *
  // kConsumers + threadIdx.x (consecutive threads, consecutive words)
  int* park = reinterpret_cast<int*>(smem + stages * stage_bytes +
                                     2 * pbytes + 16 * stages);

  // patches are staged in the order they are taken: segment 0's chunks,
  // then segment 1's; q counts them and picks the buffer
  const int n0c = (s0.cin_pad + kKB - 1) / kKB;
  const int total = n0c + (kTwo ? (s1.cin_pad + kKB - 1) / kKB : 0);
  auto stage = [&](int q) {
    const bool second = q >= n0c;
    const Seg& s = second ? s1 : s0;
    const int c0 = (second ? q - n0c : q) * kKB;
    stage_patch<1>(patch[q & 1], s.x, n, h, w, s.cin, g, img0, i0, j0, c0,
                   min(kKB, s.cin_pad - c0), s.vec);
    cp_async_commit();
  };
  auto run = [&](auto& a, const Seg& s, int q0, int q1) {
    for (int q = q0; q < q1; ++q) {
      cp_async_wait_all();
      consumer_sync();  // patch q landed; patch q - 1 is no longer read
      if (q + 1 < total) stage(q + 1);
      mma_chunk<PN>(a, ring, smem_addr(patch[q & 1]) + a_off, pc * kPitch,
                    kPitch, min(kKB, s.cin_pad - (q - q0) * kKB), 0);
    }
  };
  stage(0);
  run(acc, s0, 0, n0c);
  if constexpr (kTwo) {
#pragma unroll
    for (int i = 0; i < PN / 2; ++i) {
      park[i * kConsumers + threadIdx.x] = acc[i];
      acc[i] = 0;
    }
    run(acc, s1, n0c, total);
  }

  // ---- epilogue ----
  const int n0 = nt * PN, t = lane & 3;
  constexpr int kOut =
      MODE == kRaw || MODE == kF32 ? 4 : MODE == kBf16 ? 2 : 1;
  unsigned char* rows[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const Px p = chunk_pixel(mbase + (lane >> 2) + 8 * half, g);
    const int on = img0 + p.s, oi = i0 + p.r, oj = j0 + p.c;
    rows[half] = on < n && oi < h && oj < w
                     ? static_cast<unsigned char*>(y) +
                           (((size_t)on * h + oi) * w + oj) * cout * kOut
                     : nullptr;
  }
  // the ReLU'd value of column 8j + 2t + e of row half (bf16-rounded but
  // in the float32 forms)
  auto value = [&](int j, int half, int e) {
    const int i = 4 * j + 2 * half + e, col = n0 + 8 * j + 2 * t + e;
    const bool in = col < cout;
    const float k = in ? ep.k[col] : 0.f, b = in ? ep.bias[col] : 0.f;
    float v;
    if constexpr (kTwo) {  // acc: the second segment's sums
      const float k2 = in ? ep.k2[col] : 0.f;
      v = __fadd_rn(
          __fmaf_rn(__int2float_rn(park[i * kConsumers + threadIdx.x]), k,
                    __fmul_rn(__int2float_rn(acc[i]), k2)),
          b);
    } else {
      v = __fmaf_rn(__int2float_rn(acc[i]), k, b);
    }
    if constexpr (s8_f32(MODE)) return fmaxf(v, 0.f);
    return fmaxf(__bfloat162float(__float2bfloat16_rn(v)), 0.f);
  };
  if constexpr (MODE == kRaw || MODE == kF32) {
    uint32_t* const r32[2] = {reinterpret_cast<uint32_t*>(rows[0]),
                              reinterpret_cast<uint32_t*>(rows[1])};
    store32<PN>(
        [&](int j, int half, int e) {
          if constexpr (MODE == kF32) return __float_as_uint(value(j, half, e));
          return (uint32_t)acc[4 * j + 2 * half + e];
        },
        n0, cout, r32, vec_out);
  } else if constexpr (MODE == kBf16) {
    unsigned short* const r16[2] = {
        reinterpret_cast<unsigned short*>(rows[0]),
        reinterpret_cast<unsigned short*>(rows[1])};
    store16<PN>(
        [&](int j, int half) {
          return bf16x2_bits(value(j, half, 0), value(j, half, 1));
        },
        n0, cout, r16, vec_out);
  } else {
    store8<PN>(
        [&](int j, int half) {
          return quantize_s8(value(j, half, 0), ep.inv_s) |
                 (quantize_s8(value(j, half, 1), ep.inv_s) << 8);
        },
        n0, cout, rows, vec_out);
  }
}

template <int PN, int MODE>
int launch(const Seg& s0, const Seg& s1, const Epi& ep, void* y, int n,
           int h, int w, int cout, Geo g, int stages, int smem, bool vec_out,
           cudaStream_t stream) {
  const int tiles_h = (h + (1 << g.tr) - 1) >> g.tr;
  const int tiles_w = (w + (1 << g.tw) - 1) >> g.tw;
  const long long tiles_n = (n + (1 << g.ni) - 1) >> g.ni;
  const long long blocks = tiles_n * tiles_h * tiles_w;
  const int n_tiles = (cout + PN - 1) / PN;
  if (blocks > 0x7fffffffLL || n_tiles > 65535)
    return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_s8_kernel<PN, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)blocks, n_tiles);
  conv3x3_s8_kernel<PN, MODE><<<grid, kConvThreads, smem, stream>>>(
      s0, s1, ep, y, n, h, w, cout, g, tiles_h, tiles_w, stages, vec_out);
  return (int)cudaGetLastError();
}

}  // namespace fabric

using namespace fabric;

// Dynamic shared memory of one block: the weight ring (stages slots of pn
// x 64 bytes), two staged patches of geometry (tw, tr, ni) (log2s), 16
// bytes of barriers per slot and, for the split form, the parked sums.
// ops/conv_s8.py mirrors this formula.
extern "C" int fabric_conv3x3_s8_smem_bytes(int pn, int tw, int tr, int ni,
                                            int stages, int split) {
  return stages * pn * kKB + 2 * patch_bytes(Geo{tw, tr, ni}) + 16 * stages +
         (split ? park_bytes(pn) : 0);
}

// x (n, h, w, cin) int8 and wpk, its weights packed by ops/conv_s8.py
// pack_weight (N tiles of pn = 64 or 128 channels); for mode 3 (split)
// also x2 (n, h, w, cin2) and wpk2, the second K segment.  k, k2, bias:
// (cout,) float32 (unused in mode 0); inv_s: the float32 reciprocal of the
// output scale (modes 1, 3, 5, 6).  y (n, h, w, cout): int32 (mode 0), int8
// (1, 3, 5, 6), bf16 (2) or float32 (4).  (tw, tr, ni): log2 of the tile's columns, rows and
// images, tw + tr + ni = 7.  Returns the CUDA error of the launch (0 on
// success).
extern "C" int fabric_conv3x3_s8(const void* x, const void* wpk, int cin,
                                 const void* x2, const void* wpk2, int cin2,
                                 const void* k, const void* k2,
                                 const void* bias, float inv_s, void* y,
                                 int n, int h, int w, int cout, int pn,
                                 int tw, int tr, int ni, int stages,
                                 int mode, void* stream) {
  const bool split = mode == kSplit || mode == kSplitF32;
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 ||
      (pn != 64 && pn != 128) || tw < 0 || tr < 0 || ni < 0 ||
      tw + tr + ni != 7 || stages < 2 || mode < kRaw || mode > kSplitF32 ||
      reinterpret_cast<uintptr_t>(wpk) % 16 ||
      (mode != kRaw && (k == nullptr || bias == nullptr)) ||
      (split && (cin2 <= 0 || x2 == nullptr || k2 == nullptr ||
                 reinterpret_cast<uintptr_t>(wpk2) % 16)))
    return (int)cudaErrorInvalidValue;
  auto seg = [](const void* xs, const void* ws, int c) {
    return Seg{xs, ws, c, round_up(c, 32),
               c % 16 == 0 && reinterpret_cast<uintptr_t>(xs) % 16 == 0};
  };
  const Seg s0 = seg(x, wpk, cin), s1 = split ? seg(x2, wpk2, cin2) : s0;
  const int smem =
      fabric_conv3x3_s8_smem_bytes(pn, tw, tr, ni, stages, split);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const Epi ep{static_cast<const float*>(k), static_cast<const float*>(k2),
               static_cast<const float*>(bias), inv_s};
  const int out_align =
      mode == kRaw || mode == kF32 ? 4 : mode == kBf16 ? 8 : 16;
  const bool vec_out =
      cout % out_align == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const Geo g{tw, tr, ni};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FABRIC_LAUNCH(M)                                                     \
  (pn == 64 ? launch<64, M>(s0, s1, ep, y, n, h, w, cout, g, stages, smem, \
                            vec_out, s)                                      \
            : launch<128, M>(s0, s1, ep, y, n, h, w, cout, g, stages, smem, \
                             vec_out, s))
  switch (mode) {
    case kRaw:
      return FABRIC_LAUNCH(kRaw);
    case kInt8:
      return FABRIC_LAUNCH(kInt8);
    case kBf16:
      return FABRIC_LAUNCH(kBf16);
    case kSplit:
      return FABRIC_LAUNCH(kSplit);
    case kF32:
      return FABRIC_LAUNCH(kF32);
    case kInt8F32:
      return FABRIC_LAUNCH(kInt8F32);
    default:
      return FABRIC_LAUNCH(kSplitF32);
  }
#undef FABRIC_LAUNCH
}
