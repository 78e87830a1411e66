"""Fused 3x3 conv + bias + ReLU on NHWC bf16 or float32 (inference).

Counterpart of ``fabric_tpu/ops/pallas_conv.py:conv3x3_bias_relu``: with
BatchNorm folded into the weights, a conv of a DoubleConv block is
``relu(conv3x3_SAME(x, K) + b)``, computed in x's dtype as the Pallas
kernel does.  On a CUDA tensor :func:`conv3x3_bias_relu` launches the
hand-written Hopper kernel of x's dtype: ``csrc/conv3x3_bias_relu.cu``
(bf16, wgmma) or ``csrc/conv3x3_bias_relu_f32.cu`` (float32, 3xTF32 wgmma:
three TF32 products per float32 product; counted on
``conv3x3_bias_relu.launches_f32``); see their headers for the designs and
what bounds them.  On a CPU tensor it computes
:func:`conv3x3_bias_relu_reference`, the plain PyTorch version the tests
hold against the Pallas function.

The kernels read their weights in a packed layout of their dtype
(:func:`pack_weight`; the float32 kernels' split into TF32 hi and lo
planes, :func:`split_tf32`).  Callers that keep their weights pack them
once and pass them in: the folded ``DoubleConv`` (``models/blocks.py``)
and the int8 path's calibration forward (``infer/quant.py``).  This module also
holds the tile planner that the conv kernels share (:func:`tile_geometry`,
:func:`n_tile`), mirrored from ``csrc/conv_tile.cuh``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from fabric_tpu_torch.ops import _build, fp32_conv

KB = 64          # kKB in csrc/conv_tile.cuh: bytes of K per staged chunk
KC = KB // 2     # kKC: the same in bf16 channels
PITCH = KB + 16  # kPitch: bytes per staged pixel
STAGES = 4       # weight ring slots of the conv kernel
MAX_SMEM = 232448  # 227 KB: the most shared memory a Hopper block may use
KC_F32 = KB // 4  # the same in fp32 channels (csrc/conv_tile_tf32x3.cuh)
K_STEP_F32 = 8    # fp32 channels of one TF32 wgmma K step (32 bytes): the
                  # fp32 packing pads Cin to it


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _log2_ceil(v: int) -> int:
    return max(v - 1, 0).bit_length()


def tile_geometry(h: int, w: int, rows: int = 128) -> tuple[int, int, int]:
    """log2 of (TW, TR, NI) of an M chunk of ``rows`` (64 or 128) output
    pixels: TW the power of two >= w (at most ``rows``), TR the power of
    two >= h that fits beside it, NI = rows / (TR*TW) whole images."""
    r = rows.bit_length() - 1
    tw = min(_log2_ceil(w), r)
    tr = min(_log2_ceil(h), r - tw)
    return tw, tr, r - tw - tr


def n_tile(cout: int) -> int:
    """Output channels per wgmma N tile: 64, or 128 where Cout > 64."""
    return 64 if cout <= 64 else 128


def patch_bytes(geo: tuple[int, int, int]) -> int:
    """Shared memory of one staged input patch (patch_bytes in the CUDA
    core): NI x (TR+2) x (TW+2) pixels of PITCH bytes, rounded to 128."""
    tw, tr, ni = geo
    return _round_up(((1 << tr) + 2) * ((1 << tw) + 2) * (1 << ni) * PITCH,
                     128)


def smem_bytes(h: int, w: int, cout: int) -> int:
    """Shared memory of one conv block (fabric_conv3x3_smem_bytes): the
    weight ring, two staged patches and the ring's barriers."""
    return (STAGES * n_tile(cout) * KB + 2 * patch_bytes(
        tile_geometry(h, w)) + 16 * STAGES)


def pack_blocks(k: torch.Tensor, pn: int, chunk: int) -> torch.Tensor:
    """(taps, K, N) -> the flat B layout the CUDA core streams through its
    ring (``produce`` in csrc/conv_tile.cuh): blocks of pn columns x kc
    rows of K x one tap, laid out [N tile][K chunk of ``chunk`` elements
    (the last may be shorter)][tap], each block in the no-swizzle K-major
    layout wgmma reads: core matrices [n // 8][k // V], each 8 rows n of V
    contiguous k, V = 16 // element size (8 bf16, 16 int8).  K must be a
    multiple of 2V (32 bytes), N of pn."""
    taps, kk, nn = k.shape
    v, tiles = 16 // k.element_size(), nn // pn
    full = kk // chunk * chunk
    pieces = []
    if full:
        b = k[:, :full].reshape(taps, full // chunk, chunk // v, v, tiles,
                                pn // 8, 8)
        # (tap, chunk, k//V, k%V, tile, n//8, n%8)
        #   -> (tile, chunk, tap, n//8, k//V, n%8, k%V)
        pieces.append(b.permute(4, 1, 0, 5, 2, 6, 3).reshape(tiles, -1))
    if full < kk:
        kc = kk - full
        b = k[:, full:].reshape(taps, kc // v, v, tiles, pn // 8, 8)
        # (tap, k//V, k%V, tile, n//8, n%8) -> (tile, tap, n//8, k//V, n%8, k%V)
        pieces.append(b.permute(3, 0, 4, 1, 5, 2).reshape(tiles, -1))
    return torch.cat(pieces, dim=1).reshape(-1).contiguous()


def _tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away
    from zero, as ``cvt.rna.tf32.f32``: a half unit of the 13 dropped bits
    added to the magnitude, then the 13 bits cleared (float32 bits are
    sign and magnitude, so one integer add serves both signs)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 a -> (hi, lo), the 3xTF32 split the float32 kernels make
    (``csrc/conv_tile_tf32x3.cuh`` split; the weights' at pack time):
    hi = tf32(a), lo = tf32(a - hi), both rounded to nearest, ties away
    (a - hi is exact in float32).  hi + lo is within 2^-21 |a| of a, and
    split(-a) = -split(a)."""
    hi = _tf32_rna(a)
    return hi, _tf32_rna(a - hi)


def _pair_blocks(hi: torch.Tensor, lo: torch.Tensor, tiles: int, kk: int,
                 pn: int, chunk: int, taps: int = 9) -> torch.Tensor:
    """Two flat :func:`pack_blocks` layouts of one (taps, kk, tiles*pn)
    kernel -> one, each hi block followed by the lo block of the same N
    tile, K chunk and tap (what a ring slot of the float32 core holds)."""
    h, lg = hi.reshape(tiles, -1), lo.reshape(tiles, -1)
    full = kk // chunk * chunk
    cut = taps * full * pn
    pieces = []
    if full:
        shape = (tiles, full // chunk, taps, 1, pn * chunk)
        pieces.append(torch.cat([h[:, :cut].reshape(shape),
                                 lg[:, :cut].reshape(shape)], 3)
                      .reshape(tiles, -1))
    if full < kk:
        shape = (tiles, taps, 1, pn * (kk - full))
        pieces.append(torch.cat([h[:, cut:].reshape(shape),
                                 lg[:, cut:].reshape(shape)], 2)
                      .reshape(tiles, -1))
    return torch.cat(pieces, dim=1).reshape(-1).contiguous()


def pack_weight_f32(kernel: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) HWIO kernel -> the float32 kernels' packed weights
    (``csrc/conv_tile_tf32x3.cuh``): the kernel zero-padded to Cin8 (Cin
    rounded up to the TF32 K step, 8) x CoutP (Cout rounded up to the N
    tile PN = n_tile(Cout)), split into TF32 hi and lo planes
    (:func:`split_tf32`), each plane laid out as the bf16 kernels' blocks
    (:func:`pack_blocks`: [N tile][K chunk of 16 channels, the last one
    may be 8][tap], each block PN channels x kc in the no-swizzle K-major
    layout of 8 x 4 core matrices, the only one TF32 wgmma reads), and
    each hi block followed by its lo block: a flat float32 tensor of 2 * 9
    * Cin8 * CoutP elements."""
    cin, cout = kernel.shape[2], kernel.shape[3]
    pn = n_tile(cout)
    cin_pad, cout_pad = _round_up(cin, K_STEP_F32), _round_up(cout, pn)
    k = torch.zeros((9, cin_pad, cout_pad), dtype=torch.float32,
                    device=kernel.device)
    k[:, :cin, :cout] = kernel.reshape(9, cin, cout)
    hi, lo = split_tf32(k)
    return _pair_blocks(pack_blocks(hi, pn, KC_F32),
                        pack_blocks(lo, pn, KC_F32), cout_pad // pn,
                        cin_pad, pn, KC_F32)


def pack_weight(kernel: torch.Tensor,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(3, 3, Cin, Cout) HWIO kernel -> the packed weights of the kernel
    that computes in ``dtype``: float32 is :func:`pack_weight_f32`; any
    other dtype gets the bf16 kernel's layout (a plain version on the CPU,
    in float64 say, ignores it; the card takes bf16 and float32 only): a
    flat tensor of 9 * Cin16 * CoutP elements (Cin zero-padded to a
    multiple of 16, Cout to a multiple of the N tile PN = n_tile(Cout)).

    Blocks of PN output channels x kc input channels x one tap, laid out
    [N tile][K chunk of KC (the last one may be 16)][tap], each block in
    the no-swizzle K-major layout that wgmma reads: 8 x 8 core matrices
    [n // 8][k // 8], each 8 rows n of 8 contiguous k.  So element (tap,
    ci, co) sits at tile*9*Cin16*PN + 9*c0*PN + tap*kc*PN + (n//8)*kc*8 +
    (k//8)*64 + (n%8)*8 + k%8, with tile, n = divmod(co, PN) and c0, k =
    the chunk of ci and the offset in it."""
    if dtype == torch.float32:
        return pack_weight_f32(kernel)
    cin, cout = kernel.shape[2], kernel.shape[3]
    pn = n_tile(cout)
    cin_pad, cout_pad = _round_up(cin, 16), _round_up(cout, pn)
    k = torch.zeros((9, cin_pad, cout_pad), dtype=torch.bfloat16,
                    device=kernel.device)
    k[:, :cin, :cout] = kernel.reshape(9, cin, cout)
    return pack_blocks(k, pn, KC)


def check_packed(packed: torch.Tensor, kernel: torch.Tensor,
                 dtype: torch.dtype = torch.bfloat16) -> None:
    """Raise unless ``packed`` is what :func:`pack_weight` makes for a
    kernel of ``kernel``'s shape and ``dtype``, on its device."""
    cin, cout = kernel.shape[2], kernel.shape[3]
    if dtype == torch.float32:
        want = 2 * 9 * _round_up(cin, K_STEP_F32) * _round_up(cout,
                                                             n_tile(cout))
    else:
        want = 9 * _round_up(cin, 16) * _round_up(cout, n_tile(cout))
    if (packed.dim() != 1 or packed.numel() != want
            or packed.dtype != dtype or not packed.is_contiguous()
            or packed.device != kernel.device or packed.data_ptr() % 16):
        raise ValueError(f"packed weights must be a contiguous, 16-byte "
                         f"aligned {dtype} vector of {want} elements on "
                         f"{kernel.device} (pack_weight), got "
                         f"{tuple(packed.shape)} {packed.dtype} on "
                         f"{packed.device}")


def check_operands(x: torch.Tensor, weights, biases) -> None:
    """Validate what the CUDA kernels take: a contiguous bf16 or float32
    NHWC tensor on the card, HWIO 3x3 kernels chained by channel count,
    (Cout,) biases."""
    if x.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the CUDA conv kernels take bfloat16 or float32, "
                        f"got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"expected a contiguous (N, H, W, C) tensor, got "
                         f"shape {tuple(x.shape)}")
    if min(x.shape) <= 0:
        raise ValueError(f"empty input of shape {tuple(x.shape)}")
    cin = x.shape[-1]
    for k, b in zip(weights, biases):
        if k.dim() != 4 or tuple(k.shape[:3]) != (3, 3, cin):
            raise ValueError(f"expected a (3, 3, {cin}, Cout) kernel, got "
                             f"{tuple(k.shape)}")
        if tuple(b.shape) != (k.shape[3],):
            raise ValueError(f"bias of shape {tuple(b.shape)} does not match "
                             f"{k.shape[3]} output channels")
        if k.device != x.device or b.device != x.device:
            raise ValueError("kernel, bias and input must be on one device")
        cin = k.shape[3]


def conv3x3_bias_relu_reference(x: torch.Tensor, kernel: torch.Tensor,
                                bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the kernel cast to x's dtype as the CUDA kernel
    takes it, fp32 conv, fp32 bias, ReLU, one rounding to x's dtype.  For
    float32 x nothing is rounded but the fp32 sums: no bf16 step anywhere
    (on the card the conv runs with TF32 off, ``ops/fp32_conv.py``)."""
    k = kernel.to(x.dtype).float().permute(3, 2, 0, 1)  # HWIO -> OIHW
    y = fp32_conv.conv(x.float().permute(0, 3, 1, 2), k, bias.float(),
                       padding=1)
    return torch.relu(y).permute(0, 2, 3, 1).to(x.dtype).contiguous()


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("conv3x3_bias_relu")
    fn = lib.fabric_conv3x3_bias_relu
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def _lib_f32() -> ctypes.CDLL:
    lib = _build.load("conv3x3_bias_relu_f32")
    fn = lib.fabric_conv3x3_bias_relu_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _launch_f32(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                packed: torch.Tensor | None) -> torch.Tensor:
    """Launch csrc/conv3x3_bias_relu_f32.cu (3xTF32) on validated operands
    (counted)."""
    if packed is None:
        packed = pack_weight_f32(kernel)
    check_packed(packed, kernel, torch.float32)
    n, h, w, cin = x.shape
    cout = kernel.shape[3]
    tw, tr, ni = tile_geometry(h, w)
    b = bias.float().contiguous()
    y = torch.empty((n, h, w, cout), dtype=torch.float32, device=x.device)
    lib = _lib_f32()
    with _build.on_device(x.get_device()):
        err = lib.fabric_conv3x3_bias_relu_f32(
            x.data_ptr(), packed.data_ptr(), b.data_ptr(), y.data_ptr(), n, h,
            w, cin, cout, _round_up(cin, K_STEP_F32), n_tile(cout), tw, tr,
            ni, STAGES, _build.raw_stream(x.get_device()))
    _build.check(lib, err, "conv3x3_bias_relu_f32")
    conv3x3_bias_relu.launches_f32 += 1
    return y


def _launch(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
            packed: torch.Tensor | None) -> torch.Tensor:
    """Validate and launch the kernel of x's dtype (counted):
    csrc/conv3x3_bias_relu.cu or csrc/conv3x3_bias_relu_f32.cu."""
    check_operands(x, [kernel], [bias])
    if x.dtype == torch.float32:
        return _launch_f32(x, kernel, bias, packed)
    if packed is None:
        packed = pack_weight(kernel)
    check_packed(packed, kernel)
    n, h, w, cin = x.shape
    cout = kernel.shape[3]
    tw, tr, ni = tile_geometry(h, w)
    b = bias.float().contiguous()
    y = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    lib = _lib()
    with _build.on_device(x.get_device()):
        err = lib.fabric_conv3x3_bias_relu(
            x.data_ptr(), packed.data_ptr(), b.data_ptr(), y.data_ptr(), n, h,
            w, cin, cout, _round_up(cin, 16), n_tile(cout), tw, tr, ni,
            STAGES, _build.raw_stream(x.get_device()))
    _build.check(lib, err, "conv3x3_bias_relu")
    conv3x3_bias_relu.launches += 1
    return y


@torch.library.custom_op("fabric_tpu_torch::conv3x3_bias_relu",
                         mutates_args=(), device_types="cuda")
def conv3x3_bias_relu_op(x: torch.Tensor, kernel: torch.Tensor,
                         bias: torch.Tensor,
                         packed: torch.Tensor | None) -> torch.Tensor:
    """The kernel as a custom op (what an exported program calls): the
    launch on CUDA, the plain version on the CPU."""
    return _launch(x, kernel, bias, packed)


@conv3x3_bias_relu_op.register_kernel("cpu")
def _(x, kernel, bias, packed):
    return conv3x3_bias_relu_reference(x, kernel, bias)


@conv3x3_bias_relu_op.register_fake
def _(x, kernel, bias, packed):
    return x.new_empty(tuple(x.shape[:3]) + (kernel.shape[3],))


def conv3x3_bias_relu(x: torch.Tensor, kernel: torch.Tensor,
                      bias: torch.Tensor,
                      packed: torch.Tensor | None = None) -> torch.Tensor:
    """relu(conv3x3_SAME(x, kernel) + bias) in x's dtype (bf16 or float32
    on the card).  x: (N, H, W, Cin); kernel: (3, 3, Cin, Cout); bias:
    (Cout,); ``packed``: ``pack_weight(kernel, x.dtype)``, made here when
    None.  Any H, W and channel counts.  Under
    ``torch.export`` the call is the custom op; otherwise the launch (or
    on the CPU the plain version) directly, without the dispatcher's
    host cost."""
    if torch.compiler.is_exporting():
        return conv3x3_bias_relu_op(x, kernel, bias, packed)
    if x.device.type == "cpu":
        return conv3x3_bias_relu_reference(x, kernel, bias)
    return _launch(x, kernel, bias, packed)


conv3x3_bias_relu.launches = 0      # the bf16 kernel's
conv3x3_bias_relu.launches_f32 = 0  # the float32 kernel's
