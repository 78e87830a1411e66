"""SAME 3x3 conv of NHWC int8 by int8 weights with exact int32 sums, and
the int8 serving forward's conv sites with their epilogue fused.

:func:`conv3x3_s8` is the contract of ``conv_raw`` in
``fabric_tpu/infer/quant.py`` (an XLA conv with
``preferred_element_type=int32``).  :func:`conv3x3_s8_q` is one conv site
of the int8 forward as ``fabric_tpu`` computes it (XLA fuses the conv
with its consumer): the conv, then the dequantize / bias / ReLU epilogue
in float32 and the compute dtype (bf16, or float32 with no bf16 step),
then the requantization to int8 (or the compute dtype out), and in its
split form the decoder's ``conv(skip, K_skip) + conv(up, K_up)``.

On CUDA tensors both launch the hand-written Hopper kernel
``csrc/conv3x3_s8.cu`` (wgmma s8 on the core of ``csrc/conv_tile.cuh``,
the epilogue in registers; see its header for the design and what bounds
it), and raise on what it does not take.  On CPU tensors they compute
their plain versions: :func:`conv3x3_s8_reference`, an exact integer conv,
and :func:`conv3x3_s8_q_reference`, that conv followed by the epilogue in
PyTorch.  The weights are packed once (:func:`pack_weight`) when the int8
forward is built.

UNet3D's int8 3x3x3 sites (``conv_raw`` over the 3-D dimension numbers
in ``fabric_tpu``) run on the same kernel: the T-neighbour dates stacked
along the channels (:func:`t_neighbours`) by the DHWIO kernel folded to
HWIO in the same tap order (:func:`fold_depth`).  The int32 sums are
exact either way (at most 3 * 512 * 9 * 127^2 < 2^31), so this is
bit-equal to the 3-D conv.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from fabric_tpu_torch.ops import _build
from fabric_tpu_torch.ops import conv as conv_ops

KB = conv_ops.KB  # kKB in csrc/conv_tile.cuh: int8 channels per chunk
STAGES = 4        # weight ring slots
# the kernel's modes (csrc/conv3x3_s8.cu); the float32 compute dtype's
# forms of int8, bf16 and split are 5, 4 and 6
_MODES = {"raw": 0, "int8": 1, "bf16": 2, "split": 3, "float32": 4,
          "int8_f32": 5, "split_f32": 6}


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class Plan(NamedTuple):
    """A launch of the int8 conv kernel: N tile ``pn``, M tiles of geometry
    (tw, tr, ni) (log2s; ``images`` = 2**ni whole images per tile),
    ``blocks_per_sm`` (the kernel's launch bound), ``smem`` bytes per
    block (``STAGES`` ring slots of ``KB``-byte chunks, two patches, and
    for the split form its parked first sums)."""
    pn: int
    tw: int
    tr: int
    ni: int
    images: int
    blocks_per_sm: int
    smem: int


def plan(h: int, w: int, cout: int, mode: str = "int8") -> Plan:
    """The kernel's tiles for (h, w) images, cout output channels and a
    launch ``mode`` (a key of ``_MODES``; mirrors
    csrc/conv3x3_s8.cu): PN 64 at up to 64 channels (three blocks per SM,
    two for the split form, whose parked sums leave a third no shared
    memory), else 128 (one block per SM); 128-pixel M tiles of whole small
    images, one per block."""
    pn = conv_ops.n_tile(cout)
    tw, tr, ni = conv_ops.tile_geometry(h, w)
    split = mode.startswith("split")
    smem = (STAGES * pn * KB + 2 * conv_ops.patch_bytes((tw, tr, ni))
            + 16 * STAGES + (pn * 512 if split else 0))
    blocks = 1 if pn == 128 else 2 if split else 3
    return Plan(pn, tw, tr, ni, 1 << ni, blocks, smem)


def quantize(x: torch.Tensor, s: float) -> torch.Tensor:
    """Symmetric int8: round(x / s) half to even, clipped to +-127.  The
    division is a float32 multiply by the float32 reciprocal of s, which is
    what XLA and PyTorch's CUDA kernels both make of a division by a
    constant."""
    inv = float(np.float32(1) / np.float32(s))
    return torch.clamp(torch.round(x.float() * inv), -127, 127).to(torch.int8)


def conv3x3_s8_reference(x: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Plain version: the conv in float64, whose sums of int8 products are
    exact integers (float32 is not: up1's reach 9 * 512 * 127^2 > 2^24),
    cast to int32.  cuDNN is kept out so no transform-based algorithm can
    round."""
    with torch.backends.cudnn.flags(enabled=False):
        y = F.conv2d(x.double().permute(0, 3, 1, 2),
                     wq.double().permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1).to(torch.int32).contiguous()


def conv3x3_s8_q_reference(x: torch.Tensor, wq: torch.Tensor,
                           scale: torch.Tensor, bias: torch.Tensor,
                           s_out: float | None = None, up=None,
                           dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of :func:`conv3x3_s8_q`: the exact convs, then
    ``fabric_tpu``'s epilogue in PyTorch (``torch.addcmul`` where XLA
    contracts a multiply-add).  With ``dtype`` float32 h is the float32
    epilogue's value itself: no bf16 step anywhere."""
    a = conv3x3_s8_reference(x, wq).float()
    if up is None:
        h = torch.relu(torch.addcmul(bias, a, scale).to(dtype))
    else:
        x_up, wq_up, scale_up = up[:3]
        bb = conv3x3_s8_reference(x_up, wq_up).float()
        h = torch.relu(torch.addcmul(bb * scale_up, a, scale) + bias).to(dtype)
    return h if s_out is None else quantize(h, s_out)


def pack_weight(wq: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) int8 HWIO kernel -> the kernel's packed weights, a
    flat int8 tensor of 9 * Cin32 * CoutP bytes (Cin zero-padded to a
    multiple of 32, the int8 wgmma depth; Cout to a multiple of the N tile
    PN = n_tile(Cout)): ``ops/conv.pack_blocks`` over int8 bytes, blocks
    [N tile][K chunk of 64 (the last may be 32)][tap], each in 8 x 16-byte
    core matrices.  Element (tap, ci, co) sits at tile*9*Cin32*PN +
    9*c0*PN + tap*kc*PN + (n//8)*kc*8 + (k//16)*128 + (n%8)*16 + k%16,
    with tile, n = divmod(co, PN) and c0, k = the chunk of ci and the
    offset in it."""
    cin, cout = wq.shape[2], wq.shape[3]
    pn = conv_ops.n_tile(cout)
    k = torch.zeros((9, _round_up(cin, 32), _round_up(cout, pn)),
                    dtype=torch.int8, device=wq.device)
    k[:, :cin, :cout] = wq.reshape(9, cin, cout)
    return conv_ops.pack_blocks(k, pn, KB)


def fold_depth(wq: torch.Tensor) -> torch.Tensor:
    """(3, 3, 3, Cin, Cout) DHWIO kernel -> the (3, 3, 3 * Cin, Cout) HWIO
    kernel whose input channel d * Cin + c is depth tap d of channel c:
    a 3x3x3 SAME conv over T is this 3x3 conv of :func:`t_neighbours`'
    stack.  Per-output-channel scales over the fan-in are unchanged."""
    d, kh, kw, cin, cout = wq.shape
    return wq.permute(1, 2, 0, 3, 4).reshape(kh, kw, d * cin,
                                             cout).contiguous()


def t_neighbours(x: torch.Tensor) -> torch.Tensor:
    """(N, T, H, W, C) -> (N * T, H, W, 3C): each date's input of a SAME
    conv over T, the dates t - 1, t and t + 1 stacked along the channels,
    zeros beyond the first and the last date."""
    n, t, h, w, c = x.shape
    z = x.new_zeros((n, 1, h, w, c))
    prev = torch.cat([z, x[:, :-1]], dim=1)
    nxt = torch.cat([x[:, 1:], z], dim=1)
    return torch.cat([prev, x, nxt], dim=-1).reshape(n * t, h, w, 3 * c)


def _check(x: torch.Tensor, wq: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got {x.device}")
    if x.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"conv3x3_s8 takes int8 input and weights, got "
                        f"{x.dtype} and {wq.dtype}")
    if x.dim() != 4 or not x.is_contiguous() or min(x.shape) <= 0:
        raise ValueError(f"expected a contiguous non-empty (N, H, W, C) "
                         f"tensor, got shape {tuple(x.shape)}")
    cin = x.shape[3]
    if wq.dim() != 4 or tuple(wq.shape[:3]) != (3, 3, cin):
        raise ValueError(f"expected a (3, 3, {cin}, Cout) kernel, got "
                         f"{tuple(wq.shape)}")
    if wq.device != x.device:
        raise ValueError("input and weights must be on one device")


def _check_packed(packed: torch.Tensor, wq: torch.Tensor) -> None:
    cin, cout = wq.shape[2], wq.shape[3]
    want = 9 * _round_up(cin, 32) * _round_up(cout, conv_ops.n_tile(cout))
    if (packed.dim() != 1 or packed.numel() != want
            or packed.dtype != torch.int8 or not packed.is_contiguous()
            or packed.device != wq.device or packed.data_ptr() % 16):
        raise ValueError(f"packed weights must be a contiguous, 16-byte "
                         f"aligned int8 vector of {want} elements on "
                         f"{wq.device} (pack_weight), got "
                         f"{tuple(packed.shape)} {packed.dtype} on "
                         f"{packed.device}")


def _check_vector(v: torch.Tensor, cout: int, device, what: str) -> None:
    if (v.shape != (cout,) or v.dtype != torch.float32
            or not v.is_contiguous() or v.device != device):
        raise ValueError(f"{what} must be a contiguous float32 ({cout},) "
                         f"vector on {device}, got {tuple(v.shape)} "
                         f"{v.dtype} on {v.device}")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("conv3x3_s8")
    fn = lib.fabric_conv3x3_s8
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_float, ctypes.c_void_p]
                   + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _launch(mode: str, x, wq, packed, out_dtype, scale=None, bias=None,
            inv_s: float = 0.0, up=None) -> torch.Tensor:
    """Validate and launch csrc/conv3x3_s8.cu in ``mode``."""
    _check(x, wq)
    if packed is None:
        packed = pack_weight(wq)
    _check_packed(packed, wq)
    n, h, w, cin = x.shape
    cout = wq.shape[3]
    x2 = w2 = k2 = None
    cin2 = 0
    if mode != "raw":
        _check_vector(scale, cout, x.device, "scale")
        _check_vector(bias, cout, x.device, "bias")
    if up is not None:
        x_up, wq_up, k2, w2 = up
        _check(x_up, wq_up)
        if x_up.shape[:3] != x.shape[:3] or wq_up.shape[3] != cout:
            raise ValueError(f"the split form's second segment must match "
                             f"(N, H, W) = {tuple(x.shape[:3])} and {cout} "
                             f"output channels, got {tuple(x_up.shape)} and "
                             f"{tuple(wq_up.shape)}")
        if x_up.device != x.device:
            raise ValueError("both segments must be on one device")
        if w2 is None:
            w2 = pack_weight(wq_up)
        _check_packed(w2, wq_up)
        _check_vector(k2, cout, x.device, "the up segment's scale")
        x2, cin2 = x_up, x_up.shape[3]
    p = plan(h, w, cout, mode)
    y = torch.empty((n, h, w, cout), dtype=out_dtype, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _lib()
    with _build.on_device(x.get_device()):
        err = lib.fabric_conv3x3_s8(
            x.data_ptr(), packed.data_ptr(), cin, ptr(x2), ptr(w2), cin2,
            ptr(scale), ptr(k2), ptr(bias), inv_s, y.data_ptr(), n, h, w,
            cout, p.pn, p.tw, p.tr, p.ni, STAGES, _MODES[mode],
            _build.raw_stream(x.get_device()))
    _build.check(lib, err, "conv3x3_s8")
    return y


def _launch_raw(x, wq, packed) -> torch.Tensor:
    """The raw int32 conv on the card (counted)."""
    y = _launch("raw", x, wq, packed, torch.int32)
    conv3x3_s8.launches += 1
    return y


@torch.library.custom_op("fabric_tpu_torch::conv3x3_s8", mutates_args=(),
                         device_types="cuda")
def conv3x3_s8_op(x: torch.Tensor, wq: torch.Tensor,
                  packed: torch.Tensor | None) -> torch.Tensor:
    """The raw kernel as a custom op (what an exported program calls): the
    launch on CUDA, the plain version on the CPU."""
    return _launch_raw(x, wq, packed)


@conv3x3_s8_op.register_kernel("cpu")
def _(x, wq, packed):
    return conv3x3_s8_reference(x, wq)


@conv3x3_s8_op.register_fake
def _(x, wq, packed):
    return x.new_empty(tuple(x.shape[:3]) + (wq.shape[3],),
                       dtype=torch.int32)


def conv3x3_s8(x: torch.Tensor, wq: torch.Tensor,
               packed: torch.Tensor | None = None) -> torch.Tensor:
    """conv3x3_SAME(x, wq) -> int32.  x: (N, H, W, Cin) int8; wq: (3, 3,
    Cin, Cout) int8; ``packed``: ``pack_weight(wq)``, made here when None.
    Any H, W and channel counts.  Under ``torch.export`` the call is the
    custom op."""
    if torch.compiler.is_exporting():
        return conv3x3_s8_op(x, wq, packed)
    if x.device.type == "cpu":
        return conv3x3_s8_reference(x, wq)
    return _launch_raw(x, wq, packed)


conv3x3_s8.launches = 0


def _launch_q(x, wq, scale, bias, s_out, packed, up, dtype) -> torch.Tensor:
    """One int8 conv site on the card (counted: the float32 forms on
    ``conv3x3_s8_q.launches_f32``)."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"conv3x3_s8_q computes in bfloat16 or float32 on "
                        f"the card, got {dtype}")
    if up is not None and s_out is None:
        raise ValueError("the split form writes int8: give s_out")
    mode = "bf16" if s_out is None else "int8" if up is None else "split"
    f32 = dtype == torch.float32
    if f32:
        mode = {"bf16": "float32", "int8": "int8_f32",
                "split": "split_f32"}[mode]
    inv = 0.0 if s_out is None else float(np.float32(1) / np.float32(s_out))
    y = _launch(mode, x, wq, packed, dtype if s_out is None else torch.int8,
                scale, bias, inv, up)
    if f32:
        conv3x3_s8_q.launches_f32 += 1
    else:
        conv3x3_s8_q.launches += 1
    return y


def _up(x_up, wq_up, scale_up, packed_up):
    """The split form's second segment, or None."""
    return None if x_up is None else (x_up, wq_up, scale_up, packed_up)


@torch.library.custom_op("fabric_tpu_torch::conv3x3_s8_q", mutates_args=(),
                         device_types="cuda")
def conv3x3_s8_q_op(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, s_out: float | None,
                    packed: torch.Tensor | None, x_up: torch.Tensor | None,
                    wq_up: torch.Tensor | None,
                    scale_up: torch.Tensor | None,
                    packed_up: torch.Tensor | None,
                    dtype: torch.dtype) -> torch.Tensor:
    """One int8 conv site as a custom op (what an exported program calls),
    the split form's second segment as ``*_up`` (None without it): the
    launch on CUDA, the plain version on the CPU."""
    return _launch_q(x, wq, scale, bias, s_out, packed,
                     _up(x_up, wq_up, scale_up, packed_up), dtype)


@conv3x3_s8_q_op.register_kernel("cpu")
def _(x, wq, scale, bias, s_out, packed, x_up, wq_up, scale_up, packed_up,
      dtype):
    return conv3x3_s8_q_reference(x, wq, scale, bias, s_out,
                                  _up(x_up, wq_up, scale_up, packed_up),
                                  dtype)


@conv3x3_s8_q_op.register_fake
def _(x, wq, scale, bias, s_out, packed, x_up, wq_up, scale_up, packed_up,
      dtype):
    return x.new_empty(tuple(x.shape[:3]) + (wq.shape[3],),
                       dtype=dtype if s_out is None else torch.int8)


def conv3x3_s8_q(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, s_out: float | None = None,
                 packed: torch.Tensor | None = None, up=None,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """One int8 conv site: h = relu(fma(float(conv3x3_SAME(x, wq)), scale,
    bias) rounded to ``dtype``); int8 ``quantize(h, s_out)`` when s_out is
    given, else h.  x: (N, H, W, Cin) int8; wq: (3, 3, Cin, Cout) int8;
    scale (= sw * sx) and bias: (Cout,) float32; ``packed``:
    ``pack_weight(wq)``, made here when None.

    ``up`` = (x_up, wq_up, scale_up, packed_up): the decoder's split form,
    h = relu(fma(a, scale, b * scale_up) + bias) with a and b the exact
    convs of (x, wq) and (x_up, wq_up) (int8 out only).  On the card the
    compute dtype is bf16 or float32 (the kernel's modes for either).
    Under ``torch.export`` the call is the custom op."""
    if torch.compiler.is_exporting():
        x_up, wq_up, scale_up, packed_up = up or (None,) * 4
        return conv3x3_s8_q_op(x, wq, scale, bias,
                               None if s_out is None else float(s_out),
                               packed, x_up, wq_up, scale_up, packed_up,
                               dtype)
    if x.device.type == "cpu":
        return conv3x3_s8_q_reference(x, wq, scale, bias, s_out, up, dtype)
    return _launch_q(x, wq, scale, bias, s_out, packed, up, dtype)


conv3x3_s8_q.launches = 0      # the bf16 forms
conv3x3_s8_q.launches_f32 = 0  # the float32 forms
