"""SAME 3x3 conv of NHWC int8 by int8 weights with exact int32 sums.

The contract of ``conv_raw`` in ``fabric_tpu/infer/quant.py`` (an XLA conv
with ``preferred_element_type=int32``), which the int8 serving path runs for
every conv site.  On a CUDA tensor :func:`conv3x3_s8` launches the
hand-written Hopper kernel ``csrc/conv3x3_s8.cu`` (implicit GEMM on the int8
tensor cores, the GEMM core of ``ops/int8_matmul.py``); on a CPU tensor it
computes :func:`conv3x3_s8_reference`, an exact integer conv.  The weights
are packed once (:func:`pack_weight`) when the int8 forward is built.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from fabric_tpu_torch.ops import _build


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def conv3x3_s8_reference(x: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Plain version: the conv in float64, whose sums of int8 products are
    exact integers (float32 is not: up1's reach 9 * 512 * 127^2 > 2^24),
    cast to int32.  cuDNN is kept out so no transform-based algorithm can
    round."""
    with torch.backends.cudnn.flags(enabled=False):
        y = F.conv2d(x.double().permute(0, 3, 1, 2),
                     wq.double().permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1).to(torch.int32).contiguous()


def pack_weight(wq: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) int8 HWIO kernel -> the kernel's (9, Cout64, Cin32)
    layout: input channels contiguous, Cin zero-padded to a multiple of 32
    (the int8 mma depth) and Cout to a multiple of 64 (a block's width)."""
    cin, cout = wq.shape[2], wq.shape[3]
    packed = torch.zeros((9, _round_up(cout, 64), _round_up(cin, 32)),
                         dtype=torch.int8, device=wq.device)
    packed[:, :cout, :cin] = wq.reshape(9, cin, cout).transpose(1, 2)
    return packed


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
    want = (9, _round_up(wq.shape[3], 64), _round_up(wq.shape[2], 32))
    if (tuple(packed.shape) != want or packed.dtype != torch.int8
            or not packed.is_contiguous() or packed.device != wq.device):
        raise ValueError(f"packed weights must be a contiguous int8 {want} "
                         f"tensor on {wq.device} (pack_weight), got "
                         f"{tuple(packed.shape)} {packed.dtype} on "
                         f"{packed.device}")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("conv3x3_s8")
    fn = lib.fabric_conv3x3_s8
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def conv3x3_s8(x: torch.Tensor, wq: torch.Tensor,
               packed: torch.Tensor | None = None) -> torch.Tensor:
    """conv3x3_SAME(x, wq) -> int32.  x: (N, H, W, Cin) int8; wq: (3, 3,
    Cin, Cout) int8; ``packed``: ``pack_weight(wq)``, made here when None.
    Any H, W and channel counts."""
    if x.device.type == "cpu":
        return conv3x3_s8_reference(x, wq)
    _check(x, wq)
    if packed is None:
        packed = pack_weight(wq)
    _check_packed(packed, wq)
    n, h, w, cin = x.shape
    cout = wq.shape[3]
    y = torch.empty((n, h, w, cout), dtype=torch.int32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.fabric_conv3x3_s8(
            x.data_ptr(), packed.data_ptr(), y.data_ptr(), n, h, w, cin, cout,
            packed.shape[2], packed.shape[1],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "conv3x3_s8")
    conv3x3_s8.launches += 1
    return y


conv3x3_s8.launches = 0
