"""C = A @ B on the tensor cores: int8 x int8 -> int32, or bf16 x bf16 ->
float32.

Counterpart of the Pallas kernel of
``fabric_tpu/tools/ablate_train.py:microbench_int8_matmul`` (``make_pallas``,
the int8 matrix-rate probe).  On CUDA tensors :func:`int8_matmul` launches
the hand-written Hopper kernel ``csrc/int8_matmul.cu``, a GEMM on the
wgmma core of the conv kernels (``csrc/conv_tile.cuh``); see its header for
the design and what bounds it.  On CPU tensors it computes
:func:`int8_matmul_reference`, the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from fabric_tpu_torch.ops import _build
from fabric_tpu_torch.ops import conv as conv_ops

_TYPES = {torch.int8: torch.int32, torch.bfloat16: torch.float32}
KB = 128     # kMmKB in csrc/int8_matmul.cu: bytes of K per staged chunk
STAGES = 4   # ring slots


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def int8_matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version.  int8: the product in float64, exact while k * 128^2 <
    2^53 (CUDA has no integer matmul), cast to int32.  bf16: the bf16 values
    multiplied in float32 (TF32 off), float32 out."""
    if a.dtype == torch.int8:
        return (a.double() @ b.double()).to(torch.int32)
    return a.float() @ b.float()


def kpad(k: int, element_size: int) -> int:
    """K in elements, zero-padded to whole 128-byte chunks."""
    return _round_up(k, KB // element_size)


def pack_b(b: torch.Tensor) -> torch.Tensor:
    """(k, n) B -> the kernel's packed copy, the layout of the conv weights
    (``ops/conv.pack_blocks`` with one tap): zero past k (to ``kpad``) and
    past n (to a multiple of the N tile PN = 64 or 128), blocks [N
    tile][K chunk of 128 bytes], each in 8 x 16-byte core matrices.  So
    element (kk, nn) sits at tile*Kpad*PN + c0*PN + (n//8)*C*8 +
    (k//V)*8V + (n%8)*V + k%V, with tile, n = divmod(nn, PN), c0, k = the
    chunk of kk and the offset in it, and C and V the elements in 128 and
    16 bytes."""
    k, n = b.shape
    pn, chunk = conv_ops.n_tile(n), KB // b.element_size()
    kp, npad = kpad(k, b.element_size()), _round_up(n, pn)
    if (kp, npad) != (k, n):
        b = F.pad(b, (0, npad - n, 0, kp - k))
    return conv_ops.pack_blocks(b.unsqueeze(0), pn, chunk)


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"expected two tensors on one CUDA device, got "
                         f"{a.device} and {b.device}")
    if a.dtype not in _TYPES or b.dtype != a.dtype:
        raise TypeError(f"int8_matmul takes two int8 or two bfloat16 "
                        f"tensors, got {a.dtype} and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"expected (m, k) @ (k, n), got {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if min(*a.shape, b.shape[1]) <= 0:
        raise ValueError(f"empty product {tuple(a.shape)} @ {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("int8_matmul takes contiguous tensors")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("int8_matmul")
    fn = lib.fabric_int8_matmul
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (m, k) @ b (k, n): int32 for int8 operands, float32 for bf16.
    Any m, k and n."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return int8_matmul_reference(a, b)
    _check(a, b)
    (m, k), n = a.shape, b.shape[1]
    bpk = pack_b(b)
    c = torch.empty((m, n), dtype=_TYPES[a.dtype], device=a.device)
    lib = _lib()
    with _build.on_device(a.get_device()):
        err = lib.fabric_int8_matmul(
            a.data_ptr(), bpk.data_ptr(), c.data_ptr(), m, k, n,
            kpad(k, a.element_size()), conv_ops.n_tile(n), STAGES,
            int(a.dtype == torch.int8),
            _build.raw_stream(a.get_device()))
    _build.check(lib, err, "int8_matmul")
    int8_matmul.launches += 1
    return c


int8_matmul.launches = 0
