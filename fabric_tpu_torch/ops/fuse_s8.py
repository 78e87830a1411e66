"""The int8 forward's Siamese fusion with its requantization, and the int8
2x2 max-pool of the same encoder level.

:func:`siamese_fuse_s8` computes what ``fabric_tpu``'s int8 forward does
after each encoder level (``fabric_tpu/infer/quant.py:336-352``, ``fuse_q``
and ``f5``, and the pool of ``:211-219``), which XLA fuses into one pass
on the TPU: from the level's int8 tensor ``a`` (both dates stacked, as
``torch.cat([x_d1, x_d2])`` lays them out) the fused skip

    f = float(relu(int32(a[n:]) * int32(a[:n]))) * m

requantized to int8 (``clamp(round(f), 0, 127)``, f1..f4) or rounded once
to a float dtype (f5), and the next level's input, the 2x2 max-pool of
``a``.

On CUDA tensors it launches the hand-written kernel ``csrc/siamese_s8.cu``
(one pass: ``a`` read once, f and the pool written once, no int32 tensor
in device memory; see its header for the design and what bounds it) and
raises on what that does not take; on CPU tensors it computes the plain
version :func:`siamese_fuse_s8_reference`, the lines the int8 forward ran
before, bit-equal to the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fabric_tpu_torch.models.blocks import max_pool2x2
from fabric_tpu_torch.ops import _build

_OUT = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}


def siamese_fuse_s8_reference(a: torch.Tensor, m: float,
                              out_dtype=torch.int8, pool: bool = True):
    """Plain version of :func:`siamese_fuse_s8`."""
    n = a.shape[0] // 2
    f = torch.relu(a[n:].to(torch.int32) * a[:n].to(torch.int32)).float() * m
    if out_dtype == torch.int8:
        f = torch.clamp(torch.round(f), 0, 127).to(torch.int8)
    else:
        f = f.to(out_dtype)
    return f, (max_pool2x2(a) if pool else None)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("siamese_s8")
    fn = lib.fabric_siamese_fuse_s8
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check(a: torch.Tensor, out_dtype) -> None:
    if a.get_device() < 0:
        raise ValueError(f"expected a CUDA tensor, got {a.device}")
    if a.dtype != torch.int8:
        raise TypeError(f"siamese_fuse_s8 takes an int8 tensor, got "
                        f"{a.dtype}")
    if out_dtype not in _OUT:
        raise TypeError(f"siamese_fuse_s8 writes int8, bfloat16 or float32, "
                        f"got {out_dtype}")
    if (a.dim() != 4 or not a.is_contiguous() or a.data_ptr() % 16
            or min(a.shape) <= 0 or a.shape[0] % 2):
        raise ValueError(f"siamese_fuse_s8 takes a contiguous, 16-byte "
                         f"aligned, non-empty (2n, H, W, C) tensor, got "
                         f"{tuple(a.shape)} with strides {a.stride()}")
    if a.shape[-1] % 16:
        raise ValueError(f"siamese_fuse_s8 takes a channel count that is a "
                         f"multiple of 16, got {a.shape[-1]}")


def _launch(a: torch.Tensor, m: float, out_dtype, pool: bool):
    """Validate and launch csrc/siamese_s8.cu (counted)."""
    _check(a, out_dtype)
    n2, h, w, c = a.shape
    f = torch.empty((n2 // 2, h, w, c), dtype=out_dtype, device=a.device)
    p = (torch.empty((n2, h // 2, w // 2, c), dtype=torch.int8,
                     device=a.device) if pool else None)
    lib = _lib()
    idx = a.get_device()
    with _build.on_device(idx):
        err = lib.fabric_siamese_fuse_s8(
            a.data_ptr(), f.data_ptr(), None if p is None else p.data_ptr(),
            n2 // 2, h, w, c, float(m), _OUT[out_dtype],
            _build.raw_stream(idx))
    _build.check(lib, err, "siamese_fuse_s8")
    siamese_fuse_s8.launches += 1
    return f, p


def _no_pool(a: torch.Tensor) -> torch.Tensor:
    """The op's stand-in for "no pool": a custom op returns tensors."""
    return a.new_empty((0,))


@torch.library.custom_op("fabric_tpu_torch::siamese_fuse_s8",
                         mutates_args=(), device_types="cuda")
def siamese_fuse_s8_op(a: torch.Tensor, m: float, out_dtype: torch.dtype,
                       pool: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel as a custom op (what an exported program calls): the
    launch on CUDA, the plain version on the CPU; without ``pool`` the
    second output is empty."""
    f, p = _launch(a, m, out_dtype, pool)
    return f, _no_pool(a) if p is None else p


@siamese_fuse_s8_op.register_kernel("cpu")
def _(a, m, out_dtype, pool):
    f, p = siamese_fuse_s8_reference(a, m, out_dtype, pool)
    return f, _no_pool(a) if p is None else p


@siamese_fuse_s8_op.register_fake
def _(a, m, out_dtype, pool):
    n2, h, w, c = a.shape
    f = a.new_empty((n2 // 2, h, w, c), dtype=out_dtype)
    return f, (a.new_empty((n2, h // 2, w // 2, c)) if pool
               else _no_pool(a))


def siamese_fuse_s8(a: torch.Tensor, m: float, out_dtype=torch.int8,
                    pool: bool = True):
    """(f, p) of an int8 encoder level ``a`` (2n, H, W, C): f (n, H, W, C)
    = float(relu(a[n + i] * a[i])) * float32(m), as int8 codes
    clamp(round(f), 0, 127) for ``out_dtype`` int8, else rounded once to
    ``out_dtype`` (bfloat16 or float32); p (2n, H // 2, W // 2, C) int8 the
    2x2 max-pool of a when ``pool``, else None.  On the card C is a
    multiple of 16.  Under ``torch.export`` the call is the custom op."""
    if torch.compiler.is_exporting():
        f, p = siamese_fuse_s8_op(a, float(m), out_dtype, pool)
        return f, (p if pool else None)
    if a.device.type == "cpu":
        return siamese_fuse_s8_reference(a, m, out_dtype, pool)
    return _launch(a, m, out_dtype, pool)


siamese_fuse_s8.launches = 0
