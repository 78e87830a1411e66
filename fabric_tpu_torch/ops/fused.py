"""Siamese fusion relu(a * b), elementwise, with a gradient.

Counterpart of ``fabric_tpu/ops/pallas_fused.py:fused_mul_relu``.  On a
CUDA tensor :func:`fused_mul_relu` launches a Triton kernel: one masked 1-D
pass over the flattened tensors.  :class:`FusedMulRelu` puts the same
forward under autograd for training; its backward is plain elementwise
PyTorch (``fabric_tpu`` has no backward kernel for it either).

Bound on the H100: two reads and one write per element and one multiply
and one max, so bytes bound it (3 x 2 bytes per element at 3.35 TB/s).  The
kernel moves exactly those bytes once, 16 bytes per thread per access, with
no padding of the tail (the TPU kernel's lane-padded (rows, 128) flatten is
not needed here): the mask covers the ragged end.
"""

from __future__ import annotations

import functools

import torch

from fabric_tpu_torch.ops import _build

_BLOCK = 4096


def fused_mul_relu_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version."""
    return torch.relu(a * b)


@functools.cache
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def mul_relu_kernel(a_ptr, b_ptr, out_ptr, n, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        a = tl.load(a_ptr + offs, mask=mask)
        b = tl.load(b_ptr + offs, mask=mask)
        tl.store(out_ptr + offs, tl.maximum(a * b, 0.0).to(a.dtype),
                 mask=mask)

    return mul_relu_kernel


def _launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Validate and launch the Triton kernel (counted)."""
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"expected two tensors on one CUDA device, got "
                         f"{a.device} and {b.device}")
    if a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(f"shape/dtype mismatch: {tuple(a.shape)} {a.dtype} "
                         f"vs {tuple(b.shape)} {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("fused_mul_relu takes contiguous tensors")
    out = torch.empty_like(a)
    n = a.numel()
    if n:
        # Triton launches on the current device: make it the tensors'
        with _build.on_device(a.get_device()):
            _kernel()[(-(-n // _BLOCK),)](a, b, out, n, BLOCK=_BLOCK,
                                           num_warps=8)
        fused_mul_relu.launches += 1
    return out


@torch.library.custom_op("fabric_tpu_torch::fused_mul_relu", mutates_args=(),
                         device_types="cuda")
def fused_mul_relu_op(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel as a custom op (what an exported program calls): the
    launch on CUDA, the plain version on the CPU."""
    return _launch(a, b)


@fused_mul_relu_op.register_kernel("cpu")
def _(a, b):
    return fused_mul_relu_reference(a, b)


@fused_mul_relu_op.register_fake
def _(a, b):
    return torch.empty_like(a)


def fused_mul_relu(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """relu(a * b) for two tensors of one shape and dtype.  Under
    ``torch.export`` the call is the custom op."""
    if torch.compiler.is_exporting():
        return fused_mul_relu_op(a, b)
    if a.device.type == "cpu":
        return fused_mul_relu_reference(a, b)
    return _launch(a, b)


fused_mul_relu.launches = 0


class FusedMulRelu(torch.autograd.Function):
    """relu(a * b) with the kernel forward and a plain backward:
    g_a = g * b * [out > 0], g_b = g * a * [out > 0].  The mask ``out > 0``
    is ``jax.nn.relu``'s (zero gradient at 0), and the backward repeats
    autograd's own ops for ``torch.relu(a * b)``, so the gradients equal
    autograd's exactly."""

    @staticmethod
    def forward(ctx, a, b):
        out = fused_mul_relu(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        g = torch.where(out > 0, g, torch.zeros_like(g))
        return g * b, g * a
