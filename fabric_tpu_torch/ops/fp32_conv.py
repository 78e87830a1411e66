"""Convolutions that run in full float32 on the card, whatever the
process's TF32 flags say.

PyTorch lets cuDNN compute a float32 convolution in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
decimal digits; ``fabric_tpu`` computes the same convs in full float32,
and the port is held to it.  A flag set once at import would not hold: a
caller may set it back, and autograd runs a conv's backward later, under
whatever the flag says then.  So every float32 conv of the port on the
card goes through :func:`conv`, which

- calls ``aten._convolution`` with ``allow_tf32=False`` as an argument
  (an exported program keeps that argument in its graph), and
- where a gradient is wanted, wraps it in an autograd Function whose
  backward computes ``aten.convolution_backward`` with the flag off for
  its duration (:func:`no_tf32`), and puts the caller's setting back.

On the CPU, and for other dtypes, :func:`conv` is ``F.conv2d`` /
``F.conv3d`` as they are.  The float32 matmuls are pinned the same way
(``ops/fp32_matmul.py``).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def no_tf32():
    """cuDNN without TF32 inside the block, the caller's setting after."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _args(x: torch.Tensor, padding, groups: int) -> tuple:
    """``aten._convolution``'s arguments after (input, weight, bias):
    stride 1, no dilation, the process's cuDNN settings, TF32 off."""
    nd = x.dim() - 2
    pad = [padding] * nd if isinstance(padding, int) else list(padding)
    cudnn = torch.backends.cudnn
    return ([1] * nd, pad, [1] * nd, False, [0] * nd, groups,
            cudnn.benchmark,
            cudnn.deterministic or torch.are_deterministic_algorithms_enabled(),
            cudnn.enabled, False)


class _Conv(torch.autograd.Function):
    """:func:`conv` with a gradient: the backward with TF32 off too."""

    @staticmethod
    def forward(ctx, x, weight, bias, padding, groups):
        ctx.save_for_backward(x, weight)
        ctx.conf = (padding, groups, None if bias is None else bias.shape)
        return torch.ops.aten._convolution(x, weight, bias,
                                           *_args(x, padding, groups))

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        padding, groups, bias_shape = ctx.conf
        stride, pad, dilation, _, out_pad = _args(x, padding, groups)[:5]
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                bias_shape is not None and ctx.needs_input_grad[2]]
        with no_tf32():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                g, x, weight, bias_shape, stride, pad, dilation, False,
                out_pad, groups, mask)
        return gx, gw, gb, None, None


def conv(x: torch.Tensor, weight: torch.Tensor,
         bias: torch.Tensor | None = None, padding=0,
         groups: int = 1) -> torch.Tensor:
    """``F.conv2d`` (4-D x) or ``F.conv3d`` (5-D), stride 1, in full
    float32 on the card for a float32 CUDA x, forward and backward."""
    if x.dtype != torch.float32 or x.device.type != "cuda":
        op = F.conv2d if x.dim() == 4 else F.conv3d
        return op(x, weight, bias, padding=padding, groups=groups)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias)):
        return _Conv.apply(x, weight, bias, padding, groups)
    return torch.ops.aten._convolution(x, weight, bias,
                                       *_args(x, padding, groups))
