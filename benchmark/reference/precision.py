"""The lower-precision control: the reference computed one step below the
configuration's precision.  The configurations serve and train in
bfloat16, so the control computes in fp8 as fp8 training does: every
tensor that the program stores in bfloat16 (each conv's input, weights
and output, each product of the date fusions, and the logits) is
rounded to e4m3, and the
gradient that flows back through each such point to e5m2, both at a
per-tensor scale that maps the largest magnitude to the format's
largest value."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = t.abs().amax().clamp(min=1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2, E5M2_MAX)


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3, its gradient to e5m2 (per-tensor scales)."""
    if t.requires_grad:
        return _FP8.apply(t)
    with torch.no_grad():
        return _round(t, torch.float8_e4m3fn, E4M3_MAX)

