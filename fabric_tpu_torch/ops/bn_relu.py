"""Eval BatchNorm + ReLU over NHWC: relu(x * s + t) per channel.

Counterpart of ``fabric_tpu/ops/pallas_fused.py:bn_relu_inference``.  The
wrapper forms the per-channel constants in float32 exactly as that
function does (``inv = scale / sqrt(var + eps)``, ``t = bias - mean *
inv``); on a CUDA tensor it then launches a Triton kernel that computes
``relu(x_f32 * s + t)`` in float32 and rounds once to x's dtype (bf16 or
fp32).

Rounding against the TPU kernel: ``fabric_tpu``'s Pallas kernel casts s
and t to x's dtype and computes in bf16.  The port instead matches what
``fabric_tpu``'s model computes on its eval path, where the kernel is not
used: ``TorchBatchNorm`` in float32, then ReLU, then the cast to the
compute dtype (``fabric_tpu/models/blocks.py:86-88, 181-185``).  In bf16
the two differ by the TPU kernel's extra roundings of s, t and x*s; that
is a rounding difference, not a fault.

Why Triton, not CUDA C++: the work is one elementwise pass with a
per-channel broadcast along the contiguous last axis.  There is no
tensor-core work and no reuse beyond the two (C,) vectors, so bytes bound
it (read x, write y: 2 x 2 bytes per element in bf16, at 3.35 TB/s on the
H100).  A 2-D blocked Triton kernel moves exactly those bytes: each block
takes a power-of-two channel slice of a run of rows, loads its slice of s
and t once, and reads and writes x with 16-byte vector accesses (the
channel count, a multiple of 8, keeps every row aligned).  A CUDA kernel
would move the same bytes.
"""

from __future__ import annotations

import functools

import torch

_BLOCK_ELEMS = 8192  # elements per block: 16 KB of bf16


def _scale_shift(scale, bias, mean, var, eps):
    """(s, t) in float32: s = scale / sqrt(var + eps), t = bias - mean*s."""
    inv = scale / torch.sqrt(var + eps)
    return inv, bias - mean * inv


def bn_relu_inference_reference(x: torch.Tensor, scale: torch.Tensor,
                                bias: torch.Tensor, mean: torch.Tensor,
                                var: torch.Tensor,
                                eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version."""
    s, t = _scale_shift(scale, bias, mean, var, eps)
    return torch.relu(x.float() * s + t).to(x.dtype)


@functools.cache
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def bn_relu_kernel(x_ptr, s_ptr, t_ptr, out_ptr, rows, c,
                       BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        r = tl.program_id(0).to(tl.int64) * BLOCK_R + tl.arange(0, BLOCK_R)
        k = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        kmask = k < c
        s = tl.load(s_ptr + k, mask=kmask, other=0.0)
        t = tl.load(t_ptr + k, mask=kmask, other=0.0)
        offs = r[:, None] * c + k[None, :]
        mask = (r[:, None] < rows) & kmask[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0)
        y = tl.maximum(x.to(tl.float32) * s[None, :] + t[None, :], 0.0)
        tl.store(out_ptr + offs, y.to(x.dtype), mask=mask)

    return bn_relu_kernel


def _block(c: int) -> tuple[int, int]:
    """(rows, channels) of one block: the channel slice is the power of
    two >= C, at most 256; rows fill _BLOCK_ELEMS."""
    block_c = min(256, 1 << max(c - 1, 0).bit_length())
    return _BLOCK_ELEMS // block_c, block_c


def bn_relu_inference(x: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, mean: torch.Tensor,
                      var: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """relu((x - mean) * scale / sqrt(var + eps) + bias) over the last
    axis of an (N, H, W, C) tensor; scale, bias, mean, var (C,) float32."""
    if x.device.type == "cpu":
        return bn_relu_inference_reference(x, scale, bias, mean, var, eps)
    vecs = (scale, bias, mean, var)
    if x.device.type != "cuda" or any(v.device != x.device for v in vecs):
        raise ValueError(f"expected tensors on one CUDA device, got "
                         f"{x.device} and {[str(v.device) for v in vecs]}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"bn_relu_inference takes bfloat16 or float32 x, "
                        f"got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"bn_relu_inference takes a contiguous (N, H, W, "
                         f"C) tensor, got {tuple(x.shape)}")
    c = x.shape[-1]
    if any(v.dtype != torch.float32 or tuple(v.shape) != (c,) for v in vecs):
        raise ValueError(f"scale, bias, mean and var must be float32 of "
                         f"shape ({c},)")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *vecs)):
        raise RuntimeError("bn_relu_inference has no backward; call it "
                           "under torch.no_grad() or inference_mode()")
    s, t = _scale_shift(scale, bias, mean, var, eps)
    out = torch.empty_like(x)
    rows = x.numel() // max(c, 1)
    if rows and c:
        block_r, block_c = _block(c)
        grid = (-(-rows // block_r), -(-c // block_c))
        _kernel()[grid](x, s, t, out, rows, c, BLOCK_R=block_r,
                        BLOCK_C=block_c, num_warps=8)
        bn_relu_inference.launches += 1
    return out


bn_relu_inference.launches = 0
