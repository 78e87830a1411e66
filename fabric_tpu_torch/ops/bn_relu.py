"""Eval BatchNorm + ReLU over NHWC: relu(x * s + t) per channel, with the
conv bias before it optionally fused.

Counterpart of ``fabric_tpu/ops/pallas_fused.py:bn_relu_inference``.  The
per-channel constants are ``fabric_tpu``'s, in float32: ``s = scale /
sqrt(var + eps)``, ``t = bias - mean * s``.  The result is computed in
float32 and rounded once to x's dtype (bf16 or fp32).  With ``conv_bias``
the input is first ``x + conv_bias`` rounded to x's dtype, exactly as
``Conv.forward`` adds its bias, so the unfolded eval forward runs each
conv without its bias and reads and writes the conv output once.

On a CUDA tensor :func:`bn_relu_inference` makes one launch of the
hand-written kernel ``csrc/bn_relu.cu`` and nothing else: the kernel forms
s and t itself, with the plain version's float32 steps, so its output is
bit-equal to :func:`bn_relu_inference_reference`.  It replaced a Triton
kernel whose wrapper formed s and t in five small PyTorch launches and
went through Triton's Python launcher: at the eval forward's small levels
(6^2, 12^2) the card's work is a few microseconds, so those host costs
set the time; a ``ctypes`` call into the built library costs the host
less.  See the source's header for the design and what bounds it.

Rounding against the TPU kernel: ``fabric_tpu``'s Pallas kernel casts s
and t to x's dtype and computes in bf16.  The port instead matches what
``fabric_tpu``'s model computes on its eval path, where the kernel is not
used: ``TorchBatchNorm`` in float32, then ReLU, then the cast to the
compute dtype (``fabric_tpu/models/blocks.py:86-88, 181-185``).  In bf16
the two differ by the TPU kernel's extra roundings of s, t and x*s; that
is a rounding difference, not a fault.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fabric_tpu_torch.ops import _build


def _scale_shift(scale, bias, mean, var, eps):
    """(s, t) in float32: s = scale / sqrt(var + eps), t = bias - mean*s."""
    inv = scale / torch.sqrt(var + eps)
    return inv, bias - mean * inv


def bn_relu_inference_reference(x: torch.Tensor, scale: torch.Tensor,
                                bias: torch.Tensor, mean: torch.Tensor,
                                var: torch.Tensor, eps: float = 1e-5,
                                conv_bias: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """Plain version."""
    if conv_bias is not None:
        x = x + conv_bias.to(x.dtype)
    s, t = _scale_shift(scale, bias, mean, var, eps)
    return torch.relu(x.float() * s + t).to(x.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("bn_relu")
    fn = lib.fabric_bn_relu
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_float]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, vecs: tuple) -> int:
    """Raise on what the kernel does not take; x's device index.  Kept
    cheap on the host: at the small levels the host's cost of a call is
    the kernel's time."""
    idx = x.get_device()
    c = x.shape[-1]
    if idx < 0 or any(v.get_device() != idx for v in vecs):
        raise ValueError(f"expected tensors on one CUDA device, got "
                         f"{x.device} and {[str(v.device) for v in vecs]}")
    if x.dtype is not torch.bfloat16 and x.dtype is not torch.float32:
        raise TypeError(f"bn_relu_inference takes bfloat16 or float32 x, "
                        f"got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"bn_relu_inference takes a contiguous, 16-byte "
                         f"aligned (N, H, W, C) tensor, got "
                         f"{tuple(x.shape)} with strides {x.stride()}")
    if c % 8:
        raise ValueError(f"bn_relu_inference takes a channel count that is "
                         f"a multiple of 8, got {c}")
    for v in vecs:
        if v.dtype is not torch.float32 or v.shape != (c,) or \
                not v.is_contiguous():
            raise ValueError(f"scale, bias, mean, var and conv_bias must be "
                             f"contiguous float32 of shape ({c},)")
    if torch.is_grad_enabled() and (
            x.requires_grad or any(v.requires_grad for v in vecs)):
        raise RuntimeError("bn_relu_inference has no backward; call it "
                           "under torch.no_grad() or inference_mode()")
    return idx


def _launch(x, scale, bias, mean, var, eps, conv_bias) -> torch.Tensor:
    """Validate and launch csrc/bn_relu.cu (counted)."""
    vecs = (scale, bias, mean, var) + (() if conv_bias is None
                                       else (conv_bias,))
    idx = _check(x, vecs)
    out = torch.empty_like(x)
    if x.numel():
        lib = _lib()
        with _build.on_device(idx):
            err = lib.fabric_bn_relu(
                x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                mean.data_ptr(), var.data_ptr(), eps,
                None if conv_bias is None else conv_bias.data_ptr(),
                out.data_ptr(), x.numel() // x.shape[-1], x.shape[-1],
                x.dtype is torch.bfloat16, _build.raw_stream(idx))
        _build.check(lib, err, "bn_relu_inference")
        bn_relu_inference.launches += 1
    return out


@torch.library.custom_op("fabric_tpu_torch::bn_relu_inference",
                         mutates_args=(), device_types="cuda")
def bn_relu_inference_op(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, mean: torch.Tensor,
                         var: torch.Tensor, eps: float,
                         conv_bias: torch.Tensor | None) -> torch.Tensor:
    """The kernel as a custom op (what an exported program calls): the
    launch on CUDA, the plain version on the CPU."""
    return _launch(x, scale, bias, mean, var, eps, conv_bias)


@bn_relu_inference_op.register_kernel("cpu")
def _(x, scale, bias, mean, var, eps, conv_bias):
    return bn_relu_inference_reference(x, scale, bias, mean, var, eps,
                                       conv_bias)


@bn_relu_inference_op.register_fake
def _(x, scale, bias, mean, var, eps, conv_bias):
    return torch.empty_like(x)


def bn_relu_inference(x: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, mean: torch.Tensor,
                      var: torch.Tensor, eps: float = 1e-5,
                      conv_bias: torch.Tensor | None = None) -> torch.Tensor:
    """relu((z - mean) * scale / sqrt(var + eps) + bias) over the last
    axis of an (N, H, W, C) tensor, z = x, or x + conv_bias rounded to x's
    dtype; scale, bias, mean, var, conv_bias (C,) float32.  On the card C
    is a multiple of 8.  Under ``torch.export`` the call is the custom
    op."""
    if torch.compiler.is_exporting():
        return bn_relu_inference_op(x, scale, bias, mean, var, eps,
                                    conv_bias)
    if x.device.type == "cpu":
        return bn_relu_inference_reference(x, scale, bias, mean, var, eps,
                                           conv_bias)
    return _launch(x, scale, bias, mean, var, eps, conv_bias)


bn_relu_inference.launches = 0
