"""Matrix products that run in full float32 on the card, whatever the
process's TF32 matmul setting says.

A caller may let cuBLAS compute float32 products in TF32
(``torch.backends.cuda.matmul.allow_tf32 = True`` or
``torch.set_float32_matmul_precision("high")``), which keeps about three
decimal digits; ``fabric_tpu`` computes the port's float32 products (the
align-corners upsample's two matmuls, the 1x1 heads, the s2d kernel
packing) in full float32, and the port is held to it.  As for the convs
(``ops/fp32_conv.py``), a setting made once would not hold, and importing
the port changes no setting of the caller's process.  So every float32
product of the port goes through :func:`matmul` or :func:`einsum`, which
for a float32 CUDA operand

- computes the product with cuBLAS's float32 precision set to full
  ("ieee") for the call alone (:func:`full_fp32`), the caller's setting
  put back after;
- where a gradient is wanted, wraps it in an autograd Function whose
  backward computes its two products under the same pin (autograd runs
  it later, under whatever the setting says then);
- under ``torch.export`` emits the custom op ``fabric_tpu_torch::
  fp32_product`` for any float32 operand, so that an exported program
  keeps the pin on whatever device it is served (its CPU kernel is the
  plain product, as the in-process CPU path computes it).

On the CPU, and for other dtypes, they are ``a @ b`` and
``torch.einsum`` as they are.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_fp32():
    """cuBLAS's float32 products in full float32 inside the block, the
    caller's setting after (``torch.backends.cuda.matmul.fp32_precision``
    where this PyTorch has it, else the legacy ``allow_tf32``)."""
    m = torch.backends.cuda.matmul
    try:
        prev = m.fp32_precision
    except AttributeError:  # a PyTorch without the fp32_precision API
        prev = None
    if prev is None:
        prev_tf32 = m.allow_tf32
        m.allow_tf32 = False
        try:
            yield
        finally:
            m.allow_tf32 = prev_tf32
        return
    m.fp32_precision = "ieee"
    try:
        yield
    finally:
        m.fp32_precision = prev


def _product(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for the empty equation, else ``torch.einsum``."""
    return a @ b if not equation else torch.einsum(equation, a, b)


@torch.library.custom_op("fabric_tpu_torch::fp32_product", mutates_args=())
def fp32_product_op(equation: str, a: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """The product as a custom op (what an exported program calls): in
    full float32 on CUDA, the plain product on the CPU."""
    if a.device.type != "cuda":
        return _product(equation, a, b)
    with full_fp32():
        return _product(equation, a, b)


@fp32_product_op.register_fake
def _(equation, a, b):
    return _product(equation, a, b)


def _grads(equation: str, a, b, g, need_a: bool, need_b: bool):
    """The gradients of ``_product(equation, a, b)`` for upstream ``g``,
    as two products of the same kind (each index of an operand is in the
    other operand or in the output, as in the port's products)."""
    if not equation:  # a (..., K) @ b (K, N)
        ga = g @ b.transpose(0, 1) if need_a else None
        gb = (a.reshape(-1, a.shape[-1]).transpose(0, 1)
              @ g.reshape(-1, g.shape[-1])) if need_b else None
        return ga, gb
    ins, out = equation.replace(" ", "").split("->")
    ia, ib = ins.split(",")
    ga = torch.einsum(f"{out},{ib}->{ia}", g, b) if need_a else None
    gb = torch.einsum(f"{ia},{out}->{ib}", a, g) if need_b else None
    return ga, gb


def _setup(ctx, inputs, output):
    equation, a, b = inputs
    ctx.save_for_backward(a, b)
    ctx.equation = equation


def _backward(ctx, g):
    """Both gradients' products in full float32 (autograd runs them later,
    under whatever the process's setting says then)."""
    a, b = ctx.saved_tensors
    with full_fp32():
        ga, gb = _grads(ctx.equation, a, b, g, ctx.needs_input_grad[1],
                        ctx.needs_input_grad[2])
    return None, ga, gb


fp32_product_op.register_autograd(_backward, setup_context=_setup)


class _Product(torch.autograd.Function):
    """:func:`_product` in full float32 with a gradient: the backward's
    products pinned too."""

    @staticmethod
    def forward(equation, a, b):
        with full_fp32():
            return _product(equation, a, b)

    setup_context = staticmethod(_setup)
    backward = staticmethod(_backward)


def _pinned(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.dtype != torch.float32:
        return _product(equation, a, b)
    if torch.compiler.is_exporting():
        return fp32_product_op(equation, a, b)
    if a.device.type != "cuda":
        return _product(equation, a, b)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _Product.apply(equation, a, b)
    with full_fp32():
        return _product(equation, a, b)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (a: (..., K), b: (K, N)), in full float32 on the card
    for float32 operands, forward and backward."""
    return _pinned("", a, b)


def einsum(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(equation, a, b)`` of two operands, in full float32
    on the card for float32 operands, forward and backward."""
    return _pinned(equation, a, b)
