"""The float32 conv kernels' arithmetic on the CPU: the 3xTF32 split
(``ops/conv.split_tf32``, the split the kernels make of A in registers and
of the weights at pack time) and a plain 3xTF32 emulation of the conv
(:func:`conv3x3_tf32x3`) against ``fabric_tpu``'s float32 conv; and the float32 product pin
(``ops/fp32_matmul.py``): gradients, the custom op an exported program
keeps, and an import that writes no TF32 setting.  The kernels themselves
are held against the plain versions on the card by test_torch_cuda.py."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from fabric_tpu.ops.pallas_conv import conv3x3_bias_relu as pallas_conv

from fabric_tpu_torch.ops import conv, fp32_matmul

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def conv3x3_tf32x3(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Plain emulation of the float32 kernels' products: conv3x3_SAME of
    NHWC float32 x with the HWIO kernel as 3xTF32, lo_x*hi_k + hi_x*lo_k +
    hi_x*hi_k, each term a conv of TF32 values summed in float64 (the
    tensor cores' products are exact; their fp32 sums are not emulated).
    Float64 (N, H, W, Cout) out."""
    (xh, xl), (kh, kl) = (conv.split_tf32(x.float()),
                          conv.split_tf32(kernel.float()))

    def conv64(a, k):
        return F.conv2d(a.double().permute(0, 3, 1, 2),
                        k.double().permute(3, 2, 0, 1), padding=1)
    return (conv64(xl, kh) + conv64(xh, kl) + conv64(xh, kh)).permute(
        0, 2, 3, 1)


def _values(seed: int, n: int = 4096) -> torch.Tensor:
    """float32 values over many binades, with the TF32 split's ties
    (a half unit of the 13 dropped bits exactly) and both signs."""
    rng = np.random.RandomState(seed)
    a = (rng.randn(n) * np.exp2(rng.randint(-30, 30, n))).astype(np.float32)
    ties = (rng.randint(1 << 23, 1 << 24, 64) | 0x1000) & ~0xFFF
    t = ties.astype(np.float32) * np.float32(2.0 ** -23)
    return torch.from_numpy(np.concatenate([a, t, -t, [0.0, 1.0, -1.0]])
                            .astype(np.float32))


def test_split_tf32_is_the_kernels_split():
    """hi keeps 10 mantissa bits (its low 13 are zero) and is a rounded to
    nearest with ties away from zero (cvt.rna.tf32.f32); lo is the same of
    a - hi; hi + lo is within 2^-21 |a| of a; split(-a) = -split(a)."""
    a = _values(0)
    hi, lo = conv.split_tf32(a)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    # nearest, ties away: |a - hi| <= half a unit of hi's last kept bit,
    # and a tie goes to the larger magnitude
    d = (a.double() - hi.double()).abs()
    unit = torch.ldexp(torch.ones_like(d), torch.frexp(a.double())[1] - 11)
    assert (d <= unit / 2).all()
    tie = d == unit / 2
    assert tie.sum() >= 128 and (hi[tie].abs() > a[tie].abs()).all()
    err = (a.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -21 * a.double().abs()).all()
    nh, nl = conv.split_tf32(-a)
    assert torch.equal(nh, -hi) and torch.equal(nl, -lo)


@pytest.mark.parametrize("n,h,w,cin,cout", [
    (2, 16, 24, 8, 16), (1, 32, 33, 13, 64), (1, 16, 8, 256, 32),
    (2, 16, 16, 64, 8)])
def test_tf32x3_emulation_matches_fabric_tpu(n, h, w, cin, cout):
    """The float32 kernels' three TF32 products (lo*hi + hi*lo + hi*hi,
    summed in float64 here) against fabric_tpu's float32 Pallas conv on
    the CPU: within 1e-6 relative L2 of relu(conv + b) (the dropped lo*lo
    term and the split's remainder are below 2^-21 of each product)."""
    rng = np.random.RandomState(n + h + cin)
    x = rng.randn(n, h, w, cin).astype(np.float32)
    k = (rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    want = np.asarray(pallas_conv(jnp.asarray(x), jnp.asarray(k),
                                  jnp.asarray(b))).astype(np.float64)
    got = torch.relu(conv3x3_tf32x3(torch.from_numpy(x),
                                    torch.from_numpy(k))
                     + torch.from_numpy(b).double()).numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-6, rel
    # one TF32 product alone keeps ~3 digits: the emulation is not that
    hi = conv.split_tf32(torch.from_numpy(x))[0]
    one = torch.relu(torch.nn.functional.conv2d(
        hi.double().permute(0, 3, 1, 2),
        conv.split_tf32(torch.from_numpy(k))[0].double().permute(3, 2, 0, 1),
        padding=1).permute(0, 2, 3, 1) + torch.from_numpy(b).double())
    assert np.linalg.norm(one.numpy() - want) / np.linalg.norm(want) > 1e-5


@pytest.mark.parametrize("equation,shapes", [
    ("", ((2, 5, 3, 16), (16, 2))),                       # the 1x1 head
    ("nhwc,Hh->nHwc", ((2, 4, 3, 6), (8, 4))),           # upsample, rows
    ("nhwc,Ww->nhWc", ((2, 4, 3, 6), (6, 3))),           # upsample, columns
    ("ABabdeuv,uvic->ABabidec", ((2, 2, 2, 2, 2, 2, 3, 3), (3, 3, 4, 5))),
])
def test_fp32_products_and_gradients(equation, shapes):
    """The pinned products compute what the plain ones do, and their
    gradients (the autograd Function's and the custom op's, each two
    products of the same kind) equal autograd's of the plain product."""
    rng = np.random.RandomState(len(equation))
    a0, b0 = (torch.from_numpy(rng.randn(*s).astype(np.float32))
              for s in shapes)
    plain = (lambda a, b: a @ b) if not equation else (
        lambda a, b: torch.einsum(equation, a, b))
    pinned = (fp32_matmul.matmul if not equation else
              lambda a, b: fp32_matmul.einsum(equation, a, b))
    assert torch.equal(pinned(a0, b0), plain(a0, b0))
    g = torch.from_numpy(rng.randn(*plain(a0, b0).shape).astype(np.float32))
    want = torch.autograd.grad(
        plain(a0.requires_grad_(), b0.requires_grad_()), (a0, b0), g)
    for fn in (lambda a, b: fp32_matmul._Product.apply(equation, a, b),
               lambda a, b: fp32_matmul.fp32_product_op(equation, a, b)):
        a, b = a0.detach().requires_grad_(), b0.detach().requires_grad_()
        got = torch.autograd.grad(fn(a, b), (a, b), g)
        for x, y in zip(got, want):
            torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)


def test_exported_fp32_program_keeps_the_pin():
    """torch.export of a float32 head and upsample emits the pin's custom
    op for each product (on whatever device the program is served, its
    CUDA kernel computes in full float32), with the plain products' values
    on the CPU; the artifacts' kernel-op count leaves it out; bf16 products
    stay aten ops."""
    from fabric_tpu_torch.infer import aot
    from fabric_tpu_torch.ops.resize import upsample2x_align_corners

    class Head(torch.nn.Module):
        def __init__(self, dtype):
            super().__init__()
            self.k = torch.nn.Parameter(torch.randn(8, 2, dtype=dtype))

        def forward(self, x):
            return fp32_matmul.matmul(upsample2x_align_corners(x), self.k)

    for dtype, pins in ((torch.float32, 3), (torch.bfloat16, 0)):
        head = Head(dtype)
        x = torch.randn(2, 4, 5, 8, dtype=dtype)
        program = torch.export.export(head, (x,), strict=False)
        ops = [n for n in program.graph.nodes if n.op == "call_function"
               and "fp32_product" in str(n.target)]
        assert len(ops) == pins
        assert aot.kernel_ops(program) == {}
        with torch.no_grad():
            assert torch.equal(program.module()(x), head(x))


def test_importing_the_port_writes_no_tf32_setting():
    """A caller's TF32 settings survive importing every
    serving and training module of the port (no module writes one at
    import)."""
    code = """
import torch
torch.backends.cuda.matmul.allow_tf32 = True
torch.backends.cudnn.allow_tf32 = False
before = (torch.get_float32_matmul_precision(),
          torch.backends.cuda.matmul.allow_tf32,
          torch.backends.cudnn.allow_tf32)
import fabric_tpu_torch.infer.service, fabric_tpu_torch.train.loop
import fabric_tpu_torch.infer.aot, fabric_tpu_torch.tools.export
import fabric_tpu_torch.ops.resize, fabric_tpu_torch.models.bidate
after = (torch.get_float32_matmul_precision(),
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32)
print(before == after == ("high", True, False))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True"
