"""Serving artifacts on an NVIDIA GPU: the kernels' custom ops against
their direct launches, and scene runners exported with torch.export and
served from aot_dir on the card, bit-equal to the in-process runners and
launching the same kernels; an artifact for the card exported on the CPU
is moved to the card when it loads.  Every test here is marked ``cuda``
and skips without a card; on one, run ``python -m pytest -m cuda
tests/test_torch_card_aot.py``.  Imports no JAX."""

import numpy as np
import pytest
import torch

from fabric_tpu_torch.config import Config
from fabric_tpu_torch.infer import aot
from fabric_tpu_torch.infer.service import ScenePredictor
from fabric_tpu_torch.ops import (bn_relu, conv, conv_s8, double_conv,
                                  fuse_s8, fused)

COUNTERS = (conv.conv3x3_bias_relu, double_conv.double_conv3x3_bias_relu,
            fused.fused_mul_relu, bn_relu.bn_relu_inference,
            conv_s8.conv3x3_s8, conv_s8.conv3x3_s8_q,
            fuse_s8.siamese_fuse_s8)
# the float32 forms' counters: attributes of the same wrappers
F32_COUNTERS = (conv.conv3x3_bias_relu, double_conv.double_conv3x3_bias_relu,
                conv_s8.conv3x3_s8_q)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with -m cuda on the card)")
    return torch.device("cuda")


def _counts() -> dict:
    return {**{fn.__name__: fn.launches for fn in COUNTERS},
            **{fn.__name__ + "_f32": fn.launches_f32 for fn in F32_COUNTERS}}


def _launched(fn) -> tuple:
    before = _counts()
    out = fn()
    torch.cuda.synchronize()
    after = _counts()
    return out, {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}


@pytest.mark.cuda
def test_kernel_ops_equal_direct_launches(card):
    """Each custom op on CUDA tensors is the kernel's launch: bit-equal to
    the wrapper's direct call, one count each."""
    g = torch.Generator(device=card).manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=card).to(dtype)

    x, k1, b1 = randn(4, 16, 16, 64), randn(3, 3, 64, 128), randn(128)
    k2, b2 = randn(3, 3, 128, 128), randn(128)
    p1, p2 = conv.pack_weight(k1), conv.pack_weight(k2)
    ops = torch.ops.fabric_tpu_torch
    cases = [
        (lambda: conv.conv3x3_bias_relu(x, k1, b1, p1),
         lambda: ops.conv3x3_bias_relu(x, k1, b1, p1), "conv3x3_bias_relu"),
        (lambda: double_conv.double_conv3x3_bias_relu(x, k1, b1, k2, b2,
                                                      (p1, p2)),
         lambda: ops.double_conv3x3_bias_relu(x, k1, b1, k2, b2, p1, p2),
         "double_conv3x3_bias_relu"),
        (lambda: fused.fused_mul_relu(x, x),
         lambda: ops.fused_mul_relu(x, x), "fused_mul_relu"),
    ]
    v = [randn(64, dtype=torch.float32).abs() + 0.5 for _ in range(4)]
    cases.append((lambda: bn_relu.bn_relu_inference(x, *v),
                  lambda: ops.bn_relu_inference(x, *v, 1e-5, None),
                  "bn_relu_inference"))
    xq = torch.randint(-127, 128, (4, 16, 16, 64), device=card,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (3, 3, 64, 64), device=card,
                       dtype=torch.int8)
    pq = conv_s8.pack_weight(wq)
    sc, bi = v[0] * 1e-3, v[1]
    cases += [
        (lambda: conv_s8.conv3x3_s8(xq, wq, pq),
         lambda: ops.conv3x3_s8(xq, wq, pq), "conv3x3_s8"),
        (lambda: conv_s8.conv3x3_s8_q(xq, wq, sc, bi, 0.05, pq),
         lambda: ops.conv3x3_s8_q(xq, wq, sc, bi, 0.05, pq, None, None,
                                  None, None, torch.bfloat16),
         "conv3x3_s8_q"),
        (lambda: fuse_s8.siamese_fuse_s8(xq, 0.01)[0],
         lambda: ops.siamese_fuse_s8(xq, 0.01, torch.int8, True)[0],
         "siamese_fuse_s8"),
    ]
    for direct, op, name in cases:
        want, n_direct = _launched(direct)
        got, n_op = _launched(op)
        assert n_direct == n_op == {name: 1}, name
        assert torch.equal(got, want), name


def _cfg(**kw):
    return Config(**{"patch_size": 32, "dtype": "bfloat16", "model_base": 16,
                     "eval_batch_size": 16, **kw})


def _pair(seed, h=200, w=240):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(h, w, 13).astype(np.float32) for _ in range(2))


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"quant": "int8"},
                                {"fullconv_band_rows": 128}],
                         ids=["grid", "int8", "fullconv"])
def test_aot_serves_the_kernels_on_the_card(card, tmp_path, kw):
    """An artifact exported on the card serves the in-process masks bit
    for bit, through the same kernel launches."""
    _aot_serves_the_kernels(tmp_path, kw, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"quant": "int8"},
                                {"fullconv_band_rows": 128}],
                         ids=["grid", "int8", "fullconv"])
def test_f32_aot_serves_the_kernels_on_the_card(card, tmp_path, kw):
    """The same in float32: the exported program calls the fp32 forms
    through the same custom ops, and no bf16 kernel."""
    n_in = _aot_serves_the_kernels(tmp_path, kw, "float32")
    assert not {"conv3x3_bias_relu", "double_conv3x3_bias_relu",
                "conv3x3_s8_q"} & set(n_in), n_in
    assert {"conv3x3_bias_relu_f32", "conv3x3_s8_q_f32"} & set(n_in), n_in


def _aot_serves_the_kernels(tmp_path, kw, dtype) -> dict:
    d1, d2 = _pair(1)
    base = ScenePredictor(_cfg(dtype=dtype), bucket=128, device="cuda", **kw)
    base.predict(*_pair(2))  # int8: calibrates
    aot.export_aot(base, str(tmp_path), [d1.shape[:2]])
    served = ScenePredictor(_cfg(dtype=dtype), bucket=128, device="cuda",
                            aot_dir=str(tmp_path), **kw)
    want, n_in = _launched(lambda: base.predict(d1, d2))
    got, n_aot = _launched(lambda: served.predict(d1, d2))
    assert served._aot_keys == {(256, 256)}
    np.testing.assert_array_equal(got, want)
    assert n_aot == n_in and n_in
    return n_in


@pytest.mark.cuda
def test_cuda_artifact_exported_on_the_cpu(card, tmp_path):
    """An artifact for the card exported by a CPU predictor holds its
    tensors on the CPU; loaded on the card it is moved there, and serves
    the in-process card masks through the kernels."""
    d1, d2 = _pair(3)
    cpu = ScenePredictor(_cfg(), bucket=128, device="cpu")
    meta = aot.export_aot(cpu, str(tmp_path), [d1.shape[:2]],
                          platforms=("cuda",))
    assert meta["platforms"] == ["cuda"]
    base = ScenePredictor(_cfg(), bucket=128, device="cuda")
    served = ScenePredictor(_cfg(), bucket=128, device="cuda",
                            aot_dir=str(tmp_path))
    want, n_in = _launched(lambda: base.predict(d1, d2))
    got, n_aot = _launched(lambda: served.predict(d1, d2))
    np.testing.assert_array_equal(got, want)
    assert n_aot == n_in and n_in
