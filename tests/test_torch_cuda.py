"""The port's CUDA and Triton kernels against their plain PyTorch versions,
on an NVIDIA GPU.  Every test here is marked ``cuda`` and skips without a
card; on one, run ``python -m pytest -m cuda tests/test_torch_cuda.py``.
Imports no JAX, so it runs where only PyTorch is installed."""

import warnings

import numpy as np
import pytest
import torch

from fabric_tpu_torch.ops import bn_relu, conv, double_conv, fused

CONV_SHAPES = [(2, 16, 24, 8, 16), (1, 32, 33, 13, 64), (1, 48, 128, 64, 64),
               (3, 7, 5, 3, 70), (2, 5, 300, 24, 8), (512, 64, 64, 64, 64),
               # the main path's conv launches (inc, down1, up4), N cut
               (4, 64, 64, 13, 64), (4, 32, 32, 64, 128),
               (4, 32, 32, 128, 128), (4, 64, 64, 128, 64),
               # and the double-conv levels' convs, where the gate may send
               (5, 16, 16, 128, 256), (5, 8, 8, 256, 512),
               (9, 4, 4, 512, 512), (3, 8, 8, 1024, 256),
               # edges: 1x1, 3x5, 7x9 images, Cin 13 and 1024, Cout 2 and
               # 40, N not a multiple of the images per tile
               (3, 1, 1, 16, 64), (5, 3, 5, 13, 40), (3, 7, 9, 1024, 2),
               (11, 4, 4, 40, 40), (9, 8, 8, 64, 200)]
DOUBLE_SHAPES = [(2, 8, 8, 16, 32, 32), (1, 12, 20, 8, 8, 16),
                 (5, 16, 16, 32, 32, 32), (3, 8, 8, 32, 32, 16),
                 (1, 6, 6, 4, 4, 4), (2, 7, 13, 13, 24, 70),
                 (64, 16, 16, 128, 256, 256),
                 # the main path's double-conv levels, N cut (down2-4 and
                 # up1-3; down4's 4 images per block, up1's 2)
                 (3, 16, 16, 128, 256, 256), (5, 8, 8, 256, 512, 512),
                 (9, 4, 4, 512, 512, 512), (3, 8, 8, 1024, 256, 256),
                 (2, 16, 16, 512, 128, 128), (2, 32, 32, 256, 64, 64),
                 # edges: 1x1, 3x5, 7x9, Cin 13 and 1024, Cout 2 and 40,
                 # N not a multiple of the images per block
                 (5, 1, 1, 16, 32, 2), (7, 3, 5, 13, 40, 40),
                 (3, 7, 9, 1024, 64, 40), (6, 4, 4, 13, 64, 2),
                 (7, 8, 8, 64, 200, 136)]
FUSED_SHAPES = [(2, 17, 23, 64), (3, 7, 11, 5), (256, 64, 64, 64)]
BN_SHAPES = [(2, 9, 9, 32), (3, 5, 7, 24), (256, 96, 96, 64),
             (128, 12, 12, 256), (256, 6, 6, 512), (1, 3, 3, 8)]
# (2n, H, W, C) of siamese_fuse_s8: the 5 levels of an int8 forward
# (patch 64), N cut, then odd H and W, 1x1 images, C 16 and 48
FUSE_SHAPES = [(8, 64, 64, 64), (8, 32, 32, 128), (8, 16, 16, 256),
               (8, 8, 8, 512), (8, 4, 4, 512), (2, 7, 9, 16), (4, 1, 1, 32),
               (6, 5, 12, 48), (2, 3, 1, 16), (600, 4, 4, 64)]


def _conv_case(seed, n, h, w, cin, cout):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, h, w, cin).astype(np.float32),
            (rng.randn(3, 3, cin, cout) * 0.1).astype(np.float32),
            rng.randn(cout).astype(np.float32))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with -m cuda on the card)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _ulp_bound(ref: torch.Tensor, ulps: int) -> float:
    """`ulps` bf16 ulps (2^-7 relative, at most) of the largest output:
    kernel and plain version round the same fp32 sums, taken in another
    order, to bf16."""
    return ulps * 2.0 ** -7 * ref.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout", CONV_SHAPES)
def test_conv_kernel_matches_plain(card, n, h, w, cin, cout):
    x, k, b = (torch.from_numpy(a).to(card)
               for a in _conv_case(0, n, h, w, cin, cout))
    x = x.to(torch.bfloat16)
    before = conv.conv3x3_bias_relu.launches
    got = conv.conv3x3_bias_relu(x, k, b)
    torch.cuda.synchronize()
    assert conv.conv3x3_bias_relu.launches == before + 1
    ref = conv.conv3x3_bias_relu_reference(x, k, b)
    assert (got.float() - ref.float()).abs().max().item() <= _ulp_bound(ref, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DOUBLE_SHAPES)
def test_double_conv_kernel_matches_plain(card, shape):
    n, h, w, cin, cmid, cout = shape
    g = torch.Generator().manual_seed(0)
    x = torch.randn(n, h, w, cin, generator=g).to(card, torch.bfloat16)
    w1 = (torch.randn(3, 3, cin, cmid, generator=g) / (9 * cin) ** .5)
    w2 = (torch.randn(3, 3, cmid, cout, generator=g) / (9 * cmid) ** .5)
    b1, b2 = torch.randn(cmid, generator=g), torch.randn(cout, generator=g)
    args = [t.to(card) for t in (w1, b1, w2, b2)]
    got = double_conv.double_conv3x3_bias_relu(x, *args)
    torch.cuda.synchronize()
    ref = double_conv.double_conv3x3_bias_relu_reference(x, *args)
    # a one-ulp difference in the intermediate moves the output by at most
    # a few ulps more
    assert (got.float() - ref.float()).abs().max().item() <= _ulp_bound(ref, 4)


@pytest.mark.cuda
def test_prepacked_weights_give_the_same_result(card):
    g = torch.Generator().manual_seed(4)
    x = torch.randn(3, 8, 8, 64, generator=g).to(card, torch.bfloat16)
    w1 = (torch.randn(3, 3, 64, 128, generator=g) / 24).to(card)
    w2 = (torch.randn(3, 3, 128, 128, generator=g) / 34).to(card)
    b1, b2 = (torch.randn(128, generator=g).to(card) for _ in range(2))
    p1, p2 = conv.pack_weight(w1), conv.pack_weight(w2)
    assert torch.equal(conv.conv3x3_bias_relu(x, w1, b1, p1),
                       conv.conv3x3_bias_relu(x, w1, b1))
    assert torch.equal(
        double_conv.double_conv3x3_bias_relu(x, w1, b1, w2, b2, (p1, p2)),
        double_conv.double_conv3x3_bias_relu(x, w1, b1, w2, b2))


@pytest.mark.cuda
def test_folded_model_packs_its_kernels_once(card):
    """build_model packs the folded kernels; a forward reuses them; a
    changed kernel is packed again."""
    from fabric_tpu_torch import Config
    from fabric_tpu_torch.models import build_model
    model = build_model(Config(model_base=16), card)
    block = model.down3.conv
    first = block.packed_kernels()
    x = torch.randn(2, 16, 16, 13, device=card)
    with torch.inference_mode():
        model(x.to(torch.bfloat16), x.to(torch.bfloat16))
    assert block.packed_kernels() is first
    with torch.no_grad():
        block.conv1.kernel.mul_(2)
    again = block.packed_kernels()
    assert again is not first
    assert torch.equal(again[0], conv.pack_weight(block.conv1.kernel))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FUSED_SHAPES)
def test_fused_kernel_matches_plain(card, shape):
    a, b = (torch.randn(*shape).to(card, torch.bfloat16) for _ in range(2))
    got = fused.fused_mul_relu(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, fused.fused_mul_relu_reference(a, b))


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(card):
    x = torch.zeros(1, 8, 8, 4, device=card).half()  # bf16 and fp32 only
    k, b = torch.zeros(3, 3, 4, 4, device=card), torch.zeros(4, device=card)
    with pytest.raises(TypeError):
        conv.conv3x3_bias_relu(x, k, b)
    with pytest.raises(TypeError):
        conv.conv3x3_bias_relu(x.double(), k, b)
    with pytest.raises(ValueError, match="pack_weight"):  # bf16 layout
        conv.conv3x3_bias_relu(x.float(), k, b, conv.pack_weight(k))
    big = torch.zeros(1, 64, 64, 64, device=card, dtype=torch.bfloat16)
    k64, b64 = (torch.zeros(3, 3, 64, 64, device=card),
                torch.zeros(64, device=card))
    # the gate: a 64x64 image's 64-channel intermediate does not fit
    assert not double_conv.fits(64, 64, 64, 64, 64)
    with pytest.raises(ValueError, match="shared memory"):
        double_conv.double_conv3x3_bias_relu(big, k64, b64, k64, b64)
    with pytest.raises(ValueError, match="pack_weight"):
        conv.conv3x3_bias_relu(big, k64, b64, conv.pack_weight(k64)[:-8])
    with pytest.raises(ValueError, match="pack_weight"):
        small = big[:, :8, :8]
        double_conv.double_conv3x3_bias_relu(
            small.contiguous(), k64, b64, k64, b64,
            (conv.pack_weight(k64), conv.pack_weight(k64).float()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", BN_SHAPES)
def test_bn_relu_kernel_matches_plain(card, shape, dtype):
    """Element by element: the kernel may fuse x*s + t into one FMA where
    the plain version rounds the product first, so the fp32 values differ
    by at most 2^-22 (|x s| + |t|); bf16 adds one ulp of the output
    (2^-7 of the larger of the two outputs, at most)."""
    g = torch.Generator().manual_seed(1)
    c = shape[-1]
    x = (torch.randn(*shape, generator=g) * 2).to(card, dtype)
    scale, bias, mean = (torch.randn(c, generator=g).to(card)
                         for _ in range(3))
    var = (torch.rand(c, generator=g) + 0.1).to(card)
    before = bn_relu.bn_relu_inference.launches
    got = bn_relu.bn_relu_inference(x, scale, bias, mean, var)
    torch.cuda.synchronize()
    assert bn_relu.bn_relu_inference.launches == before + 1
    ref = bn_relu.bn_relu_inference_reference(x, scale, bias, mean, var)
    assert got.dtype == dtype and got.shape == x.shape
    s, t = bn_relu._scale_shift(scale, bias, mean, var, 1e-5)
    tol = 2.0 ** -22 * (x.float().abs() * s.abs() + t.abs())
    if dtype == torch.bfloat16:
        tol += 2.0 ** -7 * torch.maximum(got.float().abs(), ref.float().abs())
    assert ((got.float() - ref.float()).abs() <= tol).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", BN_SHAPES)
def test_bn_relu_kernel_with_conv_bias_matches_plain(card, shape, dtype):
    """The conv-bias form (the unfolded eval forward's): one launch, and
    the tolerance of the form without it, the bias add rounded to x's
    dtype on both sides first."""
    g = torch.Generator().manual_seed(4)
    c = shape[-1]
    x = (torch.randn(*shape, generator=g) * 2).to(card, dtype)
    scale, bias, mean, cb = (torch.randn(c, generator=g).to(card)
                             for _ in range(4))
    var = (torch.rand(c, generator=g) + 0.1).to(card)
    before = bn_relu.bn_relu_inference.launches
    got = bn_relu.bn_relu_inference(x, scale, bias, mean, var, 1e-5, cb)
    torch.cuda.synchronize()
    assert bn_relu.bn_relu_inference.launches == before + 1
    ref = bn_relu.bn_relu_inference_reference(x, scale, bias, mean, var,
                                              1e-5, cb)
    assert got.dtype == dtype and got.shape == x.shape
    z = (x + cb.to(dtype)).float()
    s, t = bn_relu._scale_shift(scale, bias, mean, var, 1e-5)
    tol = 2.0 ** -22 * (z.abs() * s.abs() + t.abs())
    if dtype == torch.bfloat16:
        tol += 2.0 ** -7 * torch.maximum(got.float().abs(), ref.float().abs())
    assert ((got.float() - ref.float()).abs() <= tol).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_eval_conv_output_is_contiguous(card, dtype):
    """The unfolded eval forward hands Conv.conv's output (cuDNN's
    channels-last result, permuted back to NHWC) to the eval-BatchNorm
    kernel, which takes only a contiguous tensor."""
    from fabric_tpu_torch.models.blocks import Conv
    for n, h, w, cin, cout in [(4, 96, 96, 13, 64), (4, 12, 12, 256, 512),
                               (4, 6, 6, 512, 512), (3, 1, 1, 64, 64),
                               (2, 24, 24, 1024, 256)]:
        conv = Conv(cin, cout).to(card)
        x = torch.randn(n, h, w, cin, device=card).to(dtype)
        assert conv.conv(x).is_contiguous(), (n, h, w, cin, cout)


@pytest.mark.cuda
def test_bn_relu_refuses_what_it_does_not_take(card):
    x = torch.zeros(1, 4, 4, 8, device=card)
    v = torch.ones(8, device=card)
    with pytest.raises(TypeError):
        bn_relu.bn_relu_inference(x.half(), v, v, v, v)
    with pytest.raises(ValueError, match="contiguous"):
        bn_relu.bn_relu_inference(x.permute(0, 2, 1, 3), v, v, v, v)
    with pytest.raises(ValueError, match="float32"):
        bn_relu.bn_relu_inference(x, v[:4], v, v, v)
    with pytest.raises(RuntimeError, match="no backward"):
        bn_relu.bn_relu_inference(x, v.clone().requires_grad_(), v, v, v)
    with pytest.raises(ValueError, match="multiple of 8"):
        bn_relu.bn_relu_inference(torch.zeros(1, 4, 4, 12, device=card),
                                  *(torch.ones(12, device=card),) * 4)
    with pytest.raises(ValueError, match="one CUDA device"):
        bn_relu.bn_relu_inference(x, v, v.cpu(), v, v)
    with pytest.raises(ValueError, match="one CUDA device"):
        bn_relu.bn_relu_inference(x, v, v, v, v, 1e-5, v.cpu())
    with pytest.raises(ValueError, match="float32"):
        bn_relu.bn_relu_inference(x, v, v, v, v, 1e-5, v.double())
    with pytest.raises(ValueError, match="aligned"):
        bn_relu.bn_relu_inference(
            torch.zeros(8 * 16 + 2, device=card)[2:].view(1, 4, 4, 8),
            v, v, v, v)


def _fuse_case(rng, card, n2, h, w, c):
    return torch.from_numpy(rng.randint(-128, 128, (n2, h, w, c)).astype(
        np.int8)).to(card)


@pytest.mark.cuda
@pytest.mark.parametrize("out,pool", [(torch.int8, True),
                                      (torch.bfloat16, False),
                                      (torch.bfloat16, True),
                                      (torch.float32, True),
                                      (torch.int8, False)])
@pytest.mark.parametrize("n2,h,w,c", FUSE_SHAPES)
def test_siamese_fuse_s8_kernel_matches_plain_exactly(card, n2, h, w, c, out,
                                                      pool):
    """One launch, bit-equal to the plain version (exact products, one
    float32 multiply by the same float32 m, the same rounding), at a scale
    that lands on .5 ties and clips codes at 127 and at one that does
    not."""
    from fabric_tpu_torch.ops import fuse_s8
    rng = np.random.RandomState(n2 * h + w + c)
    a = _fuse_case(rng, card, n2, h, w, c)
    for m in (1.0 / 64, 3.1 * 3.1 / 127 / 5.3):
        before = fuse_s8.siamese_fuse_s8.launches
        f, p = fuse_s8.siamese_fuse_s8(a, m, out, pool)
        torch.cuda.synchronize()
        assert fuse_s8.siamese_fuse_s8.launches == before + 1
        rf, rp = fuse_s8.siamese_fuse_s8_reference(a, m, out, pool)
        assert f.dtype == out and f.shape == (n2 // 2, h, w, c)
        assert torch.equal(f, rf)
        assert (p is None) == (not pool)
        if pool:
            assert p.shape == (n2, h // 2, w // 2, c) and torch.equal(p, rp)


@pytest.mark.cuda
def test_siamese_fuse_s8_refuses_what_it_does_not_take(card):
    from fabric_tpu_torch.ops import fuse_s8
    a = torch.zeros(2, 4, 4, 16, dtype=torch.int8, device=card)
    with pytest.raises(TypeError):
        fuse_s8.siamese_fuse_s8(a.float(), 0.5)
    with pytest.raises(TypeError):
        fuse_s8.siamese_fuse_s8(a, 0.5, torch.float16)
    with pytest.raises(ValueError, match="contiguous"):
        fuse_s8.siamese_fuse_s8(a.permute(0, 2, 1, 3), 0.5)
    with pytest.raises(ValueError, match="multiple of 16"):
        fuse_s8.siamese_fuse_s8(a[..., :8].contiguous(), 0.5)
    with pytest.raises(ValueError, match="2n"):
        fuse_s8.siamese_fuse_s8(a[:1], 0.5)
    with pytest.raises(ValueError, match="aligned"):
        fuse_s8.siamese_fuse_s8(torch.zeros(
            2 * 4 * 4 * 16 + 8, dtype=torch.int8,
            device=card)[8:].view(2, 4, 4, 16), 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_function_gradients_equal_autograd_on_card(card, dtype):
    g = torch.Generator().manual_seed(2)
    a0, b0, go = (torch.randn(4, 24, 24, 64, generator=g).to(card, dtype)
                  for _ in range(3))
    a1, b1 = a0.clone().requires_grad_(), b0.clone().requires_grad_()
    before = fused.fused_mul_relu.launches
    fused.FusedMulRelu.apply(a1, b1).backward(go)
    assert fused.fused_mul_relu.launches == before + 1
    a2, b2 = a0.clone().requires_grad_(), b0.clone().requires_grad_()
    torch.relu(a2 * b2).backward(go)
    assert torch.equal(a1.grad, a2.grad) and torch.equal(b1.grad, b2.grad)


@pytest.mark.cuda
def test_unfolded_serving_agrees_with_folded(card):
    """ScenePredictor(fold_bn=False) (cuDNN convs + the eval-BN kernel)
    against fold_bn=True (the conv kernels) on one bf16 scene: a mask
    pixel may differ only where the fp32 logit margin is within 1/16 of
    the logit scale, on at most 1% of the pixels.  (chip_smoke.py caps the
    share at 0.1%, on a trained checkpoint; random weights at base 16
    leave logits of scale ~0.2 and more near-ties, 0.09% seen, so the
    share is held to 1% here.)"""
    from fabric_tpu_torch import Config
    from fabric_tpu_torch.infer.device_tiling import (_gather_tiles,
                                                      _plan_grid, _stitch)
    from fabric_tpu_torch.infer.service import ScenePredictor
    rng = np.random.RandomState(3)
    d1, d2 = (rng.randn(96, 128, 13).astype(np.float32) for _ in range(2))
    cfg = Config(patch_size=32, eval_batch_size=8, model_base=16)
    folded = ScenePredictor(cfg, bucket=0, device=card).predict(d1, d2)
    before = bn_relu.bn_relu_inference.launches
    unfolded = ScenePredictor(cfg, bucket=0, fold_bn=False,
                              device=card).predict(d1, d2)
    assert bn_relu.bn_relu_inference.launches == before + 18 * 2
    fp32 = ScenePredictor(Config(patch_size=32, model_base=16,
                                 dtype="float32"), bucket=0, fold_bn=False,
                          device=card)
    ys, xs, k, _, _ = _plan_grid(96, 128, 32, 32, 12)
    t1, t2 = (_gather_tiles(torch.from_numpy(d).to(card), ys, xs, 32)
              for d in (d1, d2))
    with torch.inference_mode():
        logits = fp32.model(t1, t2)
    margin = _stitch((logits[..., 1] - logits[..., 0]).abs(), ys, xs, k, 96,
                     128, 32).cpu().numpy()
    flips = folded != unfolded
    print(f"folded vs unfolded: {int(flips.sum())} of {flips.size} pixels "
          f"flipped, largest margin at a flip "
          f"{margin[flips].max() if flips.any() else 0.0:.4g}, logit scale "
          f"{logits.abs().max().item():.4g}")
    assert flips.mean() <= 0.01
    assert (margin[flips] <= logits.abs().max().item() / 16).all()


@pytest.mark.cuda
def test_train_step_on_card_runs_the_fused_kernel(card):
    from fabric_tpu_torch import Config
    from fabric_tpu_torch.losses import get_loss_fn
    from fabric_tpu_torch.models import build_model
    from fabric_tpu_torch.train.state import create_state
    from fabric_tpu_torch.train.steps import make_eval_step, make_train_step
    cfg = Config(model_base=16, patch_size=32, batch_size=4)
    model = build_model(cfg, card, fold_bn=False, train=True)
    state = create_state(cfg, model)
    rng = np.random.RandomState(4)
    batch = {"img1": rng.randn(4, 32, 32, 13),
             "img2": rng.randn(4, 32, 32, 13),
             "label": rng.randint(0, 2, (4, 32, 32)), "weight": np.ones(4)}
    batch = {k: torch.from_numpy(v).to(card, torch.float32 if v.dtype.kind
                                       == "f" else torch.int32)
             for k, v in batch.items()}
    step = make_train_step(model, get_loss_fn(cfg))
    state, stats = step(state, batch)  # first call: one-time set-up
    fused.fused_mul_relu.launches = bn_relu.bn_relu_inference.launches = 0
    torch.cuda.synchronize()
    # a step never waits for the card: no synchronizing operation in it
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state, stats = step(state, batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{w.filename}:{w.lineno}" for w in caught
             if "called a synchronizing" in str(w.message)]
    assert not syncs, syncs
    assert fused.fused_mul_relu.launches == 5 and state.step == 2
    assert bn_relu.bn_relu_inference.launches == 0
    assert torch.isfinite(stats["loss"]).item()
    make_eval_step(model, get_loss_fn(cfg))(state, batch)
    assert bn_relu.bn_relu_inference.launches == 18


S8_CONV_SHAPES = [(1, 7, 7, 13, 64), (3, 5, 9, 13, 70), (2, 4, 4, 512, 256),
                  (5, 8, 8, 256, 64), (1, 1, 1, 32, 8), (2, 64, 64, 64, 64),
                  (1, 33, 300, 48, 24), (9, 16, 16, 128, 128),
                  # many blocks; 2 images of 8x8 per tile, N odd
                  (35, 64, 64, 64, 64), (1001, 8, 8, 40, 24)]
MATMUL_SHAPES = [(1000, 100, 24), (37, 13, 70), (4096, 512, 512),
                 (130, 33, 130), (257, 200, 64), (131, 515, 257)]
# (N, H, W, Cin, Cout, mode) of conv3x3_s8_q: the 18 sites of the int8
# forward (patch 64), N cut, each in the mode the forward runs it in (the
# decoder's split conv1 with Cin per segment), then edges: 1x1, 3x5 and
# 7x9 images, Cin 13 and 1024, Cout 2 and 40, N not a multiple of the
# images per tile
S8Q_SHAPES = [(2, 64, 64, 13, 64, "int8"), (2, 64, 64, 64, 64, "int8"),
              (2, 32, 32, 64, 128, "int8"), (2, 32, 32, 128, 128, "int8"),
              (3, 16, 16, 128, 256, "int8"), (3, 16, 16, 256, 256, "int8"),
              (5, 8, 8, 256, 512, "int8"), (5, 8, 8, 512, 512, "int8"),
              (9, 4, 4, 512, 512, "int8"), (3, 8, 8, 512, 256, "split"),
              (3, 8, 8, 256, 256, "bf16"), (2, 16, 16, 256, 128, "split"),
              (2, 16, 16, 128, 128, "bf16"), (2, 32, 32, 128, 64, "split"),
              (2, 32, 32, 64, 64, "bf16"), (2, 64, 64, 64, 64, "split"),
              (3, 1, 1, 16, 64, "int8"), (5, 3, 5, 13, 40, "bf16"),
              (3, 7, 9, 1024, 2, "int8"), (11, 4, 4, 40, 40, "split"),
              (9, 8, 8, 64, 200, "bf16"), (3, 7, 9, 13, 2, "split"),
              # many blocks; 2 images of 8x8 per tile, N odd
              (64, 64, 64, 13, 64, "int8"), (48, 32, 32, 64, 128, "bf16"),
              (1001, 8, 8, 40, 24, "int8")]


def _s8(rng, *shape):
    return torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8))


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout", S8_CONV_SHAPES)
def test_conv_s8_kernel_matches_plain_exactly(card, n, h, w, cin, cout):
    """int32 sums of int8 products are exact on both sides: bit-equal."""
    from fabric_tpu_torch.ops import conv_s8
    rng = np.random.RandomState(n * h + w)
    x, wq = _s8(rng, n, h, w, cin).to(card), _s8(rng, 3, 3, cin, cout).to(card)
    before = conv_s8.conv3x3_s8.launches
    got = conv_s8.conv3x3_s8(x, wq)
    torch.cuda.synchronize()
    assert conv_s8.conv3x3_s8.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (n, h, w, cout)
    assert torch.equal(got, conv_s8.conv3x3_s8_reference(x, wq))
    packed = conv_s8.pack_weight(wq)  # the prepacked call gives the same
    assert torch.equal(conv_s8.conv3x3_s8(x, wq, packed), got)


def _s8q_case(rng, card, n, h, w, cin, cout, mode):
    """Inputs of one conv3x3_s8_q launch: int8 tensors, scale vectors that
    put the sums at a few units (the split form's two halves at unequal
    scales), a bias, and an output scale that clips some values."""
    def scale(c, f):
        return torch.from_numpy(((rng.rand(cout) + 0.5) * f / (
            np.sqrt(9 * c) * 5400)).astype(np.float32)).to(card)
    x, wq = _s8(rng, n, h, w, cin).to(card), _s8(rng, 3, 3, cin, cout).to(card)
    k = scale(cin, 2.0)
    bias = torch.from_numpy(rng.randn(cout).astype(np.float32)).to(card)
    up = None
    if mode == "split":
        x2 = _s8(rng, n, h, w, cin).to(card)
        w2 = _s8(rng, 3, 3, cin, cout).to(card)
        up = (x2, w2, scale(cin, 0.7), None)
    s_out = None if mode == "bf16" else 3.0 / 127
    return x, wq, k, bias, s_out, up


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout,mode", S8Q_SHAPES)
def test_conv_s8_q_kernel_matches_plain(card, n, h, w, cin, cout, mode):
    """The fused int8 conv site in the mode the forward runs it in against
    its plain version (the exact conv, then the epilogue in PyTorch):
    identical."""
    from fabric_tpu_torch.ops import conv_s8
    rng = np.random.RandomState(n * h + w + cin)
    x, wq, k, bias, s_out, up = _s8q_case(rng, card, n, h, w, cin, cout, mode)
    before = conv_s8.conv3x3_s8_q.launches
    got = conv_s8.conv3x3_s8_q(x, wq, k, bias, s_out, None, up)
    torch.cuda.synchronize()
    assert conv_s8.conv3x3_s8_q.launches == before + 1
    assert got.shape == (n, h, w, cout)
    assert got.dtype == (torch.bfloat16 if mode == "bf16" else torch.int8)
    ref = conv_s8.conv3x3_s8_q_reference(x, wq, k, bias, s_out, up)
    assert torch.equal(got, ref)
    if mode != "bf16" and got.numel() >= 4096:  # codes across the range
        assert 0 < int((got == 127).sum()) < got.numel()
    packed = conv_s8.pack_weight(wq)  # the prepacked call gives the same
    if up is not None:
        up = (*up[:3], conv_s8.pack_weight(up[1]))
    assert torch.equal(conv_s8.conv3x3_s8_q(x, wq, k, bias, s_out, packed,
                                            up), got)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
def test_int8_matmul_kernel_matches_plain(card, m, k, n):
    """int8: bit-equal.  bf16: the products are exact in float32 and each
    side's float32 sum over k terms is within (k - 1) 2^-24 sum|a b| of the
    exact one; the tensor cores may truncate where IEEE rounds, so each
    element is held to k 2^-22 (|a| @ |b|)."""
    from fabric_tpu_torch.ops import int8_matmul as im
    rng = np.random.RandomState(m + k + n)
    a, b = _s8(rng, m, k).to(card), _s8(rng, k, n).to(card)
    before = im.int8_matmul.launches
    got = im.int8_matmul(a, b)
    torch.cuda.synchronize()
    assert im.int8_matmul.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, im.int8_matmul_reference(a, b))
    af = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(card)
    bf = torch.from_numpy(rng.randn(k, n).astype(np.float32)).to(card)
    af, bf = af.to(torch.bfloat16), bf.to(torch.bfloat16)
    got = im.int8_matmul(af, bf)
    ref = im.int8_matmul_reference(af, bf)
    assert got.dtype == torch.float32
    tol = k * 2.0 ** -22 * (af.float().abs() @ bf.float().abs())
    assert ((got - ref).abs() <= tol).all()


@pytest.mark.cuda
def test_int8_kernels_refuse_what_they_do_not_take(card):
    from fabric_tpu_torch.ops import conv_s8
    from fabric_tpu_torch.ops import int8_matmul as im
    a = torch.zeros(64, 32, dtype=torch.int8, device=card)
    b = torch.zeros(32, 16, dtype=torch.int8, device=card)
    with pytest.raises(ValueError, match="CUDA device"):
        im.int8_matmul(a, b.cpu())
    with pytest.raises(TypeError):
        im.int8_matmul(a.float(), b.float())
    with pytest.raises(TypeError):
        im.int8_matmul(a, b.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        im.int8_matmul(a, b.t().contiguous().t())
    x = torch.zeros(1, 8, 8, 16, dtype=torch.int8, device=card)
    wq = torch.zeros(3, 3, 16, 8, dtype=torch.int8, device=card)
    with pytest.raises(ValueError, match="one device"):
        conv_s8.conv3x3_s8(x, wq.cpu())
    with pytest.raises(TypeError):
        conv_s8.conv3x3_s8(x.float(), wq)
    with pytest.raises(ValueError, match="contiguous"):
        conv_s8.conv3x3_s8(x.permute(0, 2, 1, 3), wq)
    with pytest.raises(ValueError, match="packed"):
        conv_s8.conv3x3_s8(x, wq, conv_s8.pack_weight(wq)[:-16])
    with pytest.raises(ValueError, match="packed"):
        conv_s8.conv3x3_s8(x, wq, conv_s8.pack_weight(wq).view(9, -1))
    k = torch.ones(8, device=card)
    with pytest.raises(ValueError, match="packed"):
        conv_s8.conv3x3_s8_q(x, wq, k, k, 0.1, conv_s8.pack_weight(wq)[16:])
    with pytest.raises(ValueError, match="scale"):
        conv_s8.conv3x3_s8_q(x, wq, torch.ones(7, device=card), k, 0.1)
    with pytest.raises(ValueError, match="bias"):
        conv_s8.conv3x3_s8_q(x, wq, k, k.double(), 0.1)
    with pytest.raises(ValueError, match="scale"):
        conv_s8.conv3x3_s8_q(x, wq, k.cpu(), k, 0.1)
    with pytest.raises(ValueError, match="one device"):
        conv_s8.conv3x3_s8_q(x, wq.cpu(), k, k, 0.1)
    with pytest.raises(TypeError):  # bf16 and float32 only
        conv_s8.conv3x3_s8_q(x, wq, k, k, 0.1, dtype=torch.float16)
    with pytest.raises(ValueError, match="s_out"):
        conv_s8.conv3x3_s8_q(x, wq, k, k, None, None, (x, wq, k, None))
    with pytest.raises(ValueError, match="one device"):
        conv_s8.conv3x3_s8_q(x, wq, k, k, 0.1, None, (x, wq.cpu(), k, None))
    with pytest.raises(ValueError, match="up segment"):
        conv_s8.conv3x3_s8_q(x, wq, k, k, 0.1, None,
                             (x, wq, torch.ones(9, device=card), None))
    with pytest.raises(ValueError, match="second segment"):
        conv_s8.conv3x3_s8_q(x, wq, k, k, 0.1, None, (x[:, :4], wq, k, None))


@pytest.mark.cuda
def test_int8_serving_equals_its_plain_forward_on_card(card):
    """ScenePredictor(quant="int8") on the card: 18 fused conv3x3_s8_q
    launches per forward (no raw one), and a mask identical to the same
    int8 forward (same scales) on the plain versions of the conv sites,
    which leaves nothing else to differ."""
    from fabric_tpu_torch import Config
    from fabric_tpu_torch.infer.device_tiling import make_scene_infer
    from fabric_tpu_torch.infer.service import ScenePredictor
    from fabric_tpu_torch.ops import conv_s8, fuse_s8
    rng = np.random.RandomState(5)
    d1, d2 = (rng.randn(96, 128, 13).astype(np.float32) for _ in range(2))
    cfg = Config(patch_size=32, eval_batch_size=12, model_base=16)
    pred = ScenePredictor(cfg, bucket=0, device=card, quant="int8")
    pred.predict(d1, d2)  # calibrates
    counters = (conv_s8.conv3x3_s8_q, conv_s8.conv3x3_s8,
                fuse_s8.siamese_fuse_s8)
    before = [fn.launches for fn in counters]
    mask = pred.predict(d1, d2)
    # 12 tiles, 1 chunk
    assert [fn.launches - b for fn, b in zip(counters, before)] == [18, 0, 5]
    kernel, fusion = conv_s8.conv3x3_s8_q, fuse_s8.siamese_fuse_s8
    conv_s8.conv3x3_s8_q = lambda x, wq, k, b, s_out=None, packed=None, \
        up=None, dtype=torch.bfloat16: conv_s8.conv3x3_s8_q_reference(
            x, wq, k, b, s_out, up, dtype)
    fuse_s8.siamese_fuse_s8 = fuse_s8.siamese_fuse_s8_reference
    try:
        plain = make_scene_infer(pred._forward, 32, (96, 128),
                                 batch_size=12)(
            *(torch.from_numpy(d).to(card) for d in (d1, d2)))
    finally:
        conv_s8.conv3x3_s8_q, fuse_s8.siamese_fuse_s8 = kernel, fusion
    np.testing.assert_array_equal(mask, plain.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,h,w,cin,cout", [(4, 5, 16, 16, 13, 32),
                                              (2, 5, 8, 8, 96, 64),
                                              (3, 3, 4, 4, 256, 256),
                                              (1, 1, 7, 9, 8, 16)])
def test_t_neighbour_int8_conv_matches_plain(card, n, t, h, w, cin, cout):
    """UNet3D's int8 3x3x3 site: one conv3x3_s8_q launch over the
    T-neighbour stack by the depth-folded kernel, against its plain
    version (int8 out and raw int32): identical, and the raw sums equal
    the float64 3-D conv."""
    from fabric_tpu_torch.ops import conv_s8
    rng = np.random.RandomState(n + t + cin)
    x = _s8(rng, n, t, h, w, cin).to(card)
    wq = conv_s8.fold_depth(_s8(rng, 3, 3, 3, cin, cout)).to(card)
    xs = conv_s8.t_neighbours(x)
    assert xs.shape == (n * t, h, w, 3 * cin)
    k = torch.from_numpy(((rng.rand(cout) + 0.5) / (
        np.sqrt(27 * cin) * 2700)).astype(np.float32)).to(card)
    bias = torch.from_numpy(rng.randn(cout).astype(np.float32)).to(card)
    got = conv_s8.conv3x3_s8_q(xs, wq, k, bias, 3.0 / 127)
    assert torch.equal(got, conv_s8.conv3x3_s8_q_reference(
        xs, wq, k, bias, 3.0 / 127))
    raw = conv_s8.conv3x3_s8(xs, wq)
    torch.cuda.synchronize()
    w5 = wq.reshape(3, 3, 3, cin, cout).permute(2, 0, 1, 3, 4)
    with torch.backends.cudnn.flags(enabled=False):
        want = torch.nn.functional.conv3d(
            x.double().permute(0, 4, 1, 2, 3),
            w5.double().permute(4, 3, 0, 1, 2), padding=1)
    assert torch.equal(raw.reshape(n, t, h, w, cout),
                       want.permute(0, 2, 3, 4, 1).to(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("model,quant", [("bidate", None),
                                         ("bidate", "int8"),
                                         ("unet_lstm", None),
                                         ("unet3d", "int8")])
def test_packed_equals_per_scene_on_card(card, model, quant):
    """Fleet packing on the card: each scene's mask equals its own
    predict's, bit for bit, though the chunks mix the scenes' tiles (every
    kernel computes each image on its own) and the last pack has a zero
    scene; 4 tiles a scene in chunks of 12."""
    from fabric_tpu_torch import Config
    from fabric_tpu_torch.infer.service import ScenePredictor
    cfg = Config(model=model, patch_size=32, eval_batch_size=12,
                 model_base=16, num_dates=3)
    pred = ScenePredictor(cfg, bucket=64, device=card, quant=quant)
    rng = np.random.RandomState(7)
    shape = (3,) if model != "bidate" else (2,)
    scenes = [rng.randn(*shape, 64, 60, 13).astype(np.float32)
              for _ in range(5)]
    if model == "bidate":
        seq = [pred.predict(*s) for s in scenes]
        packed = pred.predict_many([tuple(s) for s in scenes], pack="auto")
    else:
        seq = [pred.predict_multidate(s) for s in scenes]
        packed = pred.predict_many_multidate(scenes, pack="auto")
    for a, b in zip(packed, seq, strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape", [
    ("conv", (1280, 64, 64, 13, 64)),            # UNetLSTM inc.conv1
    ("conv", (1280, 32, 32, 64, 128)),           # down1.conv1
    ("double", (1280, 16, 16, 128, 256, 256)),   # down2
    ("double", (1280, 4, 4, 512, 512, 512)),     # down4
    ("s8", (1280, 64, 64, 39, 32)),              # UNet3D inc.conv1, stacked
])
def test_conv_kernels_at_the_multidate_encoder_batch(card, kind, shape):
    """The multi-date encoders run at batch N*T: at 256 tiles and T = 5,
    1280 images of 64^2 a launch (671 MB a bf16 activation at 64
    channels), so the kernels' offsets and grids are held against their
    plain versions at that batch."""
    if kind == "conv":
        test_conv_kernel_matches_plain(card, *shape)
    elif kind == "double":
        test_double_conv_kernel_matches_plain(card, shape)
    else:
        test_conv_s8_kernel_matches_plain_exactly(card, *shape)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["unet_lstm", "unet3d"])
def test_unfolded_multidate_serving_agrees_with_folded(card, model):
    """The multi-date eval forward with BatchNorm unfolded (cuDNN convs,
    the eval-BN kernel after each, UNet3D's 3-D blocks over the (N*T, H,
    W, C) view: 18 launches a forward in both families) against the
    folded one (the conv kernels), by the bi-date test's rule above."""
    from fabric_tpu_torch import Config
    from fabric_tpu_torch.infer import device_tiling as tdt
    from fabric_tpu_torch.infer.service import ScenePredictor
    stack = np.random.RandomState(4).randn(3, 64, 96, 13).astype(np.float32)
    cfg = Config(model=model, patch_size=32, eval_batch_size=8,
                 model_base=16, num_dates=3)
    folded = ScenePredictor(cfg, bucket=0, device=card).predict_multidate(
        stack)
    before = bn_relu.bn_relu_inference.launches
    unfolded = ScenePredictor(cfg, bucket=0, fold_bn=False,
                              device=card).predict_multidate(stack)
    assert bn_relu.bn_relu_inference.launches == before + 18
    fp32 = ScenePredictor(Config(model=model, patch_size=32, model_base=16,
                                 num_dates=3, dtype="float32"), bucket=0,
                          fold_bn=False, device=card)
    ys, xs, k, _, _ = tdt._plan_grid(64, 96, 32, 32, 8)
    tiles = tdt._multidate_tiles(torch.from_numpy(stack).to(card), ys, xs,
                                 32)
    with torch.inference_mode():
        logits = fp32.model(tiles)
    margin = tdt._stitch((logits[..., 1] - logits[..., 0]).abs(), ys, xs, k,
                         64, 96, 32).cpu().numpy()
    flips = folded != unfolded
    assert flips.mean() <= 0.01
    assert (margin[flips] <= logits.abs().max().item() / 16).all()


# --- seamless fullconv: the kernels at band shapes, banding on the card ---

# (N, H, W, Cin, Cout) of conv3x3_bias_relu in a bi-date band forward
# (band 512 + 2 x 128 halo = 768 context rows of a 2048-wide scene): inc,
# down4 and up4 convs, the band_batch 4 stack's inc, the widest band's
BAND_CONV_SHAPES = [(2, 768, 2048, 13, 64), (2, 768, 2048, 64, 64),
                    (2, 48, 128, 512, 512), (1, 768, 2048, 128, 64),
                    (8, 768, 2048, 13, 64), (2, 768, 8192, 64, 64)]
BAND_FUSED_SHAPES = [(1, 768, 2048, 64), (4, 768, 2048, 64),
                     (1, 768, 8192, 64), (1, 48, 128, 512)]
# conv3x3_s8_q at the int8 band forward's sites in their modes
BAND_S8Q_SHAPES = [(2, 768, 2048, 13, 64, "int8"),
                   (1, 768, 2048, 64, 64, "split"),
                   (1, 768, 2048, 64, 64, "bf16"),
                   (2, 48, 128, 512, 512, "int8"),
                   (8, 768, 2048, 13, 64, "int8")]
BAND_FUSE_SHAPES = [(2, 768, 2048, 64), (8, 768, 2048, 64),
                    (2, 48, 128, 512)]


def _randn(card, *shape, scale=1.0):
    g = torch.Generator(card).manual_seed(sum(shape))
    return torch.randn(*shape, generator=g, device=card) * scale


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout", BAND_CONV_SHAPES)
def test_conv_kernel_at_band_shapes(card, n, h, w, cin, cout):
    """Whole-scene-wide images, batch 1-8 (TW 128, TR 1: up to 98304 M
    chunks a launch): one ulp of the largest output, as at tile shapes."""
    x = _randn(card, n, h, w, cin).to(torch.bfloat16)
    k = _randn(card, 3, 3, cin, cout, scale=(9 * cin) ** -.5)
    b = _randn(card, cout, scale=0.1)
    got = conv.conv3x3_bias_relu(x, k, b)
    torch.cuda.synchronize()
    ref = conv.conv3x3_bias_relu_reference(x, k, b)
    assert (got.float() - ref.float()).abs().max().item() <= _ulp_bound(ref, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BAND_FUSED_SHAPES)
def test_fused_kernel_at_band_shapes(card, shape):
    a, b = (_randn(card, *shape).to(torch.bfloat16) for _ in range(2))
    got = fused.fused_mul_relu(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, fused.fused_mul_relu_reference(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout,mode", BAND_S8Q_SHAPES)
def test_conv_s8_q_kernel_at_band_shapes(card, n, h, w, cin, cout, mode):
    test_conv_s8_q_kernel_matches_plain(card, n, h, w, cin, cout, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("n2,h,w,c", BAND_FUSE_SHAPES)
def test_siamese_fuse_s8_kernel_at_band_shapes(card, n2, h, w, c):
    from fabric_tpu_torch.ops import fuse_s8
    g = torch.Generator(card).manual_seed(n2 + h)
    a = torch.randint(-127, 128, (n2, h, w, c), generator=g, device=card,
                      dtype=torch.int8)
    for out, pool in ((torch.int8, True), (torch.bfloat16, False)):
        f, p = fuse_s8.siamese_fuse_s8(a, (3.1 / 127) ** 2 / (5.3 / 127),
                                       out, pool)
        torch.cuda.synchronize()
        rf, rp = fuse_s8.siamese_fuse_s8_reference(
            a, (3.1 / 127) ** 2 / (5.3 / 127), out, pool)
        assert torch.equal(f, rf)
        assert (p is None) == (not pool) and (not pool or torch.equal(p, rp))


@pytest.mark.cuda
@pytest.mark.parametrize("model,quant", [("bidate", "none"),
                                         ("bidate", "int8"),
                                         ("unet_lstm", "none"),
                                         ("unet_lstm", "int8"),
                                         ("unet3d", "none")])
def test_fullconv_banded_equals_whole_on_card(card, model, quant):
    """On the card (kernels, cuBLAS and the fixed-order multi-date
    reductions), the banded mask equals one whole-scene forward's, bit for
    bit, band_batch 3 equals 1 (bi-date), and the streamed predictor from
    host arrays equals the in-device one; base 16, a 600 x 200 scene in
    the 608 x 208 bucket, band 160 (3 bands and a tail)."""
    _fullconv_banded_equals_whole(card, model, quant, "bfloat16")


def _fullconv_banded_equals_whole(card, model, quant, dtype):
    from fabric_tpu_torch import Config
    from fabric_tpu_torch.infer import fullconv
    from fabric_tpu_torch.infer.service import ScenePredictor
    cfg = Config(model=model, model_base=16, num_dates=3, dtype=dtype)
    kw = dict(bucket=16, device=card, quant=quant, fullconv_band_rows=160)
    pred = ScenePredictor(cfg, **kw)
    pred_s = ScenePredictor(cfg, fullconv_stream=True, **kw)
    rng = np.random.RandomState(9)
    scenes = rng.randn(2 if model == "bidate" else 3, 600, 200,
                       13).astype(np.float32)
    x = torch.from_numpy(np.pad(scenes, [(0, 0), (0, 8), (0, 8), (0, 0)],
                                mode="edge")).to(card)
    if model == "bidate":
        mask = pred.predict(*scenes)
        streamed = pred_s.predict(*scenes)
        whole = fullconv.make_fullconv_scene_infer(
            pred._forward, (608, 208), band_rows=1024, dtype=pred.dtype)(*x)
        batched = fullconv.make_fullconv_scene_infer(
            pred._forward, (608, 208), band_rows=160, dtype=pred.dtype,
            band_batch=3)(*x)
        np.testing.assert_array_equal(batched.cpu().numpy()[:600, :200],
                                      mask)
    else:
        mask = pred.predict_multidate(scenes)
        streamed = pred_s.predict_multidate(scenes)
        whole = fullconv.make_fullconv_scene_infer_multidate(
            pred._forward, (608, 208), 3, band_rows=1024, dtype=pred.dtype)(x)
    np.testing.assert_array_equal(whole.cpu().numpy()[:600, :200], mask)
    np.testing.assert_array_equal(streamed, mask)


@pytest.mark.cuda
def test_signed_gate_conv_is_crop_exact(card):
    """The fullconv UNetLSTM's gate conv (bf16, 512 + 512 -> 2048
    channels, base 64): the signed launch of the conv kernel gives a
    crop's interior exactly the whole image's values (cuDNN's conv does
    not at these shapes), and equals cuDNN's within one bf16 rounding."""
    from fabric_tpu_torch.models.blocks import Conv
    from fabric_tpu_torch.models.unet_lstm import signed_conv
    x = _randn(card, 1, 64, 128, 1024).to(torch.bfloat16)
    k = _randn(card, 3, 3, 1024, 2048, scale=96 ** -1)
    b = _randn(card, 2048)
    kk, bb = torch.cat([k, -k], -1), torch.cat([b, -b])
    whole = signed_conv(x, kk, bb)
    crop = signed_conv(x[:, 8:48].contiguous(), kk, bb)
    assert torch.equal(whole[:, 9:47], crop[:, 1:39])
    cudnn = Conv(1024, 2048).to(card)
    cudnn.kernel.data, cudnn.bias.data = k, b
    assert (whole.float() - cudnn(x).float()).abs().max().item() \
        <= _ulp_bound(whole, 2)


# --- multi-date training on the card ---

def _multidate_step(model_name, dev, variables, batch, local_upsample=False,
                    dtype="float32"):
    """One tversky + SGD step of a multi-date model at base 8 on ``dev``;
    returns (loss, (params, batch_stats), state)."""
    from fabric_tpu_torch import Config
    from fabric_tpu_torch.losses import get_loss_fn
    from fabric_tpu_torch.models import build_model
    from fabric_tpu_torch.train.state import create_state
    from fabric_tpu_torch.train.steps import make_train_step
    cfg = Config(model=model_name, model_base=8, num_dates=3, batch_size=4,
                 patch_size=32, dtype=dtype, learning_rate=0.05,
                 local_upsample=local_upsample)
    model = build_model(cfg, dev, fold_bn=False, variables=variables,
                        train=True)
    state = create_state(cfg, model)
    _, stats = make_train_step(model, get_loss_fn(cfg))(
        state, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
    return stats["loss"].item(), state.variables(), state


def _multidate_case(model_name, seed=0):
    from fabric_tpu_torch.weights import init_variables
    variables = init_variables(13, 2, 8, torch.Generator().manual_seed(seed),
                               model_name)
    rng = np.random.RandomState(seed)
    imgs = rng.randn(4, 3, 32, 32, 13).astype(np.float32)
    label = (rng.rand(4, 32, 32) < 0.3).astype(np.int32)
    imgs[:, -1][label == 1] += 1.5
    return variables, {"imgs": imgs, "label": label,
                       "weight": np.ones(4, np.float32)}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.cuda
@pytest.mark.parametrize("model_name", ["unet_lstm", "unet3d"])
def test_multidate_train_step_card_matches_cpu(card, model_name):
    """One fp32 train step (TF32 off) on the card and on the CPU from the
    same weights and batch (base 8, T = 3, batch 4, patch 32).  cuDNN sums
    the convolutions, forward and backward, in another order than the
    CPU, and train-mode BatchNorm's E[x^2] - E[x]^2 keeps fewer bits than
    the loss: the loss within 1e-5 relative, every parameter within 1e-2
    of the largest update, the running statistics within 1e-3 relative
    (1e-3 floor), as chip_smoke.py holds BiDateNet's step."""
    variables, batch = _multidate_case(model_name)
    l_gpu, (p_gpu, s_gpu), _ = _multidate_step(model_name, card, variables,
                                               batch)
    l_cpu, (p_cpu, s_cpu), _ = _multidate_step(model_name, "cpu", variables,
                                               batch)
    p0 = dict(_leaves(variables[0]))
    pc, pg = dict(_leaves(p_cpu)), dict(_leaves(p_gpu))
    sc, sg = dict(_leaves(s_cpu)), dict(_leaves(s_gpu))
    step_max = max(np.abs(pc[k] - p0[k]).max() for k in pc)
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    assert max(np.abs(pg[k] - pc[k]).max() for k in pc) <= 1e-2 * step_max
    assert max((np.abs(sg[k] - sc[k]) / (np.abs(sc[k]) + 1e-3)).max()
               for k in sc) <= 1e-3


@pytest.mark.cuda
def test_signed_gate_cache_follows_the_optimizer_on_card(card):
    """A bf16 UNetLSTM with local_upsample on the card: its eval forward
    runs the gate conv as one signed row-1 launch a date, from packed
    weights cached on the gate tensors' version.  After a train step
    (F.conv2d gates, cuDNN) updates them in place, the cache holds the new
    [K, -K] and the eval forward equals a fresh model's on the new
    variables, bit for bit.  In fp32 the same, on the fp32 conv kernel
    (its own launch counter)."""
    from fabric_tpu_torch import Config
    from fabric_tpu_torch.models import build_model
    variables, batch = _multidate_case("unet_lstm", seed=1)
    x = torch.from_numpy(batch["imgs"]).to(card)
    for dtype, counter in (("bfloat16", "launches"),
                           ("float32", "launches_f32")):
        _, _, state = _multidate_step("unet_lstm", card, variables, batch,
                                      local_upsample=True, dtype=dtype)
        model, cell = state.model, state.model.bottleneck_lstm
        before = getattr(conv.conv3x3_bias_relu, counter)
        with torch.no_grad():
            got = model(x)
        assert getattr(conv.conv3x3_bias_relu, counter) == before + 3  # T=3
        kk, _, packed = cell.signed_gates(model.dtype)
        assert torch.equal(kk, torch.cat([cell.gates.kernel,
                                          -cell.gates.kernel], -1))
        assert packed is not None
        fresh = build_model(Config(model="unet_lstm", model_base=8,
                                   num_dates=3, dtype=dtype,
                                   local_upsample=True),
                            card, fold_bn=False,
                            variables=state.variables(), train=True)
        with torch.no_grad():
            assert torch.equal(got, fresh(x))


@pytest.mark.cuda
def test_loader_dev_shm_check_raises_before_it_allocates(card, tmp_path,
                                                        monkeypatch):
    """A pinned multi-date ring for the card (7 workers, prefetch 1: 9
    slots of 128 x 3 x 96^2 x 13 floats) that /dev/shm cannot hold:
    BatchLoader raises naming the byte counts before it allocates the
    ring (no shared block is made)."""
    from collections import namedtuple
    from fabric_tpu_torch import Config
    from fabric_tpu_torch.data import loader, oscd
    from fabric_tpu_torch.data.synthetic import generate_synthetic_dataset
    generate_synthetic_dataset(str(tmp_path), Config(), cities=["a"],
                               sizes=[(64, 64)], num_dates=3)
    dataset = oscd.full_load(str(tmp_path), Config(num_dates=3))
    md, _ = oscd.metadata_from_dataset(dataset, [], 32, 32)
    shared = loader.share_dataset(dataset)
    need = loader.ring_bytes(7, 1, 128, 96, 3, 13, True)
    usage = namedtuple("usage", "total used free")
    monkeypatch.setattr(loader.shutil, "disk_usage",
                        lambda path: usage(need, 1, need // 2))
    made = []
    monkeypatch.setattr(loader.torch, "empty",
                        lambda *a, **k: made.append(a))
    with pytest.raises(RuntimeError, match=f"9 slots .* needs {need} bytes"):
        loader.BatchLoader(shared, md, 96, True, 128, shuffle=True,
                           num_workers=7, prefetch=1, device=card,
                           multi_date=True)
    assert made == []


# ---- float32 serving: the fp32 forms of rows 1, 2 and 5b ----

F32_DOUBLE_SHAPES = [  # where ops/double_conv.plan_f32 admits a block
    (9, 4, 4, 512, 512, 512), (3, 8, 8, 1024, 256, 256),  # down4, up1
    (2, 8, 8, 16, 32, 32), (1, 6, 6, 4, 4, 4), (5, 1, 1, 16, 32, 2),
    (7, 3, 5, 13, 40, 40), (6, 4, 4, 13, 64, 2), (3, 11, 11, 24, 70, 36)]
F32_S8Q_SHAPES = [(n, h, w, cin, cout, mode) for n, h, w, cin, cout, mode
                  in S8Q_SHAPES if n < 1000]


def _f32_close(got: torch.Tensor, ref: torch.Tensor) -> None:
    """The fp32 forms against their plain versions (fp32 sums in another
    order, TF32 off on both sides): relative L2 <= 1e-5 and max |diff| <=
    1e-4 of the largest output."""
    d = (got - ref).double()
    scale = ref.double().abs().max().item()
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert d.norm().item() <= 1e-5 * max(ref.double().norm().item(), 1e-30)
    assert d.abs().max().item() <= 1e-4 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout", CONV_SHAPES)
def test_conv_f32_kernel_matches_plain(card, n, h, w, cin, cout):
    x, k, b = (torch.from_numpy(a).to(card)
               for a in _conv_case(0, n, h, w, cin, cout))
    before = conv.conv3x3_bias_relu.launches_f32
    got = conv.conv3x3_bias_relu(x, k, b)
    torch.cuda.synchronize()
    assert conv.conv3x3_bias_relu.launches_f32 == before + 1
    _f32_close(got, conv.conv3x3_bias_relu_reference(x, k, b))
    assert torch.equal(conv.conv3x3_bias_relu(
        x, k, b, conv.pack_weight(k, torch.float32)), got)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", F32_DOUBLE_SHAPES)
def test_double_conv_f32_kernel_matches_plain(card, shape):
    """Within the fp32 bounds of the plain version, and bit-equal to two
    fp32 conv launches: each sum runs in the conv kernel's order and the
    intermediate stays fp32."""
    n, h, w, cin, cmid, cout = shape
    assert double_conv.fits(h, w, cin, cmid, cout, torch.float32)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(n, h, w, cin, generator=g).to(card)
    w1 = (torch.randn(3, 3, cin, cmid, generator=g) / (9 * cin) ** .5)
    w2 = (torch.randn(3, 3, cmid, cout, generator=g) / (9 * cmid) ** .5)
    b1, b2 = torch.randn(cmid, generator=g), torch.randn(cout, generator=g)
    w1, b1, w2, b2 = (t.to(card) for t in (w1, b1, w2, b2))
    before = double_conv.double_conv3x3_bias_relu.launches_f32
    got = double_conv.double_conv3x3_bias_relu(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert double_conv.double_conv3x3_bias_relu.launches_f32 == before + 1
    _f32_close(got, double_conv.double_conv3x3_bias_relu_reference(
        x, w1, b1, w2, b2))
    two = conv.conv3x3_bias_relu(conv.conv3x3_bias_relu(x, w1, b1), w2, b2)
    assert torch.equal(got, two)


@pytest.mark.cuda
def test_f32_double_conv_refuses_what_does_not_fit(card):
    big = torch.zeros(1, 16, 16, 64, device=card)
    k, b = torch.zeros(3, 3, 64, 64, device=card), torch.zeros(64,
                                                               device=card)
    assert not double_conv.fits(16, 16, 64, 64, 64, torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        double_conv.double_conv3x3_bias_relu(big, k, b, k, b)
    with pytest.raises(TypeError):
        double_conv.double_conv3x3_bias_relu(big.double(), k, b, k, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout,mode", F32_S8Q_SHAPES)
def test_conv_s8_q_f32_kernel_matches_plain(card, n, h, w, cin, cout, mode):
    """The int8 conv site's float32 epilogue (h = relu(fma(acc, k, b)) with
    no bf16 step, float32 out or int8 from that h): identical to its plain
    version at float32."""
    from fabric_tpu_torch.ops import conv_s8
    rng = np.random.RandomState(n * h + w + cin)
    x, wq, k, bias, s_out, up = _s8q_case(rng, card, n, h, w, cin, cout, mode)
    before = conv_s8.conv3x3_s8_q.launches_f32, conv_s8.conv3x3_s8_q.launches
    got = conv_s8.conv3x3_s8_q(x, wq, k, bias, s_out, None, up,
                               torch.float32)
    torch.cuda.synchronize()
    assert (conv_s8.conv3x3_s8_q.launches_f32,
            conv_s8.conv3x3_s8_q.launches) == (before[0] + 1, before[1])
    assert got.dtype == (torch.float32 if mode == "bf16" else torch.int8)
    ref = conv_s8.conv3x3_s8_q_reference(x, wq, k, bias, s_out, up,
                                         torch.float32)
    assert torch.equal(got, ref)
    assert torch.equal(conv_s8.conv3x3_s8_q(
        x, wq, k, bias, s_out, conv_s8.pack_weight(wq), up, torch.float32),
        got)


def _f32_counts() -> dict:
    """The launches so far of the conv kernels' fp32 forms and of their
    bf16 forms (rows 1, 2, 5b each)."""
    from fabric_tpu_torch.ops import conv_s8
    fns = (conv.conv3x3_bias_relu, double_conv.double_conv3x3_bias_relu,
           conv_s8.conv3x3_s8_q)
    return {"f32": [fn.launches_f32 for fn in fns],
            "bf16": [fn.launches for fn in fns]}


@pytest.mark.cuda
@pytest.mark.parametrize("model,quant", [("bidate", None), ("bidate", "int8"),
                                         ("unet_lstm", None),
                                         ("unet_lstm", "int8"),
                                         ("unet3d", None), ("unet3d", "int8")])
def test_f32_folded_serving_on_card(card, model, quant):
    """ScenePredictor(Config(dtype="float32")) serves folded on the card
    through the fp32 kernels alone (no bf16 launch), with a mask that flips
    against the same forward on the plain versions only where the plain
    fp32 logit margin is within 1e-4 of the logit scale (exact); int8: the
    same scales, identical to the plain int8 forward."""
    from fabric_tpu_torch import Config
    from fabric_tpu_torch.infer.device_tiling import (
        make_scene_infer, make_scene_infer_multidate)
    from fabric_tpu_torch.infer.service import ScenePredictor
    from fabric_tpu_torch.ops import conv_s8
    cfg = Config(model=model, patch_size=32, eval_batch_size=12,
                 model_base=16, num_dates=3, dtype="float32")
    pred = ScenePredictor(cfg, bucket=0, device=card, quant=quant)
    rng = np.random.RandomState(5)
    scenes = rng.randn(2 if model == "bidate" else 3, 96, 128,
                       13).astype(np.float32)
    serve = (lambda: pred.predict(*scenes)) if model == "bidate" else (
        lambda: pred.predict_multidate(scenes))
    serve()  # int8: calibrates
    before = _f32_counts()
    mask = serve()
    launched = {k: [n - b for n, b in zip(v, before[k])]
                for k, v in _f32_counts().items()}
    assert launched["bf16"] == [0, 0, 0], launched
    assert (launched["f32"][2] > 0) == (quant == "int8"), launched
    # int8: the clip probe's calibration forward runs the fp32 convs too
    assert sum(launched["f32"][:2]) > 0, launched
    x = torch.from_numpy(scenes).to(card)

    def infer(fwd):
        if model == "bidate":
            return make_scene_infer(fwd, 32, (96, 128), batch_size=12,
                                    dtype=torch.float32)(*x)
        return make_scene_infer_multidate(fwd, 32, (96, 128), 3,
                                          batch_size=12,
                                          dtype=torch.float32)(x)
    saved = (conv.conv3x3_bias_relu, double_conv.double_conv3x3_bias_relu,
             conv_s8.conv3x3_s8_q)
    conv.conv3x3_bias_relu = lambda x, k, b, packed=None: \
        conv.conv3x3_bias_relu_reference(x, k, b)
    double_conv.double_conv3x3_bias_relu = \
        lambda x, w1, b1, w2, b2, packed=None: \
        double_conv.double_conv3x3_bias_relu_reference(x, w1, b1, w2, b2)
    conv_s8.conv3x3_s8_q = lambda x, wq, k, b, s_out=None, packed=None, \
        up=None, dtype=torch.bfloat16: conv_s8.conv3x3_s8_q_reference(
            x, wq, k, b, s_out, up, dtype)
    try:
        plain = infer(pred._forward).cpu().numpy()
        if quant is None:  # the plain logits' margin at each pixel
            tiles = torch.stack([x[..., i:i + 32, j:j + 32, :]
                                 for i in range(0, 96, 32)
                                 for j in range(0, 128, 32)], 1)
            with torch.no_grad():
                if model == "bidate":
                    logits = pred._forward(tiles[0], tiles[1])
                else:
                    logits = pred._forward(tiles.permute(1, 0, 2, 3, 4))
    finally:
        (conv.conv3x3_bias_relu, double_conv.double_conv3x3_bias_relu,
         conv_s8.conv3x3_s8_q) = saved
    flips = mask != plain
    if quant is not None or not flips.any():
        np.testing.assert_array_equal(mask, plain)
        return
    margin = (logits[..., 1] - logits[..., 0]).abs()
    margin = margin.reshape(3, 4, 32, 32).permute(0, 2, 1, 3).reshape(
        96, 128).cpu().numpy()
    assert (margin[flips] <= 1e-4 * logits.abs().max().item()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("model,quant", [("bidate", "none"),
                                         ("bidate", "int8"),
                                         ("unet_lstm", "none"),
                                         ("unet_lstm", "int8"),
                                         ("unet3d", "none")])
def test_fullconv_f32_banded_equals_whole_on_card(card, model, quant):
    """The fullconv test above in float32: the fp32 kernels' sums do not
    depend on the image's size either (UNetLSTM's signed gate conv on the
    fp32 conv kernel), so banded = whole bit for bit."""
    before = conv.conv3x3_bias_relu.launches_f32
    _fullconv_banded_equals_whole(card, model, quant, "float32")
    assert conv.conv3x3_bias_relu.launches_f32 > before or quant == "int8"


_TF32_PIN = r"""
import json, sys
import numpy as np
import torch
from fabric_tpu_torch import Config
from fabric_tpu_torch.losses import get_loss_fn
from fabric_tpu_torch.models import build_model
from fabric_tpu_torch.ops import fp32_conv, fp32_matmul
from fabric_tpu_torch.train.state import create_state
from fabric_tpu_torch.train.steps import make_train_step
from fabric_tpu_torch.weights import init_variables

if sys.argv[1] == "library":  # the control: cuDNN and cuBLAS under the
    # process's flags, the matmul flag on
    torch.backends.cuda.matmul.allow_tf32 = True
    fp32_conv.conv = lambda x, w, bias=None, padding=0, groups=1: (
        torch.nn.functional.conv2d if x.dim() == 4 else
        torch.nn.functional.conv3d)(x, w, bias, padding=padding,
                                    groups=groups)
    fp32_matmul._pinned = fp32_matmul._product
elif sys.argv[1] == "unpinned":  # the convs pinned, the products not (the
    # port before its products were pinned)
    fp32_matmul._pinned = fp32_matmul._product
if len(sys.argv) > 2:  # the caller's float32 matmul precision
    torch.set_float32_matmul_precision(sys.argv[2])
cfg = Config(model_base=16, patch_size=32, batch_size=4, dtype="float32",
             learning_rate=0.05)
variables = init_variables(13, 2, 16, torch.Generator().manual_seed(3))
rng = np.random.RandomState(3)
img1 = rng.randn(4, 32, 32, 13).astype(np.float32)
label = (rng.rand(4, 32, 32) < 0.3).astype(np.int32)
img2 = img1 + 0.3 * rng.randn(*img1.shape).astype(np.float32)
img2[label == 1] += 1.5
batch = {"img1": img1, "img2": img2, "label": label,
         "weight": np.ones(4, np.float32)}
out = {}
for dev in ("cuda", "cpu"):
    model = build_model(cfg, dev, fold_bn=False, variables=variables,
                        train=True)
    b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    with torch.no_grad():
        logits = model(b["img1"], b["img2"]).cpu().double()
    state = create_state(cfg, model)
    loss = get_loss_fn(cfg)(model(b["img1"], b["img2"], train=True),
                            b["label"])
    loss.backward()
    grads = torch.cat([p.grad.reshape(-1).cpu().double()
                       for p in model.parameters()])
    out[dev] = (logits, loss.item(), grads)
(lg, pg, gg), (lc, pc, gc) = out["cuda"], out["cpu"]
res = {"logits": ((lg - lc).norm() / lc.norm()).item(),
       "loss": abs(pg - pc) / abs(pc),
       "grads": ((gg - gc).norm() / gc.norm()).item()}
if len(sys.argv) > 3:  # the folded serving forward as an exported program
    class Eval(torch.nn.Module):  # on the card, against the CPU's
        def __init__(self, model):
            super().__init__()
            self.model = model

        def forward(self, a, b):
            return self.model(a, b)
    args = {dev: tuple(torch.from_numpy(batch[k]).to(dev)
                       for k in ("img1", "img2")) for dev in ("cuda", "cpu")}
    with torch.no_grad():
        ref = build_model(cfg, "cpu", fold_bn=True, variables=variables)(
            *args["cpu"]).double()
        program = torch.export.export(
            Eval(build_model(cfg, "cuda", fold_bn=True,
                             variables=variables)).eval(),
            args["cuda"], strict=False)
        le = program.module()(*args["cuda"]).cpu().double()
    res["exported"] = ((le - ref).norm() / ref.norm()).item()
    res["pins"] = sum("fp32_product" in str(n.target)
                      for n in program.graph.nodes)
print(json.dumps(res))
"""


@pytest.mark.cuda
def test_float32_convs_ignore_the_tf32_flags(card, tmp_path):
    """In a fresh process under PyTorch's default flags (cuDNN's TF32 on),
    an unfolded BiDateNet's fp32 eval forward and one train step's loss
    and gradients on the card agree with the CPU's: relative L2 of the
    logits and relative loss within 1e-5, of the gradients within 1e-4
    (fp32 sums in other orders; train-mode BatchNorm's variance keeps
    fewer bits).  The control run, cuDNN and cuBLAS as the flags leave them
    with the matmul flag turned on, misses those bounds (TF32 keeps
    ~1e-3)."""
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    got = {}
    for mode in ("port", "library"):
        run = subprocess.run([sys.executable, "-c", _TF32_PIN, mode],
                             capture_output=True, text=True, env=env,
                             cwd=str(tmp_path), timeout=300)
        assert run.returncode == 0, run.stderr[-3000:]
        got[mode] = json.loads(run.stdout.strip().splitlines()[-1])
    print(got)
    port, library = got["port"], got["library"]
    assert port["logits"] <= 1e-5 and port["loss"] <= 1e-5
    assert port["grads"] <= 1e-4
    assert (library["logits"] > 1e-5 or library["loss"] > 1e-5
            or library["grads"] > 1e-4)


@pytest.mark.cuda
def test_float32_products_ignore_the_matmul_precision(card, tmp_path):
    """The same in a fresh process whose caller asked for TF32 matmuls
    (``torch.set_float32_matmul_precision("high")``): the upsamples' and
    the head's products are pinned per call (ops/fp32_matmul.py), so the
    logits and loss stay within 1e-5 of the CPU's and the gradients within
    1e-4; and the folded serving forward exported on the card agrees with
    the CPU's within 1e-5, its graph holding the pin's op for each product
    (8 upsample matmuls and the head).  Printed beside it, not held: the same run with the products
    unpinned (what the port computed before the pin)."""
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    got = {}
    for mode, extra in (("port", ["export"]), ("unpinned", [])):
        run = subprocess.run([sys.executable, "-c", _TF32_PIN, mode, "high",
                              *extra], capture_output=True, text=True,
                             env=env, cwd=str(tmp_path), timeout=300)
        assert run.returncode == 0, run.stderr[-3000:]
        got[mode] = json.loads(run.stdout.strip().splitlines()[-1])
    print(got)
    got = got["port"]
    assert got["logits"] <= 1e-5 and got["loss"] <= 1e-5
    assert got["grads"] <= 1e-4
    assert got["exported"] <= 1e-5 and got["pins"] == 9


@pytest.mark.cuda
def test_f32_long_k_at_up1(card):
    """up1's convs at the main path's count (256 tiles of 8x8; 1024 -> 256
    -> 256, the longest K of the fp32 path: 9216 products a sum), single
    and fused, within the fp32 bounds of the plain version; the fused
    kernel equals two conv launches bit for bit."""
    g = torch.Generator().manual_seed(16)
    x = torch.randn(256, 8, 8, 1024, generator=g).to(card)
    w1 = (torch.randn(3, 3, 1024, 256, generator=g) / 96).to(card)
    w2 = (torch.randn(3, 3, 256, 256, generator=g) / 48).to(card)
    b1, b2 = (torch.randn(256, generator=g).to(card) * 0.1 for _ in range(2))
    one = conv.conv3x3_bias_relu(x, w1, b1)
    _f32_close(one, conv.conv3x3_bias_relu_reference(x, w1, b1))
    two = conv.conv3x3_bias_relu(one, w2, b2)
    _f32_close(two, double_conv.double_conv3x3_bias_relu_reference(
        x, w1, b1, w2, b2))
    fused_y = double_conv.double_conv3x3_bias_relu(x, w1, b1, w2, b2)
    assert torch.equal(fused_y, two)


@pytest.mark.cuda
def test_f32_signed_gate_conv_negates_exactly(card):
    """UNetLSTM's signed gate conv in float32 on the 3xTF32 kernel: the
    launch of [K, -K] (bias [b, -b]) on -x gives the launch on x with its
    halves swapped, bit for bit (the sums of -K and of -x are the same
    negation: the TF32 splits and the products are sign-symmetric), one of
    each pair is 0, and their difference, the gate's z, is within the fp32
    bounds of the plain conv."""
    from fabric_tpu_torch.models.unet_lstm import signed_conv
    g = torch.Generator().manual_seed(17)
    x = torch.randn(3, 16, 16, 96, generator=g).to(card)
    k = (torch.randn(3, 3, 96, 128, generator=g) / 29).to(card)
    b = (torch.randn(128, generator=g) * 0.1).to(card)
    kk, bb = torch.cat([k, -k], -1), torch.cat([b, -b])
    y = conv.conv3x3_bias_relu(x, kk, bb)
    neg = conv.conv3x3_bias_relu(-x, kk, -bb)
    assert torch.equal(neg, torch.cat([y[..., 128:], y[..., :128]], -1))
    assert not (torch.minimum(y[..., :128], y[..., 128:]) != 0).any()
    z = signed_conv(x, kk, bb)
    plain = torch.nn.functional.conv2d(
        x.double().permute(0, 3, 1, 2), k.double().permute(3, 2, 0, 1),
        b.double(), padding=1).permute(0, 2, 3, 1)
    _f32_close(z, plain.float())


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [None, "int8"])
def test_f32_serving_modes_on_card(card, quant):
    """The other serving modes in float32 on the card, each through the
    fp32 kernels only: overlap (banded = unbanded; exact only, as int8
    overlap serves the same sites), fleet packing (= per scene), and the
    scene sharded over two shards of the card, grid and fullconv (=
    one device)."""
    from fabric_tpu_torch import Config
    from fabric_tpu_torch.infer.service import ScenePredictor
    from fabric_tpu_torch.parallel.mesh import make_mesh
    kw = dict(patch_size=32, eval_batch_size=12, model_base=16,
              dtype="float32")
    rng = np.random.RandomState(11)
    pair = tuple(rng.randn(96, 128, 13).astype(np.float32)
                 for _ in range(2))
    fleet = [tuple(rng.randn(64, 60, 13).astype(np.float32)
                   for _ in range(2)) for _ in range(3)]
    def counted(fn):
        before = _f32_counts()
        out = fn()
        torch.cuda.synchronize()
        after = _f32_counts()
        d = [a - b for k in ("f32", "bf16")
             for a, b in zip(after[k], before[k])]
        assert sum(d[:3]) > 0 and d[3:] == [0, 0, 0], d
        return out

    if quant is None:
        over = dict(kw, infer_overlap=8)
        a = ScenePredictor(Config(**over), bucket=0, device=card)
        b = ScenePredictor(Config(**over), bucket=0, device=card,
                           overlap_band_rows=2)
        np.testing.assert_array_equal(counted(lambda: a.predict(*pair)),
                                      counted(lambda: b.predict(*pair)))
    pred = ScenePredictor(Config(**kw), bucket=64, device=card, quant=quant)
    seq = [counted(lambda p=p: pred.predict(*p)) for p in fleet]
    for got, want in zip(counted(lambda: pred.predict_many(fleet,
                                                           pack="auto")),
                         seq, strict=True):
        np.testing.assert_array_equal(got, want)
    mesh = make_mesh(2, devices=[card] * 2)
    for band in (0, 256):
        two = ScenePredictor(Config(**kw), device=card, quant=quant,
                             fullconv_band_rows=band, mesh=mesh,
                             shard_scene=True)
        one = ScenePredictor(Config(**kw), device=card, quant=quant,
                             fullconv_band_rows=band, bucket=two.bucket)
        if quant:
            one.predict(*pair)
            two._use_scales(one._scales)
        np.testing.assert_array_equal(counted(lambda: two.predict(*pair)),
                                      counted(lambda: one.predict(*pair)))
