"""The port's seamless fullconv serving (fabric_tpu_torch.infer.fullconv,
ops.resize.upsample2x_local, the models' local_upsample, int8 with it,
ScenePredictor(fullconv_band_rows, fullconv_stream), cli.infer) against
fabric_tpu on the CPU, at base 8 (bi-date) and base 4 (multi-date, T = 3),
scenes of a few hundred pixels (the shapes of tests/test_fullconv.py),
weights bridged from fabric_tpu's trees, inputs from numpy seeds.

Within the port, banded, band-batched and streamed masks are held to the
whole-scene forward exactly: every op commutes with 16-aligned crops and
the CPU's plain versions compute each image on its own.  Against
fabric_tpu the tolerances are the earlier slices': fp32 logits within
1e-5 (summation order), bf16 within 0.05 (where each side rounds), and a
mask pixel may differ only where the logit margin is below 0.1."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fabric_tpu.infer import fullconv as jfc
from fabric_tpu.infer import quant as jq
from fabric_tpu.models import BiDateNet as JaxBiDateNet
from fabric_tpu.models.unet3d import UNet3D as JaxUNet3D
from fabric_tpu.models.unet_lstm import UNetLSTM as JaxUNetLSTM
from fabric_tpu.ops.fold_bn import fold_batchnorm
from fabric_tpu.ops.resize import upsample2x_local as jax_upsample2x_local

from fabric_tpu_torch import Config
from fabric_tpu_torch import checkpoint as ckpt
from fabric_tpu_torch.infer import fullconv as fc
from fabric_tpu_torch.infer import quant as tq
from fabric_tpu_torch.infer.service import ScenePredictor
from fabric_tpu_torch.models import BiDateNet, UNet3D, UNetLSTM, build_model
from fabric_tpu_torch.ops.resize import upsample2x_local
from fabric_tpu_torch.weights import load_variables

BASE, MD_BASE, T = 8, 4, 3
FP32_ATOL = 1e-5   # fp32 logits: summation order only
BF16_ATOL = 0.05   # bf16 logits: each side rounds at other places
FLIP_MARGIN = 2 * BF16_ATOL  # a mask flip only below this logit margin
SCALE_RTOL = 1e-5  # fp32 calibration scales: summation order only
FAMILIES = {"unet_lstm": (JaxUNetLSTM, UNetLSTM),
            "unet3d": (JaxUNet3D, UNet3D)}
# weight seeds whose masks at the banding tests' scene are not near
# constant (random multi-date nets often saturate to one class), so that
# an insufficient halo shows
MD_SEEDS = {"unet_lstm": 2, "unet3d": 1}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small PyTorch ops: one thread, as the other port tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(model, x, seed):
    """fabric_tpu's variables of ``model`` (shapes from ``eval_shape``)
    with numpy values: lecun-scaled kernels, small biases, non-trivial
    BatchNorm."""
    shapes = jax.eval_shape(lambda k: model.init(k, *x, train=False),
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def value(path, leaf):
        key, shape = path[-1].key, leaf.shape
        if key == "kernel":
            return (rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))).astype(
                np.float32)
        if key in ("bias", "mean"):
            return (rng.randn(*shape) * 0.1).astype(np.float32)
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)

    v = jax.tree_util.tree_map_with_path(value, shapes)
    return v["params"], v["batch_stats"]


@pytest.fixture(scope="module")
def bidate():
    """(fabric_tpu's folded tree, the port's folded fp32 BiDateNet with
    local_upsample) at base 8."""
    x = jnp.zeros((1, 32, 32, 13), jnp.float32)
    variables = _tree(JaxBiDateNet(base=BASE), (x, x), 0)
    model = BiDateNet(13, 2, BASE, fold_bn=True, dtype=torch.float32,
                      local_upsample=True)
    load_variables(model, *variables)
    return fold_batchnorm(*variables), model.eval()


def _multidate(name, seed):
    """(fabric_tpu's folded tree, the port's folded fp32 model with
    local_upsample) of a multi-date family at base 4."""
    x = jnp.zeros((1, T, 32, 32, 13), jnp.float32)
    variables = _tree(FAMILIES[name][0](base=MD_BASE), (x,), seed)
    model = FAMILIES[name][1](13, 2, MD_BASE, fold_bn=True,
                              dtype=torch.float32, local_upsample=True)
    load_variables(model, *variables)
    return fold_batchnorm(*variables), model.eval()


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    """(name, folded tree, port model) at the family's MD_SEEDS seed."""
    return (request.param, *_multidate(request.param,
                                       MD_SEEDS[request.param]))


def _pair(seed, h, w, n=None):
    rng = np.random.RandomState(seed)
    shape = (h, w, 13) if n is None else (n, h, w, 13)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def _stack(seed, h, w, n=None):
    shape = (T, h, w, 13) if n is None else (n, T, h, w, 13)
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _whole(model, *scenes):
    """Oracle: one forward over the whole scene (edge-padded to 16, mask
    cropped back), and its logits."""
    h, w = scenes[0].shape[-3:-1]
    hp, wp = -(-h // 16) * 16, -(-w // 16) * 16
    with torch.inference_mode():
        x = [fc._edge_pad(s, hp, wp)[None] for s in _t(*scenes)]
        logits = model(*x)[0]
    return fc._mask(logits).numpy()[:h, :w], logits.numpy()[:h, :w]


# --- the local upsample ------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (1, 4, 6, 2), (5, 7, 3),
                                   (6, 4, 2), (1, 1, 1, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_upsample2x_local_bit_equal(shape, dtype):
    """NHWC and HWC, odd and even sizes, one pixel: bit-equal to
    fabric_tpu.ops.resize.upsample2x_local (fp32 midpoints rounded once)."""
    x = np.random.RandomState(len(shape)).randn(*shape).astype(np.float32)
    want = jax_upsample2x_local(jnp.asarray(x, getattr(jnp, dtype)))
    got = upsample2x_local(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_upsample2x_local_gradient_matches_jax():
    """Differentiable: the vector-Jacobian product equals jax.vjp's."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 6, 3).astype(np.float32)
    g = rng.randn(2, 10, 12, 3).astype(np.float32)
    _, vjp = jax.vjp(jax_upsample2x_local, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    upsample2x_local(xt).backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(g)[0]),
                               rtol=0, atol=1e-6)


def test_local_upsample_adds_no_parameter():
    """Checkpoints are unchanged: the same state_dict either way, and
    build_model takes cfg.local_upsample (and an override)."""
    keys = [sorted(BiDateNet(13, 2, BASE, local_upsample=flag).state_dict())
            for flag in (False, True)]
    assert keys[0] == keys[1]
    cfg = Config(model_base=BASE, dtype="float32", local_upsample=True)
    assert build_model(cfg, "cpu").local_upsample is True
    assert build_model(cfg, "cpu", local_upsample=False).up1.local_upsample \
        is False
    for name in FAMILIES:
        m = build_model(Config(model=name, model_base=MD_BASE, num_dates=T,
                               local_upsample=True), "cpu")
        assert m.local_upsample and m.up4.local_upsample


class _Jitted:
    """A flax model whose init and apply are jitted (fabric_tpu's
    receptive_field_radius calls them eagerly, which takes ~20 s here)."""

    def __init__(self, model):
        self.init = jax.jit(model.init, static_argnames="train")
        self.apply = jax.jit(model.apply, static_argnames="train")


def test_receptive_field_radius_matches_fabric_tpu():
    """The default models' radii, both float32 base 4, from their own
    seeded initialisations."""
    r = fc.receptive_field_radius()
    assert r == jfc.receptive_field_radius(_Jitted(JaxBiDateNet(
        base=4, dtype=jnp.float32, local_upsample=True)))
    assert r <= 128 - fc.STRIDE


# --- banding in the port -----------------------------------------------------

@pytest.mark.parametrize("shape,band_rows", [
    ((600, 100), 160),   # 3 uniform bands and a tail band
    ((608, 96), 304),    # an exact multiple: no tail
    ((300, 70), 1024),   # smaller than one band: one window
])
def test_banded_equals_whole_scene(bidate, shape, band_rows):
    d1, d2 = _pair(1, *shape)
    run = fc.make_fullconv_scene_infer(bidate[1], shape, band_rows=band_rows,
                                       dtype=torch.float32)
    got = run(*_t(d1, d2)).numpy()
    assert got.shape == shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _whole(bidate[1], d1, d2)[0])


@pytest.mark.parametrize("shape,band_batch", [
    ((600, 100), 2),   # 3 uniform bands: a group of 2, the rest, the tail
    ((608, 96), 4),    # 3 uniform bands and a tail, one remainder group
    ((960, 80), 3),    # 6 uniform bands: exactly 2 groups
    ((600, 100), 8),   # band_batch above the band count
])
def test_band_batched_equals_sequential(bidate, shape, band_batch):
    d1, d2 = _pair(3, *shape)
    runs = [fc.make_fullconv_scene_infer(bidate[1], shape, band_rows=160,
                                         dtype=torch.float32, band_batch=b)
            for b in (1, band_batch)]
    seq, got = (run(*_t(d1, d2)).numpy() for run in runs)
    np.testing.assert_array_equal(got, seq)
    np.testing.assert_array_equal(got, _whole(bidate[1], d1, d2)[0])


@pytest.mark.parametrize("shape,band_rows", [((600, 100), 160),
                                             ((300, 70), 1024)])
def test_streamed_equals_in_hbm(bidate, shape, band_rows, tmp_path):
    """Scenes read back as memmaps, the mask written into an out= memmap;
    plain arrays and a fresh canvas; with padded_shape, the in-device
    runner on the edge-padded scene."""
    d1, d2 = _pair(4, *shape)
    m1, m2 = (np.memmap(tmp_path / f"d{i}.npy", np.float32, "w+",
                        shape=d.shape) for i, d in enumerate((d1, d2)))
    m1[:], m2[:] = d1, d2
    m1, m2 = (np.memmap(m.filename, np.float32, "r", shape=m.shape)
              for m in (m1, m2))
    out = np.memmap(tmp_path / "mask.npy", np.uint8, "w+", shape=shape)
    kw = dict(band_rows=band_rows, dtype=torch.float32)
    run_s = fc.make_fullconv_scene_infer_streamed(bidate[1], shape,
                                                  device="cpu",
                                                  max_in_flight=1, **kw)
    want = fc.make_fullconv_scene_infer(bidate[1], shape, **kw)(
        *_t(d1, d2)).numpy()
    assert run_s(m1, m2, out=out) is out
    np.testing.assert_array_equal(np.asarray(out), want)
    np.testing.assert_array_equal(run_s(d1, d2), want)
    padded = (shape[0] + 50, shape[1] + 30)
    run_p = fc.make_fullconv_scene_infer_streamed(
        bidate[1], shape, padded_shape=padded, device="cpu", **kw)
    big = [np.pad(d, [(0, 50), (0, 30), (0, 0)], mode="edge")
           for d in (d1, d2)]
    want_p = fc.make_fullconv_scene_infer(bidate[1], padded, **kw)(
        *_t(*big)).numpy()[:shape[0], :shape[1]]
    np.testing.assert_array_equal(run_p(d1, d2), want_p)
    with pytest.raises(ValueError, match="out must be"):
        run_s(d1, d2, out=np.empty((3, 3), np.uint8))
    with pytest.raises(ValueError, match="must cover"):
        fc.make_fullconv_scene_infer_streamed(bidate[1], shape,
                                              padded_shape=(10, 10))


def test_insufficient_halo_breaks_equality(bidate):
    """Teeth: a halo below the receptive field changes the mask."""
    d1, d2 = _pair(2, 600, 100)
    run = fc.make_fullconv_scene_infer(bidate[1], (600, 100), band_rows=160,
                                       halo=16, dtype=torch.float32)
    assert (run(*_t(d1, d2)).numpy() != _whole(bidate[1], d1, d2)[0]).any()


def test_align_corners_model_and_bad_plans_refused(bidate):
    plain = BiDateNet(13, 2, BASE, dtype=torch.float32)
    for make in (fc.make_fullconv_scene_infer,
                 fc.make_fullconv_scene_infer_streamed):
        with pytest.raises(ValueError, match="local_upsample"):
            make(plain, (600, 100))
        with pytest.raises(ValueError, match="multiples"):
            make(bidate[1], (600, 100), band_rows=100)
    with pytest.raises(ValueError, match="local_upsample"):
        fc.make_fullconv_scene_infer_multidate(
            UNetLSTM(13, 2, MD_BASE), (600, 100), T)
    with pytest.raises(ValueError, match="band_batch"):
        fc.make_fullconv_scene_infer(bidate[1], (600, 100), band_batch=0)


# --- against fabric_tpu ------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fullconv_mask_matches_fabric_tpu(bidate, dtype):
    """fabric_tpu's banded fullconv mask and the port's on the same
    weights at (600, 100) / band 160: equal in fp32; in bf16 a pixel may
    differ only where the port's logit margin is below 0.1."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    d1, d2 = _pair(5, 600, 100)
    jmodel = JaxBiDateNet(base=BASE, dtype=jdt, fold_bn=True,
                          local_upsample=True)
    want = np.asarray(jfc.make_fullconv_scene_infer(
        jmodel, (600, 100), band_rows=160, dtype=jdt)(
        {"params": bidate[0], "batch_stats": {}}, jnp.asarray(d1),
        jnp.asarray(d2)))
    model = BiDateNet(13, 2, BASE, fold_bn=True, dtype=tdt,
                      local_upsample=True)
    model.load_state_dict(bidate[1].state_dict())
    got = fc.make_fullconv_scene_infer(model.eval(), (600, 100),
                                       band_rows=160, dtype=tdt)(
        *_t(d1, d2)).numpy()
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
        return
    logits = _whole(model, d1.astype(np.float32), d2)[1]
    flips = got != want
    print(f"bf16: {int(flips.sum())} of {flips.size} pixels differ")
    assert (np.abs(logits[..., 1] - logits[..., 0])[flips]
            < FLIP_MARGIN).all()


@pytest.mark.parametrize("name", list(FAMILIES))
@pytest.mark.parametrize("dtype,atol", [("float32", FP32_ATOL),
                                        ("bfloat16", BF16_ATOL)])
def test_local_upsample_logits_match_fabric_tpu(bidate, name, dtype, atol):
    """The folded forwards with local_upsample, bi-date and both
    multi-date families, against model.apply.  The multi-date weights are
    seed 0's, whose logits are near 1 in scale as in the grid tests' (the
    bf16 bound is absolute: MD_SEEDS' UNetLSTM reaches 12, where both
    sides lie 0.11-0.12 from the fp32 logits and 0.094 = 1.5 bf16 ulps of
    the scale from each other, local upsample or align-corners alike)."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    cases = [(JaxBiDateNet(base=BASE, dtype=jdt, fold_bn=True,
                           local_upsample=True), bidate, _pair(6, 48, 32, 2)),
             (FAMILIES[name][0](base=MD_BASE, dtype=jdt, fold_bn=True,
                                local_upsample=True), _multidate(name, 0),
              (_stack(6, 48, 32, 2),))]
    for jmodel, (tree, model), x in cases:
        want = np.asarray(jax.jit(lambda v, *a: jmodel.apply(
            v, *a, train=False))({"params": tree, "batch_stats": {}},
                                 *map(jnp.asarray, x)))
        m = type(model)(13, 2, model.inc.conv1.kernel.shape[-1],
                        fold_bn=True, dtype=tdt, local_upsample=True)
        m.load_state_dict(model.state_dict())
        with torch.inference_mode():
            got = m.eval()(*_t(*x)).numpy()
        err = np.abs(got - want).max()
        print(f"{type(model).__name__} {dtype}: max abs err {err:.3g}")
        assert err <= atol


def test_multidate_banded_and_streamed_equal_whole(family):
    """UNetLSTM and UNet3D at (600, 80) / band 160 with the halo of
    halo_for (tests/test_fullconv.py's (432, 80) fits UNetLSTM's halo in
    one window): banded = whole-scene forward, streamed from a host (T, H,
    W, C) array = in-HBM, exactly; an insufficient halo breaks the
    equality."""
    name, _, model = family
    shape = (600, 80)
    scenes = _stack(7, *shape)
    kw = dict(band_rows=160, dtype=torch.float32, halo=fc.halo_for(name, T))
    got = fc.make_fullconv_scene_infer_multidate(model, shape, T, **kw)(
        torch.from_numpy(scenes)).numpy()
    whole = _whole_md(model, scenes)
    np.testing.assert_array_equal(got, whole)
    run_s = fc.make_fullconv_scene_infer_multidate_streamed(
        model, shape, T, device="cpu", **kw)
    np.testing.assert_array_equal(run_s(scenes), got)
    bad = fc.make_fullconv_scene_infer_multidate(model, shape, T, halo=16,
                                                 band_rows=160,
                                                 dtype=torch.float32)
    assert (bad(torch.from_numpy(scenes)).numpy() != whole).any()
    with pytest.raises(ValueError, match="date stack"):
        run_s(scenes[:2])


@pytest.mark.parametrize("t", [2, 3])
def test_unet_lstm_halo_covers_its_receptive_field(t):
    """UNetLSTM's ConvLSTM adds a 3x3 conv at stride 16 per date, so its
    receptive-field radius is 109 + 16 T px (float64, perturbing one
    pixel of a 320^2 stack): beyond fabric_tpu's halo of 128 from T = 2,
    where a band's kept logits differ from the whole scene's (thousands of
    pixels at (640, 48) / band 160); halo_for's 128 + 16 T covers it with a
    stride to spare and gives every kept logit exactly."""
    model = UNetLSTM(13, 2, MD_BASE, dtype=torch.float64,
                     local_upsample=True)
    load_variables(model, *_tree(JaxUNetLSTM(base=MD_BASE), (
        jnp.zeros((1, T, 32, 32, 13), jnp.float32),), 2))
    model = model.double().eval()
    assert fc.halo_for("unet_lstm", t) == 128 + 16 * t
    assert fc.halo_for("unet3d", t) == fc.halo_for("bidate") == 128
    rng = np.random.RandomState(t)
    x = torch.from_numpy(rng.randn(1, t, 320, 320, 13))
    xp = x.clone()
    xp[0, :, 160, 160] += 10.0
    with torch.inference_mode():
        changed = (model(xp) != model(x)).any(-1)[0].numpy()
    rows, cols = np.where(changed.any(1))[0], np.where(changed.any(0))[0]
    radius = max(abs(rows - 160).max(), abs(cols - 160).max())
    assert radius == 109 + 16 * t
    x = torch.from_numpy(rng.randn(1, t, 640, 48, 13))
    with torch.inference_mode():
        whole = model(x)[0]
        for halo, want_equal in ((128, False), (fc.halo_for("unet_lstm", t),
                                                True)):
            ctx, bands = fc._bands(640, 160, halo)
            equal = True
            for y0, rows in bands:
                cs = fc._window(y0, halo, 640, ctx)
                kept = model(x[:, :, cs:cs + ctx])[0][y0 - cs:y0 - cs + rows]
                equal &= torch.equal(kept, whole[y0:y0 + rows])
            assert equal is want_equal, halo


def _whole_md(model, scenes):
    h, w = scenes.shape[1:3]
    hp, wp = -(-h // 16) * 16, -(-w // 16) * 16
    with torch.inference_mode():
        x = fc._edge_pad(torch.from_numpy(scenes), hp, wp)[None]
        return fc._mask(model(x)[0]).numpy()[:h, :w]


# --- int8 with local_upsample ------------------------------------------------

def _calib(seed):
    return [_pair(seed, 32, 32, 2)]


def test_int8_bidate_local_upsample_matches_fabric_tpu(bidate):
    """Scales within 1e-5 relative and the stats forward's logits within
    1e-5 of fabric_tpu's; the int8 logits on the same scales within 1e-5;
    the banded int8 mask = the whole-scene int8 mask exactly."""
    tree = tq.folded_params(bidate[1])
    calib = _calib(8)
    want = jq.calibrate(bidate[0], calib, jnp.float32, local_upsample=True)
    got = tq.calibrate(tree, calib, torch.float32, local_upsample=True)
    assert sorted(got) == sorted(want)
    assert max(abs(got[k] - want[k]) / want[k] for k in want) <= SCALE_RTOL
    x = _pair(9, 48, 32, 2)
    jl, _ = jq.make_stats_forward(bidate[0], jnp.float32,
                                  local_upsample=True)(*map(jnp.asarray, x))
    tl, _ = tq.make_stats_forward(tree, torch.float32,
                                  local_upsample=True)(*_t(*x))
    assert np.abs(tl.numpy() - np.asarray(jl)).max() <= FP32_ATOL
    with torch.inference_mode():
        assert np.abs(tl.numpy() - bidate[1](*_t(*x)).numpy()).max() \
            <= FP32_ATOL
    apply_j = jq.make_int8_apply(bidate[0], got, jnp.float32,
                                 local_upsample=True)
    fwd = tq.make_int8_apply(tree, got, torch.float32, local_upsample=True)
    assert fwd.local_upsample is True
    err = np.abs(fwd(*_t(*x)).numpy() - np.asarray(jax.jit(
        lambda a, b: apply_j(None, a, b))(*x))).max()
    print(f"int8 bi-date local_upsample logits: max abs diff {err:.3g}")
    assert err <= FP32_ATOL
    d1, d2 = _pair(10, 600, 100)
    banded = fc.make_fullconv_scene_infer(fwd, (600, 100), band_rows=160,
                                          dtype=torch.float32)
    np.testing.assert_array_equal(banded(*_t(d1, d2)).numpy(),
                                  _whole(fwd, d1, d2)[0])
    with pytest.raises(ValueError, match="local_upsample"):
        fc.make_fullconv_scene_infer(
            tq.make_int8_apply(tree, got, torch.float32), (600, 100))


def test_int8_bidate_local_upsample_bf16_logits(bidate):
    """bf16 int8 logits on the same scales within 0.05 of fabric_tpu's,
    as the grid path's (tests/test_torch_quant.py)."""
    model = BiDateNet(13, 2, BASE, fold_bn=True, dtype=torch.bfloat16,
                      local_upsample=True)
    model.load_state_dict(bidate[1].state_dict())
    tree = tq.folded_params(model.eval())
    scales = tq.calibrate(tree, _calib(8), torch.bfloat16,
                          local_upsample=True)
    x = _pair(9, 48, 32, 2)
    apply_j = jq.make_int8_apply(bidate[0], scales, jnp.bfloat16,
                                 local_upsample=True)
    want = np.asarray(jax.jit(lambda a, b: apply_j(None, a, b))(*x))
    got = tq.make_int8_apply(tree, scales, torch.bfloat16,
                             local_upsample=True)(*_t(*x)).numpy()
    err = np.abs(got - want).max()
    print(f"int8 bf16 local_upsample logits: max abs diff {err:.3g} at "
          f"scale {np.abs(want).max():.3g}")
    assert err <= BF16_ATOL


def test_int8_multidate_local_upsample_matches_fabric_tpu(family):
    name, folded, model = family
    tree = tq.folded_params(model)
    calib = [_stack(11, 32, 32, 2)]
    want = jq.calibrate(folded, calib, jnp.float32, local_upsample=True,
                        model=name)
    got = tq.calibrate(tree, calib, torch.float32, local_upsample=True,
                       model=name)
    assert sorted(got) == sorted(want)
    assert max(abs(got[k] - want[k]) / want[k] for k in want) <= SCALE_RTOL
    x = _stack(12, 48, 32, 2)
    apply_j = jq.make_int8_apply(folded, got, jnp.float32,
                                 local_upsample=True, model=name)
    fwd = tq.make_int8_apply(tree, got, torch.float32, local_upsample=True,
                             model=name)
    err = np.abs(fwd(torch.from_numpy(x)).numpy() - np.asarray(
        jax.jit(lambda a: apply_j(None, a))(x))).max()
    print(f"int8 {name} local_upsample logits: max abs diff {err:.3g}")
    assert err <= FP32_ATOL
    scenes = _stack(13, 600, 80)
    banded = fc.make_fullconv_scene_infer_multidate(
        fwd, (600, 80), T, band_rows=160, dtype=torch.float32,
        halo=fc.halo_for(name, T))
    np.testing.assert_array_equal(banded(torch.from_numpy(scenes)).numpy(),
                                  _whole_md(fwd, scenes))


# --- ScenePredictor and the CLI ----------------------------------------------

def _cfg(**kw):
    return Config(patch_size=16, eval_batch_size=8, dtype="float32",
                  model_base=BASE, **kw)


def test_predictor_fullconv_guards():
    """fabric_tpu's guards: streaming needs band rows; fullconv needs
    fold_bn and no overlap; the sharded form needs a mesh (it is ported:
    tests/test_torch_sharded.py)."""
    with pytest.raises(ValueError, match="fullconv_stream"):
        ScenePredictor(_cfg(), device="cpu", fullconv_stream=True)
    for cfg, kw in ((_cfg(infer_overlap=8), {}),
                    (_cfg(infer_overlap=8), dict(overlap_band_rows=2)),
                    (_cfg(), dict(fold_bn=False))):
        with pytest.raises(ValueError, match="fullconv_band_rows"):
            ScenePredictor(cfg, device="cpu", fullconv_band_rows=160, **kw)
    with pytest.raises(ValueError, match="shard_scene requires a mesh"):
        ScenePredictor(_cfg(), device="cpu", shard_scene=True,
                       fullconv_band_rows=160)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_predictor_fullconv_serves_like_its_runner(quant):
    """predict through fullconv equals the runner on the bucket-padded
    scene; the streamed predictor equals the in-HBM one (int8: the same
    self-calibration); serving_mode and predict_many."""
    pred = ScenePredictor(_cfg(), bucket=16, device="cpu", quant=quant,
                          fullconv_band_rows=160)
    pred_s = ScenePredictor(_cfg(), bucket=16, device="cpu", quant=quant,
                            fullconv_band_rows=160, fullconv_stream=True)
    assert pred.model.local_upsample and pred_s.model.local_upsample
    assert (pred.serving_mode(), pred_s.serving_mode()) == (
        "fullconv", "fullconv_stream")
    d1, d2 = _pair(14, 330, 60)
    mask = pred.predict(d1, d2)
    assert mask.shape == (330, 60) and set(np.unique(mask)) <= {0, 1}
    np.testing.assert_array_equal(pred_s.predict(d1, d2), mask)
    assert (336, 64) in pred._runners and (330, 60) in pred_s._runners
    pad = [(0, 6), (0, 4), (0, 0)]
    ref = pred._get_runner(336, 64)(*_t(*(np.pad(d, pad, mode="edge")
                                          for d in (d1, d2))))
    np.testing.assert_array_equal(mask, ref.numpy()[:330, :60])
    if quant == "int8":
        assert pred._forward.local_upsample is True
        assert pred_s._scales == pred._scales
    many = pred_s.predict_many([(d1, d2), _pair(15, 200, 48)])
    np.testing.assert_array_equal(many[0], mask)
    np.testing.assert_array_equal(many[1], pred.predict(*_pair(15, 200,
                                                              48)))
    with pytest.raises(ValueError, match="grid tiling mode only"):
        pred.predict_many([(d1, d2)], pack=2)


def test_predictor_fullconv_multidate():
    """predict_multidate through fullconv: the mask of the predictor's
    folded UNet3D on the bucket-padded stack, in-HBM and streamed."""
    cfg = Config(patch_size=16, eval_batch_size=4, dtype="float32",
                 model="unet3d", model_base=MD_BASE, num_dates=T)
    pred = ScenePredictor(cfg, bucket=16, device="cpu",
                          fullconv_band_rows=160)
    pred_s = ScenePredictor(cfg, bucket=16, device="cpu",
                            fullconv_band_rows=160, fullconv_stream=True)
    scenes = _stack(16, 330, 60)
    mask = pred.predict_multidate(scenes)
    assert mask.shape == (330, 60)
    padded = np.pad(scenes, [(0, 0), (0, 6), (0, 4), (0, 0)], mode="edge")
    np.testing.assert_array_equal(mask,
                                  _whole_md(pred.model, padded)[:330, :60])
    np.testing.assert_array_equal(pred_s.predict_multidate(scenes), mask)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A 200x48 synthetic city and a checkpoint of fresh base-4 weights."""
    from fabric_tpu_torch.data.synthetic import generate_synthetic_dataset
    from fabric_tpu_torch.train.state import create_state
    root = tmp_path_factory.mktemp("fc")
    cfg = Config(dataset_dir=str(root / "data"), weight_dir=str(root / "w"),
                 patch_size=16, dtype="float32", model_base=4,
                 validation_cities=["alpha"])
    generate_synthetic_dataset(cfg.dataset_dir, cfg, cities=["alpha"],
                               sizes=[(200, 48)])
    ckpt.save(create_state(cfg, build_model(cfg, "cpu", fold_bn=False,
                                            train=True)),
              cfg.weight_dir, epoch=0)
    return cfg


@pytest.mark.parametrize("stream", [False, True])
def test_cli_infer_fullconv(dataset, tmp_path, stream):
    """cli.infer --fullconv_band_rows [--fullconv_stream] writes the mask
    that ScenePredictor.predict_city serves, and fullconv records."""
    from fabric_tpu_torch.cli.infer import main
    from fabric_tpu_torch.data.image import read_png_gray
    args = ["--dataset_dir", dataset.dataset_dir, "--resume",
            dataset.weight_dir, "--patch_size", "16", "--dtype", "float32",
            "--model_base", "4", "--validation_cities", '["alpha"]',
            "--log_dir", str(tmp_path / "logs"), "--device", "cpu",
            "--output_dir", str(tmp_path / "m"), "--bucket", "16",
            "--fullconv_band_rows", "64"] + (["--fullconv_stream"]
                                             if stream else [])
    assert main(args) == 0
    mask = read_png_gray(str(tmp_path / "m" / "alpha_mask.png"))
    cfg = Config(dataset_dir=dataset.dataset_dir, patch_size=16,
                 dtype="float32", model_base=4)
    pred = ScenePredictor(cfg, checkpoint=dataset.weight_dir, bucket=16,
                          device="cpu", fullconv_band_rows=64)
    np.testing.assert_array_equal(mask, pred.predict_city("alpha") * 255)
    run = next((tmp_path / "logs").iterdir())
    (rec,) = [json.loads(x) for x in (run / "metrics.jsonl").read_text()
              .splitlines()]
    assert rec["serve_mode"] == ("fullconv_stream" if stream
                                 else "fullconv")
