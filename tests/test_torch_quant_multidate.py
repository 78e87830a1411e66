"""The port's int8 serving of the multi-date models
(fabric_tpu_torch.infer.quant with model="unet_lstm" / "unet3d",
infer/quant_multidate.py, ScenePredictor quant="int8") against
fabric_tpu's quant / quant_multidate on the CPU, at model_base 8, patch 16
and T = 3 dates, inputs from numpy seeds, weights bridged.  On the CPU the
int8 conv wrappers compute their plain versions, exact integer convs, so
the sides can differ only in the float epilogues (XLA's fused
multiply-adds, bf16 chains kept in float32) and the calibration forward's
summation order."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fabric_tpu.infer import device_tiling as jdt
from fabric_tpu.infer import quant as jq
from fabric_tpu.models.unet3d import UNet3D as JaxUNet3D
from fabric_tpu.models.unet_lstm import UNetLSTM as JaxUNetLSTM
from fabric_tpu.ops.fold_bn import fold_batchnorm

from fabric_tpu_torch import Config
from fabric_tpu_torch.infer import quant as tq
from fabric_tpu_torch.infer.service import ScenePredictor
from fabric_tpu_torch.models import UNet3D, UNetLSTM
from fabric_tpu_torch.ops import conv_s8
from fabric_tpu_torch.weights import load_variables

BASE, PATCH, BATCH, T = 8, 16, 8, 3
FAMILIES = {"unet_lstm": (JaxUNetLSTM, UNetLSTM),
            "unet3d": (JaxUNet3D, UNet3D)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# float32 int8 logits: the int32 convs are exact on both sides; what is
# left is the float epilogues' fused multiply-adds and the upsample (~1e-7)
FP32_ATOL = 1e-5
# bf16 int8 logits: the bi-date path's bound (tests/test_torch_quant.py):
# XLA keeps the bf16 gate chains in float32; a value one bf16 ulp off may
# requantize one int8 quantum off
BF16_ATOL = 0.05
# calibration scales in float32: the float forward's summation order
SCALE_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _variables(name, seed=0):
    """fabric_tpu's tree of a family at base 8 (``eval_shape``) with numpy
    values (lecun-scaled kernels, small biases, non-trivial BatchNorm)."""
    model = FAMILIES[name][0](base=BASE)
    x = jnp.zeros((1, T, PATCH, PATCH, 13), jnp.float32)
    shapes = jax.eval_shape(lambda k: model.init(k, x, train=False),
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


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    """(name, fabric_tpu's folded tree, {dtype: the port's folded model})."""
    name = request.param
    variables = _variables(name)
    models = {}
    for dtype, (_, tdt) in DTYPES.items():
        m = FAMILIES[name][1](13, 2, BASE, fold_bn=True, dtype=tdt)
        load_variables(m, *variables)
        models[dtype] = m.eval()
    return name, fold_batchnorm(*variables), models


def _seq(seed, n, h=PATCH, w=PATCH):
    return np.random.RandomState(seed).randn(n, T, h, w, 13).astype(
        np.float32)


def test_sites_and_weights_bit_equal(family):
    """derive_conv_sites and quantize_weights (with the decoder's
    skip/up halves and the gate conv's x/h halves) equal fabric_tpu's."""
    name, jfolded, models = family
    tree = tq.folded_params(models["float32"])
    assert dict(tq.derive_conv_sites(tree)) == dict(
        jq.derive_conv_sites(jfolded))
    want = jq.quantize_weights(jfolded)
    got = tq.quantize_weights(tree)
    assert sorted(got) == sorted(want)
    if name == "unet_lstm":
        assert {"bottleneck_lstm.gates.x", "bottleneck_lstm.gates.h"} <= \
            set(got)
    else:
        assert got["down2.conv1"]["wq"].shape == (3, 3, 3, 2 * BASE,
                                                  4 * BASE)
    for site, fields in want.items():
        assert sorted(got[site]) == sorted(fields), site
        for f, v in fields.items():
            v = np.asarray(v)
            assert got[site][f].dtype == v.dtype, (site, f)
            np.testing.assert_array_equal(got[site][f], v, err_msg=site)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stats_forward_equals_model_forward(family, dtype):
    """The calibration forward is the folded model's forward: the same
    logits, bit for bit, with a tap at every site and the family's own."""
    name, jfolded, models = family
    x = torch.from_numpy(_seq(1, 2))
    fwd = tq.make_stats_forward(tq.folded_params(models[dtype]),
                                DTYPES[dtype][1], model=name)
    logits, stats = fwd(x)
    with torch.inference_mode():
        want = models[dtype](x)
    assert torch.equal(logits, want)
    taps = {s for s, _ in tq.derive_conv_sites(jfolded)} | {"enc.x5"}
    taps.discard("bottleneck_lstm.gates")  # its x side is enc.x5's
    if name == "unet_lstm":
        taps |= {"lstm.h", "f1", "f2", "f3", "f4"}
    assert set(stats) == taps


def test_calibrate_scales_agree(family):
    name, jfolded, models = family
    batches = [_seq(2, 2), _seq(3, 1)]
    want = jq.calibrate(jfolded, batches, jnp.float32, model=name)
    got = tq.calibrate(tq.folded_params(models["float32"]), batches,
                       torch.float32, model=name)
    assert sorted(got) == sorted(want)
    rel = max(abs(got[k] - want[k]) / want[k] for k in want)
    print(f"{name}: largest relative scale difference {rel:.3g}")
    assert rel <= SCALE_RTOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_logits_match_fabric_tpu(family, dtype):
    """Both sides serve the same scales (the port's bf16 calibration)."""
    name, jfolded, models = family
    jdtype, tdtype = DTYPES[dtype]
    scales = tq.calibrate(tq.folded_params(models["bfloat16"]),
                          [_seq(4, 2)], model=name)
    x = _seq(5, 2)
    apply_q = jq.make_int8_apply(jfolded, scales, jdtype, model=name)
    want = np.asarray(jax.jit(lambda x: apply_q(None, x))(x))
    fwd = tq.make_int8_apply(tq.folded_params(models[dtype]), scales,
                             tdtype, model=name)
    got = fwd(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (2, PATCH, PATCH, 2)
    err = np.abs(got - want).max()
    print(f"{name} {dtype}: int8 logits max abs diff {err:.3g} at scale "
          f"{np.abs(want).max():.3g}")
    assert err <= (FP32_ATOL if dtype == "float32" else BF16_ATOL)


@pytest.mark.parametrize("n,t,h,w,cin,cout", [(2, 3, 6, 7, 13, 16),
                                              (1, 5, 4, 4, 32, 8),
                                              (1, 1, 5, 3, 8, 8)])
def test_t_neighbour_conv_bit_equal_3d_conv(n, t, h, w, cin, cout):
    """A 3x3x3 SAME int8 conv as one 3x3 conv over the T-neighbour stack
    by the depth-folded kernel: equal to XLA's 3-D int32 conv (T = 1: only
    the middle depth tap sees data)."""
    rng = np.random.RandomState(n + t + cin)
    x = rng.randint(-127, 128, (n, t, h, w, cin)).astype(np.int8)
    k = rng.randint(-127, 128, (3, 3, 3, cin, cout)).astype(np.int8)
    want = np.asarray(jax.lax.conv_general_dilated(
        x, k, (1, 1, 1), "SAME", dimension_numbers=jq._DN3,
        preferred_element_type=jnp.int32))
    got = conv_s8.conv3x3_s8(conv_s8.t_neighbours(torch.from_numpy(x)),
                             conv_s8.fold_depth(torch.from_numpy(k)))
    np.testing.assert_array_equal(got.reshape(want.shape).numpy(), want)


def test_int8_scene_predictor_multidate(family):
    """ScenePredictor(quant="int8") on a multi-date model: calibrated on
    the first stack, its mask equal to fabric_tpu's int8 runner on the
    same scales (float32, exactly); later stacks probed; packed serving
    equals scene by scene."""
    name, jfolded, _ = family
    cfg = Config(model=name, patch_size=PATCH, eval_batch_size=BATCH,
                 dtype="float32", model_base=BASE, num_dates=T)
    pred = ScenePredictor(cfg, bucket=16, device="cpu", quant="int8")
    load_variables(pred.model, *_variables(name))
    stacks = [_seq(6 + i, 1, *hw)[0] for i, hw in
              enumerate([(48, 32), (30, 20), (32, 32)])]
    seq = [pred.predict_multidate(s) for s in stacks]
    assert pred.last_clip_report  # the later stacks were probed
    apply_q = jq.make_int8_apply(jfolded, pred._scales, jnp.float32,
                                 model=name)
    run = jdt.make_scene_infer_multidate(apply_q, PATCH, (48, 32),
                                         num_dates=T, batch_size=BATCH,
                                         dtype=jnp.float32)
    want = np.asarray(run(None, jnp.asarray(stacks[0])))
    np.testing.assert_array_equal(seq[0], want)
    for pack in ("auto", 2):
        got = pred.predict_many_multidate(stacks, pack=pack)
        for a, b in zip(got, seq, strict=True):
            np.testing.assert_array_equal(a, b)
