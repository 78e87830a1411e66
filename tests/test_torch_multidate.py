"""The port's multi-date models (fabric_tpu_torch.models.unet_lstm,
unet3d), their weight bridge, tiling and serving against fabric_tpu on the
CPU, at model_base 8, patch 16 and T = 3 dates, inputs from numpy seeds,
weights bridged from fabric_tpu's trees.  Tolerances are stated with each
test."""

import json
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fabric_tpu.infer import device_tiling as jdt
from fabric_tpu.models.unet3d import UNet3D as JaxUNet3D
from fabric_tpu.models.unet_lstm import UNetLSTM as JaxUNetLSTM
from fabric_tpu.ops.fold_bn import _fold_tree, fold_batchnorm

from fabric_tpu_torch import Config
from fabric_tpu_torch import checkpoint as ckpt
from fabric_tpu_torch import weights
from fabric_tpu_torch.infer import device_tiling as tdt
from fabric_tpu_torch.infer.service import ScenePredictor
from fabric_tpu_torch.models import UNet3D, UNetLSTM, build_model
from fabric_tpu_torch.models.unet_lstm import multi_date_fuse
from fabric_tpu_torch.ops import fused

BASE, PATCH, BATCH, T = 8, 16, 8, 3
FAMILIES = {"unet_lstm": (JaxUNetLSTM, UNetLSTM),
            "unet3d": (JaxUNet3D, UNet3D)}
# float32: the two sides differ only in summation order (conv algorithms,
# the order of the 3-D conv's taps): ~1e-7 at logit scales of ~1.
FP32_ATOL = 1e-5
# bf16: XLA on the CPU keeps chains of bf16 elementwise ops (the gate
# nonlinearities, f*c + i*g, the product over T) in float32 and rounds
# once, where PyTorch rounds after each op; and fabric_tpu rounds each
# conv before adding a bf16 bias, where the port's conv kernels round
# once after the fp32 bias.  Over 20-odd layers that is a few bf16 ulps at
# the logit scale (measured: up to 0.016 at a scale of ~1.3).
BF16_ATOL = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_variables(name, seed=0):
    """fabric_tpu's tree of a multi-date family at base 8 (shapes from
    ``eval_shape``) with numpy values: lecun-scaled kernels, small biases,
    non-trivial BatchNorm."""
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
    return request.param, jax_variables(request.param)


def _port(name, variables, fold_bn, dtype):
    model = FAMILIES[name][1](13, 2, BASE, fold_bn=fold_bn, dtype=dtype)
    weights.load_variables(model, *variables)
    return model.eval()


def _seq(seed, n, h, w, t=T):
    return np.random.RandomState(seed).randn(n, t, h, w, 13).astype(
        np.float32)


def _jax_logits(name, variables, x, fold_bn, dtype):
    model = FAMILIES[name][0](base=BASE, fold_bn=fold_bn, dtype=dtype)
    v = ({"params": fold_batchnorm(*variables), "batch_stats": {}}
         if fold_bn else {"params": variables[0],
                          "batch_stats": variables[1]})
    return np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(
        v, x))


@pytest.mark.parametrize("fold_bn,dtype,atol", [
    (False, "float32", FP32_ATOL),
    (True, "float32", FP32_ATOL),
    (False, "bfloat16", BF16_ATOL),
    (True, "bfloat16", BF16_ATOL),
])
def test_forward_matches_fabric_tpu(family, fold_bn, dtype, atol):
    """The eval forward, BatchNorm folded (conv kernels' plain versions)
    and unfolded (eval-BatchNorm kernel's), against model.apply."""
    name, variables = family
    x = _seq(1, 2, PATCH, PATCH)
    want = _jax_logits(name, variables, x, fold_bn, getattr(jnp, dtype))
    model = _port(name, variables, fold_bn, getattr(torch, dtype))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (2, PATCH, PATCH, 2)
    err = np.abs(got - want).max()
    print(f"{name} fold_bn={fold_bn} {dtype}: max abs err {err:.3g} at "
          f"logit scale {np.abs(want).max():.3g}")
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_weight_bridge_round_trips(family):
    """load_variables then variables_of gives the tree back; the folded
    model holds fabric_tpu's folded leaves (the 3-D kernels too), bit for
    bit."""
    name, (params, stats) = family
    model = _port(name, (params, stats), False, torch.float32)
    got_p, got_s = weights.variables_of(model)
    flat = weights.flatten_tree
    assert flat(got_p).keys() == flat(params).keys()
    assert flat(got_s).keys() == flat(stats).keys()
    for k, v in {**flat(params), **flat(stats)}.items():
        np.testing.assert_array_equal({**flat(got_p), **flat(got_s)}[k], v)
    folded = _port(name, (params, stats), True, torch.float32)
    want = flat(_fold_tree(params, stats, 1e-5))
    got = flat(weights.variables_of(folded)[0])
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    if name == "unet3d":
        assert got["down1.conv1.kernel"].shape == (3, 3, 3, BASE, 2 * BASE)
    else:
        assert got["bottleneck_lstm.gates.kernel"].shape == (
            3, 3, 16 * BASE, 32 * BASE)


def test_init_variables_match_fabric_tpu_layout(family):
    """The port's fresh weights have fabric_tpu's tree, shapes and
    initialiser statistics, and build_model serves them."""
    name, (params, stats) = family
    p, s = weights.init_variables(13, 2, BASE, torch.Generator().manual_seed(
        0), model=name)
    shape = {k: v.shape for k, v in weights.flatten_tree(params).items()}
    assert {k: v.shape for k, v in weights.flatten_tree(p).items()} == shape
    assert ({k: v.shape for k, v in weights.flatten_tree(s).items()}
            == {k: v.shape for k, v in weights.flatten_tree(stats).items()})
    k = weights.flatten_tree(p)["up1.conv.conv1.kernel"]
    assert abs(k.std() * np.sqrt(np.prod(k.shape[:-1])) - 1) < 0.1
    cfg = Config(model=name, model_base=BASE, num_dates=T, dtype="float32")
    model = build_model(cfg, "cpu")
    assert model.fold_bn and not model.training
    with torch.inference_mode():
        assert model(torch.zeros(1, T, PATCH, PATCH, 13)).shape == (
            1, PATCH, PATCH, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_multi_date_fuse_at_two_dates_is_the_bidate_fusion(dtype):
    g = torch.Generator().manual_seed(0)
    a, b = (torch.randn(2, 5, 7, 16, generator=g).to(dtype)
            for _ in range(2))
    assert torch.equal(multi_date_fuse(torch.stack([a, b], dim=1)),
                       fused.fused_mul_relu(b, a))


@pytest.mark.parametrize("shape,overlap", [((40, 55), 0), ((41, 40), 6)])
def test_scene_multidate_matches_fabric_tpu(family, shape, overlap):
    """make_scene_infer_multidate in float32, grid and overlap mode: the
    mask equals fabric_tpu's exactly (logits ~1e-7 apart)."""
    name, variables = family
    scenes = _seq(2, 1, *shape)[0]
    jmodel = FAMILIES[name][0](base=BASE, fold_bn=True, dtype=jnp.float32)
    jrun = jdt.make_scene_infer_multidate(jmodel, PATCH, shape, num_dates=T,
                                          batch_size=BATCH, overlap=overlap,
                                          dtype=jnp.float32)
    want = np.asarray(jrun({"params": fold_batchnorm(*variables),
                            "batch_stats": {}}, jnp.asarray(scenes)))
    run = tdt.make_scene_infer_multidate(
        _port(name, variables, True, torch.float32), PATCH, shape,
        num_dates=T, batch_size=BATCH, overlap=overlap, dtype=torch.float32)
    got = run(torch.from_numpy(scenes)).numpy()
    assert 0 < got.mean() < 1
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="date stack"):
        run(torch.from_numpy(scenes[:2]))


def test_packed_multidate_matches_single_scene(family):
    name, variables = family
    shape = (32, 41)
    model = _port(name, variables, True, torch.float32)
    stacks = _seq(3, 2, *shape)
    single = tdt.make_scene_infer_multidate(model, PATCH, shape, num_dates=T,
                                            batch_size=BATCH,
                                            dtype=torch.float32)
    packed = tdt.make_packed_scene_infer(model, PATCH, shape, pack=3,
                                         batch_size=BATCH,
                                         dtype=torch.float32, num_dates=T)
    got = packed(torch.from_numpy(np.concatenate(
        [stacks, np.zeros_like(stacks[:1])])))
    assert got.shape == (3, *shape)
    for i in range(2):
        assert torch.equal(got[i], single(torch.from_numpy(stacks[i])))


def _save(variables, path):
    """A checkpoint of ``variables``, written by the port."""
    state = types.SimpleNamespace(step=0, opt_state={},
                                  variables=lambda: variables)
    ckpt.save(state, path, epoch=0)
    return path


def test_scene_predictor_multidate(family, tmp_path):
    """predict_multidate from a checkpoint equals fabric_tpu's runner on
    the bucket-padded stack (float32, exactly); predict_many_multidate,
    packed or not, equals it scene by scene; the bi-date calls are
    refused, and the other way round."""
    name, variables = family
    path = _save(variables, str(tmp_path / "ckpt"))
    cfg = Config(model=name, patch_size=PATCH, eval_batch_size=BATCH,
                 dtype="float32", model_base=BASE, num_dates=T)
    pred = ScenePredictor(cfg, checkpoint=path, bucket=32, device="cpu")
    stacks = [_seq(4 + i, 1, *hw)[0] for i, hw in
              enumerate([(45, 53), (30, 30), (20, 40)])]
    seq = [pred.predict_multidate(s) for s in stacks]
    padded = np.pad(stacks[0], [(0, 0), (0, 19), (0, 11), (0, 0)],
                    mode="edge")
    jmodel = FAMILIES[name][0](base=BASE, fold_bn=True, dtype=jnp.float32)
    want = np.asarray(jdt.make_scene_infer_multidate(
        jmodel, PATCH, (64, 64), num_dates=T, batch_size=BATCH,
        dtype=jnp.float32)({"params": fold_batchnorm(*variables),
                            "batch_stats": {}}, jnp.asarray(padded)))
    np.testing.assert_array_equal(seq[0], want[:45, :53])
    for pack in (0, "auto", 2):
        got = pred.predict_many_multidate(iter(stacks), pack=pack)
        for a, b in zip(got, seq, strict=True):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="predict_multidate"):
        pred.predict(stacks[0][0], stacks[0][1])
    with pytest.raises(ValueError, match="predict_many_multidate"):
        pred.predict_many([(stacks[0][0], stacks[0][1])])
    with pytest.raises(ValueError, match="bi-date model only"):
        ScenePredictor(Config(model=name, model_base=BASE, num_dates=T,
                              infer_overlap=8), device="cpu",
                       overlap_band_rows=2)
    bidate = ScenePredictor(Config(model_base=BASE, patch_size=PATCH),
                            device="cpu")
    for call in (bidate.predict_multidate,
                 bidate.predict_many_multidate):
        with pytest.raises(ValueError, match="multi-date model"):
            call(stacks[:1] if call is bidate.predict_many_multidate
                 else stacks[0])


def test_synthetic_multidate_dataset_matches_fabric_tpu(tmp_path):
    """num_dates=3: the same files, byte for byte, as fabric_tpu's
    generator (imgs_1..imgs_3, the change ramping up over the dates)."""
    from fabric_tpu.config import Config as JaxConfig
    from fabric_tpu.data.synthetic import generate_synthetic_dataset as jgen
    from fabric_tpu_torch.data.synthetic import generate_synthetic_dataset
    jgen(str(tmp_path / "j"), JaxConfig(), cities=["a"], sizes=[(20, 24)],
         seed=3, num_dates=3)
    generate_synthetic_dataset(str(tmp_path / "t"), Config(), cities=["a"],
                               sizes=[(20, 24)], seed=3, num_dates=3)
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "j")
                   for d, _, fs in os.walk(tmp_path / "j") for f in fs)
    assert any("imgs_3" in f for f in files) and len(files) == 3 * 13 + 3
    for f in files:
        with open(tmp_path / "j" / f, "rb") as a, \
                open(tmp_path / "t" / f, "rb") as b:
            assert a.read() == b.read(), f


@pytest.fixture(scope="module")
def dataset3(tmp_path_factory):
    from fabric_tpu_torch.data.synthetic import generate_synthetic_dataset
    root = tmp_path_factory.mktemp("d3")
    cfg = Config(dataset_dir=str(root / "data"))
    generate_synthetic_dataset(cfg.dataset_dir, cfg,
                               cities=["alpha", "beta", "gamma"],
                               sizes=[(40, 48), (36, 30), (50, 45)],
                               num_dates=T)
    return cfg.dataset_dir


@pytest.mark.parametrize("flags", [["--pack", "auto"], ["--pack", "2"], []])
def test_cli_infer_multidate(family, dataset3, tmp_path, flags):
    """cli.infer on a synthetic 3-date dataset: --pack streams the cities
    into packs and writes the masks predict_multidate gives city by city;
    without flags the reference path (the unfolded eval forward through
    infer_city) serves all T dates."""
    from fabric_tpu_torch.cli.infer import main
    from fabric_tpu_torch.data.image import read_png_gray
    from fabric_tpu_torch.infer.runner import infer_city
    name, variables = family
    path = _save(variables, str(tmp_path / "ckpt"))
    out, logs = tmp_path / "masks", tmp_path / "logs"
    common = ["--model", name, "--num_dates", str(T), "--dataset_dir",
              dataset3, "--patch_size", str(PATCH), "--eval_batch_size",
              str(BATCH), "--dtype", "float32", "--model_base", str(BASE)]
    assert main(common + ["--resume", path, "--log_dir", str(logs),
                          "--output_dir", str(out), "--device", "cpu",
                          "--bucket", "16", "--city", "alpha", "--city",
                          "beta", "--city", "gamma", *flags]) == 0
    cfg = Config(model=name, num_dates=T, dataset_dir=dataset3,
                 patch_size=PATCH, eval_batch_size=BATCH, dtype="float32",
                 model_base=BASE)
    if flags:
        pred = ScenePredictor(cfg, checkpoint=path, bucket=16, device="cpu")
        predict = pred.predict_city
    else:
        model = build_model(cfg, "cpu", fold_bn=False,
                            variables=ckpt.load_variables(
                                ckpt.resolve(path)))
        predict = lambda c: infer_city(model, cfg, c, device="cpu")  # noqa
    for city in ("alpha", "beta", "gamma"):
        got = read_png_gray(str(out / f"{city}_mask.png")) // 255
        np.testing.assert_array_equal(got, predict(city))
    recs = [json.loads(x) for x in
            (next(logs.iterdir()) / "metrics.jsonl").read_text().splitlines()]
    assert [r["serve_scene"] for r in recs] == ["alpha", "beta", "gamma"]
    if flags:
        assert all(r["serve_packed"] >= 1 for r in recs)
