"""The port's other tiled serving modes (fabric_tpu_torch.infer:
overlap-averaged stitching, banded overlap, fleet packing; ScenePredictor
and cli.infer) against fabric_tpu on the CPU, at model_base 8 and patch
16, inputs from numpy seeds, the bi-date model on bridged weights.  The
tolerances are stated with each test: the coset sums and the masks
exactly, the banded and packed modes exactly equal to their unbanded and
unpacked forms."""

import json
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fabric_tpu.infer import device_tiling as jdt
from fabric_tpu.models import BiDateNet as JaxBiDateNet
from fabric_tpu.ops.fold_bn import fold_batchnorm

from fabric_tpu_torch import Config
from fabric_tpu_torch import checkpoint as ckpt
from fabric_tpu_torch.infer import device_tiling as tdt
from fabric_tpu_torch.infer.service import ScenePredictor
from fabric_tpu_torch.models import BiDateNet
from fabric_tpu_torch.weights import load_variables

BASE, PATCH, BATCH = 8, 16, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small PyTorch ops: one thread, not a pool per op shared by the
    test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def variables():
    """fabric_tpu's BiDateNet tree at base 8 (shapes from ``eval_shape``)
    with numpy values: lecun-scaled kernels, small biases, non-trivial
    BatchNorm."""
    model = JaxBiDateNet(base=BASE)
    x = jnp.zeros((1, PATCH, PATCH, 13), jnp.float32)
    shapes = jax.eval_shape(lambda k: model.init(k, x, x, train=False),
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)

    def value(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return (rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))).astype(
                np.float32)
        if name in ("bias", "mean"):
            return (rng.randn(*shape) * 0.1).astype(np.float32)
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)

    v = jax.tree_util.tree_map_with_path(value, shapes)
    return v["params"], v["batch_stats"]


@pytest.fixture(scope="module")
def port_model(variables):
    model = BiDateNet(13, 2, BASE, fold_bn=True, dtype=torch.float32)
    load_variables(model, *variables)
    return model.eval()


def _scenes(seed, shape, n=2):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape, 13).astype(np.float32) for _ in range(n)]


class _Records:
    """A tracker that keeps the records it is given."""

    def __init__(self):
        self.rows = []

    def log_metrics(self, rec, step=None, prefix=""):
        self.rows.append({prefix + k: v for k, v in rec.items()})


@pytest.mark.parametrize("h,w,patch,stride", [
    (40, 55, 16, 8),    # regular cosets and an edge stop on each axis
    (48, 48, 16, 5),    # stride not dividing the patch: m = 4, d = 20
    (41, 40, 16, 12),
    (37, 70, 8, 3),     # m = 3 cosets, edge stops
    (16, 33, 16, 4),    # one row of tiles
])
def test_coset_overlap_add_matches_fabric_tpu(h, w, patch, stride):
    """The fp32 canvas of overlapping tiles, summed coset by coset: equal
    to fabric_tpu's bit for bit (the same adds in the same order)."""
    ys = tdt._axis_positions(h, patch, stride)
    xs = tdt._axis_positions(w, patch, stride)
    tiles = np.random.RandomState(h * w).uniform(
        0, 1, (len(ys), len(xs), patch, patch)).astype(np.float32)
    want = np.asarray(jdt._coset_overlap_add(jnp.asarray(tiles), ys, xs, h,
                                             w, patch, stride))
    got = tdt._coset_overlap_add(torch.from_numpy(tiles), ys, xs, h, w,
                                 patch, stride).numpy()
    np.testing.assert_array_equal(got, want)
    ones = tdt._coset_overlap_add(torch.ones(tiles.shape), ys, xs, h, w,
                                  patch, stride).numpy()
    assert ones.min() >= 1  # every pixel is covered


@pytest.mark.parametrize("shape,overlap", [((40, 55), 8), ((41, 40), 5)])
def test_overlap_mask_matches_fabric_tpu(variables, port_model, shape,
                                         overlap):
    """Overlap mode in float32: the mask equals fabric_tpu's
    make_scene_infer(overlap) on the same folded weights exactly (the
    logits differ by ~1e-6, far from a 0.5 tie of the averaged
    probability)."""
    d1, d2 = _scenes(1, shape)
    jmodel = JaxBiDateNet(base=BASE, fold_bn=True, split_up_concat=True,
                          dtype=jnp.float32)
    jrun = jdt.make_scene_infer(jmodel, PATCH, shape, batch_size=BATCH,
                                overlap=overlap, dtype=jnp.float32)
    want = np.asarray(jrun({"params": fold_batchnorm(*variables),
                            "batch_stats": {}}, jnp.asarray(d1),
                           jnp.asarray(d2)))
    run = tdt.make_scene_infer(port_model, PATCH, shape, batch_size=BATCH,
                               overlap=overlap, dtype=torch.float32)
    got = run(torch.from_numpy(d1), torch.from_numpy(d2)).numpy()
    assert got.dtype == np.uint8 and 0 < got.mean() < 1
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,band_rows", [((40, 55), 2), ((48, 48), 3),
                                             ((41, 40), 1), ((40, 40), 99)])
def test_banded_overlap_matches_unbanded(port_model, shape, band_rows):
    """Banded overlap accumulation reproduces the unbanded mask exactly,
    at fabric_tpu's cases (tests/test_device_tiling.py): tail bands, the
    edge-anchored stop row, more band rows than the grid has."""
    d1, d2 = (torch.from_numpy(d) for d in _scenes(2, shape))
    ref = tdt.make_scene_infer(port_model, PATCH, shape, batch_size=BATCH,
                               overlap=8, dtype=torch.float32)(d1, d2)
    banded = tdt.make_banded_overlap_infer(
        port_model, PATCH, shape, batch_size=BATCH, overlap=8,
        band_tile_rows=band_rows, dtype=torch.float32)
    assert torch.equal(banded(d1, d2), ref)


def test_banded_overlap_rejects_grid_mode(port_model):
    with pytest.raises(ValueError, match="grid mode"):
        tdt.make_banded_overlap_infer(port_model, PATCH, (40, 40), overlap=0)


def test_packed_matches_single_scene(port_model):
    """Fleet packing: each scene's mask equals its own grid run exactly,
    with edge tiles (40x55 is not a multiple of 16) and a zero scene in
    the slot that no scene fills."""
    shape = (40, 55)
    pairs = [_scenes(3 + i, shape) for i in range(3)]
    single = tdt.make_scene_infer(port_model, PATCH, shape, batch_size=BATCH,
                                  dtype=torch.float32)
    want = [single(*(torch.from_numpy(d) for d in p)) for p in pairs]
    packed = tdt.make_packed_scene_infer(port_model, PATCH, shape, pack=4,
                                         batch_size=BATCH,
                                         dtype=torch.float32)
    zero = np.zeros((*shape, 13), np.float32)
    got = packed(*(torch.from_numpy(np.stack([p[i] for p in pairs] + [zero]))
                   for i in (0, 1)))
    assert got.shape == (4, *shape)
    for i in range(3):
        assert torch.equal(got[i], want[i])


@pytest.fixture(scope="module")
def bidate_ckpt(variables, tmp_path_factory):
    """The variables in a checkpoint the port writes."""
    path = str(tmp_path_factory.mktemp("bidate_ckpt"))
    state = types.SimpleNamespace(step=0, opt_state={},
                                  variables=lambda: variables)
    ckpt.save(state, path, epoch=0)
    return path


def test_predict_many_packed_equals_predict(bidate_ckpt):
    """predict_many(pack=N | "auto") equals predict scene by scene, bit for
    bit, over mixed buckets (bf16), from a lazy iterator, with partial
    packs; each record says its pack."""
    cfg = Config(patch_size=PATCH, eval_batch_size=BATCH, dtype="bfloat16",
                 model_base=BASE)
    pred = ScenePredictor(cfg, checkpoint=bidate_ckpt, bucket=32,
                          device="cpu", tracker=_Records())
    pairs = [tuple(_scenes(10 + i, hw)) for i, hw in enumerate(
        [(45, 53), (30, 30), (70, 140), (64, 40), (20, 20), (33, 31)])]
    want = [pred.predict(*p) for p in pairs]
    for pack, window in (("auto", 2), (2, 1), (3, 2)):
        pred.tracker.rows.clear()
        got = pred.predict_many((p for p in pairs), window=window, pack=pack,
                                scene_ids=list("abcdef"))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        packs = {r["serve_scene"]: r["serve_packed"]
                 for r in pred.tracker.rows}
        assert sorted(packs) == list("abcdef")
        if pack == "auto":
            # tiles per scene in the 32^2 bucket: 4, so 2 scenes fill 8
            assert packs["b"] == 2 and packs["e"] == 2 and packs["c"] == 1
        else:
            assert set(packs.values()) == {pack}
        assert {r["serve_mode"] for r in pred.tracker.rows} == {"grid"}


def test_packing_refused_in_non_grid_modes():
    cfg = Config(patch_size=PATCH, eval_batch_size=BATCH, dtype="float32",
                 model_base=BASE, infer_overlap=8)
    pair = tuple(_scenes(5, (32, 32)))
    for rows in (0, 2):
        pred = ScenePredictor(cfg, bucket=0, device="cpu",
                              overlap_band_rows=rows)
        with pytest.raises(ValueError, match="grid tiling mode only"):
            pred.predict_many([pair], pack=2)
    with pytest.raises(ValueError, match="pack must be"):
        ScenePredictor(Config(patch_size=PATCH, model_base=BASE,
                              dtype="float32"), device="cpu").predict_many(
            [pair], pack=0.5)


def test_serving_mode_and_banded_predictor(bidate_ckpt):
    """ScenePredictor's overlap modes: the banded predictor serves the
    unbanded masks, and each record names its mode (no longer always
    "grid"); overlap_band_rows needs overlap mode."""
    pair = tuple(_scenes(6, (45, 70)))
    masks, modes = [], []
    for overlap, rows in ((0, 0), (8, 0), (8, 2), (8, 1)):
        cfg = Config(patch_size=PATCH, eval_batch_size=BATCH, dtype="float32",
                     model_base=BASE, infer_overlap=overlap)
        pred = ScenePredictor(cfg, checkpoint=bidate_ckpt, bucket=0,
                              device="cpu", overlap_band_rows=rows,
                              tracker=_Records())
        masks.append(pred.predict(*pair))
        modes.append(pred.tracker.rows[0]["serve_mode"])
    assert modes == ["grid", "overlap", "banded_overlap", "banded_overlap"]
    np.testing.assert_array_equal(masks[2], masks[1])
    np.testing.assert_array_equal(masks[3], masks[1])
    with pytest.raises(ValueError, match="infer_overlap"):
        ScenePredictor(Config(patch_size=PATCH, model_base=BASE,
                              dtype="float32"), device="cpu",
                       overlap_band_rows=2)


@pytest.fixture(scope="module")
def dataset3(bidate_ckpt, tmp_path_factory):
    """A synthetic 3-date dataset of three small cities."""
    from fabric_tpu_torch.data.synthetic import generate_synthetic_dataset
    root = tmp_path_factory.mktemp("d3")
    cfg = Config(dataset_dir=str(root / "data"))
    generate_synthetic_dataset(cfg.dataset_dir, cfg,
                               cities=["alpha", "beta", "gamma"],
                               sizes=[(40, 48), (36, 30), (50, 45)],
                               num_dates=3)
    return cfg.dataset_dir


def _cli(dataset_dir, resume, tmp_path, *extra):
    from fabric_tpu_torch.cli.infer import main
    out = tmp_path / "masks"
    args = ["--dataset_dir", dataset_dir, "--resume", resume,
            "--patch_size", str(PATCH), "--eval_batch_size", str(BATCH),
            "--dtype", "float32", "--model_base", str(BASE),
            "--log_dir", str(tmp_path / "logs"), "--output_dir", str(out),
            "--device", "cpu", "--bucket", "16",
            "--city", "alpha", "--city", "beta", "--city", "gamma", *extra]
    assert main(args) == 0
    from fabric_tpu_torch.data.image import read_png_gray
    run = next((tmp_path / "logs").iterdir())
    recs = [json.loads(x) for x in (run / "metrics.jsonl").read_text()
            .splitlines()]
    return ({c: read_png_gray(str(out / f"{c}_mask.png")) // 255
             for c in ("alpha", "beta", "gamma")}, recs)


def test_cli_infer_banded_overlap(dataset3, bidate_ckpt, tmp_path):
    """cli.infer --overlap_band_rows on the 3-date dataset (the bi-date
    model takes its first two dates): the unbanded overlap masks."""
    masks, recs = _cli(dataset3, bidate_ckpt, tmp_path, "--infer_overlap",
                       "8", "--overlap_band_rows", "2")
    cfg = Config(dataset_dir=dataset3, patch_size=PATCH,
                 eval_batch_size=BATCH, dtype="float32", model_base=BASE,
                 infer_overlap=8)
    pred = ScenePredictor(cfg, checkpoint=bidate_ckpt, bucket=16,
                          device="cpu")
    for city, mask in masks.items():
        np.testing.assert_array_equal(mask, pred.predict_city(city))
    assert {r["serve_mode"] for r in recs} == {"banded_overlap"}
