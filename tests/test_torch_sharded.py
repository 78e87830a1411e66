"""The port's sharded serving (fabric_tpu_torch.infer.sharded_scene,
infer.fullconv.make_sharded_fullconv_infer, the tile-batch mesh split of
infer.device_tiling, ScenePredictor(mesh, shard_scene), cli.infer
--shard_scene) on meshes of n = 1, 2 and 4 CPU "devices" (``[cpu] * n``),
at base 8 on bridged weights, inputs from numpy seeds.

Within the port the sharded masks are held to the single-device masks bit
for bit, bf16 and int8: every kernel computes each image on its own, and a
shard's tiles or context windows are the ones the single-device runner
cuts.  Against fabric_tpu's sharded functions on the 8-device XLA CPU mesh
of tests/conftest.py (bf16) the rule of the fullconv parity tests holds: a
mask pixel may differ only where the port's logit margin is below 0.1."""

import json
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fabric_tpu.infer import fullconv as jfc
from fabric_tpu.infer import sharded_scene as jss
from fabric_tpu.models import BiDateNet as JaxBiDateNet
from fabric_tpu.ops.fold_bn import fold_batchnorm
from fabric_tpu.parallel.mesh import make_mesh as jax_make_mesh

from fabric_tpu_torch import Config
from fabric_tpu_torch import checkpoint as ckpt
from fabric_tpu_torch.infer import device_tiling as tdt
from fabric_tpu_torch.infer import fullconv as fc
from fabric_tpu_torch.infer import quant as tq
from fabric_tpu_torch.infer import sharded_scene as ss
from fabric_tpu_torch.infer.service import ScenePredictor
from fabric_tpu_torch.models import BiDateNet
from fabric_tpu_torch.parallel.mesh import Mesh, make_mesh
from fabric_tpu_torch.weights import load_variables

BASE, PATCH, BATCH = 8, 16, 8
FLIP_MARGIN = 0.1  # a bf16 mask flip only below this logit margin
GRID = (128, 48)   # n * patch divides 128 for n = 1, 2, 4
FC = (256, 40)     # fullconv: a shard's band (64 rows at n = 4) >= 2*halo
FC_BAND, FC_HALO = 64, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def variables():
    """fabric_tpu's BiDateNet tree at base 8 with numpy values."""
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


def _port(variables, local_upsample=False, dtype=torch.bfloat16):
    model = BiDateNet(13, 2, BASE, fold_bn=True, dtype=dtype,
                      local_upsample=local_upsample)
    load_variables(model, *variables)
    return model.eval()


def _int8(model, seed):
    """The int8 forward of ``model``, calibrated on crops of a seeded
    pair."""
    folded = tq.folded_params(model)
    crops = _pair(seed, 3 * PATCH, PATCH)
    scales = tq.calibrate(folded, [tuple(c.reshape(3, PATCH, PATCH, 13)
                                         for c in crops)])
    return tq.make_int8_apply(folded, scales,
                              local_upsample=model.local_upsample)


def _pair(seed, h, w):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(h, w, 13).astype(np.float32) for _ in range(2))


def _mesh(n):
    return make_mesh(n, devices=["cpu"] * n)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# --- the sharded runners, bit-equal to the single-device ones ---------------

@pytest.mark.parametrize("quant", ["none", "int8"])
def test_sharded_grid_equals_single_device(variables, quant):
    """Sharded grid (H-bands over n = 1, 2, 4 shards) and the tile-batch
    split over the mesh: the single-device grid mask, bf16 and int8; the
    scene given whole or as put_scene_sharded bands."""
    model = _port(variables)
    fwd = model if quant == "none" else _int8(model, 1)
    d1, d2 = _pair(2, *GRID)
    want = tdt.make_scene_infer(fwd, PATCH, GRID, batch_size=BATCH)(
        *_t(d1, d2)).numpy()
    assert 0 < want.mean() < 1
    for n in (1, 2, 4):
        mesh = _mesh(n)
        run = ss.make_sharded_scene_infer(fwd, PATCH, GRID, mesh,
                                          batch_size=BATCH)
        np.testing.assert_array_equal(run(d1, d2).numpy(), want)
        bands = [ss.put_scene_sharded(d, mesh, torch.bfloat16)
                 for d in (d1, d2)]
        assert [b.shape for b in bands[0]] == [(GRID[0] // n, GRID[1], 13)] * n
        assert bands[0][0].dtype == torch.bfloat16
        np.testing.assert_array_equal(run(*bands).numpy(), want)
        split = tdt.make_scene_infer(fwd, PATCH, GRID, batch_size=BATCH,
                                     mesh=mesh)
        np.testing.assert_array_equal(split(*_t(d1, d2)).numpy(), want)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_sharded_fullconv_equals_single_device(variables, quant):
    """Sharded fullconv over n = 1, 2, 4 shards (halos copied from the
    neighbours, zeros past the scene): the single-device fullconv mask of
    the same band rows and halo, bf16 and int8."""
    model = _port(variables, local_upsample=True)
    fwd = model if quant == "none" else _int8(model, 3)
    d1, d2 = _pair(4, *FC)
    want = fc.make_fullconv_scene_infer(fwd, FC, band_rows=FC_BAND,
                                        halo=FC_HALO)(*_t(d1, d2)).numpy()
    assert 0 < want.mean() < 1
    for n in (1, 2, 4):
        run = fc.make_sharded_fullconv_infer(fwd, FC, _mesh(n),
                                             band_rows=FC_BAND, halo=FC_HALO)
        got = run(d1, d2)
        assert got.device.type == "cpu" and got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)


def test_sharded_fullconv_insufficient_halo_breaks_equality(variables):
    """With a halo of 16 px, far below the 109-px receptive field, the
    sharded mask is not the whole-scene forward's."""
    model = _port(variables, local_upsample=True, dtype=torch.float32)
    d1, d2 = _pair(5, *FC)
    with torch.inference_mode():
        whole = fc._mask(model(*(fc._edge_pad(t, 256, 48)[None]
                                 for t in _t(d1, d2))))[0, :, :40]
    run = fc.make_sharded_fullconv_infer(model, FC, _mesh(4), band_rows=32,
                                         halo=16, dtype=torch.float32)
    assert (run(d1, d2) != whole).any()


# --- against fabric_tpu's sharded functions ----------------------------------

def _margin(logits):
    return np.abs(logits[..., 1] - logits[..., 0])


def _grid_logits(model, d1, d2):
    """The port's per-pixel logits of the aligned grid: each tile's
    forward."""
    h, w = d1.shape[:2]
    ys = np.arange(0, h, PATCH)
    xs = np.arange(0, w, PATCH)
    with torch.inference_mode():
        t1, t2 = (tdt._gather_tiles(t.to(torch.bfloat16), ys, xs, PATCH)
                  for t in _t(d1, d2))
        lg = model(t1, t2).float().numpy()
    return lg.reshape(len(ys), len(xs), PATCH, PATCH, 2).transpose(
        0, 2, 1, 3, 4).reshape(h, w, 2)


def _held(got, want, logits):
    flips = got != want
    print(f"{int(flips.sum())} of {flips.size} pixels differ")
    assert flips.mean() < 1e-2
    assert (_margin(logits)[flips] < FLIP_MARGIN).all()


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_grid_matches_fabric_tpu(variables, n):
    """fabric_tpu's make_sharded_scene_infer on n XLA CPU devices and the
    port's on n CPU shards, bf16, the same weights: equal masks but for
    flips under the 0.1 logit margin."""
    d1, d2 = _pair(6, *GRID)
    jmodel = JaxBiDateNet(base=BASE, dtype=jnp.bfloat16, fold_bn=True)
    jrun = jss.make_sharded_scene_infer(
        jmodel, PATCH, GRID, jax_make_mesh(data=n, devices=jax.devices()[:n]),
        batch_size=BATCH)
    want = np.asarray(jrun({"params": fold_batchnorm(*variables),
                            "batch_stats": {}}, jnp.asarray(d1),
                           jnp.asarray(d2)))
    model = _port(variables)
    got = ss.make_sharded_scene_infer(model, PATCH, GRID, _mesh(n),
                                      batch_size=BATCH)(d1, d2).numpy()
    _held(got, want, _grid_logits(model, d1, d2))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_fullconv_matches_fabric_tpu(variables, n):
    """fabric_tpu's make_sharded_fullconv_infer on n XLA CPU devices and
    the port's on n CPU shards, bf16, halo 128 (it covers the receptive
    field, so the masks are the whole-scene forward's and the margins are
    read from it): equal but for flips under the 0.1 logit margin."""
    shape = (max(n, 2) * 256, 32)
    d1, d2 = _pair(7, *shape)
    jmodel = JaxBiDateNet(base=BASE, dtype=jnp.bfloat16, fold_bn=True,
                          local_upsample=True)
    jrun = jfc.make_sharded_fullconv_infer(
        jmodel, shape, jax_make_mesh(data=n, devices=jax.devices()[:n]),
        band_rows=128, halo=128)
    want = np.asarray(jrun({"params": fold_batchnorm(*variables),
                            "batch_stats": {}}, jnp.asarray(d1),
                           jnp.asarray(d2)))
    model = _port(variables, local_upsample=True)
    got = fc.make_sharded_fullconv_infer(model, shape, _mesh(n),
                                         band_rows=128, halo=128)(
        d1, d2).numpy()
    with torch.inference_mode():
        logits = model(*(t[None] for t in _t(d1, d2)))[0].float().numpy()
    _held(got, want, logits)


# --- guards ------------------------------------------------------------------

def test_sharded_guards(variables):
    """fabric_tpu's refusals (tests/test_fullconv.py:345-372 and the grid
    constraints of infer/sharded_scene.py:48-55)."""
    model = _port(variables, local_upsample=True)
    mesh = _mesh(8)
    with pytest.raises(ValueError, match="2\\*halo"):
        fc.make_sharded_fullconv_infer(model, (1024, 64), mesh)
    with pytest.raises(ValueError, match="divide"):
        fc.make_sharded_fullconv_infer(model, (2052, 64), mesh)
    with pytest.raises(ValueError, match="multiple of 16"):
        fc.make_sharded_fullconv_infer(model, (8 * 264, 64), mesh, halo=64)
    with pytest.raises(ValueError, match="local_upsample"):
        fc.make_sharded_fullconv_infer(_port(variables), (2048, 64), mesh)
    with pytest.raises(ValueError, match="patch-aligned bands"):
        ss.make_sharded_scene_infer(model, PATCH, (8 * PATCH + 8, 64), mesh)
    with pytest.raises(ValueError, match="multiple of patch"):
        ss.make_sharded_scene_infer(model, PATCH, (8 * PATCH, 60), mesh)
    with pytest.raises(ValueError, match="divide over"):
        tdt.make_scene_infer(model, PATCH, GRID, batch_size=6, mesh=_mesh(4))
    with pytest.raises(ValueError, match="needs 3 devices, have 2"):
        make_mesh(3, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(-1, spatial=2, devices=["cpu"] * 3)
    assert make_mesh(devices=["cpu"] * 4).shape == {
        "data": 4, "spatial": 1, "model": 1}


def test_make_mesh_without_devices_needs_a_card():
    """make_mesh() lays the mesh over the visible cards: on a host without
    one it raises instead of building a mesh of the CPU."""
    if torch.cuda.is_available():
        pytest.skip("holds the refusal on a host without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(1, spatial=2)


def _cfg(**kw):
    return Config(patch_size=PATCH, eval_batch_size=BATCH, model_base=BASE,
                  **kw)


def test_predictor_sharded_guards_and_buckets():
    """ScenePredictor's guards and bucket alignment, as fabric_tpu's
    (infer/service.py:150-209): n * patch for grid, n * 256 for fullconv."""
    mesh = _mesh(2)
    for kw, match in ((dict(shard_scene=True), "requires a mesh"),
                      (dict(shard_scene=True, fullconv_band_rows=96,
                            fullconv_stream=True, mesh=mesh), "ONE device"),
                      (dict(mesh=mesh, fullconv_band_rows=96),
                       "fullconv_band_rows"),
                      (dict(shard_scene=True, mesh=mesh,
                            overlap_band_rows=2), "overlap_band_rows")):
        with pytest.raises(ValueError, match=match):
            ScenePredictor(_cfg(infer_overlap=8 if "overlap_band_rows" in kw
                                else 0), device="cpu", **kw)
    with pytest.raises(ValueError, match="grid and fullconv"):
        ScenePredictor(_cfg(infer_overlap=8), device="cpu", mesh=mesh,
                       shard_scene=True)
    with pytest.raises(ValueError, match="bidate"):
        ScenePredictor(_cfg(model="unet3d", num_dates=3), device="cpu",
                       mesh=mesh, shard_scene=True)
    with pytest.raises(ValueError, match="bidate"):
        ScenePredictor(_cfg(model="unet3d", num_dates=3), device="cpu",
                       mesh=mesh, shard_scene=True, fullconv_band_rows=96)
    # the spatial and model axes hold replicas: one data shard here
    spatial = ScenePredictor(_cfg(), device="cpu",
                             mesh=Mesh(["cpu"] * 2, {"data": 1,
                                                     "spatial": 2}))
    assert spatial.mesh.data_devices() == [torch.device("cpu")]
    for bucket, fullconv, want in ((0, 0, 32), (50, 0, 64), (512, 0, 512),
                                   (0, 96, 512), (300, 96, 512),
                                   (600, 96, 1024)):
        pred = ScenePredictor(_cfg(), device="cpu", mesh=mesh,
                              shard_scene=True, bucket=bucket,
                              fullconv_band_rows=fullconv)
        assert pred.bucket == want, (bucket, fullconv)
        assert pred.serving_mode() == ("sharded_fullconv" if fullconv
                                       else "sharded_grid")


class _Records:
    def __init__(self):
        self.rows = []

    def log_metrics(self, rec, step=None, prefix=""):
        self.rows.append({prefix + k: v for k, v in rec.items()})


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_predictor_sharded_grid_serves_like_one_device(quant):
    """predict with shard_scene over 2 shards, and with the tile-batch
    split over a 4-shard mesh: the unsharded predictor's masks at the same
    bucket (int8: the same self-calibration); the records say the mode."""
    rec = _Records()
    pairs = [_pair(8, 100, 70), _pair(9, 64, 32)]
    one = ScenePredictor(_cfg(), device="cpu", bucket=32, quant=quant)
    sharded = ScenePredictor(_cfg(), device="cpu", bucket=32, quant=quant,
                             mesh=_mesh(2), shard_scene=True, tracker=rec)
    split = ScenePredictor(_cfg(), device="cpu", bucket=32, quant=quant,
                           mesh=_mesh(4))
    for pair in pairs:
        want = one.predict(*pair)
        np.testing.assert_array_equal(sharded.predict(*pair), want)
        np.testing.assert_array_equal(split.predict(*pair), want)
    assert {r["serve_mode"] for r in rec.rows} == {"sharded_grid"}
    many = sharded.predict_many(pairs)
    for m, pair in zip(many, pairs):
        np.testing.assert_array_equal(m, one.predict(*pair))


@pytest.fixture(scope="module")
def dataset(variables, tmp_path_factory):
    """(dataset dir, checkpoint dir): two synthetic cities and the
    variables in a checkpoint the port writes."""
    from fabric_tpu_torch.data.synthetic import generate_synthetic_dataset
    root = tmp_path_factory.mktemp("sharded")
    generate_synthetic_dataset(str(root / "data"), Config(),
                               cities=["alpha", "beta"],
                               sizes=[(40, 48), (36, 30)])
    state = types.SimpleNamespace(step=0, opt_state={},
                                  variables=lambda: variables)
    ckpt.save(state, str(root / "ckpt"), epoch=0)
    return str(root / "data"), str(root / "ckpt")


def test_cli_infer_shard_scene(dataset, tmp_path):
    """cli.infer --shard_scene --mesh_data 2 --device cpu: the masks of
    ScenePredictor(shard_scene) on the same mesh, sharded_grid records;
    with --mesh_model 2 (item 10c, ported) the model axis holds replicas
    and the scene is sharded over the one data device: the masks of the
    data-only mesh of 1."""
    from fabric_tpu_torch.cli.infer import main
    from fabric_tpu_torch.data.image import read_png_gray
    data, resume = dataset
    out = tmp_path / "masks"
    args = ["--dataset_dir", data, "--resume", resume, "--patch_size",
            str(PATCH), "--eval_batch_size", str(BATCH), "--dtype",
            "bfloat16", "--model_base", str(BASE), "--log_dir",
            str(tmp_path / "logs"), "--output_dir", str(out), "--device",
            "cpu", "--city", "alpha", "--city", "beta"]
    assert main(args + ["--shard_scene", "--mesh_data", "2"]) == 0
    cfg = _cfg(dataset_dir=data, dtype="bfloat16")
    pred = ScenePredictor(cfg, checkpoint=resume, device="cpu",
                          mesh=_mesh(2), shard_scene=True)
    assert pred.bucket == 512
    for city in ("alpha", "beta"):
        mask = read_png_gray(str(out / f"{city}_mask.png")) // 255
        np.testing.assert_array_equal(mask, pred.predict_city(city))
    run = next((tmp_path / "logs").iterdir())
    recs = [json.loads(x) for x in (run / "metrics.jsonl").read_text()
            .splitlines()]
    assert {r["serve_mode"] for r in recs} == {"sharded_grid"}
    model = tmp_path / "model"
    assert main([str(model) if a == str(out) else a for a in args]
                + ["--shard_scene", "--mesh_model", "2"]) == 0
    one = ScenePredictor(cfg, checkpoint=resume, device="cpu",
                         mesh=_mesh(1), shard_scene=True)
    for city in ("alpha", "beta"):
        mask = read_png_gray(str(model / f"{city}_mask.png")) // 255
        np.testing.assert_array_equal(mask, one.predict_city(city))
