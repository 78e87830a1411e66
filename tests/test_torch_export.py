"""Serving bundles in the port (fabric_tpu_torch.tools.export,
ScenePredictor(bundle=...), tools.validate_int8 --bundle) against
fabric_tpu's on the CPU, at patch 16 and base 8 on 40x56 and 64x48
scenes: a bundle of either package serves in either package.  The
weights are the port's fresh initialisation with non-trivial BatchNorm,
in a checkpoint written by the port (fabric_tpu's format)."""

import json
import os

import numpy as np
import pytest
import torch

from fabric_tpu.config import Config as JaxConfig
from fabric_tpu.infer.service import ScenePredictor as JaxPredictor
from fabric_tpu.tools import export as jexport

from fabric_tpu_torch import Config
from fabric_tpu_torch import checkpoint as ckpt
from fabric_tpu_torch import weights
from fabric_tpu_torch.infer.service import ScenePredictor
from fabric_tpu_torch.models import build_model
from fabric_tpu_torch.tools import export as texport

# int8 scales: absmax / 127 of the float32 calibration forward, taken in
# another summation order (tests/test_torch_quant.py SCALE_RTOL)
SCALE_RTOL = 1e-5
SMALL = dict(patch_size=16, dtype="float32", model_base=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def perturbed_variables(model: str = "bidate", seed: int = 0):
    """Fresh base-8 variables of ``model`` with non-trivial BatchNorm."""
    params, stats = weights.init_variables(
        13, 2, 8, torch.Generator().manual_seed(seed), model)
    rng = np.random.RandomState(seed)

    def perturb(p, s):
        for key, value in p.items():
            if key.startswith("bn"):
                c = value["scale"].shape[0]
                value["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                value["bias"] = (rng.randn(c) * 0.1).astype(np.float32)
                s[key]["mean"] = (rng.randn(c) * 0.1).astype(np.float32)
                s[key]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            elif isinstance(value, dict):
                perturb(value, s.get(key, {}))
    perturb(params, stats)
    return params, stats


def save_checkpoint(cfg, directory: str, seed: int = 0) -> str:
    """A checkpoint of perturbed weights written by the port."""
    from fabric_tpu_torch.train.state import create_state
    model = build_model(cfg, "cpu", fold_bn=False, train=True,
                        variables=perturbed_variables(cfg.model, seed))
    ckpt.save(create_state(cfg, model), directory, epoch=0)
    return directory


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    return save_checkpoint(Config(**SMALL),
                           str(tmp_path_factory.mktemp("run")))


@pytest.fixture(scope="module")
def bundles(run_dir, tmp_path_factory):
    """{(package, quant): path} of bundles of ``run_dir`` written by
    fabric_tpu and by the port."""
    d = tmp_path_factory.mktemp("bundles")
    out = {}
    for quant in ("none", "int8"):
        out["jax", quant] = str(d / f"jax_{quant}.npz")
        jexport.export_bundle(JaxConfig(**SMALL), run_dir, out["jax", quant],
                              quant=quant)
        out["torch", quant] = str(d / f"torch_{quant}.npz")
        texport.export_bundle(Config(**SMALL), run_dir, out["torch", quant],
                              quant=quant, device="cpu")
    return out


def _pair(seed, h=40, w=56):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(h, w, 13).astype(np.float32) for _ in range(2))


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(tree[k])


def test_fabric_tpu_bundle_serves_in_port(run_dir, bundles):
    """fabric_tpu's bundle, exact and int8, serves in the port with the
    masks of the port's checkpoint path on the same weights (int8: at the
    bundle's scales, which seed the forward: nothing calibrates)."""
    cfg = Config(**SMALL, eval_batch_size=8)
    d1, d2 = _pair(1)
    from_ckpt = ScenePredictor(cfg, checkpoint=run_dir, bucket=32,
                               device="cpu")
    served = ScenePredictor(cfg, bundle=bundles["jax", "none"], bucket=32,
                            device="cpu")
    assert served.quant == "none"
    np.testing.assert_array_equal(served.predict(d1, d2),
                                  from_ckpt.predict(d1, d2))

    _, scales, _ = jexport.load_bundle(bundles["jax", "int8"])
    served = ScenePredictor(cfg, bundle=bundles["jax", "int8"], bucket=32,
                            device="cpu")
    assert served.quant == "int8" and served._scales == scales
    from_ckpt = ScenePredictor(cfg, checkpoint=run_dir, bucket=32,
                               device="cpu", quant="int8")
    from_ckpt._use_scales(scales)
    np.testing.assert_array_equal(served.predict(d1, d2),
                                  from_ckpt.predict(d1, d2))
    assert served._scales == scales  # the first scene did not calibrate
    # quant="none" serves an int8 bundle exactly
    exact = ScenePredictor(cfg, bundle=bundles["jax", "int8"], bucket=32,
                           device="cpu", quant="none")
    assert exact.quant == "none" and exact._scales is None


def test_port_bundle_loads_in_fabric_tpu(bundles):
    """The port's bundle read by fabric_tpu's load_bundle: the folded
    params bit-equal to fabric_tpu's own export (dtype too), the same
    meta, the int8 scales within SCALE_RTOL; the same .npz keys."""
    for quant in ("none", "int8"):
        want = jexport.load_bundle(bundles["jax", quant])
        got = jexport.load_bundle(bundles["torch", quant])
        w_leaves, g_leaves = dict(_leaves(want[0])), dict(_leaves(got[0]))
        assert sorted(g_leaves) == sorted(w_leaves)
        for k, v in w_leaves.items():
            assert g_leaves[k].dtype == v.dtype, k
            np.testing.assert_array_equal(g_leaves[k], v, err_msg=k)
        assert got[2] == want[2]
        with np.load(bundles["jax", quant]) as a, \
                np.load(bundles["torch", quant]) as b:
            assert sorted(a.files) == sorted(b.files)
        if quant == "none":
            assert got[1] is None and want[1] is None
            continue
        assert sorted(got[1]) == sorted(want[1])
        rel = max(abs(got[1][k] - want[1][k]) / want[1][k] for k in want[1])
        print(f"int8 bundle scales: largest relative difference {rel:.3g}")
        assert rel <= SCALE_RTOL


def test_port_bundle_serves_in_fabric_tpu(bundles):
    """fabric_tpu's ScenePredictor serves the port's exact bundle with
    the masks of its own bundle."""
    jcfg = JaxConfig(**SMALL, eval_batch_size=8)
    d1, d2 = _pair(2)
    mine = JaxPredictor(jcfg, bundle=bundles["torch", "none"], bucket=32)
    theirs = JaxPredictor(jcfg, bundle=bundles["jax", "none"], bucket=32)
    np.testing.assert_array_equal(mine.predict(d1, d2),
                                  theirs.predict(d1, d2))


def test_multidate_bundle_params_equal(tmp_path):
    """A UNet3D bundle (DHWIO kernels) of either package holds the same
    folded params and meta."""
    cfg = dict(SMALL, model="unet3d", num_dates=3)
    run = save_checkpoint(Config(**cfg), str(tmp_path / "run"))
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    jexport.export_bundle(JaxConfig(**cfg), run, a)
    texport.export_bundle(Config(**cfg), run, b, device="cpu")
    want, got = jexport.load_bundle(a), texport.load_bundle(b)
    assert got[2] == want[2] and got[2]["num_dates"] == 3
    w_leaves, g_leaves = dict(_leaves(want[0])), dict(_leaves(got[0]))
    assert sorted(g_leaves) == sorted(w_leaves)
    for k, v in w_leaves.items():
        np.testing.assert_array_equal(g_leaves[k], v, err_msg=k)
    served = ScenePredictor(Config(**cfg, eval_batch_size=8), bundle=a,
                            bucket=32, device="cpu")
    from_ckpt = ScenePredictor(Config(**cfg, eval_batch_size=8),
                               checkpoint=run, bucket=32, device="cpu")
    stack = np.random.RandomState(3).randn(3, 40, 56, 13).astype(np.float32)
    np.testing.assert_array_equal(served.predict_multidate(stack),
                                  from_ckpt.predict_multidate(stack))


def test_export_main_and_mismatches(run_dir, tmp_path, capsys):
    """tools.export.main writes the bundle, prints its meta and mirrors it
    to an output store; a bundle refuses a config of other channels, model
    family or folding."""
    out = str(tmp_path / "b.npz")
    store = tmp_path / "store"
    rc = texport.main(["--out", out, "--quant", "none", "--resume", run_dir,
                       "--patch_size", "16", "--model_base", "8",
                       "--dtype", "float32", "--device", "cpu",
                       "--output_store", f"file://{store}"])
    assert rc == 0 and os.path.exists(out)
    meta = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert meta["quant"] == "none" and meta["model_base"] == 8
    assert meta["output_store"] == f"file://{store}"
    assert (store / "bundles" / "b.npz").read_bytes() == \
        open(out, "rb").read()
    params, scales, _ = texport.load_bundle(out)
    assert scales is None and "bn1" not in params["inc"]
    assert "kernel" in params["inc"]["conv1"]
    with pytest.raises(ValueError, match="n_channels"):
        ScenePredictor(Config(**SMALL, band_ids=["B02", "B03", "B04",
                                                 "B08"]),
                       bundle=out, device="cpu")
    with pytest.raises(ValueError, match="model"):
        ScenePredictor(Config(**SMALL, model="unet_lstm", num_dates=3),
                       bundle=out, device="cpu")
    with pytest.raises(ValueError, match="fold_bn"):
        ScenePredictor(Config(**SMALL), bundle=out, device="cpu",
                       fold_bn=False)
    # model_base comes from the bundle's meta
    pred = ScenePredictor(Config(patch_size=16, dtype="float32"), bundle=out,
                          device="cpu")
    assert pred.model.inc.conv1.kernel.shape[-1] == 8


def test_validate_int8_bundle(run_dir, tmp_path, capsys):
    """validate_int8 --bundle: the exact and the int8 predictor both from
    one bundle, on a synthetic city."""
    from fabric_tpu_torch.data.synthetic import generate_synthetic_dataset
    from fabric_tpu_torch.tools.validate_int8 import main
    cfg = Config(**SMALL, dataset_dir=str(tmp_path / "data"),
                 validation_cities=["alpha"])
    generate_synthetic_dataset(cfg.dataset_dir, cfg, cities=["alpha"],
                               sizes=[(64, 48)])
    out = str(tmp_path / "b.npz")
    texport.export_bundle(Config(**SMALL), run_dir, out, quant="int8",
                          device="cpu")
    rc = main(["--bundle", out, "--dataset_dir", cfg.dataset_dir,
               "--patch_size", "16", "--model_base", "8", "--dtype",
               "float32", "--validation_cities", '["alpha"]', "--device",
               "cpu", "--max_f1_drop", "1.0", "--min_agreement", "0.0"])
    city, summary = [json.loads(x)
                     for x in capsys.readouterr().out.splitlines()]
    assert rc == 0 and summary["summary"] == "ok" and summary["cities"] == 1
    assert city["city"] == "alpha" and city["verdict"] == "ok"
    # the int8 predictor served the bundle's scales: it probed the city
    assert city["clip_overflow_ratio"] > 0
