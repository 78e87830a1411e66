"""The port's standalone evaluation (fabric_tpu_torch.evaluate and
cli.evaluate) on the CPU: for a checkpoint the port's loop trained, it
reproduces the validation metrics the loop recorded with it exactly, and
it gives fabric_tpu.evaluate's metrics for the same checkpoint and
dataset; the CLI writes its JSON, takes a run directory's best save and a
dataset archive, and exits 2 without --resume."""

import json
import os
import re
import tarfile

import numpy as np
import pytest
import torch

from fabric_tpu.config import Config as JaxConfig

from fabric_tpu_torch import checkpoint as ckpt
from fabric_tpu_torch.config import Config
from fabric_tpu_torch.data.synthetic import generate_synthetic_dataset

torch.set_num_threads(1)

PATCH_KEYS = ("cd_losses", "cd_corrects", "cd_precisions", "cd_recalls",
              "cd_f1scores", "global_precision", "global_recall",
              "global_f1", "global_accuracy")


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The port's loop, 2 epochs at patch 16, base 8, fp32, with scene
    inference of the validation city."""
    from fabric_tpu_torch.train.loop import train
    root = tmp_path_factory.mktemp("torch_eval")
    cfg = Config(dataset_dir=str(root / "data"),
                 weight_dir=str(root / "weights"), log_dir=str(root / "logs"),
                 patch_size=16, stride=16, batch_size=8, epochs=2,
                 learning_rate=0.05, dtype="float32", model_base=8,
                 validation_cities=["beta"], augmentation=True,
                 num_workers=0, prefetch=1, seed=0)
    generate_synthetic_dataset(cfg.dataset_dir, cfg, seed=3)
    _, history = train(cfg, run_scene_inference=True, device="cpu")
    return cfg, history


def _best(weight_dir):
    best = ckpt.read_pointer(weight_dir, "best")
    epoch = int(re.search(r"_epoch_(\d+)\.msgpack$", best).group(1))
    with open(os.path.join(weight_dir, f"metadata_epoch_{epoch}.json")) as f:
        return best, epoch, json.load(f)["validation_metrics"]


def test_evaluate_reproduces_the_loops_validation_metrics(env):
    """evaluate() on the best checkpoint: the patch metrics and the
    scene F1 the loop recorded with it (and its history row), exactly."""
    from fabric_tpu_torch.evaluate import evaluate
    cfg, history = env
    path, epoch, recorded = _best(cfg.weight_dir)
    result = evaluate(Config.from_dict({**cfg.to_dict(), "resume": path}),
                      device="cpu")
    for k in PATCH_KEYS:
        assert result["patch"][k] == recorded[k] == history["val"][epoch][k]
    assert result["scenes"]["beta"]["f1"] == recorded["beta_scene_f1"]
    assert 0.0 <= result["scenes"]["beta"]["change_pct"] <= 100.0
    assert result["patch"]["num_batches"] >= 1


def test_evaluate_matches_fabric_tpu(env):
    """fabric_tpu.evaluate with the same checkpoint's weights and the same
    dataset: equal confusion-derived patch and scene metrics, the loss
    within 1e-5 relative (fp32 convolutions in another order)."""
    from fabric_tpu.evaluate import evaluate as jax_evaluate
    from fabric_tpu.models import build_model as jax_build_model
    from fabric_tpu.train.state import create_state as jax_create_state
    from fabric_tpu_torch.evaluate import evaluate
    cfg, _ = env
    path, _, _ = _best(cfg.weight_dir)
    d = {**cfg.to_dict(), "resume": path}
    ours = evaluate(Config.from_dict(d), device="cpu")
    jcfg = JaxConfig.from_dict({**d, "mesh_data": 1})
    params, stats = ckpt.load_variables(path)
    jstate = jax_create_state(jcfg, jax_build_model(jcfg), variables={
        "params": params, "batch_stats": stats})
    theirs = jax_evaluate(jcfg, state=jstate)
    for k in PATCH_KEYS:
        rtol = 1e-5 if k == "cd_losses" else 0
        np.testing.assert_allclose(ours["patch"][k], theirs["patch"][k],
                                   rtol=rtol, atol=0, err_msg=k)
    for k in ("num_batches", "num_samples"):
        assert ours["patch"][k] == theirs["patch"][k], k
    assert ours["scenes"] == theirs["scenes"]


def test_evaluate_cli(env, tmp_path):
    """--output JSON, a run directory (its best save), a dataset given
    as an archive (extracted by ensure_dataset), --no_scene."""
    from fabric_tpu_torch.cli.evaluate import main
    cfg, _ = env
    _, _, recorded = _best(cfg.weight_dir)
    archive = str(tmp_path / "onera.tar.gz")
    with tarfile.open(archive, "w:gz") as tf:
        tf.add(cfg.dataset_dir, arcname="onera")
    out = str(tmp_path / "metrics.json")
    rc = main(["--dataset_dir", str(tmp_path / "data"),
               "--dataset_name", archive, "--resume", cfg.weight_dir,
               "--patch_size", "16", "--stride", "16", "--dtype", "float32",
               "--model_base", "8", "--batch_size", "8",
               "--validation_cities", '["beta"]', "--no_scene",
               "--output", out, "--device", "cpu"])
    assert rc == 0
    with open(out) as f:
        result = json.load(f)
    assert result["scenes"] == {}
    for k in PATCH_KEYS:
        assert result["patch"][k] == recorded[k], k
    assert os.path.isdir(tmp_path / "data" / "onera" / "labels")


def test_evaluate_cli_requires_resume(env, capsys):
    from fabric_tpu_torch.cli.evaluate import main
    cfg, _ = env
    assert main(["--dataset_dir", cfg.dataset_dir, "--device", "cpu"]) == 2
    assert "--resume" in capsys.readouterr().err
