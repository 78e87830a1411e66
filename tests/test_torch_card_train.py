"""The rest of the port's training path on an NVIDIA GPU: remat against no
remat, the worker processes' batches pinned and moved to the card, and
cli.evaluate with --device cuda.  Every test here is marked ``cuda`` and
skips without a card; on one, run ``python -m pytest -m cuda
tests/test_torch_card_train.py``.  Imports no JAX."""

import json
import os

import numpy as np
import pytest
import torch

from fabric_tpu_torch.config import Config
from fabric_tpu_torch.data import loader, oscd, pipeline
from fabric_tpu_torch.data.synthetic import generate_synthetic_dataset


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with -m cuda on the card)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("card_train")
    generate_synthetic_dataset(str(root / "data"), Config(),
                               cities=["alpha", "beta", "gamma"],
                               sizes=[(128, 128), (96, 128), (64, 64)],
                               seed=11)
    return str(root / "data")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_matches_plain_on_the_card(card, dtype):
    """One train forward and backward at base 16, batch 4, patch 32, with
    and without remat from the same weights: the loss and the BatchNorm
    running statistics equal, each gradient within 1e-5 (fp32) or 2e-2
    (bf16) of its scale (cuDNN's weight gradients may sum in another
    order).  The scale is the larger of the tensor's largest component
    and a tenth of the model's largest: the biases of the convs before a
    train-mode BatchNorm have zero gradient analytically, and theirs is
    rounding noise (~1e-9 in fp32 on the card, against 2.6e-2 for the
    model's largest)."""
    from fabric_tpu_torch.losses import get_loss_fn
    from fabric_tpu_torch.models import build_model
    from fabric_tpu_torch.weights import init_variables
    variables = init_variables(13, 2, 16, torch.Generator().manual_seed(3))
    rng = np.random.RandomState(3)
    img1, img2 = (torch.from_numpy(rng.randn(4, 32, 32, 13).astype(
        np.float32)).to(card) for _ in range(2))
    label = torch.from_numpy((rng.rand(4, 32, 32) < .3).astype(
        np.int32)).to(card)
    out = {}
    for remat in (False, True):
        cfg = Config(model_base=16, dtype=dtype, remat=remat)
        model = build_model(cfg, card, fold_bn=False, variables=variables,
                            train=True)
        loss = get_loss_fn(cfg)(model(img1, img2, train=True), label)
        loss.backward()
        out[remat] = (loss.item(),
                      {n: p.grad for n, p in model.named_parameters()},
                      dict(model.named_buffers()))
    (l0, g0, s0), (l1, g1, s1) = out[False], out[True]
    assert l0 == l1
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    tol = 1e-5 if dtype == "float32" else 2e-2
    top = max(g.abs().max().item() for g in g0.values())
    for k in g0:
        scale = max(g0[k].abs().max().item(), 0.1 * top)
        assert (g1[k] - g0[k]).abs().max().item() <= tol * scale, k


@pytest.mark.cuda
def test_worker_batches_on_the_card_equal_the_threads(card, dataset_dir):
    """2 workers, batches copied to the card from the pinned ring of 6
    slots (13 batches: every slot is reused): bit-equal to
    batch_iterator's numpy batches, and to the thread's on the card."""
    data = oscd.full_load(dataset_dir, Config())
    md, _ = oscd.metadata_from_dataset(data, ["gamma"], 32, 32)
    kw = dict(shuffle=True, pad_mode="wrap", seed=4, skip_batches=1)
    want = list(pipeline.batch_iterator(
        pipeline.PatchSampler(data, md, 32, True), 2, **kw))
    thread = list(pipeline.prefetch_to_device(iter(want), card))
    with loader.BatchLoader(loader.share_dataset(data), md, 32, True, 2,
                            shuffle=True, num_workers=2,
                            device=card) as workers:
        got = list(workers.epoch(seed=4, skip_batches=1))
    assert len(got) == len(want) == len(thread) == 13
    for g, t, w in zip(got, thread, want):
        for k in w:
            assert g[k].device.type == "cuda"
            assert torch.equal(g[k], t[k]), k
            np.testing.assert_array_equal(g[k].cpu().numpy(), w[k])


@pytest.mark.cuda
def test_cli_evaluate_on_the_card(card, dataset_dir, tmp_path):
    """Train 2 epochs on the card (base 8, patch 16, fp32), then
    cli.evaluate --device cuda on the run directory: the best save's
    recorded validation metrics, exactly (the same forward, cuDNN's
    deterministic inference algorithms)."""
    from fabric_tpu_torch import checkpoint as ckpt
    from fabric_tpu_torch.cli.evaluate import main
    from fabric_tpu_torch.train.loop import train
    cfg = Config(dataset_dir=dataset_dir, weight_dir=str(tmp_path / "w"),
                 log_dir=str(tmp_path / "l"), patch_size=16, stride=16,
                 batch_size=8, epochs=2, learning_rate=0.05,
                 dtype="float32", model_base=8,
                 validation_cities=["gamma"], num_workers=2)
    train(cfg, device="cuda")
    best = ckpt.read_pointer(cfg.weight_dir, "best")
    epoch = int(best.rsplit("_", 1)[1].split(".")[0])
    with open(os.path.join(cfg.weight_dir,
                           f"metadata_epoch_{epoch}.json")) as f:
        recorded = json.load(f)["validation_metrics"]
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg.to_dict()))
    out = tmp_path / "metrics.json"
    assert main(["--config", str(cfg_path), "--resume", cfg.weight_dir,
                 "--output", str(out), "--device", "cuda"]) == 0
    result = json.loads(out.read_text())
    for k in ("cd_losses", "cd_precisions", "cd_recalls", "cd_f1scores",
              "global_f1"):
        assert result["patch"][k] == recorded[k], k
    assert result["scenes"]["gamma"]["f1"] == recorded["gamma_scene_f1"]
