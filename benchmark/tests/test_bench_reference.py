"""The benchmark's plain reference against the port's plain CPU path at a
tiny size (float32): the folded serving forward, the train-mode forward,
the loss and the batches."""

import numpy as np
import pytest
import torch

from benchmark.harness import data as bench_data
from benchmark.harness import manifest
from benchmark.harness import weights as bench_weights
from benchmark.reference import batches as ref_batches
from benchmark.reference import compare
from benchmark.reference.nets import Net, tversky

CPU = torch.device("cpu")
TINY = {"model": "bidate", "n_channels": 13, "n_classes": 2,
        "model_base": 8}
BIDATE = manifest.model("bidate")


def _program_model(params, stats, train):
    from fabric_tpu_torch.config import Config
    from fabric_tpu_torch.models import build_model
    cfg = Config(model=TINY["model"], model_base=TINY["model_base"],
                 dtype="float32")
    return build_model(cfg, CPU, variables=(bench_weights.to_host(params),
                                            bench_weights.to_host(stats)),
                       fold_bn=not train, train=train)


def _weights(seed=3):
    return bench_weights.make(TINY, seed, CPU)


@pytest.mark.parametrize("train", [False, True])
def test_bidate_forward(train):
    params, stats = _weights()
    g = torch.Generator().manual_seed(1)
    d1, d2 = (torch.randn(4, 32, 32, 13, generator=g) for _ in range(2))
    prog = _program_model(params, stats, train)
    with torch.no_grad():
        want = prog(d1, d2, train=train)
        got = Net(BIDATE, params, stats, train=train)(
            {"img1": d1, "img2": d2})
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4 * want.abs().max())


def test_tiled_reference_is_the_grid_of_tiles():
    params, stats = _weights()
    net = Net(BIDATE, params, stats)
    pool = bench_data.scene_pool(4, 1, 32, 48, 13, CPU)
    d1, d2 = (torch.from_numpy(d) for d in pool[0])
    whole = compare.tiled_logits(net, d1, d2, 16, 2)
    tile = BIDATE.pair(net, d1[None, 16:32, 32:48],
                       d2[None, 16:32, 32:48])[0]
    assert torch.allclose(whole[16:32, 32:48], tile, rtol=1e-5, atol=1e-6)
    assert compare.widest_gap(whole, whole.argmax(-1)) == 0.0


def test_tversky_matches_the_program():
    from fabric_tpu_torch.losses import tversky_loss
    g = torch.Generator().manual_seed(5)
    logits = torch.randn(4, 8, 8, 2, generator=g)
    labels = torch.randint(0, 2, (4, 8, 8), generator=g)
    w = torch.tensor([1.0, 1.0, 0.0, 1.0])
    want = tversky_loss(logits, labels, 0.1, 0.9, weights=w)
    assert torch.allclose(tversky(logits, labels, w, 0.1, 0.9), want,
                          rtol=1e-6)


@pytest.mark.parametrize("dates", [2, 3])
def test_batches_match_the_program_pipeline(dates):
    from fabric_tpu_torch.data.oscd import metadata_from_dataset
    from fabric_tpu_torch.data.pipeline import PatchSampler, batch_iterator
    data = bench_data.cities(9, 2, 40, 56, 13, dates, CPU)
    md, _ = metadata_from_dataset(data, [], 16, 8)
    patches = ref_batches.train_patches(data, [], 16, 8)
    assert patches == md
    sampler = PatchSampler(data, md, 16, augment=True,
                           multi_date=dates > 2)
    it = batch_iterator(sampler, 6, shuffle=True, pad_mode="wrap", seed=11)
    n = -(-len(md) // 6)
    for step in range(n + 2):  # into the second epoch
        if step == n:
            it = batch_iterator(sampler, 6, shuffle=True, pad_mode="wrap",
                                seed=12)
        want = next(it)
        got = ref_batches.batch(data, patches, 16, 6, 11, step, dates > 2)
        assert set(got) == set(want)
        for k in got:
            assert np.array_equal(got[k], want[k]), (step, k)
