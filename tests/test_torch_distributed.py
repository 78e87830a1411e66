"""Data-parallel training in the port (fabric_tpu_torch.parallel, the
per-rank batches of data/pipeline.py and data/loader.py, the global
BatchNorm of models/blocks.py, the global losses, train.loop.train over a
torch.distributed gloo group) on the CPU, at base 8.

The rule: a 2-process run on one global batch computes what a 1-process
run on it computes.  The unit parities run two short gloo subprocesses
against the same computation in this process; the loop runs 2 processes
against 1, in the pattern of tests/test_multiprocess.py.  Sums go over
the ranks in another order than over the whole batch, so values agree
within the fp32 bounds stated with each test (the loop's are those of the
port's train parity tests: loss 1e-6, parameters 1e-5, running statistics
1e-6), and the batches and the pad byte for byte."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from fabric_tpu.data import pipeline as jax_pipeline
from fabric_tpu.parallel import mesh as jax_mesh

from fabric_tpu_torch import losses
from fabric_tpu_torch.config import Config
from fabric_tpu_torch.data import loader, oscd, pipeline
from fabric_tpu_torch.data.synthetic import generate_synthetic_dataset
from fabric_tpu_torch.models import build_model
from fabric_tpu_torch.models.blocks import BatchNorm
from fabric_tpu_torch.parallel import distributed, mesh
from fabric_tpu_torch.train import loop as loop_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
TIMEOUT = 240  # s, each subprocess


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(code: str, world: int, **env) -> list[str]:
    """Run ``code`` in ``world`` processes of one gloo group (the FABRIC_*
    variables; none for a world of 1), each with its own timeout; their
    outputs."""
    coord = f"localhost:{_free_port()}"
    procs = []
    for r in range(world):
        e = dict(os.environ, PYTHONPATH=REPO, **env)
        for k in ("FABRIC_COORDINATOR", "FABRIC_NUM_PROCESSES",
                  "FABRIC_PROCESS_ID", "WORLD_SIZE"):
            e.pop(k, None)
        if world > 1:
            e.update(FABRIC_COORDINATOR=coord,
                     FABRIC_NUM_PROCESSES=str(world),
                     FABRIC_PROCESS_ID=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=e, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0].decode())
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{text[-4000:]}"
    return outs


# --- the mesh, the pad, the per-rank batches ---------------------------------

@pytest.mark.parametrize("n,multiple,multi_date", [
    (5, 2, False), (6, 4, False), (8, 4, False), (3, 4, True), (1, 1, True)])
def test_pad_batch_to_multiple_matches_fabric_tpu(n, multiple, multi_date):
    """Zero rows of weight 0, byte for byte fabric_tpu's."""
    rng = np.random.RandomState(n)
    shape = (n, 3, 4, 4, 2) if multi_date else (n, 4, 4, 2)
    batch = {"imgs" if multi_date else "img1":
             rng.randn(*shape).astype(np.float32),
             "label": rng.randint(0, 2, (n, 4, 4)).astype(np.int32),
             "weight": np.ones(n, np.float32)}
    got = mesh.pad_batch_to_multiple(dict(batch), multiple)
    want = jax_mesh.pad_batch_to_multiple(dict(batch), multiple)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k
    assert got["label"].shape[0] % multiple == 0


@pytest.fixture(scope="module")
def sampler_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_batches")
    generate_synthetic_dataset(str(root / "data"), Config(),
                               cities=["alpha", "beta"],
                               sizes=[(80, 64), (48, 40)], seed=2)
    dataset = oscd.full_load(str(root / "data"), Config())
    train_md, _ = oscd.metadata_from_dataset(dataset, ["beta"], 16, 16)
    return dataset, train_md


@pytest.mark.parametrize("augment,pad_mode,skip", [
    (True, "wrap", 0), (True, "wrap", 1), (False, "mask", 0)])
def test_rank_slices_concatenate_to_the_global_batch(sampler_data, augment,
                                                     pad_mode, skip):
    """batch_iterator at process_index 0 and 1 of 2: each rank's rows, byte
    for byte fabric_tpu's slices, concatenate to the 1-process batch."""
    dataset, md = sampler_data
    kw = dict(shuffle=True, pad_mode=pad_mode, seed=4, max_batches=3,
              skip_batches=skip)
    whole = list(pipeline.batch_iterator(
        pipeline.PatchSampler(dataset, md, 16, augment), 8, **kw))
    ranks = [list(pipeline.batch_iterator(
        pipeline.PatchSampler(dataset, md, 16, augment), 8, **kw,
        process_index=r, process_count=WORLD)) for r in range(WORLD)]
    jranks = [list(jax_pipeline.batch_iterator(
        jax_pipeline.PatchSampler(dataset, md, 16, augment, seed=4), 8,
        **kw, process_index=r, process_count=WORLD)) for r in range(WORLD)]
    assert len(whole) == 3 - skip
    for b, full in enumerate(whole):
        for k in full:
            parts = [ranks[r][b][k] for r in range(WORLD)]
            assert all(p.shape[0] == 4 for p in parts)
            assert np.concatenate(parts).tobytes() == full[k].tobytes(), k
            for r in range(WORLD):
                assert parts[r].tobytes() == jranks[r][b][k].tobytes(), k


def test_loader_rank_batches_equal_the_thread(sampler_data):
    """A worker loader of rank 1 of 2 (its ring sized for 4 rows a slot)
    delivers batch_iterator's rows of rank 1, byte for byte."""
    dataset, md = sampler_data
    want = list(pipeline.batch_iterator(
        pipeline.PatchSampler(dataset, md, 16, True), 8, shuffle=True,
        seed=6, max_batches=3, process_index=1, process_count=WORLD))
    with loader.BatchLoader(loader.share_dataset(dataset), md, 16, True, 8,
                            shuffle=True, num_workers=1, device="cpu",
                            process_index=1,
                            process_count=WORLD) as batches:
        got = list(batches.epoch(seed=6, max_batches=3))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        for k in b:
            assert a[k].numpy().tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("kw,match", [
    (dict(batch_size=7), "not divisible by process_count"),
    (dict(ragged_tail=True), "does not shard"),
    (dict(compat=True), "single-process only")])
def test_rank_batch_errors_as_fabric_tpu(sampler_data, kw, match):
    """fabric_tpu's refusals across processes (data/pipeline.py:136-146)."""
    import random
    dataset, md = sampler_data
    stream = random.Random(0) if kw.pop("compat", False) else None
    sampler = pipeline.PatchSampler(dataset, md, 16, True,
                                    compat_aug_stream=stream)
    with pytest.raises(ValueError, match=match):
        next(pipeline.batch_iterator(sampler, kw.pop("batch_size", 8),
                                     shuffle=True, process_count=WORLD,
                                     **kw))


def test_single_process_is_not_distributed(tmp_path, caplog):
    """Without a group: maybe_initialize is a no-op, rank 0 is primary,
    the mesh is (1, 1, 1); the loop refuses a data, spatial or model axis
    beyond the world size (the spatial and model axes are ported, item
    10c: a ValueError, not a refusal naming the item); sync_batchnorm
    logs fabric_tpu's warning and changes nothing."""
    assert not distributed.maybe_initialize("cpu")
    assert distributed.is_primary() and distributed.world_size() == 1
    assert not distributed.any_rank(False) and distributed.any_rank(True)
    assert distributed.mesh_shape() == {"data": 1, "spatial": 1, "model": 1}
    assert distributed.coords() == (0, 0, 0)
    for kw in (dict(mesh_data=2), dict(mesh_spatial=2),
               dict(mesh_data=1, mesh_model=2)):
        cfg = Config(log_dir=str(tmp_path / "l"),
                     weight_dir=str(tmp_path / "w"), **kw)
        with pytest.raises(ValueError, match="needs 2 devices, have 1"):
            loop_mod.train(cfg, dataset={}, device="cpu", metadata=([], []))
    cfg = Config(model_base=8, sync_batchnorm=True)
    with caplog.at_level("WARNING", logger="fabric_tpu_torch"):
        build_model(cfg, "cpu")
    assert "sync_batchnorm=True is a no-op" in caplog.text


# --- global BatchNorm and losses over a 2-rank gloo group ---------------------

_UNIT = r"""
import os
import numpy as np
import torch
torch.set_num_threads(1)
from fabric_tpu_torch import losses
from fabric_tpu_torch.models.blocks import BatchNorm
from fabric_tpu_torch.parallel import distributed as dist

assert dist.maybe_initialize("cpu")
r, w = dist.rank(), dist.world_size()
d = np.load(os.environ["FT_IN"])
rows = slice(r * d["x"].shape[0] // w, (r + 1) * d["x"].shape[0] // w)
out = {}

bn = BatchNorm(d["x"].shape[-1])
with torch.no_grad():
    for k in ("scale", "bias", "mean", "var"):
        getattr(bn, k).copy_(torch.from_numpy(d["bn_" + k]))
bn.requires_grad_(True)
x = torch.from_numpy(d["x"][rows]).requires_grad_(True)
y = bn(x)
loss = dist.all_reduce_sum((y * torch.from_numpy(d["g"][rows])).sum())
loss.backward()
dist.mean_gradients(bn.parameters())
bn.update_stats = False          # the rematerialised forward
y2 = bn(x)
out.update(bn_y=y.detach(), bn_y2=y2.detach(), bn_dx=x.grad / w,
           bn_dscale=bn.scale.grad, bn_dbias=bn.bias.grad, bn_mean=bn.mean,
           bn_var=bn.var, bn_loss=loss.detach())

for name in ("tversky", "ce", "dice", "jaccard", "focal"):
    fn = {"tversky": losses.tversky_loss, "dice": losses.dice_loss,
          "jaccard": losses.jaccard_loss, "focal": losses.focal_loss,
          "ce": losses.cross_entropy_loss}[name]
    logits = torch.from_numpy(d["logits"][rows]).requires_grad_(True)
    loss = fn(logits, torch.from_numpy(d["labels"][rows]),
              weights=torch.from_numpy(d["weights"][rows]))
    loss.backward()
    out[name] = loss.detach()
    out[name + "_grad"] = logits.grad / w

out["any"] = torch.tensor([dist.any_rank(r == 1), dist.any_rank(False)])
counts = dist.all_reduce_(torch.tensor([r + 1], dtype=torch.int32))
out["counts"] = counts
np.savez(os.path.join(os.environ["FT_OUT"], f"unit_{r}.npz"),
         **{k: v.numpy() for k, v in out.items()})
dist.shutdown()
"""


@pytest.fixture(scope="module")
def unit(tmp_path_factory):
    """(inputs, each rank's results) of the unit worker on 2 ranks."""
    root = tmp_path_factory.mktemp("dp_unit")
    rng = np.random.RandomState(0)
    c = 5
    inputs = {
        "x": (rng.randn(4, 6, 6, c) * 2 + 3).astype(np.float32),
        "g": rng.randn(4, 6, 6, c).astype(np.float32),
        "bn_scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
        "bn_bias": (rng.randn(c) * 0.1).astype(np.float32),
        "bn_mean": (rng.randn(c) * 0.1).astype(np.float32),
        "bn_var": rng.uniform(0.5, 1.5, c).astype(np.float32),
        "logits": rng.randn(4, 8, 8, 2).astype(np.float32),
        "labels": (rng.rand(4, 8, 8) < 0.3).astype(np.int32),
        "weights": np.array([1, 1, 1, 0], np.float32),  # a padded row
    }
    np.savez(root / "in.npz", **inputs)
    _launch(_UNIT, WORLD, FT_IN=str(root / "in.npz"), FT_OUT=str(root))
    return inputs, [dict(np.load(root / f"unit_{r}.npz"))
                    for r in range(WORLD)]


def test_global_batchnorm_equals_one_batchnorm(unit):
    """BatchNorm on two halves over the group equals one BatchNorm on the
    whole batch: the output (and the rematerialised forward's), the input
    and parameter gradients and the unbiased running update (global n),
    within 2e-6 relative to each quantity's scale (fp32 sums in another
    order)."""
    inputs, ranks = unit
    bn = BatchNorm(inputs["x"].shape[-1])
    with torch.no_grad():
        for k in ("scale", "bias", "mean", "var"):
            getattr(bn, k).copy_(torch.from_numpy(inputs["bn_" + k]))
    bn.requires_grad_(True)
    x = torch.from_numpy(inputs["x"]).requires_grad_(True)
    y = bn(x)
    (y * torch.from_numpy(inputs["g"])).sum().backward()
    want = {"bn_y": y.detach().numpy(), "bn_dx": x.grad.numpy(),
            "bn_dscale": bn.scale.grad.numpy(),
            "bn_dbias": bn.bias.grad.numpy(), "bn_mean": bn.mean.numpy(),
            "bn_var": bn.var.numpy()}

    def close(a, b):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=2e-6 * np.abs(b).max())
    half = inputs["x"].shape[0] // WORLD
    for r, got in enumerate(ranks):
        rows = slice(r * half, (r + 1) * half)
        close(got["bn_y"], want["bn_y"][rows])
        np.testing.assert_array_equal(got["bn_y2"], got["bn_y"])
        close(got["bn_dx"], want["bn_dx"][rows])
        for k in ("bn_dscale", "bn_dbias", "bn_mean", "bn_var"):
            close(got[k], want[k])
    # equal on the ranks: replicated statistics and gradients
    for k in ("bn_dscale", "bn_dbias", "bn_mean", "bn_var", "bn_loss"):
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k])


@pytest.mark.parametrize("name,fn", [
    ("tversky", losses.tversky_loss), ("ce", losses.cross_entropy_loss),
    ("dice", losses.dice_loss), ("jaccard", losses.jaccard_loss),
    ("focal", losses.focal_loss)])
def test_global_losses_equal_the_whole_batch(unit, name, fn):
    """Each rank's loss over the group is the whole batch's (a weight-0 row
    included), and the rank's logit gradient (over the world size: the
    backward of the all-reduce sums every rank's) is the whole batch's,
    within 1e-6 relative to its scale."""
    inputs, ranks = unit
    logits = torch.from_numpy(inputs["logits"]).requires_grad_(True)
    loss = fn(logits, torch.from_numpy(inputs["labels"]),
              weights=torch.from_numpy(inputs["weights"]))
    loss.backward()
    grad = logits.grad.numpy()
    half = inputs["logits"].shape[0] // WORLD
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[name], loss.item(), rtol=1e-6)
        np.testing.assert_allclose(got[name + "_grad"],
                                   grad[r * half:(r + 1) * half], rtol=0,
                                   atol=1e-6 * np.abs(grad).max())
    assert (grad[3] == 0).all()  # the weight-0 row


def test_rank_flags_and_counts_agree(unit):
    """any_rank is True on every rank when one rank's flag is; the count
    all-reduce sums the ranks' counts."""
    _, ranks = unit
    for got in ranks:
        assert got["any"].tolist() == [True, False]
        assert got["counts"].tolist() == [3]


# --- train.loop.train: 2 processes against 1 ---------------------------------

_TRAIN = r"""
import json, os
import numpy as np
import torch
torch.set_num_threads(1)
from fabric_tpu_torch.config import Config
from fabric_tpu_torch.data.oscd import full_load
from fabric_tpu_torch.parallel import distributed as dist
from fabric_tpu_torch.train.loop import train
from fabric_tpu_torch.weights import flatten_tree, variables_of

dist.maybe_initialize("cpu")
root, out = os.environ["FT_DATA"], os.environ["FT_OUT"]
cfg = Config(**{**dict(
    dataset_dir=root, weight_dir=os.path.join(out, "weights"),
    log_dir=os.path.join(out, "log"), dtype="float32", model_base=8,
    patch_size=16, stride=16, batch_size=8, eval_batch_size=8, epochs=2,
    steps_per_epoch=3, num_workers=0, seed=3, validation_cities=["beta"],
    prefetch=1, augmentation=True, loss_function="tversky",
    optimizer="sgd", momentum=0.9, learning_rate=0.05),
    **json.loads(os.environ["FT_CFG"])})
state, history = train(cfg, dataset=full_load(root, cfg), device="cpu")
params, stats = variables_of(state.model)
r = dist.rank()
np.savez(os.path.join(out, f"vars_{r}.npz"),
         **{"params/" + k: v for k, v in flatten_tree(params).items()},
         **{"stats/" + k: v for k, v in flatten_tree(stats).items()})
with open(os.path.join(out, f"history_{r}.json"), "w") as f:
    json.dump({"history": history, "step": state.step,
               "world": dist.world_size()}, f)
dist.shutdown()
"""


# the loop's variants: 2 epochs of 3 steps; 2 epochs of 2 steps with
# MultiSteps accumulation (an update every 2 steps) and remat
LOOP_VARIANTS = {"plain": {},
                 "accum_remat": {"steps_per_epoch": 2,
                                 "grad_accum_steps": 2, "remat": True}}


@pytest.fixture(scope="module", params=list(LOOP_VARIANTS))
def loop_runs(request, tmp_path_factory):
    """(2-process output dir, 1-process output dir, variant) of the loop
    worker on one synthetic dataset: train steps of 8, 9 validation
    patches, scene inference of the validation city."""
    root = tmp_path_factory.mktemp("dp_loop")
    data = str(root / "data")
    generate_synthetic_dataset(data, Config(), cities=["alpha", "beta"],
                               sizes=[(80, 64), (40, 40)], seed=1)
    multi, single = str(root / "multi"), str(root / "single")
    for out, world in ((multi, WORLD), (single, 1)):
        os.makedirs(out)
        _launch(_TRAIN, world, FT_DATA=data, FT_OUT=out,
                FT_CFG=json.dumps(LOOP_VARIANTS[request.param]))
    return multi, single, request.param


def _result(out, r):
    with open(os.path.join(out, f"history_{r}.json")) as f:
        return dict(np.load(os.path.join(out, f"vars_{r}.npz"))), json.load(f)


def test_two_processes_train_like_one(loop_runs):
    """The 2-process run equals the 1-process run on the same global
    batches, plain and with accumulation and remat: each epoch's train and
    validation loss within 1e-6, the validation counts exactly, every
    parameter within 1e-5 and every running statistic within 1e-6
    (relative above 1); both ranks hold the same parameters and
    statistics."""
    multi, single, _ = loop_runs
    (v0, h0), (v1, h1), (vs, hs) = (_result(multi, 0), _result(multi, 1),
                                    _result(single, 0))
    assert h0["world"] == h1["world"] == WORLD and hs["world"] == 1
    assert h0["step"] == hs["step"] in (6, 4)
    for k in vs:
        np.testing.assert_array_equal(v0[k], v1[k])
        bound = 1e-5 if k.startswith("params/") else 1e-6
        np.testing.assert_allclose(v0[k], vs[k], rtol=0,
                                   atol=bound * max(1.0,
                                                    np.abs(vs[k]).max()))
    for split in ("train", "val"):
        for e0, e1, es in zip(h0["history"][split], h1["history"][split],
                              hs["history"][split], strict=True):
            assert abs(e0["cd_losses"] - es["cd_losses"]) <= 1e-6
            assert e0["cd_losses"] == e1["cd_losses"]
            if split == "val":
                for k in ("global_precision", "global_recall",
                          "global_accuracy"):
                    assert e0[k] == es[k] == e1[k], k
    # the scene inference ran on rank 0 alone
    assert "beta_scene_f1" in h0["history"]["val"][0]
    assert "beta_scene_f1" not in h1["history"]["val"][0]
    assert h0["history"]["val"][0]["beta_scene_f1"] == \
        hs["history"]["val"][0]["beta_scene_f1"]


def test_only_rank_zero_writes(loop_runs):
    """One tracker run directory, rank 0's, and the checkpoints of one
    writer: the same files as the 1-process run's."""
    multi, single, _ = loop_runs
    runs = os.listdir(os.path.join(multi, "log"))
    assert len(runs) == 1
    run = os.path.join(multi, "log", runs[0])
    assert os.path.exists(os.path.join(run, "metrics.jsonl"))
    figures = [f for f in os.listdir(run) if f.endswith(".png")]
    assert figures  # rank 0 logged its figures
    assert sorted(os.listdir(os.path.join(multi, "weights"))) == \
        sorted(os.listdir(os.path.join(single, "weights")))
    assert not [n for n in os.listdir(os.path.join(multi, "weights"))
                if ".tmp" in n]
