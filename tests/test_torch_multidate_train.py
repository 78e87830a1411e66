"""Multi-date training in the port (UNetLSTM and UNet3D: fabric_tpu_torch
data, models, train and evaluate) against fabric_tpu on the CPU, at base
8, T = 3 dates, patch 16, batch 4, inputs and weights from numpy and
torch seeds.  On the CPU the kernel wrappers compute their plain PyTorch
versions; the card runs the same steps in tests/test_torch_cuda.py and
chip_smoke.py.  Tolerances are stated with each test."""

import dataclasses
import json
import os
import random
import shutil
import subprocess
from collections import namedtuple

import numpy as np
import pytest
import torch

import jax

from fabric_tpu import config as jax_config
from fabric_tpu import losses as jax_losses
from fabric_tpu.data import oscd as jax_oscd
from fabric_tpu.data import pipeline as jax_pipeline
from fabric_tpu.models import build_model as jax_build_model
from fabric_tpu.train.state import create_state as jax_create_state
from fabric_tpu.train.steps import make_train_step as jax_make_train_step

from fabric_tpu_torch import checkpoint, config, losses, weights
from fabric_tpu_torch.data import loader, oscd, pipeline
from fabric_tpu_torch.data.synthetic import generate_synthetic_dataset
from fabric_tpu_torch.models import build_model
from fabric_tpu_torch.train.state import create_state, make_schedule
from fabric_tpu_torch.train.steps import make_eval_step, make_train_step

BASE, PATCH, BATCH, T = 8, 16, 4, 3
CITIES = ["alpha", "beta", "gamma"]
SIZES = [(64, 48), (48, 32), (48, 48)]  # 12 + 6 train patches, 9 val


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def _private_native_library(tmp_path_factory):
    """fabric_tpu's native library, loadable in this process whatever the
    other test workers do.  Each worker that imports tests/test_native.py
    runs ``make -C csrc`` when the shared ``csrc/libfabric_host.so`` is
    missing; a worker that loads the half-written file gets an OSError,
    and ``fabric_tpu.native`` has already marked the library tried, so it
    stays None in that process.  So this module compiles its own copy
    with the Makefile's command into a private directory, points the
    loader at it with ``_lib`` and ``_tried`` reset, and puts all three
    back afterwards.  fabric_tpu itself is not touched."""
    from fabric_tpu import native
    so = str(tmp_path_factory.mktemp("native") / "libfabric_host.so")
    subprocess.run(["g++", "-O3", "-march=native", "-fPIC", "-shared",
                    "-std=c++17", "-o", so,
                    os.path.join(native._CSRC, "fabric_host.cpp")],
                   check=True, capture_output=True, timeout=300)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "_SO", so)
        mp.setattr(native, "_lib", None)
        mp.setattr(native, "_tried", False)
        yield


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


# --- data ---------------------------------------------------------------

@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("md_train")
    generate_synthetic_dataset(str(root / "data"), config.Config(),
                               cities=CITIES, sizes=SIZES, seed=5,
                               num_dates=T)
    return str(root / "data")


@pytest.fixture(scope="module")
def data(data_dir):
    """The 3-date dataset through the port's full_load, and the training
    patches of alpha and beta."""
    dataset = oscd.full_load(data_dir, config.Config(num_dates=T))
    md, _ = oscd.metadata_from_dataset(dataset, ["gamma"], PATCH, 16)
    return dataset, md


def test_full_load_loads_num_dates_like_fabric_tpu(data_dir, data):
    """full_load with num_dates=3 equals fabric_tpu's, byte for byte (it
    used to load two dates whatever cfg.num_dates said).  fabric_tpu's
    native library is loaded first: its loader marks the library tried
    before it is loaded, so the threads of a process's first full_load
    that come in between fall back to numpy's (x - mean) / std, 1 ulp
    off the native (x - mean) * (1 / std) that the port computes.  The
    library is this module's private build (_private_native_library)."""
    from fabric_tpu import native
    assert native.available()
    dataset, _ = data
    want = jax_oscd.full_load(data_dir, jax_config.Config(num_dates=T))
    assert sorted(dataset) == sorted(want) == CITIES
    for city in CITIES:
        got = dataset[city]["images"]
        assert got.shape == want[city]["images"].shape == (
            T,) + SIZES[CITIES.index(city)] + (13,)
        assert got.dtype == want[city]["images"].dtype == np.float32
        assert got.tobytes() == want[city]["images"].tobytes(), city
        assert dataset[city]["labels"].tobytes() == \
            want[city]["labels"].tobytes()


def test_load_city_defaults_to_the_dates_on_disk(data_dir):
    """load_city with no num_dates loads every date on disk, as
    fabric_tpu's does (it used to load 2): byte-equal to fabric_tpu's on
    the 3-date cities (the native library loaded first, as above)."""
    from fabric_tpu import native
    assert native.available()
    for city in CITIES:
        assert oscd.num_dates_on_disk(data_dir, city) == T == \
            jax_oscd.num_dates_on_disk(data_dir, city)
        got = oscd.load_city(data_dir, city, config.Config())
        want = jax_oscd.load_city(data_dir, city, jax_config.Config())
        assert got.shape == want.shape == (T,) + SIZES[
            CITIES.index(city)] + (13,)
        assert got.tobytes() == want.tobytes(), city
    assert oscd.num_dates_on_disk(data_dir, "missing") == 0


def _assert_batches_equal(ours, theirs) -> int:
    n = 0
    for a, b in zip(ours, theirs, strict=True):
        a = {k: np.asarray(v) for k, v in a.items()}
        assert sorted(a) == sorted(b) == ["imgs", "label", "weight"]
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k
        n += 1
    return n


@pytest.mark.parametrize("augment,pad_mode,seed,skip", [
    (True, "wrap", 3, 0), (False, "wrap", 0, 0), (True, "mask", 7, 1),
    (False, "mask", 1, 2)])
def test_multidate_batches_match_fabric_tpu(data, augment, pad_mode, seed,
                                            skip):
    """batch 5 over 18 patches (a padded tail): imgs (5, 3, 16, 16, 13),
    labels and weights byte-equal to fabric_tpu's batch_iterator."""
    dataset, md = data
    ours = pipeline.batch_iterator(
        pipeline.PatchSampler(dataset, md, PATCH, augment, multi_date=True),
        5, shuffle=True, pad_mode=pad_mode, seed=seed, skip_batches=skip)
    theirs = jax_pipeline.batch_iterator(
        jax_pipeline.PatchSampler(dataset, md, PATCH, augment,
                                  multi_date=True),
        5, shuffle=True, pad_mode=pad_mode, seed=seed, skip_batches=skip)
    assert _assert_batches_equal(ours, theirs) == 4 - skip


@pytest.mark.parametrize("skip", [0, 2])
def test_multidate_compat_stream_matches_fabric_tpu(data, skip):
    """compat_reference's sequential augmentation stream and ragged tail
    (18 patches at batch 4: a last batch of 2), two epochs on one
    stream, from batch ``skip`` of the first."""
    dataset, md = data
    ours_stream, theirs_stream = random.Random(0), random.Random(0)
    for epoch, sk in enumerate((skip, 0)):
        ours = pipeline.batch_iterator(
            pipeline.PatchSampler(dataset, md, PATCH, True,
                                  compat_aug_stream=ours_stream,
                                  multi_date=True),
            BATCH, shuffle=True, seed=epoch, skip_batches=sk,
            ragged_tail=True)
        theirs = jax_pipeline.batch_iterator(
            jax_pipeline.PatchSampler(dataset, md, PATCH, True,
                                      multi_date=True,
                                      compat_aug_stream=theirs_stream),
            BATCH, shuffle=True, seed=epoch, skip_batches=sk,
            ragged_tail=True)
        assert _assert_batches_equal(ours, theirs) == 5 - sk
    assert ours_stream.random() == theirs_stream.random()


def test_multidate_worker_batches_equal_the_thread(data):
    """2 worker processes filling the ring's imgs slots: the thread's
    batches bit for bit, two epochs, augmented and padded."""
    dataset, md = data
    with loader.BatchLoader(loader.share_dataset(dataset), md, PATCH, True,
                            5, shuffle=True, num_workers=2, device="cpu",
                            multi_date=True) as workers:
        for seed in (1, 2):
            thread = pipeline.batch_iterator(
                pipeline.PatchSampler(dataset, md, PATCH, True,
                                      multi_date=True), 5, shuffle=True,
                seed=seed)
            assert _assert_batches_equal(workers.epoch(seed=seed),
                                         thread) == 4


def test_loader_refuses_a_ring_that_does_not_fit_dev_shm(data,
                                                         monkeypatch):
    """/dev/shm with room for the dataset but not the ring: BatchLoader
    raises naming both byte counts, before any ring or worker exists."""
    dataset, md = data
    shared = loader.share_dataset(dataset)
    ring = loader.ring_bytes(3, 2, 128, 96, T, 13, True)
    assert ring == 8 * (128 * T * 96 * 96 * 13 * 4 + 128 * 96 * 96 * 4
                        + 128 * 4)
    usage = namedtuple("usage", "total used free")
    monkeypatch.setattr(loader.shutil, "disk_usage",
                        lambda path: usage(2 * ring, ring + 1, ring - 1))
    made = []
    monkeypatch.setattr(loader.torch.utils.data, "DataLoader",
                        lambda *a, **k: made.append(a))
    with pytest.raises(RuntimeError) as e:
        loader.BatchLoader(shared, md, 96, True, 128, shuffle=True,
                           num_workers=3, prefetch=2, device="cpu",
                           multi_date=True)
    msg = str(e.value)
    assert (f"needs {ring} bytes" in msg and f"{ring - 1} bytes free" in msg
            and f"dataset's {shared.nbytes} bytes" in msg and "8 slots" in msg)
    assert made == []
    with pytest.raises(RuntimeError, match="the shared dataset needs"):
        monkeypatch.setattr(loader.shutil, "disk_usage",
                            lambda path: usage(1, 1, 0))
        loader.share_dataset(dataset)


# --- train steps ----------------------------------------------------------

def variables(name, seed=0):
    """A tree of ``name`` (base 8) with non-trivial BatchNorm params and
    running statistics, as numpy."""
    params, stats = weights.init_variables(
        13, 2, BASE, torch.Generator().manual_seed(seed), name)
    rng = np.random.RandomState(seed)

    def walk(p, s):
        for k in sorted(p):
            if k.startswith("bn"):
                c = p[k]["scale"].shape[0]
                p[k]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                p[k]["bias"] = (rng.randn(c) * 0.1).astype(np.float32)
                s[k]["mean"] = (rng.randn(c) * 0.1).astype(np.float32)
                s[k]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            elif k in s:
                walk(p[k], s[k])
    walk(params, stats)
    return params, stats


def batch(seed, n=BATCH):
    rng = np.random.RandomState(seed)
    imgs = rng.randn(n, T, PATCH, PATCH, 13).astype(np.float32)
    label = (rng.rand(n, PATCH, PATCH) < 0.3).astype(np.int32)
    imgs[:, -1][label == 1] += 1.5
    return {"imgs": imgs, "label": label, "weight": np.ones(n, np.float32)}


RUNS = {
    "unet_lstm": dict(model="unet_lstm"),
    "unet3d": dict(model="unet3d"),
    "unet_lstm_local_upsample": dict(model="unet_lstm", local_upsample=True),
    "unet_lstm_momentum": dict(model="unet_lstm", momentum=0.9,
                               lr_schedule="cosine", lr_decay_steps=6,
                               lr_warmup_steps=1),
    "unet3d_adam": dict(model="unet3d", optimizer="adam",
                        learning_rate=0.003, lr_schedule="cosine",
                        lr_decay_steps=6, lr_warmup_steps=1),
    "unet_lstm_bf16": dict(model="unet_lstm", dtype="bfloat16"),
}


def configs(name):
    kw = {"model_base": BASE, "patch_size": PATCH, "batch_size": BATCH,
          "num_dates": T, "dtype": "float32", "learning_rate": 0.05,
          **RUNS[name]}
    return jax_config.Config(**kw), config.Config(**kw)


def run_both(name, n_steps):
    """The same variables and batches through ``n_steps`` steps of each
    package; returns ([(jax_state, jax_stats, port_flat, port_stats)],
    (jax_state, jax_step, port_state, port_step))."""
    jcfg, pcfg = configs(name)
    params, stats = variables(pcfg.model)
    jstate = jax_create_state(jcfg, jax_build_model(jcfg), variables={
        "params": params, "batch_stats": stats})
    jstep = jax_make_train_step(jax_build_model(jcfg),
                                jax_losses.get_loss_fn(jcfg), donate=False)
    pmodel = build_model(pcfg, "cpu", fold_bn=False,
                         variables=(params, stats), train=True)
    pstate = create_state(pcfg, pmodel)
    pstep = make_train_step(pmodel, losses.get_loss_fn(pcfg))
    out = []
    for i in range(n_steps):
        b = batch(i)
        jstate, jstats = jstep(jstate, b)
        pstate, pstats = pstep(pstate, {k: torch.from_numpy(v)
                                        for k, v in b.items()})
        out.append((jstate, jax.device_get(jstats),
                    flat(dict(zip(("params", "batch_stats"),
                                  pstate.variables()))),
                    {k: v.numpy() for k, v in pstats.items()}))
    return out, (jstate, jstep, pstate, pstep)


@pytest.fixture(scope="module")
def runs():
    """run_both(name, 3) once per module (one compile of fabric_tpu's
    train step per config)."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = run_both(name, 3)
        return cache[name]
    return get


@pytest.mark.parametrize("name", ["unet_lstm", "unet3d",
                                  "unet_lstm_local_upsample"])
def test_one_train_step_matches_fabric_tpu(runs, name):
    """tversky + SGD, fp32, from identical variables: the loss within 1e-6
    relative, params within 1e-5, BatchNorm running statistics within
    1e-6 (relative, 1e-6 floor; sums and convolutions in another order),
    confusion counts equal.  UNetLSTM's gates/{kernel,bias} take the
    gradient summed over the T steps of the ConvLSTM; with
    local_upsample its train forward computes the gate conv with
    F.conv2d, as fabric_tpu computes it with XLA."""
    jstate, jstats, pflat, pstats = runs(name)[0][0]
    np.testing.assert_allclose(pstats["loss"], jstats["loss"], rtol=1e-6)
    for k in ("tp", "fp", "fn", "tn"):
        assert int(pstats[k]) == int(jstats[k]), k
    want = flat({"params": jax.device_get(jstate.params),
                 "batch_stats": jax.device_get(jstate.batch_stats)})
    assert want.keys() == pflat.keys()
    for k in want:
        if k.startswith("params"):
            np.testing.assert_allclose(pflat[k], want[k], rtol=0, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(pflat[k], want[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)
    if "lstm" in name:  # the gates' update itself, within 1% of its size
        gates = "params.bottleneck_lstm.gates.kernel"
        start = flat({"params": variables("unet_lstm")[0]})[gates]
        step = want[gates] - start
        assert np.abs(step).max() > 0
        assert np.abs(pflat[gates] - start - step).max() <= \
            0.01 * np.abs(step).max()
    assert int(jstate.step) == 1


@pytest.mark.parametrize("name", ["unet_lstm_momentum", "unet3d_adam"])
def test_three_steps_match_fabric_tpu(runs, name):
    """fp32 trajectories of SGD with momentum and of Adam under a cosine
    warmup schedule: params within 1e-4 after step 3.  Under Adam the
    bias of a conv that feeds a train-mode BatchNorm has a zero gradient
    in exact arithmetic, and both sides follow rounding noise there, which
    Adam scales up to the learning rate: those biases are held to 2.02 x
    the summed learning rate (tests/test_torch_train.py's rule).  The
    ConvLSTM's gate bias feeds no BatchNorm and keeps 1e-4."""
    jstate, _, pflat, _ = runs(name)[0][-1]
    assert int(jstate.step) == 3
    want = flat({"params": jax.device_get(jstate.params)})
    noise = 1e-4
    if "adam" in name:
        schedule = make_schedule(configs(name)[1])
        noise = 2.02 * sum(schedule(t) for t in range(3))
    for k in want:
        tol = noise if k.endswith(("conv1.bias", "conv2.bias")) else 1e-4
        np.testing.assert_allclose(pflat[k], want[k], rtol=0, atol=tol,
                                   err_msg=k)


def test_bf16_train_step_loss_matches_fabric_tpu(runs):
    """bf16 compute: the two sides round at other places (the port rounds
    each conv once after the fp32 bias; XLA keeps chains of the gates'
    elementwise ops in float32), so the loss agrees within 1e-2
    relative."""
    _, jstats, _, pstats = runs("unet_lstm_bf16")[0][0]
    np.testing.assert_allclose(pstats["loss"], jstats["loss"], rtol=1e-2)


@pytest.mark.parametrize("name", ["unet_lstm_momentum", "unet3d_adam"])
def test_checkpoints_restore_both_ways(runs, name, tmp_path):
    """After 3 steps: the port's save restores in fabric_tpu.checkpoint
    into create_state's template, and fabric_tpu's in the port, with
    params, batch_stats, opt_state (optax's layout, the flax paths
    bottleneck_lstm/gates/{kernel,bias} and UNet3D's 3-D blocks
    included) and step equal; the next step from the port's restored
    state matches fabric_tpu's next step (loss within 1e-6 relative)."""
    from flax import serialization
    from fabric_tpu import checkpoint as jax_ckpt

    _, (jstate, jstep, pstate, pstep) = runs(name)
    jcfg, pcfg = configs(name)
    params, stats = variables(pcfg.model)

    def trees(params, batch_stats, opt_state, step):
        return flat({"params": params, "batch_stats": batch_stats,
                     "opt_state": opt_state, "step": np.asarray(step)})

    def jax_trees(s):
        return trees(*jax.device_get((s.params, s.batch_stats)),
                     serialization.to_state_dict(
                         jax.device_get(s.opt_state)), int(s.step))

    def assert_equal(a, b):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    port = trees(*pstate.variables(), pstate.opt_state, pstate.step)
    if pcfg.model == "unet_lstm":
        assert "opt_state.0.trace.bottleneck_lstm.gates.kernel" in port
    path = checkpoint.save(pstate, str(tmp_path / "port"), epoch=3)
    template = jax_create_state(jcfg, jax_build_model(jcfg), variables={
        "params": params, "batch_stats": stats})
    assert_equal(jax_trees(jax_ckpt.restore(template, path)), port)

    jpath = jax_ckpt.save(jstate, str(tmp_path / "jax"), epoch=3)
    restored = create_state(pcfg, build_model(
        pcfg, "cpu", fold_bn=False, variables=(params, stats), train=True))
    restored, meta = checkpoint.restore(restored, jpath)
    assert_equal(trees(*restored.variables(), restored.opt_state,
                       restored.step), jax_trees(jstate))
    assert meta["epoch"] == 3 and meta["step"] == 3

    b = batch(99)
    _, jstats = jstep(jstate, b)
    _, pstats = make_train_step(restored.model, losses.get_loss_fn(pcfg))(
        restored, {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(pstats["loss"].item(), jstats["loss"],
                               rtol=1e-6)


def test_signed_gate_cache_picks_up_an_optimizer_update():
    """A bf16 UNetLSTM built with local_upsample serves its gate conv on
    the signed route ([K, -K] on the conv kernel, here its plain version,
    cached on the gate tensors' data_ptr and version).  After an
    optimizer step in place, the cache holds the new weights, and the
    eval forward (the loop's validation and scene inference) equals a
    fresh model's on the updated variables."""
    _, pcfg = configs("unet_lstm_local_upsample")
    pcfg = dataclasses.replace(pcfg, dtype="bfloat16")
    model = build_model(pcfg, "cpu", fold_bn=False,
                        variables=variables("unet_lstm"), train=True)
    cell = model.bottleneck_lstm
    state = create_state(pcfg, model)
    x = torch.from_numpy(batch(5)["imgs"])
    eval_step = make_eval_step(model, losses.get_loss_fn(pcfg))
    with torch.no_grad():
        model(x)  # fills the cache
    assert getattr(cell, "_signed_key", None) is not None
    old = cell.signed_gates()[0].clone()
    make_train_step(model, losses.get_loss_fn(pcfg))(
        state, {k: torch.from_numpy(v) for k, v in batch(0).items()})
    kk = cell.signed_gates()[0]
    assert not torch.equal(kk, old)
    assert torch.equal(kk, torch.cat([cell.gates.kernel,
                                      -cell.gates.kernel], -1))
    fresh = build_model(pcfg, "cpu", fold_bn=False,
                        variables=state.variables(), train=True)
    b = {k: torch.from_numpy(v) for k, v in batch(5).items()}
    got = eval_step(state, b)
    want = make_eval_step(fresh, losses.get_loss_fn(pcfg))(
        create_state(pcfg, fresh), b)
    assert torch.equal(got["preds"], want["preds"])
    assert got["loss"].item() == want["loss"].item()


# --- the loop and evaluate ------------------------------------------------

@pytest.fixture(scope="module", params=["unet_lstm", "unet3d"])
def trained(request, data_dir, tmp_path_factory):
    """One epoch of the port's loop, 3 steps, with validation, scene
    inference of gamma and a checkpoint (tests/test_variant_e2e.py's
    run)."""
    from fabric_tpu_torch.train.loop import train
    root = tmp_path_factory.mktemp(request.param)
    cfg = config.Config(
        model=request.param, model_base=BASE, num_dates=T,
        dataset_dir=data_dir, weight_dir=str(root / "weights"),
        log_dir=str(root / "logs"), patch_size=PATCH, stride=16,
        batch_size=BATCH, epochs=1, learning_rate=0.05, dtype="float32",
        validation_cities=["gamma"], steps_per_epoch=3, prefetch=1,
        num_workers=0)
    state, history = train(cfg, run_scene_inference=True, device="cpu")
    return cfg, state, history


def test_loop_trains_a_multidate_model_with_scene_inference(trained):
    cfg, state, history = trained
    assert history["status"] == "complete" and len(history["train"]) == 1
    assert history["train"][0]["cd_losses"] > 0 and state.step == 3
    assert 0.0 <= history["val"][0]["gamma_scene_f1"] <= 1.0
    assert any(f.endswith(".msgpack") for f in os.listdir(cfg.weight_dir))
    run_dir = os.path.join(cfg.log_dir, sorted(os.listdir(cfg.log_dir))[-1])
    files = os.listdir(run_dir)
    assert any("gamma_epoch_0" in f for f in files)
    assert any("cd_sample_0" in f for f in files)
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rec = [json.loads(line) for line in f]
    perf = next(r for r in rec if "train_examples_per_sec" in r)
    assert perf["train_steps"] == 3


def test_evaluate_matches_the_loop_and_fabric_tpu(trained):
    """evaluate() on the loop's checkpoint gives the validation metrics
    the loop recorded; fabric_tpu.evaluate on the same weights and 3-date
    dataset gives the same confusion-derived patch and scene metrics, the
    loss within 1e-5 relative (fp32 convolutions in another order)."""
    from fabric_tpu.evaluate import evaluate as jax_evaluate
    from fabric_tpu_torch.evaluate import evaluate
    cfg, _, history = trained
    path = checkpoint.read_pointer(cfg.weight_dir, "best")
    d = {**cfg.to_dict(), "resume": path}
    ours = evaluate(config.Config.from_dict(d), device="cpu")
    keys = ("cd_losses", "cd_corrects", "cd_precisions", "cd_recalls",
            "cd_f1scores", "global_precision", "global_recall",
            "global_f1", "global_accuracy")
    for k in keys:
        assert ours["patch"][k] == history["val"][0][k], k
    assert ours["scenes"]["gamma"]["f1"] == history["val"][0][
        "gamma_scene_f1"]
    jcfg = jax_config.Config.from_dict({**d, "mesh_data": 1})
    params, stats = checkpoint.load_variables(path)
    jstate = jax_create_state(jcfg, jax_build_model(jcfg), variables={
        "params": params, "batch_stats": stats})
    theirs = jax_evaluate(jcfg, state=jstate)
    for k in keys:
        np.testing.assert_allclose(
            ours["patch"][k], theirs["patch"][k],
            rtol=1e-5 if k == "cd_losses" else 0, atol=0, err_msg=k)
    for k in ("num_batches", "num_samples"):
        assert ours["patch"][k] == theirs["patch"][k], k
    assert ours["scenes"] == theirs["scenes"]


def test_cli_train_and_evaluate_multidate(data_dir, tmp_path):
    """cli.train then cli.evaluate of a UNet3D on the 3-date dataset."""
    from fabric_tpu_torch.cli.evaluate import main as evaluate_main
    from fabric_tpu_torch.cli.train import main as train_main
    common = ["--model", "unet3d", "--num_dates", str(T), "--dataset_dir",
              data_dir, "--patch_size", str(PATCH), "--stride", "16",
              "--batch_size", str(BATCH), "--dtype", "float32",
              "--model_base", str(BASE), "--validation_cities", '["gamma"]',
              "--num_workers", "0", "--device", "cpu"]
    assert train_main(common + ["--epochs", "1", "--steps_per_epoch", "2",
                                "--weight_dir", str(tmp_path / "w"),
                                "--log_dir", str(tmp_path / "l")]) == 0
    out = str(tmp_path / "m.json")
    assert evaluate_main(common + ["--resume", str(tmp_path / "w"),
                                   "--output", out]) == 0
    with open(out) as f:
        result = json.load(f)
    assert result["patch"]["num_samples"] == 9
    assert set(result["scenes"]) == {"gamma"}
    shutil.rmtree(tmp_path / "w")


def test_loop_compat_reference_and_accumulation_multidate(data_dir,
                                                          tmp_path):
    """compat_reference (one thread, the sequential augmentation stream,
    the ragged last batch: 18 patches at batch 4) and grad_accum_steps=2
    take the multi-date batch unchanged: a UNet3D epoch of 5 micro steps
    makes 2 optimizer updates and keeps the fifth micro step's gradient
    in the running mean."""
    from fabric_tpu_torch.train.loop import train
    cfg = config.Config(
        model="unet3d", model_base=BASE, num_dates=T, dataset_dir=data_dir,
        weight_dir=str(tmp_path / "w"), log_dir=str(tmp_path / "l"),
        patch_size=PATCH, stride=16, batch_size=BATCH, epochs=1,
        learning_rate=0.05, dtype="float32", validation_cities=["gamma"],
        compat_reference=True, grad_accum_steps=2, num_workers=2,
        prefetch=1)
    state, history = train(cfg, run_scene_inference=False, device="cpu")
    assert history["status"] == "complete"
    assert state.step == 5 and state.tx.gradient_step == 2
    assert state.tx.mini_step == 1
