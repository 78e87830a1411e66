"""The port's data path and training loop (fabric_tpu_torch.data,
train.loop, cli.train) on the CPU: the synthetic dataset, loaders and
batches equal fabric_tpu's; the loop trains end to end on synthetic data;
a run interrupted by a crash or a preemption request resumes mid-epoch to
bit-identical parameters and the same epoch metrics; a non-finite loss
halts without overwriting the last finite periodic checkpoint."""

import glob
import json
import os

import numpy as np
import pytest

from fabric_tpu.config import Config as JaxConfig
from fabric_tpu.data import oscd as jax_oscd
from fabric_tpu.data import pipeline as jax_pipeline
from fabric_tpu.data.synthetic import generate_synthetic_dataset as jax_gen

from fabric_tpu_torch import checkpoint
from fabric_tpu_torch.config import Config
from fabric_tpu_torch.data import oscd, pipeline
from fabric_tpu_torch.data.synthetic import generate_synthetic_dataset
from fabric_tpu_torch.train import loop as loop_mod
from fabric_tpu_torch.train.preemption import PreemptionGuard

CITIES = ["alpha", "beta", "gamma"]
SIZES = [(128, 128), (96, 128), (64, 64)]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_loop")
    generate_synthetic_dataset(str(root / "data"), Config(), cities=CITIES,
                               sizes=SIZES, seed=11)
    return root


def test_synthetic_dataset_and_loaders_match_fabric_tpu(data_root):
    """The same seed writes the same files; the loaders read the same
    labels, and the same bands up to the normalisation's rounding (the
    port multiplies by 1/std, fabric_tpu's numpy path divides)."""
    jax_root = str(data_root / "jax_data")
    jax_gen(jax_root, JaxConfig(), cities=CITIES, sizes=SIZES, seed=11)
    ours = sorted(glob.glob(str(data_root / "data" / "**" / "*.*"),
                            recursive=True))
    theirs = sorted(glob.glob(os.path.join(jax_root, "**", "*.*"),
                              recursive=True))
    assert [os.path.relpath(p, data_root / "data") for p in ours] == [
        os.path.relpath(p, jax_root) for p in theirs]
    for a, b in zip(ours, theirs):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), a
    cfg, jcfg = Config(), JaxConfig()
    data_dir = str(data_root / "data")
    assert oscd.get_train_val_metadata(data_dir, ["gamma"], 32, 16) == \
        jax_oscd.get_train_val_metadata(data_dir, ["gamma"], 32, 16)
    got = oscd.full_load(data_dir, cfg)
    for city in CITIES:
        want = jax_oscd.load_city(data_dir, city, jcfg)
        np.testing.assert_allclose(got[city]["images"], want, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(got[city]["labels"],
                                      jax_oscd.load_label(data_dir, city))


@pytest.mark.parametrize("pad_mode,skip", [("wrap", 0), ("wrap", 2),
                                           ("mask", 1)])
def test_batches_match_fabric_tpu(data_root, pad_mode, skip):
    """Same dataset, seed and shuffle: identical augmented batches and
    weights, also when fast-forwarded past ``skip`` batches."""
    data = oscd.full_load(str(data_root / "data"), Config())
    train_md, _ = oscd.metadata_from_dataset(data, ["gamma"], 32, 32)
    ours = pipeline.batch_iterator(
        pipeline.PatchSampler(data, train_md, 32, augment=True), 5,
        shuffle=True, pad_mode=pad_mode, seed=4, skip_batches=skip)
    theirs = jax_pipeline.batch_iterator(
        jax_pipeline.PatchSampler(data, train_md, 32, augment=True, seed=4),
        5, shuffle=True, pad_mode=pad_mode, seed=4, skip_batches=skip)
    n = 0
    for a, b in zip(ours, theirs, strict=True):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        n += 1
    assert n == -(-len(train_md) // 5) - skip


def _cfg(root, weights, logs, **kw):
    """The test_midepoch_resume.py configuration at base 8: 28 train
    patches at batch 4 -> 7 steps per epoch."""
    return Config(dataset_dir=str(root / "data"), patch_size=32, stride=32,
                  batch_size=4, epochs=2, dtype="float32", model_base=8,
                  augmentation=True, validation_cities=["gamma"],
                  weight_dir=str(root / weights), log_dir=str(root / logs),
                  checkpoint_every=5, seed=3, **kw)


@pytest.fixture(scope="module")
def uninterrupted(data_root):
    cfg = _cfg(data_root, "w_full", "l_full")
    return loop_mod.train(cfg, run_scene_inference=False, device="cpu")


class _Killed(RuntimeError):
    pass


def _wrap_train_step(monkeypatch, hook):
    """Make the loop's train step call ``hook(state)`` before each step."""
    real = loop_mod.make_train_step

    def make(model, loss_fn):
        step = real(model, loss_fn)

        def wrapped(state, batch):
            hook(state)
            return step(state, batch)
        return wrapped
    monkeypatch.setattr(loop_mod, "make_train_step", make)


def _assert_same_run(a, b):
    (state_a, hist_a), (state_b, hist_b) = a, b
    assert state_b.step == state_a.step == 14
    va, vb = state_a.variables(), state_b.variables()
    for ta, tb in zip(va, vb):
        fa, fb = _flat(ta), _flat(tb)
        assert fa.keys() == fb.keys()
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    assert len(hist_b["train"]) == 1
    for part in ("train", "val"):
        for key, value in hist_a[part][1].items():
            assert hist_b[part][0][key] == pytest.approx(value, abs=1e-9), key


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_kill_and_resume_matches_uninterrupted(data_root, uninterrupted,
                                               monkeypatch):
    """A crash after step 10 (saved at step 10, mid-epoch 1) and a resume
    from the weight dir give bit-identical params, BatchNorm statistics
    and the same epoch metrics as the uninterrupted run (fp32, CPU)."""
    def crash(state):
        if state.step >= 10:
            raise _Killed(f"simulated crash at step {state.step}")
    _wrap_train_step(monkeypatch, crash)
    with pytest.raises(_Killed):
        loop_mod.train(_cfg(data_root, "w_kill", "l_kill"),
                       run_scene_inference=False, device="cpu")
    monkeypatch.undo()
    latest = checkpoint.latest_checkpoint(str(data_root / "w_kill"))
    assert latest.endswith("periodic_epoch_1.msgpack")
    resumed = loop_mod.train(
        _cfg(data_root, "w_kill", "l_resume",
             resume=str(data_root / "w_kill")),
        run_scene_inference=False, device="cpu")
    _assert_same_run(uninterrupted, resumed)
    # the periodic and best-metric sidecars of an epoch coexist
    names = set(os.listdir(data_root / "w_kill"))
    assert {"metadata_periodic_epoch_0.json", "metadata_epoch_0.json"} <= names
    with open(data_root / "w_kill" / "metadata_periodic_epoch_1.json") as f:
        side = json.load(f)
    assert side["periodic"] and len(side["train_rows"]) == side[
        "batches_done"]


def test_preemption_request_resumes_exactly(data_root, uninterrupted,
                                            monkeypatch):
    """guard.request() during step 9 (mid-epoch 1): the loop saves at that
    step boundary and returns status "preempted"; the resumed run equals
    the uninterrupted one."""
    guard = PreemptionGuard()

    def notice(state):
        if state.step == 8:
            guard.request()
    _wrap_train_step(monkeypatch, notice)
    state, hist = loop_mod.train(_cfg(data_root, "w_pre", "l_pre"),
                                 run_scene_inference=False, device="cpu",
                                 preemption_guard=guard)
    monkeypatch.undo()
    assert hist["status"] == "preempted" and state.step == 9
    meta = json.loads(open(data_root / "w_pre" /
                           "metadata_periodic_epoch_1.json").read())
    assert meta["batches_done"] == 2 and meta["step"] == 9
    resumed = loop_mod.train(
        _cfg(data_root, "w_pre", "l_pre2", resume=str(data_root / "w_pre")),
        run_scene_inference=False, device="cpu")
    _assert_same_run(uninterrupted, resumed)


def test_nan_after_periodic_save_keeps_finite_checkpoint(data_root,
                                                         monkeypatch):
    """A NaN loss from step 5 halts at the step-6 periodic sync with
    status "diverged", leaving the step-4 save as the resume point."""
    import torch
    real = loop_mod.make_train_step

    def make(model, loss_fn):
        step = real(model, loss_fn)

        def wrapped(state, batch):
            state, stats = step(state, batch)
            if state.step >= 5:
                stats["loss"] = stats["loss"] * torch.tensor(float("nan"))
            return state, stats
        return wrapped
    monkeypatch.setattr(loop_mod, "make_train_step", make)
    cfg = _cfg(data_root, "w_nan", "l_nan")
    cfg.checkpoint_every = 2
    with pytest.raises(FloatingPointError, match="periodic-checkpoint"):
        loop_mod.train(cfg, run_scene_inference=False, device="cpu")
    monkeypatch.undo()
    status = glob.glob(os.path.join(cfg.log_dir, "*", "status.json"))
    assert json.load(open(status[0]))["status"] == "diverged"
    meta = checkpoint.read_payload(checkpoint.latest_checkpoint(
        cfg.weight_dir))
    assert meta["step"] == 4
    assert all(np.isfinite(v).all() for v in _flat(meta["params"]).values())


def test_train_loop_end_to_end(tmp_path):
    """tests/test_train_e2e.py's configuration through the port's CLI on
    the CPU: the loss falls over 2 epochs, validation F1 > 0.45, a best
    checkpoint with its sidecar and best.json, the scene image logged."""
    from fabric_tpu_torch.cli.train import main
    cfg = Config(dataset_dir=str(tmp_path / "data"),
                 weight_dir=str(tmp_path / "weights"),
                 log_dir=str(tmp_path / "logs"))
    generate_synthetic_dataset(cfg.dataset_dir, cfg, seed=3)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(dict(
        dataset_dir=cfg.dataset_dir, weight_dir=cfg.weight_dir,
        log_dir=cfg.log_dir, patch_size=16, stride=16, batch_size=8,
        epochs=2, learning_rate=0.05, dtype="float32",
        validation_cities=["beta"], augmentation=True, num_workers=0,
        prefetch=1, seed=0)))
    assert main(["--config", str(cfg_path), "--device", "cpu"]) == 0
    run_dir = glob.glob(os.path.join(cfg.log_dir, "*"))[0]
    records = [json.loads(line) for line in open(
        os.path.join(run_dir, "metrics.jsonl"))]
    train_loss = [r["train_cd_losses"] for r in records
                  if "train_cd_losses" in r]
    val_f1 = [r["validate_cd_f1scores"] for r in records
              if "validate_cd_f1scores" in r]
    assert len(train_loss) == 2 and train_loss[1] < train_loss[0]
    assert val_f1[-1] > 0.45
    files = set(os.listdir(cfg.weight_dir))
    assert {"best.json", "latest.json"} <= files
    best = checkpoint.read_pointer(cfg.weight_dir, "best")
    epoch = int(best.rsplit("_", 1)[1].split(".")[0])
    assert f"metadata_epoch_{epoch}.json" in files
    assert any(f.startswith("beta_epoch") for f in os.listdir(run_dir))
    assert json.load(open(os.path.join(run_dir, "status.json")))[
        "status"] == "complete"


def test_prune_keeps_the_newest_and_what_pointers_name(tmp_path):
    """keep_last deletes older saves of a tag with their sidecars; a save
    that latest.json or best.json names survives any prune."""
    from fabric_tpu_torch.models import build_model
    from fabric_tpu_torch.train.state import create_state
    cfg = Config(model_base=8, dtype="float32")
    state = create_state(cfg, build_model(cfg, "cpu", fold_bn=False,
                                          train=True))
    d = str(tmp_path)
    for epoch in range(4):
        checkpoint.save(state, d, epoch, tag="periodic", keep_last=2)
    names = set(os.listdir(d))
    assert {n for n in names if n.startswith("periodic")} == {
        "periodic_epoch_2.msgpack", "periodic_epoch_3.msgpack"}
    assert "metadata_periodic_epoch_0.json" not in names
    paths = [checkpoint.save(state, d, e) for e in range(3)]
    checkpoint._write_pointer(d, "best", paths[0], 0, "checkpoint")
    assert checkpoint.prune(d, 1, "checkpoint") == [paths[1]]
    assert os.path.exists(paths[0]) and os.path.exists(paths[2])
    assert checkpoint.latest_checkpoint(d) == paths[2]
    assert checkpoint.latest_checkpoint(d, tag="periodic").endswith(
        "periodic_epoch_3.msgpack")


@pytest.mark.parametrize("kw", [dict(mesh_model=2),
                                dict(mesh_spatial=2)])
def test_unported_options_raise(kw, tmp_path):
    """The spatial and model axes are ported (item 10c): in one process a
    mesh of 2 is larger than the world, and raises a ValueError
    (tests/test_torch_spatial.py trains on such meshes over process
    groups of their size)."""
    cfg = Config(log_dir=str(tmp_path / "l"), weight_dir=str(tmp_path / "w"),
                 **kw)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        loop_mod.train(cfg, dataset={}, device="cpu", metadata=([], []))


def test_gs_resume_is_gated(tmp_path, monkeypatch):
    """A gs:// resume target needs gsutil or gcloud on PATH; without them
    the store refuses it before any transfer."""
    import fabric_tpu_torch.store as store_mod
    monkeypatch.setattr(store_mod.shutil, "which", lambda _: None)
    cfg = Config(log_dir=str(tmp_path / "l"), weight_dir=str(tmp_path / "w"),
                 resume="gs://b/ckpt", model_base=8, num_workers=0)
    with pytest.raises(RuntimeError, match="gsutil or gcloud"):
        loop_mod.train(cfg, dataset={}, device="cpu", metadata=([], []))


@pytest.mark.parametrize("flag,item", [
    ("mesh_spatial", "10c"), ("mesh_model", "10c")])
def test_unported_flag_names_its_roadmap_item(flag, item, tmp_path):
    """Item ``item`` is done: the flag at 2 in one process is a mesh
    larger than the world, a ValueError that names the mesh and no
    ROADMAP.md item."""
    cfg = Config(log_dir=str(tmp_path / "l"), weight_dir=str(tmp_path / "w"),
                 **{flag: 2})
    shape = "1x2x1" if flag == "mesh_spatial" else "1x1x2"
    with pytest.raises(ValueError,
                       match=f"^mesh {shape} needs 2 devices, have 1 ") as e:
        loop_mod.train(cfg, dataset={}, device="cpu", metadata=([], []))
    assert "ROADMAP" not in str(e.value) and item not in str(e.value)


def test_infer_city_matches_fabric_tpu(data_root):
    """The port's runner (device tiler, unfolded eval forward) against
    fabric_tpu's infer_city (host tiler, jitted eval step) on a synthetic
    city, fp32, same weights: equal masks."""
    import torch
    from fabric_tpu.infer.runner import infer_city as jax_infer_city
    from fabric_tpu.models import build_model as jax_build_model
    from fabric_tpu.train.state import create_state as jax_create_state
    from fabric_tpu.train.steps import make_infer_step as jax_infer_step
    from fabric_tpu_torch import weights
    from fabric_tpu_torch.infer.runner import infer_city
    from fabric_tpu_torch.models import build_model
    kw = dict(dataset_dir=str(data_root / "data"), patch_size=32,
              eval_batch_size=8, model_base=8, dtype="float32")
    variables = weights.init_variables(13, 2, 8,
                                       torch.Generator().manual_seed(5))
    jcfg = JaxConfig(**kw)
    jmodel = jax_build_model(jcfg)
    jstate = jax_create_state(jcfg, jmodel, variables={
        "params": variables[0], "batch_stats": variables[1]})
    want = jax_infer_city(jax_infer_step(jmodel), jstate, jcfg, "beta")
    cfg = Config(**kw)
    got = infer_city(build_model(cfg, "cpu", fold_bn=False,
                                 variables=variables), cfg, "beta",
                     device="cpu")
    assert got.shape == want.shape == (96, 128) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
