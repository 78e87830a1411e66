"""The port's batch sources on the CPU: compat_reference's sequential
augmentation stream and ragged final batch bit-equal to fabric_tpu's
(fabric_tpu_torch.data.pipeline), the multi-worker loader's batches
bit-equal to the single thread's (fabric_tpu_torch.data.loader), and the
training loop on each: workers or the thread give the same run, and a
compat_reference run resumes mid-epoch exactly."""

import os
import random

import numpy as np
import pytest
import torch

from fabric_tpu.data import pipeline as jax_pipeline

from fabric_tpu_torch.config import Config
from fabric_tpu_torch.data import loader, oscd, pipeline
from fabric_tpu_torch.data.synthetic import generate_synthetic_dataset
from fabric_tpu_torch.train import loop as loop_mod

torch.set_num_threads(1)

CITIES = ["alpha", "beta", "gamma"]
SIZES = [(128, 128), (96, 128), (64, 64)]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_pipeline")
    generate_synthetic_dataset(str(root / "data"), Config(), cities=CITIES,
                               sizes=SIZES, seed=11)
    return root


@pytest.fixture(scope="module")
def data(data_root):
    """The dataset and its 28 training patches at patch 32."""
    dataset = oscd.full_load(str(data_root / "data"), Config())
    train_md, _ = oscd.metadata_from_dataset(dataset, ["gamma"], 32, 32)
    assert len(train_md) == 28
    return dataset, train_md


def _assert_batches_equal(ours, theirs):
    n = 0
    for a, b in zip(ours, theirs, strict=True):
        assert a.keys() == b.keys()
        for k in b:
            got = a[k].numpy() if isinstance(a[k], torch.Tensor) else a[k]
            assert got.dtype == b[k].dtype, k
            np.testing.assert_array_equal(got, b[k], err_msg=k)
        n += 1
    return n


# --- compat_reference: the sequential stream and the ragged tail ------------

@pytest.mark.parametrize("batch_size,skip,max_batches", [
    (5, 0, 0), (5, 2, 0), (5, 6, 0), (4, 3, 0), (5, 0, 4)])
def test_compat_stream_batches_match_fabric_tpu(data, batch_size, skip,
                                                max_batches):
    """One random.Random(7) stream across two epochs, ragged final batch
    (28 % 5 = 3 rows), fast-forwarded past ``skip`` batches of the first
    epoch: every batch, including the short one, bit-equal to fabric_tpu's,
    and the streams end in the same state."""
    dataset, md = data
    ours_stream, theirs_stream = random.Random(7), random.Random(7)
    sampler = pipeline.PatchSampler(dataset, md, 32, augment=True,
                                    compat_aug_stream=ours_stream)
    jsampler = jax_pipeline.PatchSampler(dataset, md, 32, augment=True,
                                         compat_aug_stream=theirs_stream)
    n = 0
    for epoch, s in enumerate((skip, 0)):
        kw = dict(shuffle=True, pad_mode="wrap", seed=3 + epoch,
                  max_batches=max_batches, skip_batches=s, ragged_tail=True)
        n += _assert_batches_equal(
            pipeline.batch_iterator(sampler, batch_size, **kw),
            jax_pipeline.batch_iterator(jsampler, batch_size, **kw))
    full = -(-28 // batch_size) if not max_batches else max_batches
    assert n == 2 * full - skip
    assert ours_stream.getstate() == theirs_stream.getstate()


def test_compat_stream_refuses_padding(data):
    """Padded rows would draw augmentation the reference's ragged batch
    never draws: both packages refuse, unless the cap stops before them."""
    dataset, md = data
    for mod in (pipeline, jax_pipeline):
        sampler = mod.PatchSampler(dataset, md, 32, augment=True,
                                   compat_aug_stream=random.Random(0))
        with pytest.raises(ValueError, match="ragged_tail"):
            next(mod.batch_iterator(sampler, 5, shuffle=False))
        assert len(list(mod.batch_iterator(sampler, 5, shuffle=False,
                                           max_batches=5))) == 5


def test_replay_aug_draws_matches_fabric_tpu_and_sampling(data):
    """Replaying r rows leaves the stream where sampling r augmented
    patches leaves it, in both packages."""
    dataset, md = data
    sampled = random.Random(5)
    sampler = pipeline.PatchSampler(dataset, md, 32, augment=True,
                                    compat_aug_stream=sampled)
    for i in range(13):
        sampler.sample(i, None)
    ours, theirs = random.Random(5), random.Random(5)
    pipeline.replay_aug_draws(ours, 13)
    jax_pipeline.replay_aug_draws(theirs, 13)
    assert ours.getstate() == theirs.getstate() == sampled.getstate()


def test_epoch_train_rows_matches_fabric_tpu():
    for n in (1, 7, 28, 30):
        for bs in (1, 4, 5, 32):
            for cap in (0, 1, 3, 9):
                for ragged in (False, True):
                    args = (n, bs, cap, ragged)
                    assert pipeline.epoch_train_rows(*args) == \
                        jax_pipeline.epoch_train_rows(*args), args


# --- the multi-worker loader --------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(augment=True, shuffle=True, pad_mode="wrap", seed=4, skip=0,
         max_batches=0),
    dict(augment=True, shuffle=True, pad_mode="wrap", seed=9, skip=2,
         max_batches=5),
    dict(augment=False, shuffle=False, pad_mode="mask", seed=0, skip=1,
         max_batches=0),
])
def test_worker_batches_equal_batch_iterator(data, kw):
    """2 workers, batch 5 (a padded tail): the same batches, bit for bit,
    as batch_iterator's, two epochs from the same workers."""
    dataset, md = data
    with loader.BatchLoader(loader.share_dataset(dataset), md, 32,
                            kw["augment"], 5, shuffle=kw["shuffle"],
                            pad_mode=kw["pad_mode"], num_workers=2,
                            device="cpu") as workers:
        for epoch in range(2):
            seed = kw["seed"] + epoch
            n = _assert_batches_equal(
                workers.epoch(seed=seed, max_batches=kw["max_batches"],
                              skip_batches=kw["skip"]),
                pipeline.batch_iterator(
                    pipeline.PatchSampler(dataset, md, 32, kw["augment"]),
                    5, shuffle=kw["shuffle"], pad_mode=kw["pad_mode"],
                    seed=seed, max_batches=kw["max_batches"],
                    skip_batches=kw["skip"]))
            assert n == (kw["max_batches"] or 6) - kw["skip"]


def test_many_workers_reuse_a_small_ring(data):
    """12 workers (more than this machine's cores) at prefetch 1 write
    batches of one row into a ring of 14 slots, each slot reused twice
    an epoch: every batch, over two epochs, still equals the thread's."""
    dataset, md = data
    with loader.BatchLoader(loader.share_dataset(dataset), md, 32, True, 1,
                            shuffle=True, num_workers=12, device="cpu",
                            prefetch=1) as workers:
        for seed in (1, 2):
            assert _assert_batches_equal(
                workers.epoch(seed=seed),
                pipeline.batch_iterator(
                    pipeline.PatchSampler(dataset, md, 32, True), 1,
                    shuffle=True, seed=seed)) == 28


def test_worker_epoch_records_the_loaders_wait(data):
    """One worker, batch 5, 6 batches under a profiler: one ``loader.next``
    and one ``loader.upload`` a batch and a ``loader.slot`` from the third
    on, each with the batch's index as id, and ``loader.wait_s`` grows by
    at least the next and slot spans' durations."""
    from torch.profiler import ProfilerActivity, profile

    from fabric_tpu_torch.utils import profiling

    dataset, md = data
    with loader.BatchLoader(loader.share_dataset(dataset), md, 32, False, 5,
                            shuffle=False, num_workers=1,
                            device="cpu") as workers:
        profiling.clear_spans()
        before = profiling.counters().get("loader.wait_s", 0.0)
        with profile(activities=[ProfilerActivity.CPU]):
            n = sum(1 for _ in workers.epoch())
        waited = profiling.counters()["loader.wait_s"] - before
    spans = profiling.spans()
    profiling.clear_spans()
    assert n == 6
    by_name = {name: [s.id for s in spans if s.name == name]
               for name in ("loader.next", "loader.slot", "loader.upload")}
    assert by_name == {"loader.next": list(range(6)),
                       "loader.slot": list(range(2, 6)),
                       "loader.upload": list(range(6))}
    spent = sum(s.end_ns - s.start_ns for s in spans
                if s.name in ("loader.next", "loader.slot")) / 1e9
    assert spent * 0.999 - 1e-4 <= waited <= spent + 0.05 * n


def test_worker_error_reaches_the_caller(data):
    """A patch of a city the dataset lacks fails in a worker; the error
    comes out of the epoch's iteration."""
    dataset, md = data
    with loader.BatchLoader(loader.share_dataset(dataset),
                            md + [("atlantis", 0, 0)], 32, False, 29,
                            shuffle=False, num_workers=2,
                            device="cpu") as workers:
        with pytest.raises(KeyError, match="atlantis"):
            list(workers.epoch())


def test_stop_worker_server_leaves_no_process(data):
    """After the loaders close, stop_worker_server reaps the forkserver
    and the resource tracker: neither pid is left, nor any worker."""
    import multiprocessing
    from multiprocessing import forkserver, resource_tracker

    dataset, md = data
    with loader.BatchLoader(loader.share_dataset(dataset), md, 32, False, 8,
                            shuffle=False, num_workers=2,
                            device="cpu") as workers:
        assert sum(1 for _ in workers.epoch()) == 4
    pids = [forkserver._forkserver._forkserver_pid,
            resource_tracker._resource_tracker._pid]
    assert None not in pids
    loader.stop_worker_server()
    assert not multiprocessing.active_children()
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def _cfg(root, name, **kw):
    """28 train patches at patch 32, base 8, fp32."""
    return Config(dataset_dir=str(root / "data"), patch_size=32, stride=32,
                  epochs=2, dtype="float32", model_base=8,
                  augmentation=True, validation_cities=["gamma"],
                  weight_dir=str(root / name / "w"),
                  log_dir=str(root / name / "l"), seed=3, **kw)


def _assert_same_state(a, b):
    for ta, tb in zip(a.variables(), b.variables()):
        fa, fb = _flat(ta), _flat(tb)
        assert fa.keys() == fb.keys()
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_loop_with_workers_equals_the_thread(data_root):
    """loop.train with 2 worker processes and with the prefetch thread:
    bit-identical parameters, BatchNorm statistics and epoch metrics."""
    runs = [loop_mod.train(_cfg(data_root, f"w{n}", batch_size=8,
                                steps_per_epoch=3, num_workers=n),
                           run_scene_inference=False, device="cpu")
            for n in (0, 2)]
    (s0, h0), (s2, h2) = runs
    assert s0.step == s2.step == 6
    _assert_same_state(s0, s2)
    assert h0["train"] == h2["train"] and h0["val"] == h2["val"]


class _Killed(RuntimeError):
    pass


def test_compat_reference_resumes_mid_epoch_exactly(data_root, monkeypatch):
    """compat_reference at batch 5: 6 steps an epoch, the sixth on the
    3-row tail; a crash at step 8 (saved at step 8, mid-epoch 1) and a
    resume, which fast-forwards the stream past epoch 0's 28 rows and
    epoch 1's first 10, end bit-identical to the uninterrupted run."""
    kw = dict(batch_size=5, compat_reference=True, checkpoint_every=4,
              num_workers=2)
    full, hist = loop_mod.train(_cfg(data_root, "c_full", **kw),
                                run_scene_inference=False, device="cpu")
    assert full.step == 12 and len(hist["train"]) == 2
    real = loop_mod.make_train_step
    rows = []

    def make(model, loss_fn):
        step = real(model, loss_fn)

        def wrapped(state, batch):
            rows.append(batch["img1"].shape[0])
            if state.step >= 8:
                raise _Killed(f"simulated crash at step {state.step}")
            return step(state, batch)
        return wrapped
    monkeypatch.setattr(loop_mod, "make_train_step", make)
    with pytest.raises(_Killed):
        loop_mod.train(_cfg(data_root, "c_kill", **kw),
                       run_scene_inference=False, device="cpu")
    monkeypatch.undo()
    assert rows[:6] == [5, 5, 5, 5, 5, 3]
    cfg = _cfg(data_root, "c_kill", **kw)
    cfg.resume = cfg.weight_dir
    resumed, rhist = loop_mod.train(cfg, run_scene_inference=False,
                                    device="cpu")
    assert resumed.step == 12 and len(rhist["train"]) == 1
    _assert_same_state(full, resumed)
    for key, value in hist["train"][1].items():
        assert rhist["train"][0][key] == pytest.approx(value, abs=1e-9), key
