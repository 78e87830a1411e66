"""The port's profiling (fabric_tpu_torch.utils.profiling and the
training loop's ``profile_dir``) on the CPU: StepTimer's summary equals
fabric_tpu's for the same times; ``trace`` writes a non-empty
torch.profiler trace with the annotated spans; a 3-step loop run with
``profile_dir`` writes one, also when the epoch is shorter than
``profile_steps``; the loop's per-epoch ``train_`` record carries
fabric_tpu's perf keys."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from fabric_tpu.utils.profiling import StepTimer as JaxStepTimer

from fabric_tpu_torch.config import Config
from fabric_tpu_torch.data.synthetic import generate_synthetic_dataset
from fabric_tpu_torch.utils import profiling

TIMES = [0.31, 0.052, 0.049, 0.061, 0.05, 0.2, 0.048]


@pytest.mark.parametrize("times,batch_size,skip_first", [
    (TIMES, 128, 1), (TIMES, None, 0), (TIMES[:1], 4, 1), ([], 4, 1),
    (TIMES, 8, 3)])
def test_step_timer_summary_matches_fabric_tpu(times, batch_size,
                                               skip_first):
    ours, theirs = profiling.StepTimer(), JaxStepTimer()
    ours.times, theirs.times = list(times), list(times)
    assert ours.summary(batch_size, skip_first) == theirs.summary(
        batch_size, skip_first)


def test_step_timer_times_each_block():
    timer = profiling.StepTimer()
    for _ in range(3):
        with timer:
            sum(range(1000))
    assert len(timer.times) == 3 and all(t > 0 for t in timer.times)
    assert timer.summary(2)["steps"] == 3


def _traces(logdir):
    return glob.glob(os.path.join(str(logdir), "*.pt.trace.json"))


def test_trace_writes_a_trace_with_annotations(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("fabric_matmul"):
            y = x @ x
        profiling.sync(y)
    (path,) = _traces(tmp_path)
    assert os.path.getsize(path) > 0
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "fabric_matmul" in names
    assert any(e.key == "fabric_matmul" for e in prof.key_averages())


def test_sync_takes_tensors_modules_and_containers():
    """On the CPU there is nothing to wait for; each form is accepted."""
    t = torch.ones(2)
    for x in (t, torch.nn.Linear(2, 2), {"a": [t]}, (), {}, None):
        profiling.sync(x)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("prof")
    generate_synthetic_dataset(str(root / "data"), Config(),
                               cities=["alpha", "beta"],
                               sizes=[(48, 48), (32, 32)], seed=2)
    return str(root / "data")


@pytest.mark.parametrize("profile_steps", [2, 5])
def test_loop_profile_dir_writes_a_trace(data_dir, tmp_path, profile_steps):
    """3 train steps with profile_dir: the trace holds the first
    ``profile_steps`` steps, or stops at the end of the shorter epoch; the
    epoch record carries fabric_tpu's perf keys (examples_per_sec, steps,
    p50_step_s, p95_step_s)."""
    from fabric_tpu_torch.train.loop import train
    cfg = Config(dataset_dir=data_dir, weight_dir=str(tmp_path / "w"),
                 log_dir=str(tmp_path / "l"), patch_size=16, stride=16,
                 batch_size=2, epochs=1, steps_per_epoch=3,
                 dtype="float32", model_base=4,
                 validation_cities=["beta"], num_workers=0, prefetch=1,
                 profile_dir=str(tmp_path / "prof"),
                 profile_steps=profile_steps)
    _, history = train(cfg, run_scene_inference=False, device="cpu")
    assert history["status"] == "complete"
    (path,) = _traces(tmp_path / "prof")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("backward" in e.get("name", "").lower() for e in events)
    run_dir = glob.glob(str(tmp_path / "l" / "*"))[0]
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rec = next(r for r in map(json.loads, f)
                   if "train_examples_per_sec" in r)
    assert {"train_examples_per_sec", "train_steps", "train_p50_step_s",
            "train_p95_step_s"} <= set(rec)
    assert rec["train_steps"] == 3
    assert 0 < rec["train_p50_step_s"] <= rec["train_p95_step_s"]
    assert np.isfinite(rec["train_examples_per_sec"])
