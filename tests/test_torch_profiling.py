"""The port's tracing (fabric_tpu_torch.utils.profiling and the training
loop's ``profile_dir``) on the CPU: ``trace`` writes a non-empty
torch.profiler trace holding a span's range; ``span`` records nothing and
opens no range when nothing traces, and under a profiler records its
parent, id and fields on the trace's own clock; the counters; the serving
front's spans in every serving loop and the one-process feed's
``loader.next``; a 3-step loop run with ``profile_dir`` writes a trace,
also when the epoch is shorter than ``profile_steps``, and its per-epoch
``train_`` record carries the loader's wait."""

import glob
import json
import math
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fabric_tpu_torch.config import Config
from fabric_tpu_torch.data.synthetic import generate_synthetic_dataset
from fabric_tpu_torch.utils import profiling

SERVE_CHILDREN = ("serve.pad", "serve.stage", "serve.upload", "serve.launch")


@pytest.fixture(autouse=True)
def _empty_record():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _traces(logdir):
    return glob.glob(os.path.join(str(logdir), "*.pt.trace.json"))


def test_trace_writes_a_trace_with_spans(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.span("fabric_matmul"):
            y = x @ x
        profiling.sync(y)
    (path,) = _traces(tmp_path)
    assert os.path.getsize(path) > 0
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "fabric_matmul" in names
    assert any(e.key == "fabric_matmul" for e in prof.key_averages())
    assert [s.name for s in profiling.spans()] == ["fabric_matmul"]


def test_span_without_a_profiler_is_a_shared_no_op(monkeypatch):
    """No profiler: the same no-op context for every call, no
    record_function opened, no clock read, nothing recorded."""
    def refuse(*args, **kwargs):
        raise AssertionError("span opened a range or read the clock")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling.time, "time_ns", refuse)
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span("a"), profiling.span("b", id=3, bytes=8)
    assert a is b
    with profiling.span("outer", id=1):
        with profiling.span("inner"):
            pass
    assert profiling.spans() == []


def test_span_records_parent_id_and_fields():
    with _cpu_profile():
        with profiling.span("req", id=7, kind="scene"):
            with profiling.span("req.step", bytes=64):
                pass
            with profiling.span("req.other", id=8):
                pass
        with profiling.span("lone"):
            pass
    got = {s.name: s for s in profiling.spans()}
    assert [s.name for s in profiling.spans()] == [
        "req.step", "req.other", "req", "lone"]
    assert (got["req"].parent, got["req"].id, got["req"].fields) == (
        None, 7, {"kind": "scene"})
    assert (got["req.step"].parent, got["req.step"].id,
            got["req.step"].fields) == ("req", 7, {"bytes": 64})
    assert (got["req.other"].parent, got["req.other"].id) == ("req", 8)
    assert (got["lone"].parent, got["lone"].id) == (None, None)
    outer, inner = got["req"], got["req.step"]
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_span_closes_on_an_exception():
    """An exception leaves the span recorded and the stack of open spans
    empty: the next span has no parent."""
    with _cpu_profile():
        with pytest.raises(ValueError):
            with profiling.span("fails", id=1):
                raise ValueError("x")
        with profiling.span("after"):
            pass
    fails, after = profiling.spans()
    assert fails.name == "fails" and after.parent is None


def test_span_clock_is_the_traces_clock():
    """Each span and the trace's own event of its name agree on start and
    end within 1 ms: a span lies on the profiler's clock."""
    with _cpu_profile() as prof:
        for i in range(5):
            with profiling.span(f"clock{i}"):
                torch.randn(128, 128).sum()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("clock")}
    recorded = profiling.spans()
    assert len(recorded) == 5
    for s in recorded:
        e = events[s.name]
        assert abs(s.start_ns - e.start_ns()) < 1e6, s.name
        assert abs(s.end_ns - e.end_ns()) < 1e6, s.name
        assert s.start_ns <= e.start_ns() and e.end_ns() <= s.end_ns


def test_counters_are_always_on():
    base = profiling.counters().get("test.count", 0)
    profiling.count("test.count")
    profiling.count("test.count", 2.5)
    assert profiling.counters()["test.count"] == base + 3.5
    snapshot = profiling.counters()
    snapshot["test.count"] = -1
    assert profiling.counters()["test.count"] == base + 3.5


# --- the serving front ------------------------------------------------------

@pytest.fixture(scope="module")
def predictor():
    from fabric_tpu_torch.infer.service import ScenePredictor
    torch.manual_seed(0)
    return ScenePredictor(Config(patch_size=16, eval_batch_size=8,
                                 dtype="float32", model_base=4),
                          bucket=32, device="cpu")


def _pairs(n, h=40, w=24):
    rng = np.random.RandomState(5)
    return [tuple(rng.randn(h, w, 13).astype(np.float32) for _ in "ab")
            for _ in range(n)]


@pytest.mark.parametrize("mode", ["predict", "predict_many", "packed"])
def test_serving_records_each_dispatch_and_its_pieces(predictor, mode):
    """3 scenes of 40 x 24 (padded to the 64 x 32 bucket): one
    ``serve.dispatch`` a scene (a pack of 2 and one of 1 when packed),
    its pad, stage, upload and launch children sharing its id, the stage
    bytes those of the padded dates; the masks as without a profiler."""
    pairs = _pairs(3)
    want = predictor.predict_many(pairs)
    first = predictor._scenes_predicted
    with _cpu_profile():
        if mode == "predict":
            got = [predictor.predict(*p) for p in pairs]
        else:
            got = predictor.predict_many(pairs, pack=2 if mode == "packed"
                                         else 0)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)
    recorded = profiling.spans()
    dispatches = [s for s in recorded if s.name == "serve.dispatch"]
    scenes = [[first, first + 1], [first + 2]] if mode == "packed" else \
        [[first + i] for i in range(3)]
    assert [s.id for s in dispatches] == [ids[0] for ids in scenes]
    date_bytes = 64 * 32 * 13 * 4
    for d, ids in zip(dispatches, scenes):
        kids = [s for s in recorded if s.parent == "serve.dispatch"
                and s.id == d.id]
        assert sorted({s.name for s in kids}) == sorted(SERVE_CHILDREN)
        assert all(d.start_ns <= s.start_ns <= s.end_ns <= d.end_ns
                   for s in kids)
        stages = [s for s in kids if s.name == "serve.stage"]
        assert sum(s.fields["bytes"] for s in stages) == \
            2 * len(ids) * date_bytes
        assert [s.name for s in kids].count("serve.pad") == 2 * len(ids)
        assert [s.name for s in kids].count("serve.launch") == 1
    assert {s.name for s in recorded} == {"serve.dispatch",
                                          *SERVE_CHILDREN}


def test_streamed_fullconv_records_its_dispatch():
    """A mode that does not pass through the upload (streamed fullconv)
    still records one ``serve.dispatch`` a scene."""
    from fabric_tpu_torch.infer.service import ScenePredictor
    torch.manual_seed(0)
    pred = ScenePredictor(Config(patch_size=16, dtype="float32",
                                 model_base=4),
                          bucket=16, device="cpu", fullconv_band_rows=32,
                          fullconv_stream=True)
    with _cpu_profile():
        pred.predict_many(_pairs(2, 32, 16))
    assert [(s.name, s.id) for s in profiling.spans()
            if s.parent is None] == [("serve.dispatch", 0),
                                     ("serve.dispatch", 1)]


# --- the one-process feed and the training loop ------------------------------

def test_prefetch_records_loader_next_and_counts_the_wait():
    """``prefetch_to_device``'s wait for the thread's batch is one
    ``loader.next`` a batch (its index as id), and ``loader.wait_s`` grows
    by at least their durations."""
    from fabric_tpu_torch.data.pipeline import prefetch_to_device
    items = [{"x": np.full((2, 3), i, np.float32)} for i in range(4)]
    before = profiling.counters().get("loader.wait_s", 0.0)
    with _cpu_profile():
        got = list(prefetch_to_device(iter(items), "cpu", size=1))
    waited = profiling.counters()["loader.wait_s"] - before
    assert [int(b["x"][0, 0]) for b in got] == [0, 1, 2, 3]
    nexts = [s for s in profiling.spans() if s.name == "loader.next"]
    assert [s.id for s in nexts] == [0, 1, 2, 3, 4]  # and the end
    spent = sum(s.end_ns - s.start_ns for s in nexts) / 1e9
    assert spent * 0.999 - 1e-4 <= waited <= spent + 0.05


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
    ``profile_steps`` steps, or stops at the end of the shorter epoch, and
    the feed's ``loader.next`` ranges; the epoch record carries
    examples_per_sec, seconds, steps and the loader's wait
    (feed_wait_s)."""
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
    assert any(e.get("name") == "loader.next" for e in events)
    run_dir = glob.glob(str(tmp_path / "l" / "*"))[0]
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rec = next(r for r in map(json.loads, f)
                   if "train_examples_per_sec" in r)
    assert {"train_examples_per_sec", "train_seconds", "train_steps",
            "train_feed_wait_s"} <= set(rec)
    assert not {"train_p50_step_s", "train_p95_step_s"} & set(rec)
    assert rec["train_steps"] == 3
    assert math.isfinite(rec["train_feed_wait_s"])
    assert 0 <= rec["train_feed_wait_s"] <= rec["train_seconds"]
    assert np.isfinite(rec["train_examples_per_sec"])


def test_sync_takes_tensors_modules_and_containers():
    """On the CPU there is nothing to wait for; each form is accepted."""
    t = torch.ones(2)
    for x in (t, torch.nn.Linear(2, 2), {"a": [t]}, (), {}, None):
        profiling.sync(x)
