"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, each cell shrunk (``tiny.py``) and
computing in float32, so that a sound run reads far inside the limits.
The faults: a step that returns its state unchanged, half of the batch
left out (the mean taken over the rest), the gradient exchange between
ranks left out, and an answer altered where it is produced."""

import os
import textwrap
import time

import pytest

import tiny
from benchmark.harness import main as harness


def _run(cell, seed=21):
    return harness.run_cell(cell, seed, 1, False, time.perf_counter(),
                            device="cpu",
                            overrides=tiny.overrides(cell, "float32"))


@pytest.mark.parametrize("cell", [tiny.SERVE, tiny.TRAIN])
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]


def test_state_left_unchanged(monkeypatch):
    from fabric_tpu_torch.train.state import TrainState
    monkeypatch.setattr(TrainState, "apply_gradients", lambda self: None)
    r = _run(tiny.TRAIN)
    assert not r["correct"], r["checks"]


def test_half_the_batch_left_out(monkeypatch):
    from fabric_tpu_torch.train import steps
    make = steps.make_train_step

    def halved(model, loss_fn):
        step = make(model, loss_fn)
        return lambda state, batch: step(state, {
            k: v[:v.shape[0] // 2] for k, v in batch.items()})

    monkeypatch.setattr(steps, "make_train_step", halved)
    r = _run(tiny.TRAIN)
    assert not r["correct"], r["checks"]


def test_answer_altered(monkeypatch):
    from fabric_tpu_torch.infer.service import ScenePredictor
    serve = ScenePredictor.predict_many

    def altered(self, *a, **kw):
        masks = serve(self, *a, **kw)
        for m in masks:
            m[24:40, 24:40] = 1 - m[24:40, 24:40]
        return masks

    monkeypatch.setattr(ScenePredictor, "predict_many", altered)
    r = _run(tiny.SERVE)
    assert not r["correct"], r["checks"]


NO_EXCHANGE = textwrap.dedent("""
    from fabric_tpu_torch.parallel import distributed
    distributed.mean_gradients = lambda params: None
""")


@pytest.mark.parametrize("fault", [False, True])
def test_exchange_between_ranks(fault, tmp_path):
    """Two gloo ranks on the CPU: sound, and with the gradients' mean over
    the ranks left out in every rank (a ``sitecustomize`` planted in the
    ranks' processes)."""
    env = {}
    if fault:
        (tmp_path / "sitecustomize.py").write_text(NO_EXCHANGE)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(tmp_path), tiny.ROOT, os.environ.get("PYTHONPATH", "")])
    rc, out, err = tiny.run_cli(
        tiny.TRAIN, 23, tiny.overrides(tiny.TRAIN, "float32", ranks=2,
                                       num_workers=1), env=env)
    assert rc == 0, err[-3000:]
    r = tiny.result_of(out)
    assert r["correct"] is (not fault), r["checks"]
