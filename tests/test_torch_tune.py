"""tools/tune in the port against fabric_tpu's: with fabric_tpu's stub
objectives (tests/test_tune.py) and one seed, the proposals, scores and
picks are identical for random, grid and GP-UCB search, a resumed study
replays bit for bit, and a failing trial is isolated alike; then one real
trial of the port's train on the CPU (patch 16, base 8, 2 steps)."""

import json

import numpy as np
import pytest
import torch

from fabric_tpu.tools import tune as jax_tune

from fabric_tpu_torch.config import Config
from fabric_tpu_torch.data.synthetic import generate_synthetic_dataset
from fabric_tpu_torch.tools import tune


def _fake_train(cfg, run_scene_inference=False):
    # objective peaks at lr ~ 5e-3 (tests/test_tune.py)
    f1 = 1.0 - abs(cfg.learning_rate - 5e-3) * 100
    return None, {"val": [{"cd_f1scores": f1}], "train": []}


def _smooth_objective(cfg, run_scene_inference=False):
    # smooth peak inside the box at (lr=4e-3, alpha=0.12, beta=0.85)
    f1 = (1.0
          - ((cfg.learning_rate - 4e-3) / 9e-3) ** 2
          - ((cfg.tversky_alpha - 0.12) / 0.3) ** 2
          - ((cfg.tversky_beta - 0.85) / 0.3) ** 2)
    return None, {"val": [{"cd_f1scores": f1}], "train": []}


def _flaky(objective, fail_at):
    calls = []

    def train(cfg, run_scene_inference=False):
        calls.append(cfg.learning_rate)
        if len(calls) == fail_at:
            raise FloatingPointError("loss became NaN")
        return objective(cfg, run_scene_inference)
    return train


def test_search_space_and_grid_equal_fabric_tpu():
    assert tune.SPACE == jax_tune.SPACE
    for trials in (4, 8, 16, 27):
        assert tune.grid_params(trials) == jax_tune.grid_params(trials)
    a, b = np.random.RandomState(9), np.random.RandomState(9)
    assert [tune.sample_params(a) for _ in range(5)] == \
        [jax_tune.sample_params(b) for _ in range(5)]


@pytest.mark.parametrize("search,seed,objective", [
    ("random", 1, _fake_train), ("grid", 0, _fake_train),
    ("bo", 0, _smooth_objective), ("bo", 3, _fake_train)])
def test_search_equals_fabric_tpu(search, seed, objective, tmp_path):
    """Every trial's proposal and score, the best pick and the JSONL log."""
    trials = 8 if search == "grid" else 12   # the grid of 8 has 2 per axis
    out = []
    for mod, tag in ((tune, "port"), (jax_tune, "jax")):
        log = str(tmp_path / f"{tag}.jsonl")
        out.append(mod.run_search({}, trials=trials, search=search,
                                  seed=seed, train_fn=objective,
                                  log_path=log))
        with open(log) as fin:
            out[-1] += ([json.loads(line) for line in fin],)
    assert out[0] == out[1]
    assert len(out[0][2]) == trials


def test_grid_past_its_points_fails_like_fabric_tpu():
    """fabric_tpu's grid search asks for more trials than its grid holds
    (12 of 8 points) and fails with IndexError; the port keeps that."""
    for mod in (tune, jax_tune):
        with pytest.raises(IndexError):
            mod.run_search({}, trials=12, search="grid",
                           train_fn=_fake_train)


def test_resume_replays_the_uninterrupted_study(tmp_path):
    """A BO study cut after 4 trials and resumed from its log continues as
    the uninterrupted one, in the port as in fabric_tpu."""
    full = str(tmp_path / "full.jsonl")
    want = jax_tune.run_search({}, trials=10, search="bo", seed=5,
                               train_fn=_smooth_objective, log_path=full)
    part = str(tmp_path / "part.jsonl")
    with open(full) as fin, open(part, "w") as fout:
        fout.writelines(fin.readlines()[:4])
    got = tune.run_search({}, trials=10, search="bo", seed=5,
                          train_fn=_smooth_objective, log_path=part,
                          resume=True)
    assert got == want
    with open(part) as a, open(full) as b:
        assert a.read() == b.read()


def test_failed_trial_is_isolated_like_fabric_tpu(tmp_path):
    got = tune.run_search({}, trials=8, search="bo", seed=2,
                          train_fn=_flaky(_fake_train, 3),
                          log_path=str(tmp_path / "a.jsonl"))
    want = jax_tune.run_search({}, trials=8, search="bo", seed=2,
                               train_fn=_flaky(_fake_train, 3),
                               log_path=str(tmp_path / "b.jsonl"))
    assert got == want
    failed = [r for r in got[2] if r.get("failed")]
    assert [r["trial"] for r in failed] == [2]
    assert "NaN" in failed[0]["error"]
    assert failed[0]["validate_cd_f1scores"] == 0.0
    assert got[0] is not None and got[1] > 0.0


def test_one_real_trial_of_the_port_train(tmp_path):
    """A trial runs the port's train.loop.train (here on the CPU): 1
    epoch of 2 steps at patch 16, base 8, and scores its validation F1."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        generate_synthetic_dataset(str(tmp_path / "data"), Config(),
                                   cities=["alpha", "beta"],
                                   sizes=[(48, 48), (32, 32)], seed=2)
        base = dict(dataset_dir=str(tmp_path / "data"), patch_size=16,
                    stride=16, batch_size=4, epochs=1, steps_per_epoch=2,
                    model_base=8, dtype="float32", num_workers=0,
                    validation_cities=["beta"], handle_preemption=False,
                    weight_dir=str(tmp_path / "w"),
                    log_dir=str(tmp_path / "l"))
        log = str(tmp_path / "tune.jsonl")
        best, f1, results = tune.run_search(base, trials=1, search="random",
                                            seed=0, log_path=log,
                                            device="cpu")
    finally:
        torch.set_num_threads(threads)
    (rec,) = results
    assert not rec.get("failed"), rec.get("error")
    assert 0.0 <= rec["validate_cd_f1scores"] <= 1.0
    assert best == {k: rec[k] for k in tune.SPACE} and f1 == \
        rec["validate_cd_f1scores"]
    with open(log) as fin:
        assert json.loads(fin.read()) == rec
