"""Hyperparameter search maximizing validation change-class F1
(counterpart of ``fabric_tpu/tools/tune.py``).

The reference tuned with a Polyaxon Bayesian-optimization group (16
iterations of UCB over lr in [1e-3, 1e-2], tversky alpha in [0, 0.3] and
beta in [0.7, 1], maximizing ``validate_cd_f1scores``).  This is a local
searcher over the same box, numpy only: GP-UCB (``--search bo``: UCB
kappa 1.2, 16 trials), random search, or a grid; each trial a full run of
the port's ``train.loop.train`` on ``--device`` (the card unless it says
cpu), results streamed to JSONL.  With one seed the proposals are
``fabric_tpu``'s, number for number.

Usage:
  python -m fabric_tpu_torch.tools.tune --config metadata.json --trials 16
         [--epochs 5] [--search bo|random|grid] [--device cpu]
"""

from __future__ import annotations

import argparse
import functools
import json
import sys

import numpy as np

SPACE = {  # the reference BO study's search box
    "learning_rate": (1e-3, 1e-2),
    "tversky_alpha": (0.0, 0.3),
    "tversky_beta": (0.7, 1.0),
}


def sample_params(rng: np.random.RandomState) -> dict:
    return {k: float(rng.uniform(lo, hi)) for k, (lo, hi) in SPACE.items()}


def grid_params(trials: int) -> list[dict]:
    per_axis = max(2, round(trials ** (1 / len(SPACE))))
    axes = {k: np.linspace(lo, hi, per_axis) for k, (lo, hi) in SPACE.items()}
    out = []
    for lr in axes["learning_rate"]:
        for a in axes["tversky_alpha"]:
            for b in axes["tversky_beta"]:
                out.append({"learning_rate": float(lr),
                            "tversky_alpha": float(a),
                            "tversky_beta": float(b)})
    return out


class GPUCB:
    """Minimal GP-UCB Bayesian optimizer over a box (ask/tell interface).

    The reference study's optimizer shape (UCB acquisition, κ=1.2,
    Matérn kernel), in numpy:
    inputs are normalized to [0,1]^d, the surrogate is a GP with a Matérn
    ν=5/2 kernel (closed form; the study's ν=1.9 has no closed form) and
    fixed lengthscale, observations are standardized, and each ``ask``
    maximizes μ + κσ over a fresh random candidate cloud.  The first
    ``n_init`` asks are space-filling random points.
    """

    def __init__(self, space: dict, seed: int = 0, kappa: float = 1.2,
                 lengthscale: float = 0.25, noise: float = 1e-6,
                 n_init: int = 4, n_candidates: int = 512):
        self.keys = list(space)
        self.lo = np.array([space[k][0] for k in self.keys])
        self.hi = np.array([space[k][1] for k in self.keys])
        self.rng = np.random.RandomState(seed)
        self.kappa = kappa
        self.ls = lengthscale
        self.noise = noise
        self.n_init = n_init
        self.n_candidates = n_candidates
        self.X: list[np.ndarray] = []  # normalized points
        self.y: list[float] = []

    def _kernel(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        # Matérn nu=5/2: (1 + sqrt(5)r + 5r^2/3) exp(-sqrt(5)r)
        d = np.sqrt(np.maximum(
            ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1), 0.0)) / self.ls
        s5 = np.sqrt(5.0) * d
        return (1.0 + s5 + (5.0 / 3.0) * d * d) * np.exp(-s5)

    def _denorm(self, u: np.ndarray) -> dict:
        vals = self.lo + u * (self.hi - self.lo)
        return {k: float(v) for k, v in zip(self.keys, vals)}

    def ask(self) -> dict:
        if len(self.X) < self.n_init:
            u = self.rng.rand(len(self.keys))
            self._pending = u
            return self._denorm(u)
        X = np.stack(self.X)
        y = np.array(self.y)
        mu0, sd = y.mean(), y.std() + 1e-12
        yn = (y - mu0) / sd
        K = self._kernel(X, X) + self.noise * np.eye(len(X))
        Kinv_y = np.linalg.solve(K, yn)
        cand = self.rng.rand(self.n_candidates, len(self.keys))
        # include jittered copies of the incumbent for local refinement
        inc = X[int(np.argmax(y))]
        local = np.clip(inc + 0.05 * self.rng.randn(32, len(self.keys)),
                        0.0, 1.0)
        cand = np.concatenate([cand, local])
        Ks = self._kernel(cand, X)
        mu = Ks @ Kinv_y
        Kinv_Ks = np.linalg.solve(K, Ks.T)
        var = np.maximum(1.0 - np.sum(Ks * Kinv_Ks.T, axis=1), 1e-12)
        ucb = mu + self.kappa * np.sqrt(var)
        u = cand[int(np.argmax(ucb))]
        self._pending = u
        return self._denorm(u)

    def tell(self, value: float) -> None:
        self.X.append(self._pending)
        self.y.append(float(value))


def run_search(base_cfg_dict: dict, trials: int = 16, search: str = "random",
               seed: int = 0, train_fn=None, log_path: str | None = None,
               resume: bool = False, failure_score: float = 0.0,
               device=None):
    """Returns (best_params, best_f1, all_results).

    A trial that raises (NaN loss, OOM, ...) is recorded with
    ``failure_score`` and the search continues — the reference's Polyaxon
    group tolerated failed experiments the same way; one bad point must not
    lose the whole GP state.

    ``resume=True`` replays completed trials from ``log_path`` before
    running the remainder: the searcher's proposals are re-asked with the
    same ``seed`` (reconstructing both RNG and GP state exactly) and told
    the recorded scores, so a resumed study continues bit-identically to
    the uninterrupted one.

    ``train_fn(cfg, run_scene_inference=False) -> (state, history)`` runs a
    trial; None means the port's ``train.loop.train`` on ``device`` (None
    means the card).
    """
    import logging
    import os
    from fabric_tpu_torch.config import Config
    if train_fn is None:
        from fabric_tpu_torch.train.loop import train
        train_fn = functools.partial(train, device=device)
    rng = np.random.RandomState(seed)
    bo = GPUCB(SPACE, seed=seed) if search == "bo" else None
    if bo is None:
        candidates = (grid_params(trials)[:trials] if search == "grid"
                      else [sample_params(rng) for _ in range(trials)])
    done: list[dict] = []
    if resume and log_path and os.path.exists(log_path):
        with open(log_path) as fin:
            done = [json.loads(line) for line in fin if line.strip()]
    results = []
    best, best_f1 = None, -1.0
    log = open(log_path, "a") if log_path else None
    for i in range(trials):
        params = bo.ask() if bo is not None else candidates[i]
        if i < len(done):
            # replay a completed trial into the searcher state (no re-run)
            rec = done[i]
            if any(abs(rec.get(k, params[k]) - params[k]) > 1e-9
                   for k in SPACE):
                logging.warning(
                    "tune resume: trial %d proposal %s != logged %s "
                    "(seed/search args changed?)", i, params, rec)
            f1 = float(rec["validate_cd_f1scores"])
        else:
            cfg = Config.from_dict({**base_cfg_dict, **params,
                                    "loss_function": "tversky"})
            rec = {"trial": i, **params}
            try:
                _, history = train_fn(cfg, run_scene_inference=False)
                f1 = (history["val"][-1]["cd_f1scores"]
                      if history["val"] else 0.0)
                if not np.isfinite(f1):
                    raise FloatingPointError(f"non-finite val F1: {f1}")
            except Exception as e:  # noqa: BLE001 — isolate trial failures
                logging.warning("tune trial %d failed: %s", i, e)
                f1, rec["failed"], rec["error"] = failure_score, True, str(e)
            rec["validate_cd_f1scores"] = f1
            if log:
                log.write(json.dumps(rec) + "\n")
                log.flush()
        if bo is not None:
            bo.tell(f1)
        results.append(rec)
        if f1 > best_f1 and not rec.get("failed"):
            best, best_f1 = params, f1
    if log:
        log.close()
    return best, best_f1, results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None)
    ap.add_argument("--trials", type=int, default=16)
    ap.add_argument("--search", choices=["bo", "random", "grid"],
                    default="bo")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log", default="tune_results.jsonl")
    ap.add_argument("--resume", action="store_true",
                    help="replay completed trials from --log, then continue")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    base = {}
    if args.config:
        with open(args.config) as fin:
            base.update(json.load(fin))
    if args.epochs:
        base["epochs"] = args.epochs
    best, best_f1, _ = run_search(base, args.trials, args.search, args.seed,
                                  log_path=args.log, resume=args.resume,
                                  device=args.device)
    print(json.dumps({"best_params": best,
                      "validate_cd_f1scores": best_f1}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
