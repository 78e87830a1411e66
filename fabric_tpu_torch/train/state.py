"""Train state: the model, an optimizer with optax's semantics, the step.

Counterpart of ``fabric_tpu/train/state.py``.  The optimizer and learning
rate schedule come from the config as there (``sgd`` with or without
momentum, ``adam``, ``adamw``; ``constant``, ``cosine`` with optional
warmup, ``linear``) and compute what optax computes:

- sgd: ``trace = g + momentum * trace`` (optax ``trace``), update
  ``-lr * trace``;
- adam: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``,
  bias-corrected with the incremented count, update ``-lr * mu_hat /
  (sqrt(nu_hat) + eps)``; adamw adds ``weight_decay * param`` before the
  learning rate (optax's decoupled decay);
- a schedule reads its own count, starting at 0, so update t uses lr(t);
- ``grad_accum_steps`` k > 1 (optax ``MultiSteps``): each step folds its
  gradient into a running mean, ``acc + (g - acc) / (n + 1)`` (Welford,
  n the micro step), and every k-th step applies the optimizer above to
  that mean and resets it; the other steps leave the parameters alone,
  and the optimizer's and the schedule's counts advance only on updates.

:meth:`Optimizer.state_tree` lays the state out as flax serialises
optax's state for the same config (a chain's tuple as ``{"0": ..., "1":
...}``, empty states as ``{}``, ``MultiStepsState``'s fields by name), so
checkpoints restore in either package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fabric_tpu_torch.weights import (flatten_tree, unflatten_tree,
                                      variables_of)

_B1, _B2, _EPS = 0.9, 0.999, 1e-8  # optax.adam defaults


def make_schedule(cfg):
    """step -> learning rate, optax's schedules (``fabric_tpu``'s
    ``make_schedule``)."""
    name, lr = cfg.lr_schedule, cfg.learning_rate
    if name == "constant":
        return lambda step: lr
    steps, warmup = cfg.lr_decay_steps, cfg.lr_warmup_steps
    if steps <= 0:
        raise ValueError(f"lr_schedule={name!r} requires lr_decay_steps > 0")

    def linear(step, init, end, transition, begin=0):
        count = min(max(step - begin, 0), transition)
        return (init - end) * (1 - count / transition) + end

    def cosine(step, init, decay):
        count = min(step, decay)
        return init * 0.5 * (1 + math.cos(math.pi * count / decay))

    if name == "cosine":
        if warmup:
            return lambda step: (linear(step, 0.0, lr, warmup)
                                 if step < warmup else
                                 cosine(step - warmup, lr, steps - warmup))
        return lambda step: cosine(step, lr, steps)
    if name == "linear":
        return lambda step: linear(step, lr, 0.0, steps, warmup)
    raise ValueError(f"unknown lr_schedule: {name!r}")


class Optimizer:
    """sgd / adam / adamw over a module's named parameters.

    Written out rather than torch.optim's: torch's Adam and AdamW round in
    another order (a lerp for the first moment, sqrt(nu) / sqrt(bc2)) and
    after four updates land 4e-6 and 1e-5 relative from optax, outside the
    1e-6 the parity tests hold the port to."""

    def __init__(self, cfg, named_params):
        self.name = cfg.optimizer
        if self.name not in ("sgd", "adam", "adamw"):
            raise ValueError(f"unknown optimizer: {self.name!r}")
        self.params = dict(named_params)
        self.accum = max(cfg.grad_accum_steps, 1)
        self.mini_step = 0      # MultiSteps' counts
        self.gradient_step = 0
        self.acc_grads = ({n: torch.zeros_like(p)
                           for n, p in self.params.items()}
                          if self.accum > 1 else {})
        self.schedule = make_schedule(cfg)
        self.scheduled = cfg.lr_schedule != "constant"
        self.momentum = cfg.momentum if self.name == "sgd" else 0.0
        self.weight_decay = cfg.weight_decay
        self.count = 0        # adam's count
        self.sched_count = 0  # the schedule's count
        zeros = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.moments: dict[str, dict[str, torch.Tensor]] = {}
        if self.momentum:
            self.moments["trace"] = zeros
        elif self.name != "sgd":
            self.moments["mu"] = zeros
            self.moments["nu"] = {n: torch.zeros_like(p)
                                  for n, p in self.params.items()}

    @torch.no_grad()
    def step(self) -> None:
        """Take the parameters' ``.grad``: apply one update, or with
        ``grad_accum_steps`` > 1 fold it into the running mean and update
        from the mean every k-th call."""
        grads = {n: p.grad for n, p in self.params.items()}
        if self.accum == 1:
            self._update(grads)
            return
        n = self.mini_step
        for name, acc in self.acc_grads.items():
            acc.add_((grads[name] - acc) / (n + 1))
        self.mini_step = (n + 1) % self.accum
        if n == self.accum - 1:
            self.gradient_step += 1
            self._update(self.acc_grads)
            for acc in self.acc_grads.values():
                acc.mul_(0)  # optax's (1 - emit) * acc: -0.0 stays -0.0

    def _update(self, grads: dict[str, torch.Tensor]) -> None:
        """One update of the optimizer from ``grads``."""
        lr = self.schedule(self.sched_count)
        if self.scheduled:
            self.sched_count += 1
        if self.name != "sgd":
            self.count += 1
            bc1 = 1 - np.float32(_B1) ** np.float32(self.count)
            bc2 = 1 - np.float32(_B2) ** np.float32(self.count)
        for n, p in self.params.items():
            g = grads[n]
            if self.momentum:
                u = self.moments["trace"][n].mul_(self.momentum).add_(g)
            elif self.name == "sgd":
                u = g
            else:
                mu = self.moments["mu"][n]
                nu = self.moments["nu"][n]
                mu.copy_((1 - _B1) * g + _B1 * mu)
                nu.copy_((1 - _B2) * (g * g) + _B2 * nu)
                u = (mu / float(bc1)) / (torch.sqrt(nu / float(bc2)) + _EPS)
                if self.name == "adamw":
                    u = u + self.weight_decay * p
            p.add_(u * -lr)

    def state_tree(self) -> dict:
        """The state as numpy trees in optax's layout for this config."""
        def tree(d):
            return unflatten_tree({n: t.detach().cpu().numpy().copy()
                                   for n, t in d.items()})

        def count(c):
            return np.asarray(c, np.int32)
        first = {k: tree(v) for k, v in self.moments.items()}
        if self.name != "sgd":
            first["count"] = count(self.count)
        chain = [first]
        if self.name == "adamw":
            chain.append({})  # add_decayed_weights: no state
        chain.append({"count": count(self.sched_count)} if self.scheduled
                     else {})
        inner = {str(i): s for i, s in enumerate(chain)}
        if self.accum == 1:
            return inner
        return {"mini_step": count(self.mini_step),
                "gradient_step": count(self.gradient_step),
                "inner_opt_state": inner, "acc_grads": tree(self.acc_grads),
                "skip_state": {}}

    def load_state_tree(self, tree: dict) -> None:
        """Take the state from an optax-layout tree (a checkpoint's
        ``opt_state``); raises ValueError if it is not this config's."""
        if _structure(tree) != _structure(self.state_tree()):
            raise ValueError(
                f"opt_state does not match the configured optimizer "
                f"({self.name}, momentum={self.momentum}, schedule="
                f"{'on' if self.scheduled else 'off'}, grad_accum_steps="
                f"{self.accum})")
        if self.accum > 1:
            self.mini_step = int(tree["mini_step"])
            self.gradient_step = int(tree["gradient_step"])
            _copy_into(self.acc_grads, tree["acc_grads"])
            tree = tree["inner_opt_state"]
        first = tree["0"]
        for key, moments in self.moments.items():
            _copy_into(moments, first[key])
        if self.name != "sgd":
            self.count = int(first["count"])
        if self.scheduled:
            self.sched_count = int(tree[str(len(tree) - 1)]["count"])


def _copy_into(tensors: dict[str, torch.Tensor], tree: dict) -> None:
    """Copy a numpy tree's leaves into the tensors of its flat names."""
    flat = flatten_tree(tree)
    for n, t in tensors.items():
        t.copy_(torch.from_numpy(np.asarray(flat[n], np.float32)))


def _structure(tree: dict) -> dict:
    """The tree's keys, nested, with each leaf's shape."""
    return {k: _structure(v) if isinstance(v, dict) else np.shape(v)
            for k, v in tree.items()}


class TrainState:
    """What a train step advances: the model (its parameters and
    BatchNorm statistics), the optimizer state, and the step count."""

    def __init__(self, model: torch.nn.Module, tx: Optimizer, step: int = 0):
        self.model = model
        self.tx = tx
        self.step = step

    def apply_gradients(self) -> None:
        self.tx.step()
        self.step += 1

    def variables(self) -> tuple[dict, dict]:
        """(params, batch_stats) as numpy trees."""
        return variables_of(self.model)

    @property
    def opt_state(self) -> dict:
        return self.tx.state_tree()


def create_state(cfg, model: torch.nn.Module) -> TrainState:
    """A fresh TrainState over ``model`` (built with ``train=True``)."""
    return TrainState(model, Optimizer(cfg, model.named_parameters()))


def param_count(state: TrainState) -> int:
    return sum(p.numel() for p in state.model.parameters())
