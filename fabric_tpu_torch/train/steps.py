"""Train, eval and inference steps (counterpart of
``fabric_tpu/train/steps.py``).

A step runs on the batch's device: forward, loss, backward and update
(train), argmax and confusion counts.  It returns the counts and the loss
as device scalars and never waits for the device, so a loop of steps
syncs only where the caller reads them.  A multi-date batch carries its
(N, T, H, W, C) stack as ``imgs``, a bi-date one ``img1`` and ``img2``.

In training over a (data, spatial, model) mesh of ranks (a process
group, ``parallel/distributed.set_mesh``) a batch is the rank's rows of
the global batch, and with a spatial axis the rank's rows of each
patch's height, which the forward and backward run on
(``parallel/spatial.sharded``): the loss and the BatchNorm statistics are
global already (``losses.py``, ``models/blocks.BatchNorm``), the train
step takes the mean of the ranks' gradients before the update, and both
steps sum the confusion counts over the batch group (the ranks of one
model replica), so every rank returns the 1-process stats;
``stats["preds"]`` holds the rank's rows.
"""

from __future__ import annotations

from typing import Callable

import torch

from fabric_tpu_torch.metrics import confusion_counts
from fabric_tpu_torch.parallel import distributed, spatial


def _counts(preds, batch) -> dict:
    """The confusion counts of the global batch."""
    stats = confusion_counts(preds, batch["label"],
                             weights=batch.get("weight"))
    if distributed.active():
        keys = list(stats)
        total = distributed.all_reduce_(torch.stack([stats[k]
                                                     for k in keys]))
        stats = dict(zip(keys, total))
    return stats


def _logits(model, batch: dict, train: bool = False) -> torch.Tensor:
    if "imgs" in batch:
        return model(batch["imgs"], train=train)
    return model(batch["img1"], batch["img2"], train=train)


def _rows(batch: dict) -> int:
    """The rows of each patch that the batch holds (its labels' H)."""
    return batch["label"].shape[1]


def make_train_step(model, loss_fn: Callable):
    """``train_step(state, batch) -> (state, stats)``: one optimizer
    update of ``state`` in place (batch-statistics BatchNorm, whose
    running averages move too)."""

    def train_step(state, batch):
        for p in state.tx.params.values():
            p.grad = None
        with spatial.sharded(_rows(batch)):
            logits = _logits(state.model, batch, train=True)
            loss = loss_fn(logits, batch["label"],
                           weights=batch.get("weight"))
            loss.backward()
        distributed.mean_gradients(state.tx.params.values())
        state.apply_gradients()
        stats = _counts(logits.detach().argmax(-1), batch)
        stats["loss"] = loss.detach()
        return state, stats

    return train_step


def make_eval_step(model, loss_fn: Callable):
    """``eval_step(state, batch) -> stats``: running-average BatchNorm, no
    gradients; ``stats["preds"]`` is the argmax class map."""

    @torch.no_grad()
    def eval_step(state, batch):
        with spatial.sharded(_rows(batch)):
            logits = _logits(state.model, batch)
        loss = loss_fn(logits, batch["label"], weights=batch.get("weight"))
        preds = logits.argmax(-1)
        stats = _counts(preds, batch)
        stats["loss"] = loss
        stats["preds"] = preds
        return stats

    return eval_step


def make_infer_step(model):
    """``infer_step(state, *imgs) -> (N, H, W) uint8`` argmax map:
    ``infer_step(state, img1, img2)``, or for a multi-date model
    ``infer_step(state, imgs)`` with imgs (N, T, H, W, C)."""

    @torch.no_grad()
    def infer_step(state, *imgs):
        return state.model(*imgs).argmax(-1).to(torch.uint8)

    return infer_step
