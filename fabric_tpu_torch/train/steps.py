"""Train, eval and inference steps (counterpart of
``fabric_tpu/train/steps.py``).

A step runs on the batch's device: forward, loss, backward and update
(train), argmax and confusion counts.  It returns the counts and the loss
as device scalars and never waits for the device, so a loop of steps
syncs only where the caller reads them.
"""

from __future__ import annotations

from typing import Callable

import torch

from fabric_tpu_torch.metrics import confusion_counts


def make_train_step(model, loss_fn: Callable):
    """``train_step(state, batch) -> (state, stats)``: one optimizer
    update of ``state`` in place (batch-statistics BatchNorm, whose
    running averages move too)."""

    def train_step(state, batch):
        for p in state.tx.params.values():
            p.grad = None
        logits = state.model(batch["img1"], batch["img2"], train=True)
        loss = loss_fn(logits, batch["label"], weights=batch.get("weight"))
        loss.backward()
        state.apply_gradients()
        stats = confusion_counts(logits.detach().argmax(-1), batch["label"],
                                 weights=batch.get("weight"))
        stats["loss"] = loss.detach()
        return state, stats

    return train_step


def make_eval_step(model, loss_fn: Callable):
    """``eval_step(state, batch) -> stats``: running-average BatchNorm, no
    gradients; ``stats["preds"]`` is the argmax class map."""

    @torch.no_grad()
    def eval_step(state, batch):
        logits = state.model(batch["img1"], batch["img2"])
        loss = loss_fn(logits, batch["label"], weights=batch.get("weight"))
        preds = logits.argmax(-1)
        stats = confusion_counts(preds, batch["label"],
                                 weights=batch.get("weight"))
        stats["loss"] = loss
        stats["preds"] = preds
        return stats

    return eval_step


def make_infer_step(model):
    """``infer_step(state, img1, img2) -> (N, H, W) uint8`` argmax map."""

    @torch.no_grad()
    def infer_step(state, img1, img2):
        return state.model(img1, img2).argmax(-1).to(torch.uint8)

    return infer_step
