"""Segmentation losses (counterpart of ``fabric_tpu/losses.py``).

``logits`` is (N, H, W, C) float, ``labels`` (N, H, W) integer class ids;
every loss returns a float32 scalar tensor.  The soft losses reduce over
(batch, H, W) by default; ``compat_reference=True`` reduces over (batch,
H) only, the reference's shipped behaviour, and averages the per-(column,
class) ratios.  ``weights`` is an optional per-sample (N,) vector: weight
0 excludes a padded row exactly.  ``bce`` is mean softmax cross-entropy
and ``wbce`` adds a weight on the change class, as in ``fabric_tpu``.

In training over a process group (``parallel/distributed.py``) every
loss is the global batch's, as under ``fabric_tpu``'s jit SPMD: the sums
it is made of (the soft counts of dice, jaccard and Tversky, the weighted
log-likelihood and the weight of cross-entropy and focal) are
all-reduced with their gradient before the ratio, over the batch group
(the ranks of one model replica, which between them hold every row of
the batch once: on a spatial axis, the rows of each patch too, so
``compat_reference``'s sums over batch and H are summed there as well),
so every rank holds the 1-process loss.  The mean of per-rank losses
would be another function, with another gradient.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.nn.functional as F

from fabric_tpu_torch.parallel.distributed import active, all_reduce_sum


def _pixel_weights(labels: torch.Tensor, weights) -> torch.Tensor | None:
    """Per-sample (N,) weights broadcast to (N, 1, 1, ...)."""
    if weights is None:
        return None
    w = torch.as_tensor(weights, dtype=torch.float32, device=labels.device)
    return w.reshape(w.shape + (1,) * (labels.dim() - 1))


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       class_weights=None, weights=None) -> torch.Tensor:
    """Mean (optionally class-weighted) softmax cross-entropy."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    w = torch.ones_like(ll)
    if class_weights is not None:
        w = w * torch.as_tensor(class_weights, dtype=torch.float32,
                                device=ll.device)[labels.long()]
    pw = _pixel_weights(labels, weights)
    if pw is not None:
        w = w * pw
    return _weighted_mean(-ll, w)


def _weighted_mean(loss: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum(loss * w) / max(sum(w), 1e-7), both sums global."""
    num, den = all_reduce_sum(torch.stack([torch.sum(loss * w),
                                           torch.sum(w)]))
    return num / torch.clamp(den, min=1e-7)


def weighted_bce_loss(logits, labels, pos_weight: float = 1.0,
                      weights=None) -> torch.Tensor:
    """Softmax cross-entropy with extra weight on the change class (1)."""
    return cross_entropy_loss(logits, labels,
                              class_weights=[1.0, float(pos_weight)],
                              weights=weights)


def focal_loss(logits, labels, gamma: float = 2.0, alpha=None,
               weights=None) -> torch.Tensor:
    """``-(1 - pt)^gamma * log(pt)``, with an optional per-class ``alpha``
    applied to log(pt) before the focal factor; pt carries no gradient."""
    num_classes = logits.shape[-1]
    flat_labels = labels.reshape(-1).long()
    logp = torch.log_softmax(logits.reshape(-1, num_classes).float(), -1)
    logpt = torch.gather(logp, -1, flat_labels[:, None])[:, 0]
    pt = torch.exp(logpt.detach())
    if alpha is not None:
        if isinstance(alpha, (int, float)):
            alpha = [alpha, 1.0 - alpha]
        logpt = logpt * torch.as_tensor(alpha, dtype=torch.float32,
                                        device=logpt.device)[flat_labels]
    loss = -((1.0 - pt) ** gamma) * logpt
    if weights is not None:
        w = torch.as_tensor(weights, dtype=torch.float32, device=loss.device)
        pw = torch.repeat_interleave(w, loss.shape[0] // w.shape[0])
        return _weighted_mean(loss, pw)
    if active():
        return _weighted_mean(loss, torch.ones_like(loss))
    return torch.mean(loss)


def _soft_counts(logits, labels, compat_reference: bool, weights):
    probs = torch.softmax(logits.float(), dim=-1)
    onehot = F.one_hot(labels.long(), logits.shape[-1]).float()
    pw = _pixel_weights(labels, weights)
    if pw is not None:
        # zeroing probs and onehot drops a weight-0 sample from every sum
        probs = probs * pw[..., None]
        onehot = onehot * pw[..., None]
    axes = (0, 1) if compat_reference else tuple(range(labels.dim()))
    return probs, onehot, axes, torch.sum(probs * onehot, dim=axes)


def dice_loss(logits, labels, eps: float = 1e-7,
              compat_reference: bool = False, weights=None) -> torch.Tensor:
    """Soft Sorensen-Dice loss."""
    probs, onehot, axes, inter = _soft_counts(logits, labels,
                                              compat_reference, weights)
    inter, cardinality = all_reduce_sum(torch.stack(
        [inter, torch.sum(probs + onehot, dim=axes)]))
    return 1.0 - torch.mean(2.0 * inter / (cardinality + eps))


def jaccard_loss(logits, labels, eps: float = 1e-7,
                 compat_reference: bool = False, weights=None) -> torch.Tensor:
    """Soft IoU (Jaccard) loss."""
    probs, onehot, axes, inter = _soft_counts(logits, labels,
                                              compat_reference, weights)
    inter, cardinality = all_reduce_sum(torch.stack(
        [inter, torch.sum(probs + onehot, dim=axes)]))
    union = cardinality - inter
    return 1.0 - torch.mean(inter / (union + eps))


def tversky_loss(logits, labels, alpha: float = 0.5, beta: float = 0.5,
                 eps: float = 1e-7, compat_reference: bool = False,
                 weights=None) -> torch.Tensor:
    """Soft Tversky loss: ``alpha`` weighs false positives, ``beta``
    false negatives (alpha = beta = 0.5 is dice)."""
    probs, onehot, axes, inter = _soft_counts(logits, labels,
                                              compat_reference, weights)
    inter, fps, fns = all_reduce_sum(torch.stack(
        [inter, torch.sum(probs * (1.0 - onehot), dim=axes),
         torch.sum((1.0 - probs) * onehot, dim=axes)]))
    denom = inter + alpha * fps + beta * fns
    return 1.0 - torch.mean(inter / (denom + eps))


def get_loss_fn(cfg) -> Callable:
    """Config's ``loss_function`` name -> loss function."""
    name, compat = cfg.loss_function, cfg.compat_reference_losses
    if name == "bce":
        return cross_entropy_loss
    if name == "wbce":
        return functools.partial(weighted_bce_loss,
                                 pos_weight=cfg.bce_pos_weight)
    if name == "focal":
        return functools.partial(focal_loss, gamma=cfg.focal_gamma)
    if name == "dice":
        return functools.partial(dice_loss, compat_reference=compat)
    if name == "jaccard":
        return functools.partial(jaccard_loss, compat_reference=compat)
    if name == "tversky":
        return functools.partial(tversky_loss, alpha=cfg.tversky_alpha,
                                 beta=cfg.tversky_beta,
                                 compat_reference=compat)
    raise ValueError(f"unknown loss_function: {name!r}")
