"""Confusion counts on the device and reference-compatible aggregation
(counterpart of ``fabric_tpu/metrics.py``).

A step computes tp/fp/fn/tn for the change class as int32 scalars on the
tensors' device, so only four counts and the loss leave it, and not per
step: the loop brings an epoch's rows to the host at once.  The host then
forms per-batch precision/recall/F1 with sklearn's zero-division rule and
reports the mean over batches (the reference's aggregation), beside the
global confusion-matrix figures.
"""

from __future__ import annotations

import torch


def confusion_counts(preds: torch.Tensor, labels: torch.Tensor,
                     weights: torch.Tensor | None = None
                     ) -> dict[str, torch.Tensor]:
    """tp/fp/fn/tn (int32 scalars) for class 1; samples whose weight is 0
    are left out of every count."""
    pp = preds == 1
    pl = labels == 1
    if weights is None:
        valid = torch.ones_like(pl)
    else:
        valid = (weights > 0).reshape(weights.shape
                                      + (1,) * (labels.dim() - 1))
        valid = valid.expand(labels.shape)

    def count(m):
        return torch.sum(m & valid, dtype=torch.int32)
    return {"tp": count(pp & pl), "fp": count(pp & ~pl),
            "fn": count(~pp & pl), "tn": count(~pp & ~pl)}


def accuracy_pct(counts: dict) -> float:
    """100 * correct / total."""
    tp, fp, fn, tn = (float(counts[k]) for k in ("tp", "fp", "fn", "tn"))
    total = tp + fp + fn + tn
    return 100.0 * (tp + tn) / total if total else 0.0


def prf1_from_counts(counts: dict) -> tuple[float, float, float]:
    """Binary precision/recall/F1 with sklearn's zero-division -> 0."""
    tp, fp, fn = (float(counts[k]) for k in ("tp", "fp", "fn"))
    precision = tp / (tp + fp) if (tp + fp) > 0 else 0.0
    recall = tp / (tp + fn) if (tp + fn) > 0 else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if (precision + recall) > 0 else 0.0)
    return precision, recall, f1


class MetricAccumulator:
    """Epoch metrics under the reference's keys (cd_losses, cd_corrects,
    cd_precisions, cd_recalls, cd_f1scores): ``means()`` is the mean of
    the per-batch values, ``global_prf1()`` the confusion-matrix figures
    over the whole epoch."""

    def __init__(self) -> None:
        self._sums = dict.fromkeys(("cd_losses", "cd_corrects",
                                    "cd_precisions", "cd_recalls",
                                    "cd_f1scores"), 0.0)
        self._n = 0
        self._counts = {"tp": 0, "fp": 0, "fn": 0, "tn": 0}

    def update(self, loss: float, counts: dict) -> None:
        counts = {k: int(v) for k, v in counts.items()}
        precision, recall, f1 = prf1_from_counts(counts)
        values = {"cd_losses": float(loss),
                  "cd_corrects": accuracy_pct(counts),
                  "cd_precisions": precision,
                  "cd_recalls": recall,
                  "cd_f1scores": f1}
        for k, v in values.items():
            self._sums[k] += v
        self._n += 1
        for k in self._counts:
            self._counts[k] += counts[k]

    def means(self) -> dict[str, float]:
        if not self._n:
            return dict(self._sums)
        return {k: s / self._n for k, s in self._sums.items()}

    def global_prf1(self) -> dict[str, float]:
        precision, recall, f1 = prf1_from_counts(self._counts)
        return {"global_precision": precision, "global_recall": recall,
                "global_f1": f1,
                "global_accuracy": accuracy_pct(self._counts)}

    def __len__(self) -> int:
        return self._n
