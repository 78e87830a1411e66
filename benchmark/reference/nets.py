"""Plain PyTorch building blocks of the reference networks, in float32,
from the benchmark's weight trees (``harness/weights.py``).  A model's
own layout and forward live in ``models/<model>.py``, which builds on
these.

The U-Net of the configurations: DoubleConv ``inc`` (n_channels -> b),
then ``down1-4`` (2x2 max-pool and DoubleConv to 2b, 4b, 8b, 8b), a
decoder ``up1-4`` (2x bilinear align-corners upsample, concat [skip, up],
DoubleConv to 4b, 2b, b, b) and a 1x1 head.  A DoubleConv is (3x3 conv +
bias, BatchNorm, ReLU) twice.

``eval`` folds BatchNorm into the convs itself (s = scale / sqrt(var +
eps)); ``train`` normalises with the batch's statistics.  Tensors are
NHWC at the edges and NCHW inside.  ``q`` rounds each conv's input and
weights (identity for the reference; the lower-precision control passes
a rounding, which then also rounds what the computing dtype stores: each
conv's output, each product a model's forward rounds with ``q``, the
logits).  This file imports nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

EPS = 1e-5


def _ident(t):
    return t


def unet_levels(n_channels: int, base: int) -> dict:
    """{level: (cin, cout)} of the U-Net's DoubleConvs."""
    b = base
    return {"inc": (n_channels, b), "down1": (b, 2 * b),
            "down2": (2 * b, 4 * b), "down3": (4 * b, 8 * b),
            "down4": (8 * b, 8 * b), "up1": (16 * b, 4 * b),
            "up2": (8 * b, 2 * b), "up3": (4 * b, b), "up4": (2 * b, b)}


def unet_leaves(n_channels: int, n_classes: int, base: int) -> list:
    """[(path, shape, kind)] of every leaf of the U-Net, in the layout
    that ``fabric_tpu_torch.weights`` loads: per block ``conv1`` /
    ``conv2`` with an HWIO ``kernel`` and a ``bias``, ``bn1`` / ``bn2``
    with ``scale`` and ``bias`` (kind "shift") and the statistics ``mean``
    / ``var``; ``down*`` and ``up*`` wrap their block in ``conv``;
    ``outc/conv`` is the 1x1 head."""
    out = []
    for level, (cin, cout) in unet_levels(n_channels, base).items():
        pre = (level,) if level == "inc" else (level, "conv")
        for i, (ci, co) in enumerate(((cin, cout), (cout, cout)), 1):
            out.append((pre + (f"conv{i}", "kernel"), (3, 3, ci, co),
                        "kernel"))
            out.append((pre + (f"conv{i}", "bias"), (co,), "bias"))
            out.append((pre + (f"bn{i}", "scale"), (co,), "scale"))
            out.append((pre + (f"bn{i}", "bias"), (co,), "shift"))
            out.append((pre + (f"bn{i}", "mean"), (co,), "mean"))
            out.append((pre + (f"bn{i}", "var"), (co,), "var"))
    out.append((("outc", "conv", "kernel"), (1, 1, base, n_classes),
                "kernel"))
    out.append((("outc", "conv", "bias"), (n_classes,), "bias"))
    return out


def _block(tree: dict, level: str) -> dict:
    p = tree[level]
    return p if level == "inc" else p["conv"]


def _conv(x, kernel, bias, q):
    """SAME conv of NCHW ``x`` with an HWIO kernel, plus the bias."""
    k = q(kernel.permute(3, 2, 0, 1))
    return q(F.conv2d(q(x), k, padding=kernel.shape[0] // 2)
             + bias[None, :, None, None])


def fold(conv: dict, bn: dict, stats: dict) -> tuple:
    """(kernel, bias) of a conv with its BatchNorm folded in (float32)."""
    scale = bn["scale"] / torch.sqrt(stats["var"] + EPS)
    return (conv["kernel"] * scale,
            (conv["bias"] - stats["mean"]) * scale + bn["bias"])


class Net:
    """One network's reference, eval (folded) or train (batch
    statistics): ``net(batch)`` runs ``model.forward(net, batch)``, where
    ``model`` is the model's module (``models/<model>.py``)."""

    def __init__(self, model, params: dict, stats: dict | None = None,
                 train: bool = False, q=_ident, remat: bool = False):
        self.model, self.params, self.stats = model, params, stats
        self.train, self.q, self.remat = train, q, remat
        self._folded: dict = {}

    def __call__(self, batch: dict):
        return self.model.forward(self, batch)

    def double(self, level: str, x):
        p = _block(self.params, level)
        for i in (1, 2):
            c, bn = p[f"conv{i}"], p[f"bn{i}"]
            if not self.train:
                key = (level, i)
                if key not in self._folded:
                    self._folded[key] = fold(
                        c, bn, _block(self.stats, level)[f"bn{i}"])
                x = torch.relu(_conv(x, *self._folded[key], self.q))
                continue
            y = _conv(x, c["kernel"], c["bias"], self.q)
            y = F.batch_norm(y, None, None, bn["scale"], bn["bias"],
                             training=True, eps=EPS)
            x = torch.relu(y)
        return x

    def stage(self, level: str, *xs):
        fn = getattr(self, "_" + ("inc" if level == "inc" else level[:-1]))
        if self.train and self.remat:
            return checkpoint(fn, level, *xs, use_reentrant=False)
        return fn(level, *xs)

    def _inc(self, level, x):
        return self.double(level, x)

    def _down(self, level, x):
        return self.double(level, F.max_pool2d(x, 2))

    def _up(self, level, x1, x2):
        up = F.interpolate(x1, scale_factor=2, mode="bilinear",
                           align_corners=True)
        if up.shape[-2:] != x2.shape[-2:]:
            raise ValueError("the reference takes sides divisible by 16")
        return self.double(level, torch.cat([x2, up], dim=1))

    def encode(self, x):
        """The U-Net encoder's five levels of NCHW ``x``."""
        feats = [self.stage("inc", x)]
        for level in ("down1", "down2", "down3", "down4"):
            feats.append(self.stage(level, feats[-1]))
        return feats

    def head(self, y):
        c = self.params["outc"]["conv"]
        k = c["kernel"][0, 0]
        return self.q(torch.einsum("nchw,co->nhwo", self.q(y), self.q(k))
                      + c["bias"])

    def decode(self, bottom, skips):
        """NHWC logits from the bottom level and the skips, deepest
        first."""
        y = bottom
        for level, skip in zip(("up1", "up2", "up3", "up4"), skips):
            y = self.stage(level, y, skip)
        return self.head(y)


def tversky(logits, labels, weights, alpha: float, beta: float,
            eps: float = 1e-7):
    """Soft Tversky loss over the batch: per class, TP / (TP + alpha FP +
    beta FN) with soft counts summed over every pixel of every row (a row
    weighted by ``weights``), 1 - its mean over the classes."""
    probs = torch.softmax(logits.float(), dim=-1)
    onehot = F.one_hot(labels.long(), logits.shape[-1]).float()
    w = weights.float().reshape((-1,) + (1,) * (labels.dim()))
    probs, onehot = probs * w, onehot * w
    axes = tuple(range(labels.dim()))
    tp = (probs * onehot).sum(axes)
    fp = (probs * (1 - onehot)).sum(axes)
    fn = ((1 - probs) * onehot).sum(axes)
    return 1.0 - torch.mean(tp / (tp + alpha * fp + beta * fn + eps))
