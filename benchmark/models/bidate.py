"""BiDateNet (granularai/fabric ``models/bidate_model.py``), for the
configurations whose ``model`` is ``bidate``: the leaves of its seeded
weights and its plain reference forward.

A Siamese U-Net: the encoder (``reference/nets.py``) runs on both dates
at once, BatchNorm in training normalising the two dates jointly; each
level is fused as relu(d2 * d1); the decoder runs on the fused levels.
Its batches hold the dates as ``img1`` and ``img2``."""

from __future__ import annotations

import torch

from benchmark.reference import nets

MULTI_DATE = False  # the loader's batches: img1 and img2, not imgs


def leaves(config: dict) -> list:
    """[(path, shape, kind)] of every leaf of the seeded weights."""
    return nets.unet_leaves(config["n_channels"], config["n_classes"],
                            config["model_base"])


def pair(net: nets.Net, d1, d2):
    """(N, H, W, C) pair -> (N, H, W, classes) float32 logits."""
    n = d1.shape[0]
    x = torch.cat([d1, d2]).float().permute(0, 3, 1, 2)
    feats = net.encode(x)
    fused = [net.q(torch.relu(f[n:] * f[:n])) for f in feats]
    return net.decode(fused[4], fused[3::-1])


def forward(net: nets.Net, batch: dict):
    """A batch of the loader's (or a served pair as ``img1``, ``img2``)
    -> logits."""
    return pair(net, batch["img1"], batch["img2"])
