"""Siamese bi-date U-Net for change detection (counterpart of
``fabric_tpu/models/bidate.py``).

Shared encoder (inc 13->64, down x4: 64->128->256->512->512), per-level
fusion ``relu(d2 * d1)``, and a skip-connected decoder (up 1024->256,
512->128, 256->64, 128->64) with a 1x1 head.  Returns float32 logits.
The decoder upsamples align-corners, or with ``local_upsample`` by the
shift-invariant local upsample that fullconv serving needs
(``ops/resize.upsample2x_local``); the weights are the same either way.

The encoder runs once on both dates stacked on the batch axis, so
train-mode BatchNorm takes joint two-date batch statistics; with
``joint_date_batchnorm=False`` a train forward encodes each date on its
own, as the reference's twice-applied encoder does
(``fabric_tpu/models/bidate.py:102-110``).  Eval is the same either way.

With ``remat`` a train forward keeps only each stage's inputs (inc,
down1-4, up1-4, as ``fabric_tpu``'s ``nn.remat`` stages) and runs the
stage again in the backward pass (``torch.utils.checkpoint``): activation
memory for a third more convolution work.  The repeated forward leaves
the BatchNorm running averages alone, so they move once a step, as
without remat.

``lane_pack`` / ``lane_pack_bwd`` reach every DoubleConv block
(``models/blocks.py``): an unfolded model lane-packs the convs that
``ops/s2d_conv.supports`` admits; a folded one serves on the conv
kernels either way.

Inside ``parallel/spatial.sharded`` (a step on a mesh's spatial axis)
each stage runs at its level (:func:`parallel.spatial.at`; inc and
down1-4 are levels 0-4, up1-4 levels 3-0), on the rank's rows of a split
level; the fusion and the head are pointwise, so they run on whatever
rows the rank holds.  A rematerialised stage re-enters its level, and
reruns its collectives, in its recompute.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from fabric_tpu_torch.models.blocks import (BatchNorm, DoubleConv, Down,
                                            OutConv, Up)
from fabric_tpu_torch.ops import fused as fused_ops
from fabric_tpu_torch.parallel import spatial


def fuse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Multiplicative-ReLU Siamese fusion: relu(b * a), one kernel launch
    (under no_grad or inference_mode the Function records no graph)."""
    return fused_ops.FusedMulRelu.apply(b, a)


@contextlib.contextmanager
def _recompute(stage: nn.Module, lv):
    """A rematerialised ``stage``'s recompute: at its level ``lv``, its
    BatchNorm layers leaving their running averages alone."""
    layers = [m for m in stage.modules() if isinstance(m, BatchNorm)]
    for bn in layers:
        bn.update_stats = False
    try:
        with spatial.use(lv):
            yield
    finally:
        for bn in layers:
            bn.update_stats = True


class BiDateNet(nn.Module):
    def __init__(self, n_channels: int = 13, n_classes: int = 2,
                 base: int = 64, fold_bn: bool = True,
                 dtype: torch.dtype = torch.bfloat16,
                 joint_date_batchnorm: bool = True, remat: bool = False,
                 local_upsample: bool = False, lane_pack: bool = False,
                 lane_pack_bwd: bool = False):
        super().__init__()
        self.local_upsample = local_upsample
        self.fold_bn = fold_bn
        self.dtype = dtype
        self.joint_date_batchnorm = joint_date_batchnorm
        self.remat = remat
        b = base
        lp = dict(lane_pack=lane_pack, lane_pack_bwd=lane_pack_bwd)
        self.inc = DoubleConv(n_channels, b, fold_bn, **lp)
        self.down1 = Down(b, 2 * b, fold_bn, **lp)
        self.down2 = Down(2 * b, 4 * b, fold_bn, **lp)
        self.down3 = Down(4 * b, 8 * b, fold_bn, **lp)
        self.down4 = Down(8 * b, 8 * b, fold_bn, **lp)
        self.up1 = Up(16 * b, 4 * b, fold_bn, local_upsample, **lp)
        self.up2 = Up(8 * b, 2 * b, fold_bn, local_upsample, **lp)
        self.up3 = Up(4 * b, b, fold_bn, local_upsample, **lp)
        self.up4 = Up(2 * b, b, fold_bn, local_upsample, **lp)
        self.outc = OutConv(b, n_classes)

    def _stage(self, stage: nn.Module, levels: tuple[int, int],
               train: bool, *xs: torch.Tensor):
        """``stage(*xs, train)`` at its (level, source level),
        rematerialised in the backward pass when training with
        ``remat``."""
        lv = spatial.level(*levels)
        with spatial.use(lv):
            if not (self.remat and train):
                return stage(*xs, train)
            return checkpoint(stage, *xs, train, use_reentrant=False,
                              context_fn=lambda: (contextlib.nullcontext(),
                                                  _recompute(stage, lv)))

    def _encode(self, x: torch.Tensor, train: bool):
        x1 = self._stage(self.inc, (0, 0), train, x)
        x2 = self._stage(self.down1, (1, 0), train, x1)
        x3 = self._stage(self.down2, (2, 1), train, x2)
        x4 = self._stage(self.down3, (3, 2), train, x3)
        return x1, x2, x3, x4, self._stage(self.down4, (4, 3), train, x4)

    def forward(self, x_d1: torch.Tensor, x_d2: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        """x_d1, x_d2: (N, H, W, n_channels).  Returns float32 logits
        (N, H, W, n_classes); ``train`` selects batch-statistics
        BatchNorm (and updates the running averages)."""
        if self.joint_date_batchnorm or not train:
            n = x_d1.shape[0]
            feats = self._encode(torch.cat([x_d1, x_d2]).to(self.dtype),
                                 train)
            d1 = [x[:n] for x in feats]
            d2 = [x[n:] for x in feats]
        else:
            d1 = self._encode(x_d1.to(self.dtype), train)
            d2 = self._encode(x_d2.to(self.dtype), train)
        f1, f2, f3, f4, f5 = (fuse(a, b) for a, b in zip(d1, d2))
        y = self._stage(self.up1, (3, 4), train, f5, f4)
        y = self._stage(self.up2, (2, 3), train, y, f3)
        y = self._stage(self.up3, (1, 2), train, y, f2)
        y = self._stage(self.up4, (0, 1), train, y, f1)
        return self.outc(y).float()
