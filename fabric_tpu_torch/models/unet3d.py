"""UNet3D: the spatiotemporal U-Net over multi-date stacks (counterpart of
``fabric_tpu/models/unet3d.py``).

Input (N, T, H, W, C) as an NDHWC volume (depth = T).  The encoder is
five ``DoubleConv3D`` blocks (3x3x3 SAME convs, padding T too) with a
spatial-only 2x2 max-pool between them, so T is kept through the pyramid;
each skip collapses T by max, the bottleneck by mean; the decoder is
BiDateNet's 2-D Up stack and head.

The 3-D convs are ``F.conv3d`` in the compute dtype with the bias added in
that dtype (flax's ``nn.Conv``; in full float32 for float32 whatever the
TF32 flags say, ``ops/fp32_conv.py``): ``fabric_tpu`` computes them with
XLA, outside any Pallas kernel.  Folded, the decoder's 2-D blocks serve on
the conv kernels of the compute dtype (bf16 or float32).  With BatchNorm unfolded, each 3-D conv's bias,
BatchNorm and ReLU run on the eval-BatchNorm kernel over the (N*T, H, W,
C) view, as the 2-D blocks do.  In train mode (``forward(seq,
train=True)``) each 3-D conv adds its bias in the compute dtype, then
BatchNorm takes its batch statistics in float32 over N*T*H*W and ReLU
casts back to the compute dtype (``fabric_tpu/models/unet3d.py:38-52``),
all under autograd.

Inside ``parallel/spatial.sharded`` each block runs at its level, as in
BiDateNet: a 3-D conv of a split level reads a halo of H (axis 2 of
NTHWC; T is never split), and the pool into a gathered level gathers its
input.
"""

from __future__ import annotations

import torch
from torch import nn

from fabric_tpu_torch.models.blocks import (BatchNorm, OutConv, Up, _weight,
                                            max_pool2x2)
from fabric_tpu_torch.ops import fp32_conv
from fabric_tpu_torch.parallel import spatial


def conv3d_same(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """SAME 3x3x3 conv of an NDHWC tensor by a DHWIO kernel, in x's dtype,
    without bias; the output is contiguous NDHWC (on a split level: the
    rank's rows, from a halo)."""
    x, pad_h = spatial.halo_rows(x, 1, axis=2)
    y = fp32_conv.conv(x.permute(0, 4, 1, 2, 3),
                       kernel.to(x.dtype).permute(4, 3, 0, 1, 2),
                       padding=(1, pad_h, 1))
    return y.permute(0, 2, 3, 4, 1).contiguous()


def spatial_pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool over H and W of an (N, T, H, W, C) tensor; T kept
    (into a gathered level: of the gathered rows)."""
    x = spatial.pool_input(x, axis=2)
    n, t = x.shape[:2]
    y = max_pool2x2(x.reshape((n * t,) + x.shape[2:]))
    return y.reshape((n, t) + y.shape[1:])


class Conv3D(nn.Module):
    """Parameter holder laid out like flax ``nn.Conv`` with a (3, 3, 3)
    window: a DHWIO kernel and a bias."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = _weight(3, 3, 3, cin, cout)
        self.bias = _weight(cout)


class DoubleConv3D(nn.Module):
    """(3x3x3 conv -> BN -> ReLU) x 2 over NDHWC; BN folded or not."""

    def __init__(self, cin: int, cout: int, fold_bn: bool = True):
        super().__init__()
        self.fold_bn = fold_bn
        self.conv1 = Conv3D(cin, cout)
        self.conv2 = Conv3D(cout, cout)
        if not fold_bn:
            self.bn1 = BatchNorm(cout)
            self.bn2 = BatchNorm(cout)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train and self.fold_bn:
            raise ValueError("fold_bn is an inference-only transform")
        for i, c in enumerate((self.conv1, self.conv2), start=1):
            y = conv3d_same(x, c.kernel)
            if self.fold_bn:
                x = torch.relu(y + c.bias.to(y.dtype))
                continue
            bn = getattr(self, f"bn{i}")
            if train:
                x = torch.relu(bn(y + c.bias.to(y.dtype))).to(y.dtype)
            else:
                x = bn.relu_eval(y.reshape((-1,) + y.shape[2:]),
                                 c.bias).reshape(y.shape)
        return x


class UNet3D(nn.Module):
    multi_date = True

    def __init__(self, n_channels: int = 13, n_classes: int = 2,
                 base: int = 32, fold_bn: bool = True,
                 dtype: torch.dtype = torch.bfloat16,
                 local_upsample: bool = False):
        super().__init__()
        self.local_upsample = local_upsample
        self.fold_bn = fold_bn
        self.dtype = dtype
        b = base
        self.inc = DoubleConv3D(n_channels, b, fold_bn)
        self.down1 = DoubleConv3D(b, 2 * b, fold_bn)
        self.down2 = DoubleConv3D(2 * b, 4 * b, fold_bn)
        self.down3 = DoubleConv3D(4 * b, 8 * b, fold_bn)
        self.down4 = DoubleConv3D(8 * b, 8 * b, fold_bn)
        self.up1 = Up(16 * b, 4 * b, fold_bn, local_upsample)
        self.up2 = Up(8 * b, 2 * b, fold_bn, local_upsample)
        self.up3 = Up(4 * b, b, fold_bn, local_upsample)
        self.up4 = Up(2 * b, b, fold_bn, local_upsample)
        self.outc = OutConv(b, n_classes)

    def forward(self, seq: torch.Tensor, train: bool = False
                ) -> torch.Tensor:
        """seq: (N, T, H, W, n_channels).  Returns float32 logits (N, H, W,
        n_classes); ``train`` uses (and moves) batch statistics."""
        with spatial.at(0):
            x1 = self.inc(seq.to(self.dtype), train)
        with spatial.at(1, 0):
            x2 = self.down1(spatial_pool(x1), train)
        with spatial.at(2, 1):
            x3 = self.down2(spatial_pool(x2), train)
        with spatial.at(3, 2):
            x4 = self.down3(spatial_pool(x3), train)
        with spatial.at(4, 3):
            x5 = self.down4(spatial_pool(x4), train)
        s1, s2, s3, s4 = (v.amax(dim=1) for v in (x1, x2, x3, x4))
        with spatial.at(3, 4):
            y = self.up1(x5.mean(dim=1), s4, train)
        with spatial.at(2, 3):
            y = self.up2(y, s3, train)
        with spatial.at(1, 2):
            y = self.up3(y, s2, train)
        with spatial.at(0, 1):
            y = self.up4(y, s1, train)
        return self.outc(y).float()
