"""UNetLSTM: the multi-date U-Net with a ConvLSTM bottleneck (counterpart
of ``fabric_tpu/models/unet_lstm.py``).

Input (N, T, H, W, C).  The shared encoder (BiDateNet's: inc, down1-4)
runs once at batch N*T; the bottleneck features go through a ConvLSTM
scanned over the T dates from a zero state (one 3x3 conv over ``[x, h]``
gives the four gates, in the order i, f, g, o, with ``f = sigmoid(f +
1)``); each skip level fuses its T dates as ``relu(prod_t x_t)`` (for T =
2 the bi-date fusion ``relu(d2 * d1)``); the decoder is BiDateNet's.

The encoder and decoder blocks are the bi-date ones, on the conv kernels
when BatchNorm is folded and on the eval-BatchNorm kernel when not.  The
gate conv has no ReLU, so it is not the conv kernel's op: ``fabric_tpu``
computes it with XLA outside any Pallas kernel, and here it is
``F.conv2d`` in the compute dtype with the bias added in that dtype, as
flax's ``nn.Conv`` does.  The T-date product and the gate nonlinearities
are plain PyTorch, as they are XLA in ``fabric_tpu``.

Fullconv serving (``infer/fullconv.py``) needs a band of a scene to compute
each pixel as the whole scene does, and cuDNN picks its algorithm by
shape: on the H100, at base 64, a band's gate conv rounded otherwise than
the whole scene's.  So a model built with ``local_upsample`` (the fullconv
model) runs its gate conv on the conv kernel of its dtype (bf16 or
float32), whose per-pixel sums do not depend on the image's size: one
launch computes relu(z) and relu(-z) from the kernel concatenated with its
negation, and z is their difference, exact in either dtype
(:func:`signed_conv`).  Each date's gate conv widens the
receptive field by one 3x3 conv at stride 16: 109 + 16 T px, which is
what the fullconv halo must cover (``fullconv.halo_for``).

In train mode (``forward(seq, train=True)``) the shared encoder takes its
BatchNorm batch statistics over all N*T images, as ``fabric_tpu``'s does,
and the ConvLSTM is a Python loop over T through the one ``gates`` conv,
so autograd sums its gradients over the steps (``nn.scan``'s broadcast
params).  The gate conv is then always ``self.gates`` (``F.conv2d``): the
signed route runs on the conv kernel, which has no backward, and
``fabric_tpu`` computes that conv with XLA outside any Pallas kernel.  An
eval forward after an optimizer step takes the signed weights anew
(:meth:`ConvLSTMCell.signed_gates` keys on the gate tensors' versions).
The conv kernel takes bf16 and float32, so the signed route is a bf16 or
float32 eval forward's (on the kernel of that dtype), on the card and (on
its plain version) on the CPU alike: an fp64 eval forward computes the
gate conv with ``self.gates``.

Inside ``parallel/spatial.sharded`` each block runs at its level, as in
BiDateNet; the ConvLSTM at the bottleneck's (4), its gate conv reading a
halo when that level is split (the signed route: the kernel's SAME conv
of the halo-extended rows, less its first and last rows), and the T-date
fusion on the rank's rows.
"""

from __future__ import annotations

import torch
from torch import nn

from fabric_tpu_torch.models.blocks import (Conv, DoubleConv, Down, OutConv,
                                            Up, weights_key)
from fabric_tpu_torch.ops import conv as conv_ops
from fabric_tpu_torch.parallel import spatial


def multi_date_fuse(feats: torch.Tensor) -> torch.Tensor:
    """relu(prod over the date axis 1) of (N, T, H, W, C) features."""
    return torch.relu(torch.prod(feats, dim=1))


def signed_conv(x: torch.Tensor, signed_kernel: torch.Tensor,
                signed_bias: torch.Tensor,
                packed: torch.Tensor | None = None) -> torch.Tensor:
    """conv3x3_SAME(x, K) + b, rounded once to x's dtype, on the conv
    kernel: ``signed_kernel`` is [K, -K] along the output channels and
    ``signed_bias`` [b, -b], so the launch gives [relu(z), relu(-z)], the
    second the exact negation of the first's sums, and z is their
    difference (one of the two is 0), in bf16 or float32 alike."""
    y = conv_ops.conv3x3_bias_relu(x, signed_kernel, signed_bias, packed)
    c = y.shape[-1] // 2
    return y[..., :c] - y[..., c:]


class ConvLSTMCell(nn.Module):
    """One ConvLSTM step: the four gates from one 3x3 SAME conv over the
    channel concat ``[x, h]``."""

    def __init__(self, cin: int, features: int, exact_crops: bool = False):
        super().__init__()
        self.exact_crops = exact_crops
        self.gates = Conv(cin + features, 4 * features)

    def signed_gates(self, dtype: torch.dtype = torch.bfloat16) -> tuple:
        """([K, -K], [b, -b], [K, -K] packed for the conv kernel of
        ``dtype``) for :func:`signed_conv`, made once and again when the
        weights or the dtype change (``build_model`` makes them for the
        model's dtype, so that an exported program holds them as
        constants)."""
        k, b = self.gates.kernel, self.gates.bias
        key = weights_key(k, b)
        if key is not None and getattr(self, "_signed_key",
                                       None) != (key, dtype):
            with torch.no_grad():
                kk, bb = torch.cat([k, -k], -1), torch.cat([b, -b])
                self._signed = (kk, bb, conv_ops.pack_weight(kk, dtype))
            self._signed_key = (key, dtype)
        return self._signed

    @staticmethod
    def step(z: torch.Tensor, c: torch.Tensor):
        """(h, c) from the gate pre-activations z (i, f, g, o along the
        channels) and the cell state c, in z's dtype."""
        i, f, g, o = torch.chunk(z, 4, dim=-1)
        i = torch.sigmoid(i)
        f = torch.sigmoid(f + 1.0)  # the forget-gate bias trick
        g = torch.tanh(g)
        o = torch.sigmoid(o)
        c = f * c.to(f.dtype) + i * g
        return o * torch.tanh(c), c

    def forward(self, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                train: bool = False):
        xh = torch.cat([x, h], dim=-1)
        # the signed route where the conv kernel takes xh: a bf16 or
        # float32 eval, on the card and (its plain version) on the CPU alike
        signed = (self.exact_crops and not train
                  and xh.dtype in (torch.bfloat16, torch.float32))
        if not signed:
            z = self.gates(xh)
        else:
            ext, pad = spatial.halo_rows(xh, 1)
            z = signed_conv(ext, *self.signed_gates(xh.dtype))
            if not pad:  # the kernel's rows of the halo-extended input
                z = z[:, 1:-1]
        return self.step(z, c)


class UNetLSTM(nn.Module):
    multi_date = True

    def __init__(self, n_channels: int = 13, n_classes: int = 2,
                 base: int = 64, fold_bn: bool = True,
                 dtype: torch.dtype = torch.bfloat16,
                 local_upsample: bool = False):
        super().__init__()
        self.local_upsample = local_upsample
        self.fold_bn = fold_bn
        self.dtype = dtype
        b = base
        self.inc = DoubleConv(n_channels, b, fold_bn)
        self.down1 = Down(b, 2 * b, fold_bn)
        self.down2 = Down(2 * b, 4 * b, fold_bn)
        self.down3 = Down(4 * b, 8 * b, fold_bn)
        self.down4 = Down(8 * b, 8 * b, fold_bn)
        self.bottleneck_lstm = ConvLSTMCell(8 * b, 8 * b, local_upsample)
        self.up1 = Up(16 * b, 4 * b, fold_bn, local_upsample)
        self.up2 = Up(8 * b, 2 * b, fold_bn, local_upsample)
        self.up3 = Up(4 * b, b, fold_bn, local_upsample)
        self.up4 = Up(2 * b, b, fold_bn, local_upsample)
        self.outc = OutConv(b, n_classes)

    def forward(self, seq: torch.Tensor, train: bool = False
                ) -> torch.Tensor:
        """seq: (N, T, H, W, n_channels).  Returns float32 logits (N, H, W,
        n_classes); ``train`` uses (and moves) batch statistics."""
        n, t = seq.shape[:2]
        x = seq.reshape((n * t,) + seq.shape[2:]).to(self.dtype)
        with spatial.at(0):
            x1 = self.inc(x, train)
        with spatial.at(1, 0):
            x2 = self.down1(x1, train)
        with spatial.at(2, 1):
            x3 = self.down2(x2, train)
        with spatial.at(3, 2):
            x4 = self.down3(x3, train)
        with spatial.at(4, 3):
            x5 = self.down4(x4, train)
        s1, s2, s3, s4, bott = (v.reshape((n, t) + v.shape[1:])
                                for v in (x1, x2, x3, x4, x5))
        h = bott.new_zeros(bott.shape[:1] + bott.shape[2:])
        c = torch.zeros_like(h)
        with spatial.at(4):
            for step in range(t):
                h, c = self.bottleneck_lstm(bott[:, step], h, c, train)
        with spatial.at(3, 4):
            y = self.up1(h, multi_date_fuse(s4), train)
        with spatial.at(2, 3):
            y = self.up2(y, multi_date_fuse(s3), train)
        with spatial.at(1, 2):
            y = self.up3(y, multi_date_fuse(s2), train)
        with spatial.at(0, 1):
            y = self.up4(y, multi_date_fuse(s1), train)
        return self.outc(y).float()
