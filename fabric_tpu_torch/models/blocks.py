"""U-Net building blocks, NHWC (counterparts of
``fabric_tpu/models/blocks.py``).

Parameter names and layouts follow ``fabric_tpu``'s flax tree (``conv1``
/ ``conv2`` with an HWIO ``kernel`` and a ``bias``, ``bn1`` / ``bn2`` with
``scale``, ``bias`` and the running ``mean`` / ``var``), so a
``fabric_tpu`` checkpoint maps onto the modules key for key
(``fabric_tpu_torch/weights.py``).  Parameters stay float32; the forward
computes in the activations' dtype.

Folded DoubleConv blocks (BatchNorm folded into the convs) are the serving
path and run on the hand-written conv kernels of the activations' dtype
(bf16 or float32), dispatched like ``fabric_tpu/models/blocks.py:115-152``
with ``use_pallas``: the fused double-conv kernel where its gate for that
dtype holds, otherwise two conv3x3 launches, both on the block's kernels
packed once for that dtype (``DoubleConv.packed_kernels``).
Blocks with BatchNorm train (batch statistics, ``TorchBatchNorm``'s rules)
or evaluate from running averages; in eval the conv bias, BatchNorm and
ReLU are one ``bn_relu_inference`` kernel launch (``ops/bn_relu.py``).
Their convs are ``F.conv2d`` (cuDNN on the card, in full float32 for
float32 whatever the TF32 flags say: ``ops/fp32_conv.py``): ``fabric_tpu`` computes
them with XLA's ``nn.Conv`` outside any Pallas kernel
(``blocks.py:168-174``), a plain large product that stays a library call
here, not an unported kernel.

With ``lane_pack`` an unfolded block computes each conv that
``ops/s2d_conv.supports`` admits (Cout < 128, even sides of at least 96)
in space-to-depth layout (``fabric_tpu/models/blocks.py:154-166``): in
training through ``conv3x3_lane_packed`` (the direct conv's gradients;
``lane_pack_bwd`` packs the dgrad conv too), in eval as the packed conv
followed by the eval BatchNorm kernel.  A folded block keeps the conv
kernels whatever ``lane_pack`` says, as ``fabric_tpu``'s folded Pallas
branch comes before its ``lane_pack`` one (``blocks.py:117-150``).

On a mesh's spatial axis (``parallel/spatial.py``) the blocks of a
split level hold the rank's rows: a conv reads a halo and is VALID in H,
BatchNorm sums over the ranks whose rows the level spans, a Down block
into a gathered level gathers its input, and an Up block computes its
rows of the global upsample.  A lane-packed conv there (:meth:`Conv.packed`)
reads the halo rows that make the rank's rows whole s2d blocks of the
global image (``spatial.block_halo``), takes the VALID-in-H packed form
and keeps the rank's rows of its output, in training and in eval; the
gate reads the level's global rows, as ``fabric_tpu``'s does under GSPMD.
"""

from __future__ import annotations

import torch
from torch import nn

from fabric_tpu_torch.ops import bn_relu as bn_relu_ops
from fabric_tpu_torch.parallel import distributed, spatial
from fabric_tpu_torch.ops import conv as conv_ops
from fabric_tpu_torch.ops import double_conv as double_conv_ops
from fabric_tpu_torch.ops import fp32_conv, fp32_matmul
from fabric_tpu_torch.ops import s2d_conv
from fabric_tpu_torch.ops.resize import (pad_to_match,
                                        upsample2x_align_corners,
                                        upsample2x_local)


def weights_key(*tensors: torch.Tensor) -> tuple | None:
    """(data_ptr, version) of each tensor: a cache made from them is stale
    when this changes.  None while ``torch.export`` traces (the weights
    are fake tensors then, and the cache made before the trace is what the
    program holds)."""
    if torch.compiler.is_exporting():
        return None
    return tuple((t.data_ptr(), t._version) for t in tensors)


def _weight(*shape: int) -> nn.Parameter:
    """A frozen parameter; ``build_model(train=True)`` unfreezes them."""
    return nn.Parameter(torch.zeros(shape), requires_grad=False)


class Conv(nn.Module):
    """Parameter holder laid out like flax ``nn.Conv``: HWIO kernel + bias."""

    def __init__(self, cin: int, cout: int, size: int = 3):
        super().__init__()
        self.kernel = _weight(size, size, cin, cout)
        self.bias = _weight(cout)

    def conv(self, x: torch.Tensor) -> torch.Tensor:
        """SAME conv in x's dtype, NHWC, without the bias (on a split
        level: the rank's rows, from a halo)."""
        k = self.kernel.shape[0] // 2
        x, pad_h = spatial.halo_rows(x, k)
        y = fp32_conv.conv(x.permute(0, 3, 1, 2),
                           self.kernel.to(x.dtype).permute(3, 2, 0, 1),
                           padding=(pad_h, k))
        return y.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """SAME conv + bias in x's dtype (flax ``nn.Conv(dtype=...)``)."""
        return self.conv(x) + self.bias.to(x.dtype)

    def packed(self, x: torch.Tensor,
               pack_bwd: bool | None = None) -> torch.Tensor:
        """The SAME conv lane-packed (``ops/s2d_conv.py``): with
        ``pack_bwd`` None the eval form, without the bias; else
        ``conv3x3_lane_packed`` with the bias.  On a split level, of the
        rank's rows made whole s2d blocks by a halo, VALID in H, and cut
        to the rank's rows (a copy: an odd shard's output has one row
        more)."""
        h = x.shape[1]
        ext, first = spatial.block_halo(x)
        pad_h = first is None
        if pack_bwd is None:
            s2d_conv.packed_counts["eval"] += 1
            y = s2d_conv.s2d_conv3x3(ext, self.kernel, pad_h=pad_h)
        else:
            y = s2d_conv.conv3x3_lane_packed(
                ext, self.kernel.to(x.dtype), self.bias, pack_bwd,
                pad_h=pad_h, height=spatial.global_rows(h))
        if y.shape[1] != h:
            y = y[:, first:first + h].clone(
                memory_format=torch.contiguous_format)
        return y


class BatchNorm(nn.Module):
    """flax ``TorchBatchNorm`` (``fabric_tpu/models/blocks.py:32-88``):
    statistics in float32 over every axis but the last (channels), so n
    is N*H*W for an (N, H, W, C) input and N*T*H*W for UNet3D's (N, T, H,
    W, C); train mode normalises with the biased batch variance
    max(E[x^2] - E[x]^2, 0) and moves the running averages by momentum
    0.9 on the old value, the variance's by the unbiased n/(n-1)
    estimate; eval mode uses the running averages.

    ``update_stats`` False normalises the same way but leaves the running
    averages where they are: the rematerialised forward of a checkpointed
    stage (``BiDateNet.remat``) repeats a forward whose update was made.

    In training over a process group (``parallel/distributed.py``) the
    statistics are the global batch's, as under ``fabric_tpu``'s jit
    SPMD: the per-channel sums of x and x^2 are all-reduced with their
    gradient over the ranks whose rows the level spans
    (``parallel/spatial.stats_group``: the batch group, or the data group
    at a level every spatial rank holds whole), and n is the global count
    (the ranks hold equal rows).  Every rank runs these collectives in the
    same order, the rematerialised forward's included."""

    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.update_stats = True
        self.scale = _weight(features)
        self.bias = _weight(features)
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Train-mode BatchNorm; float32 output."""
        xf = x.float()
        axes = tuple(range(x.dim() - 1))
        n = x.numel() // x.shape[-1]
        group = spatial.stats_group()
        if group.collective:
            sums = distributed.all_reduce_sum(
                torch.stack([xf.sum(axes), (xf * xf).sum(axes)]), group)
            n *= group.size
            mean, sq = sums[0] / n, sums[1] / n
        else:
            mean, sq = xf.mean(axes), (xf * xf).mean(axes)
        var = torch.clamp(sq - mean * mean, min=0.0)
        if self.update_stats:
            self._move_averages(mean, var, n)
        inv = (var + self.eps) ** -0.5
        return (xf - mean) * (inv * self.scale) + self.bias

    @torch.no_grad()
    def _move_averages(self, mean: torch.Tensor, var: torch.Tensor,
                       n: int) -> None:
        m = self.momentum
        self.mean.copy_(m * self.mean + (1 - m) * mean)
        unbiased = var * (n / max(n - 1, 1))
        self.var.copy_(m * self.var + (1 - m) * unbiased)

    def relu_eval(self, x: torch.Tensor,
                  conv_bias: torch.Tensor | None = None) -> torch.Tensor:
        """Eval BatchNorm + ReLU of x (plus ``conv_bias``, rounded to x's
        dtype first), rounded to x's dtype (the kernel)."""
        return bn_relu_ops.bn_relu_inference(x, self.scale, self.bias,
                                             self.mean, self.var, self.eps,
                                             conv_bias)


class DoubleConv(nn.Module):
    """(3x3 conv -> BN -> ReLU) x 2, SAME padding; BN folded or not;
    with ``lane_pack`` (unfolded only) the convs ``s2d_conv.supports``
    admits are lane-packed."""

    def __init__(self, cin: int, cout: int, fold_bn: bool = True,
                 lane_pack: bool = False, lane_pack_bwd: bool = False):
        super().__init__()
        self.fold_bn = fold_bn
        self.lane_pack = lane_pack
        self.lane_pack_bwd = lane_pack_bwd
        self.conv1 = Conv(cin, cout)
        self.conv2 = Conv(cout, cout)
        if not fold_bn:
            self.bn1 = BatchNorm(cout)
            self.bn2 = BatchNorm(cout)

    def packed_kernels(self, dtype: torch.dtype = torch.bfloat16) -> tuple:
        """The folded kernels packed for the conv kernels of ``dtype``
        (``conv_ops.pack_weight``), made at the first call and kept until
        the kernels or the dtype change.  ``build_model`` makes them for
        the model's dtype, so that an exported program holds them as
        constants."""
        k1, k2 = self.conv1.kernel, self.conv2.kernel
        key = weights_key(k1, k2)
        if key is not None and getattr(self, "_packed_key",
                                       None) != (key, dtype):
            with torch.no_grad():
                self._packed = (conv_ops.pack_weight(k1, dtype),
                                conv_ops.pack_weight(k2, dtype))
            self._packed_key = (key, dtype)
        return self._packed

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        c1, c2 = self.conv1, self.conv2
        if self.fold_bn:
            if train:
                raise ValueError("fold_bn is an inference-only transform")
            _, h, w, cin = x.shape
            cout = c2.kernel.shape[-1]
            packed = self.packed_kernels(x.dtype)
            if double_conv_ops.supports(h, w, cin, cout, cout, x.dtype):
                return double_conv_ops.double_conv3x3_bias_relu(
                    x, c1.kernel, c1.bias, c2.kernel, c2.bias, packed)
            x = conv_ops.conv3x3_bias_relu(x, c1.kernel, c1.bias, packed[0])
            return conv_ops.conv3x3_bias_relu(x, c2.kernel, c2.bias,
                                              packed[1])
        for c, bn in ((c1, self.bn1), (c2, self.bn2)):
            # the gate reads the level's global rows
            packed = self.lane_pack and s2d_conv.supports(
                spatial.global_rows(x.shape[1]), x.shape[2], x.shape[3],
                c.kernel.shape[-1])
            if train:
                y = c.packed(x, self.lane_pack_bwd) if packed else c(x)
                x = torch.relu(bn(y)).to(x.dtype)
            elif packed:
                x = bn.relu_eval(c.packed(x), c.bias)
            else:
                # the conv bias rides in the kernel's prologue; the conv's
                # NHWC output is contiguous (a channels-last cuDNN result
                # permuted back), as the kernel requires
                x = bn.relu_eval(c.conv(x), c.bias)
        return x


def max_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 VALID max-pool of an (N, H, W, C) tensor."""
    n, h, w, c = x.shape
    x = x[:, :h // 2 * 2, :w // 2 * 2]
    return x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


class Down(nn.Module):
    """2x2 max-pool then DoubleConv (into a gathered level: of the
    gathered rows)."""

    def __init__(self, cin: int, cout: int, fold_bn: bool = True,
                 lane_pack: bool = False, lane_pack_bwd: bool = False):
        super().__init__()
        self.conv = DoubleConv(cin, cout, fold_bn, lane_pack, lane_pack_bwd)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.conv(max_pool2x2(spatial.pool_input(x)), train)


class Up(nn.Module):
    """2x upsample (align-corners, or with ``local_upsample`` the
    shift-invariant local one that fullconv serving needs; parameter-free
    either way), pad to the skip, concat ``[skip, up]`` (the reference's
    ``torch.cat([x2, x1], dim=1)``), DoubleConv."""

    def __init__(self, cin: int, cout: int, fold_bn: bool = True,
                 local_upsample: bool = False, lane_pack: bool = False,
                 lane_pack_bwd: bool = False):
        super().__init__()
        self.local_upsample = local_upsample
        self.conv = DoubleConv(cin, cout, fold_bn, lane_pack, lane_pack_bwd)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        lv = spatial.current()
        if lv is not None and lv.input_split:
            x1 = lv.upsample2x(x1, self.local_upsample)
        else:
            up = upsample2x_local if self.local_upsample \
                else upsample2x_align_corners
            x1 = up(x1)
        if lv is not None and lv.split and not lv.input_split:
            # from a gathered level: the rank's rows of the whole upsample
            x1 = lv.local_rows(pad_to_match(x1, x2.shape[1] * lv.count,
                                            x2.shape[2]))
        x1 = pad_to_match(x1, x2.shape[1], x2.shape[2])
        return self.conv(torch.cat([x2, x1], dim=-1), train)


class OutConv(nn.Module):
    """1x1 projection to class logits, in the compute dtype (flax
    ``nn.Conv``): a channel matmul, then the bias."""

    def __init__(self, cin: int, n_classes: int):
        super().__init__()
        self.conv = Conv(cin, n_classes, size=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.conv.kernel.reshape(self.conv.kernel.shape[2:])
        return fp32_matmul.matmul(x, k.to(x.dtype)) + self.conv.bias.to(
            x.dtype)
