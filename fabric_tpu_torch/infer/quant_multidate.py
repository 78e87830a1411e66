"""Int8 post-training-quantized forwards of the multi-date models
(counterpart of ``fabric_tpu/infer/quant_multidate.py``), built from the
blocks of ``infer/quant.py`` by the same rules as the bi-date forward.

- The encoder is int8-resident, its sites one ``conv3x3_s8_q`` launch
  each, requantizing in the epilogue; the levels pool their int8 codes
  with ``models.blocks.max_pool2x2`` (spatial only).
- **UNetLSTM**: the 2-D encoder at batch N*T.  The ConvLSTM gate conv runs
  as its two halves: ``za = conv(x5) * (sw_x * s5)`` on the int8 encoder
  output and ``zb = conv(q(h, sh)) * (sw_h * sh)``, each an exact int32
  conv (``conv3x3_s8``, raw mode), then ``(za + zb + bias)`` rounded to
  the compute dtype in PyTorch, with ``fabric_tpu``'s XLA contraction of
  ``za + zb`` into a fused multiply-add (``torch.addcmul``).  The gate
  nonlinearities and the cell state stay in the compute dtype.  The
  T-date skip fusion takes the product of the int8 codes in float32
  (int32 overflows at T >= 5), then ``max(., 0) * s^T``, rounds half to
  even and clips to [0, 127] at the skip's scale ``fK``.
- **UNet3D**: each 3x3x3 site is one ``conv3x3_s8_q`` launch over the
  T-neighbour stack (``conv_s8.t_neighbours`` / ``fold_depth``),
  bit-equal to the 3-D int32 conv.  The skips collapse T by ``max`` of
  the int8 codes at their encoder scales (exact: max commutes with
  symmetric quantization); the bottleneck is the int32 sum over T times
  ``s5 / T``.
- The decoders are the bi-date split-conv Up stack (``Int8Blocks``).

Stats mode (:func:`make_stats_forward`) is the BN-folded model's math op
for op, tapping each conv input's absmax (and ``enc.x5``, ``f1..f4``,
and for UNetLSTM ``lstm.h``) for calibration.
"""

from __future__ import annotations

import numpy as np
import torch

from fabric_tpu_torch.infer.quant import (Int8Blocks, StatsBlocks, _absmax,
                                          _get, q)
from fabric_tpu_torch.models.blocks import max_pool2x2
from fabric_tpu_torch.models.unet3d import conv3d_same, spatial_pool
from fabric_tpu_torch.models.unet_lstm import ConvLSTMCell, multi_date_fuse
from fabric_tpu_torch.ops import conv_s8, fp32_conv

_ENC = ("inc", "down1", "down2", "down3", "down4")


def _gate_conv(folded, x: torch.Tensor) -> torch.Tensor:
    """The ConvLSTM gate conv of ``x`` = [x_t, h]: 3x3 SAME in x's dtype
    plus the bias in x's dtype (flax ``nn.Conv``)."""
    p = folded["bottleneck_lstm"]["gates"]
    y = fp32_conv.conv(x.permute(0, 3, 1, 2),
                       p["kernel"].to(x.dtype).permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1) + p["bias"].to(x.dtype)


def make_stats_forward(folded, dtype=torch.bfloat16, model: str = "unet_lstm",
                       local_upsample: bool = False):
    """The exact folded forward ``(seq) -> (logits, {site: absmax})`` of a
    multi-date ``model`` over an (N, T, H, W, C) stack (its decoder on the
    local upsample where ``local_upsample``)."""
    blocks = StatsBlocks(folded, local_upsample, dtype)

    def dc3(x, block, stats):
        for conv in ("conv1", "conv2"):
            name = f"{block}.{conv}"
            stats[name] = _absmax(x)
            p = _get(folded, blocks.sites[name])
            y = conv3d_same(x, p["kernel"])
            x = torch.relu(y + p["bias"].to(y.dtype))
        return x

    @torch.inference_mode()
    def forward_lstm(seq):
        stats: dict = {}
        n, t = seq.shape[:2]
        x = blocks.dc(seq.reshape((n * t,) + seq.shape[2:]).to(dtype),
                      "inc", stats)
        feats = [x]
        for block in _ENC[1:]:
            feats.append(blocks.dc(max_pool2x2(feats[-1]), block, stats))
        stats["enc.x5"] = _absmax(feats[4])
        s1, s2, s3, s4, bott = (v.reshape((n, t) + v.shape[1:])
                                for v in feats)
        h = bott.new_zeros(bott.shape[:1] + bott.shape[2:])
        c = torch.zeros_like(h)
        hmax = torch.zeros((), dtype=torch.float32, device=seq.device)
        for step in range(t):
            z = _gate_conv(folded, torch.cat([bott[:, step], h], dim=-1))
            h, c = ConvLSTMCell.step(z, c)
            hmax = torch.maximum(hmax, _absmax(h))
        stats["lstm.h"] = hmax
        f = [multi_date_fuse(a) for a in (s1, s2, s3, s4)]
        for k in range(1, 5):
            stats[f"f{k}"] = _absmax(f[k - 1])
        return blocks.decode(h, (f[3], f[2], f[1], f[0]), stats), stats

    @torch.inference_mode()
    def forward_3d(seq):
        stats: dict = {}
        feats = [dc3(seq.to(dtype), "inc", stats)]
        for block in _ENC[1:]:
            feats.append(dc3(spatial_pool(feats[-1]), block, stats))
        stats["enc.x5"] = _absmax(feats[4])
        k1, k2, k3, k4 = (v.amax(dim=1) for v in feats[:4])
        return blocks.decode(feats[4].mean(dim=1), (k4, k3, k2, k1),
                             stats), stats

    return forward_lstm if model == "unet_lstm" else forward_3d


def _fuse_q(aq: torch.Tensor, sk: float, sf: float) -> torch.Tensor:
    """The T-date fusion of int8 codes (N, T, ...) at scale sk, requantized
    to int8 at sf: the product over T in float32, max(., 0) * sk^T, round
    half to even, clip to [0, 127] (the division by sf a multiply by its
    float32 reciprocal, as ``conv_s8.quantize``)."""
    t = aq.shape[1]
    pf = torch.clamp(torch.prod(aq.float(), dim=1), min=0.0) * (sk ** t)
    inv = float(np.float32(1) / np.float32(sf))
    return torch.clamp(torch.round(pf * inv), 0, 127).to(torch.int8)


def make_int8_forward(folded, act_scales: dict, dtype=torch.bfloat16,
                      model: str = "unet_lstm", local_upsample: bool = False):
    """The int8 forward ``(seq) -> float32 logits`` of a multi-date
    ``model`` (``fabric_tpu``'s ``_make_forward_lstm`` /
    ``_make_forward_3d`` in int8 mode), on the int8 conv kernel, its
    decoder on the local upsample where ``local_upsample``."""
    s = dict(act_scales)
    enc = [s[k] for k in ("inc.conv1", "down1.conv1", "down2.conv1",
                          "down3.conv1", "down4.conv1", "enc.x5")]
    if model == "unet_lstm":
        skip = {f"up{k}": s[f"f{5 - k}"] for k in range(1, 5)}
    else:  # the collapsed skips keep their encoder level's scale
        skip = {f"up{k}": enc[5 - k] for k in range(1, 5)}
    blocks = Int8Blocks(folded, s, skip, dtype, local_upsample)

    def site3(xq, name, s_out):
        """A 3x3x3 site on int8 (N, T, H, W, C): one conv3x3_s8_q launch
        over the T-neighbour stack; int8 out at s_out."""
        n, t = xq.shape[:2]
        y = blocks.site(conv_s8.t_neighbours(xq), name, s_out)
        return y.reshape((n, t) + y.shape[1:])

    def encode(x, level_dc, pool):
        """x1..x5 int8 from the compute-dtype input."""
        feats = [level_dc(q(x, enc[0]), "inc", enc[1])]
        for k, block in enumerate(_ENC[1:], start=1):
            feats.append(level_dc(pool(feats[-1]), block, enc[k + 1]))
        return feats

    @torch.inference_mode()
    def forward_lstm(seq):
        n, t = seq.shape[:2]
        x = seq.reshape((n * t,) + seq.shape[2:]).to(dtype)
        feats = encode(x, blocks.enc_dc, max_pool2x2)
        s1, s2, s3, s4, bott = (v.reshape((n, t) + v.shape[1:])
                                for v in feats)
        wx = blocks.w["bottleneck_lstm.gates.x"]
        wh = blocks.w["bottleneck_lstm.gates.h"]
        bias = blocks.w["bottleneck_lstm.gates"]["bias"]
        sh = s["lstm.h"]
        h = torch.zeros(bott.shape[:1] + bott.shape[2:], dtype=dtype,
                        device=seq.device)
        c = torch.zeros_like(h)
        for step in range(t):
            za = blocks.raw(bott[:, step].contiguous(),
                            "bottleneck_lstm.gates.x").float()
            zb = blocks.raw(q(h, sh), "bottleneck_lstm.gates.h").float()
            z = (torch.addcmul(zb * wh["k"], za, wx["k"]) + bias).to(dtype)
            h, c = ConvLSTMCell.step(z, c)
        f = [_fuse_q(a, sk, s[f"f{k}"]) for k, (a, sk) in
             enumerate(zip((s1, s2, s3, s4), enc[1:5]), start=1)]
        return blocks.decode(h, (f[3], f[2], f[1], f[0]))

    def enc_dc3(xq, block, s_out):
        hq = site3(xq, f"{block}.conv1", s[f"{block}.conv2"])
        return site3(hq, f"{block}.conv2", s_out)

    @torch.inference_mode()
    def forward_3d(seq):
        t = seq.shape[1]
        feats = encode(seq.to(dtype), enc_dc3, spatial_pool)
        k1, k2, k3, k4 = (v.amax(dim=1) for v in feats[:4])
        bott = (feats[4].sum(dim=1, dtype=torch.int32).float()
                * (enc[5] / t)).to(dtype)
        return blocks.decode(bott, (k4, k3, k2, k1))

    return forward_lstm if model == "unet_lstm" else forward_3d
