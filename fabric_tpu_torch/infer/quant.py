"""Int8 post-training-quantized serving (counterpart of
``fabric_tpu/infer/quant.py``): the scheme, the building blocks every
model family shares (:class:`StatsBlocks`, :class:`Int8Blocks`) and the
bi-date forward; the UNetLSTM and UNet3D forwards are in
``infer/quant_multidate.py``, and ``model=`` sends each family to its own.

The quantization scheme is ``fabric_tpu``'s, step for step:

- **Weights**: symmetric per-output-channel int8 (scale = absmax / 127
  over the fan-in) of the BatchNorm-folded kernels, computed once
  (:func:`quantize_weights`, a numpy copy bit-equal to ``fabric_tpu``'s);
  each decoder ``upK.conv1`` also splits at the concat boundary into a
  ``.skip`` and an ``.up`` half, each with its own scales.
- **Activations**: symmetric per-tensor int8 with static scales
  (:func:`calibrate`: absmax / 127 of each conv input over calibration
  batches, from the exact forward of :func:`make_stats_forward`).
- **Int8-resident encoder**: every encoder tensor stays int8 (max-pool
  commutes with symmetric quantization; each conv's epilogue requantizes),
  the Siamese fusion runs on the int8 values in int32 and requantizes the
  skip operands f1..f4 to int8 (:func:`fabric_tpu_torch.ops.fuse_s8.
  siamese_fuse_s8`, one pass per level that also pools the next level's
  input: 5 launches per forward, no int32 tensor in device memory on the
  card), and the decoder runs the split conv
  ``conv(skip, K_skip) + conv(up, K_up)`` without materialising the concat.

Every conv site is one :func:`fabric_tpu_torch.ops.conv_s8.conv3x3_s8_q`:
int8 x int8 with exact int32 sums and the dequantize / bias / ReLU /
requantize epilogue fused (the hand-written Hopper kernel on the card, no
int32 tensor in device memory), 18 launches per forward: the decoder's
split conv1 is one launch of two K segments.  The epilogue has
``fabric_tpu``'s rounding: round half to even, clip to +-127, the input
cast to the compute dtype first, scale products in float32.  Where
``fabric_tpu``'s XLA (on the CPU) contracts ``acc * scale + bias`` into a
fused multiply-add, so does the port (``torch.addcmul``; on the card the
kernel's ``fmaf``).
The calibration forward applies ReLU after each conv, so it runs each site
on the conv kernel of the compute dtype (``ops/conv.py``, bf16 or float32),
tapping the input's absmax first.  In float32 (``dtype=torch.float32``, as
``fabric_tpu``'s ``dtype="float32"``) every float step of the int8 forward
stays float32: the conv sites' epilogues are ``conv3x3_s8_q``'s float32
forms, the calibration forward runs the fp32 conv kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from fabric_tpu_torch.models import MULTI_DATE
from fabric_tpu_torch.models.blocks import max_pool2x2
from fabric_tpu_torch.ops import conv as conv_ops
from fabric_tpu_torch.ops import conv_s8, fp32_matmul, fuse_s8
from fabric_tpu_torch.ops import fused as fused_ops
from fabric_tpu_torch.ops.conv_s8 import quantize as q
from fabric_tpu_torch.ops.resize import (pad_to_match,
                                         upsample2x_align_corners,
                                         upsample2x_local)

# bi-date conv sites in forward order (fabric_tpu's table): each entry is
# the params-tree path of the conv whose input gets an activation scale
_SITES = (
    ("inc.conv1", ("inc", "conv1")),
    ("inc.conv2", ("inc", "conv2")),
    ("down1.conv1", ("down1", "conv", "conv1")),
    ("down1.conv2", ("down1", "conv", "conv2")),
    ("down2.conv1", ("down2", "conv", "conv1")),
    ("down2.conv2", ("down2", "conv", "conv2")),
    ("down3.conv1", ("down3", "conv", "conv1")),
    ("down3.conv2", ("down3", "conv", "conv2")),
    ("down4.conv1", ("down4", "conv", "conv1")),
    ("down4.conv2", ("down4", "conv", "conv2")),
    ("up1.conv1", ("up1", "conv", "conv1")),
    ("up1.conv2", ("up1", "conv", "conv2")),
    ("up2.conv1", ("up2", "conv", "conv1")),
    ("up2.conv2", ("up2", "conv", "conv2")),
    ("up3.conv1", ("up3", "conv", "conv1")),
    ("up3.conv2", ("up3", "conv", "conv2")),
    ("up4.conv1", ("up4", "conv", "conv1")),
    ("up4.conv2", ("up4", "conv", "conv2")),
)


def _check_family(model: str) -> None:
    if model not in ("bidate",) + MULTI_DATE:
        raise ValueError(f"no int8 forward for model {model!r}")


def _upsample(local_upsample: bool):
    """The decoder's 2x upsample: the shift-invariant local one (fullconv
    serving) or the align-corners one."""
    return upsample2x_local if local_upsample else upsample2x_align_corners


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def folded_params(model: torch.nn.Module) -> dict:
    """A folded model's parameters as ``fabric_tpu``'s folded params tree
    (``inc/conv1/kernel``, ``down1/conv/conv1/bias``, ...), the tensors
    themselves (no copies)."""
    if not getattr(model, "fold_bn", False):
        raise ValueError("the int8 forward runs on BatchNorm-folded weights")
    tree: dict = {}
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = p.detach()
    return tree


def derive_conv_sites(folded) -> list[tuple[str, tuple]]:
    """[(name, path)] for every quantizable conv site of a BN-folded tree
    of any family: every leaf dict holding a ``kernel``, ``conv`` wrapper
    levels elided from the dotted name (so UNet3D's ``down1/conv1`` and
    BiDateNet's ``down1/conv/conv1`` are both ``down1.conv1``); the 1x1
    head ``outc`` stays unquantized."""
    sites: list[tuple[str, tuple]] = []

    def walk(tree, path: tuple):
        if isinstance(tree, dict) and "kernel" in tree:
            if path[0] != "outc":
                sites.append((".".join(n for n in path if n != "conv"),
                              path))
            return
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))

    walk(folded, ())
    return sites


def _quantize_kernel(k: np.ndarray) -> dict:
    """Symmetric per-output-channel int8 for a conv kernel of any spatial
    rank ((kh, kw, cin, cout) or (kd, kh, kw, cin, cout))."""
    sw = np.max(np.abs(k), axis=tuple(range(k.ndim - 1))) / 127.0
    sw = np.maximum(sw, 1e-12)
    wq = np.clip(np.rint(k / sw), -127, 127).astype(np.int8)
    return {"wq": wq, "sw": sw}


def quantize_weights(folded) -> dict:
    """{site: {"wq": int8 kernel, "sw": float32 (Cout,), "bias": float32
    (Cout,)}} as numpy, bit-equal to ``fabric_tpu``'s; each ``upK.conv1``
    also gets ``.skip`` / ``.up`` entries, the kernel split at cin // 2 and
    each half quantized with its own per-channel scales, and the UNetLSTM
    gate conv ``.x`` / ``.h`` entries, split the same way at its [x | h]
    concat boundary."""
    out = {}
    for name, path in derive_conv_sites(folded):
        p = _get(folded, path)
        k = _np(p["kernel"]).astype(np.float32)
        out[name] = dict(_quantize_kernel(k),
                         bias=_np(p["bias"]).astype(np.float32))
        if ((name.startswith("up") and name.endswith("conv1"))
                or name == "bottleneck_lstm.gates"):
            cs = k.shape[-2] // 2  # equal halves in every family
            a, b = (".skip", ".up") if name.startswith("up") else (".x", ".h")
            out[name + a] = _quantize_kernel(k[..., :cs, :])
            out[name + b] = _quantize_kernel(k[..., cs:, :])
    return out


def _absmax(x: torch.Tensor) -> torch.Tensor:
    return x.float().abs().amax()


class StatsBlocks:
    """The exact folded forward's 2-D blocks with their calibration taps,
    shared by every family: :meth:`dc` runs a folded DoubleConv as two
    conv3x3_bias_relu launches (the site's input absmax tapped first, on
    weights packed once for the compute ``dtype``), :meth:`decode` the Up
    stack and the head, its upsample the local one with
    ``local_upsample``."""

    def __init__(self, folded, local_upsample: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        self.folded = folded
        self.upsample = _upsample(local_upsample)
        self.sites = dict(derive_conv_sites(folded))
        on_card = _device(folded).type == "cuda"
        self.packed = {}
        for name, path in self.sites.items():
            k = _get(folded, path)["kernel"]
            if k.dim() == 4 and name != "bottleneck_lstm.gates":
                self.packed[name] = conv_ops.pack_weight(k, dtype) \
                    if on_card else None

    def dc(self, x: torch.Tensor, block: str, stats: dict) -> torch.Tensor:
        for conv in ("conv1", "conv2"):
            name = f"{block}.{conv}"
            stats[name] = _absmax(x)
            p = _get(self.folded, self.sites[name])
            x = conv_ops.conv3x3_bias_relu(x, p["kernel"], p["bias"],
                                           self.packed[name])
        return x

    def decode(self, y: torch.Tensor, skips, stats: dict) -> torch.Tensor:
        """The decoder from the bottleneck ``y`` over the fused skips
        (f4, f3, f2, f1), then the head: float32 logits."""
        for k, skip in zip(range(1, 5), skips):
            u = pad_to_match(self.upsample(y), skip.shape[1],
                             skip.shape[2])
            y = self.dc(torch.cat([skip, u], dim=-1), f"up{k}", stats)
        return _outc(self.folded, y)


def make_stats_forward(folded, dtype=torch.bfloat16, local_upsample=False,
                       model: str = "bidate"):
    """The exact folded forward ``(*inputs) -> (logits, {site: absmax})``,
    the calibration taps: each conv site's input absmax, ``enc.x5`` and
    the fused skips ``f1..f4`` (UNetLSTM: ``lstm.h`` too).  The inputs are
    (d1, d2) for the bi-date model, one (N, T, H, W, C) stack for a
    multi-date one.  The absmaxes are 0-dim tensors on the device (nothing
    waits for them here).  ``local_upsample``: the decoder upsamples with
    the shift-invariant local op (the fullconv model's forward)."""
    _check_family(model)
    if model in MULTI_DATE:
        from fabric_tpu_torch.infer import quant_multidate
        return quant_multidate.make_stats_forward(folded, dtype, model,
                                                  local_upsample)
    blocks = StatsBlocks(folded, local_upsample, dtype)

    @torch.inference_mode()
    def forward(x_d1, x_d2):
        stats: dict = {}
        n = x_d1.shape[0]
        x = torch.cat([x_d1, x_d2]).to(dtype)
        feats = [blocks.dc(x, "inc", stats)]
        for k in range(1, 5):
            feats.append(blocks.dc(max_pool2x2(feats[-1]), f"down{k}", stats))
        stats["enc.x5"] = _absmax(feats[4])
        f = [fused_ops.fused_mul_relu(a[n:], a[:n]) for a in feats]
        for k in range(1, 5):
            stats[f"f{k}"] = _absmax(f[k - 1])
        return blocks.decode(f[4], (f[3], f[2], f[1], f[0]), stats), stats

    return forward


def _outc(folded, y: torch.Tensor) -> torch.Tensor:
    """The 1x1 head in the compute dtype, float32 logits."""
    p = folded["outc"]["conv"]
    k = p["kernel"].reshape(p["kernel"].shape[2:])
    return (fp32_matmul.matmul(y, k.to(y.dtype))
            + p["bias"].to(y.dtype)).float()


def stack_stats(stats: dict) -> tuple[list[str], torch.Tensor]:
    """A stats forward's taps as (names, one float32 vector on the
    device), so that the host reads them in one copy."""
    names = list(stats)
    return names, torch.stack([stats[k] for k in names])


def as_args(item, device) -> tuple:
    """A calibration batch item as the forward's inputs on ``device``: a
    (d1, d2) pair for the bi-date model, one (N, T, H, W, C) stack for a
    multi-date one."""
    items = item if isinstance(item, (tuple, list)) else (item,)
    return tuple(torch.as_tensor(np.asarray(a), device=device)
                 for a in items)


def _absmaxes(fwd, batches, device) -> dict:
    maxes: dict = {}
    for item in batches:
        _, stats = fwd(*as_args(item, device))
        names, vals = stack_stats(stats)
        for k, v in zip(names, vals.tolist()):
            maxes[k] = max(maxes.get(k, 0.0), v)
    return maxes


def _device(folded) -> torch.device:
    return folded["inc"]["conv1"]["kernel"].device


def calibrate(folded, batches, dtype=torch.bfloat16, headroom: float = 1.0,
              stats_forward=None, local_upsample: bool = False,
              model: str = "bidate") -> dict:
    """{site: scale}: absmax / 127 of each tap over ``batches`` ((d1, d2)
    NHWC pairs, or (N, T, H, W, C) stacks for a multi-date ``model``),
    times ``headroom`` (0.9 clips the top 10% of the observed range).
    ``stats_forward``: a cached :func:`make_stats_forward`."""
    fwd = stats_forward or make_stats_forward(folded, dtype, local_upsample,
                                              model)
    maxes = _absmaxes(fwd, batches, _device(folded))
    return {k: max(v * headroom, 1e-12) / 127.0 for k, v in maxes.items()}


def clip_report(folded, act_scales: dict, batches, dtype=torch.bfloat16,
                stats_forward=None, local_upsample: bool = False,
                model: str = "bidate") -> dict:
    """{site: observed absmax / (127 * scale)} over ``batches``: a ratio
    above 1 means the int8 forward clips there."""
    fwd = stats_forward or make_stats_forward(folded, dtype, local_upsample,
                                              model)
    maxes = _absmaxes(fwd, batches, _device(folded))
    return {k: maxes[k] / (127.0 * act_scales[k])
            for k in maxes if k in act_scales}


class Int8Blocks:
    """The int8 forward's conv sites and decoder, shared by every family.

    The weights are quantized, moved to the device and packed for the
    kernel once (on every device, so that an exported forward holds them
    as constants), each with its scale product ``sw * sx`` in float32, sx
    the input's activation scale: a decoder conv1's two halves take the
    skip's (``skip_scales[block]``) and the concat range's, the UNetLSTM
    gate conv's halves ``enc.x5`` and ``lstm.h``; a conv that runs as its
    two halves keeps only its bias.  UNet3D's DHWIO kernels are folded to
    (3, 3, 3 * Cin, Cout) (:func:`conv_s8.fold_depth`), the kernel of the
    conv over T-neighbour stacks.  The decoder upsamples with the local op
    where ``local_upsample``."""

    def __init__(self, folded, act_scales: dict, skip_scales: dict,
                 dtype=torch.bfloat16, local_upsample: bool = False):
        self.folded = folded
        self.upsample = _upsample(local_upsample)
        self.s = s = dict(act_scales)
        self.dtype = dtype
        device = _device(folded)
        self.w = w = {}
        for name, p in quantize_weights(folded).items():
            block, _, half = name.partition(".conv1.")
            if half:
                sx = skip_scales[block] if half == "skip" \
                    else s[f"{block}.conv1"]
            elif name.startswith("bottleneck_lstm.gates."):
                sx = s["enc.x5"] if name.endswith(".x") else s["lstm.h"]
            elif name == "bottleneck_lstm.gates" or (
                    name.startswith("up") and name.endswith(".conv1")):
                w[name] = {"bias": torch.from_numpy(p["bias"]).to(device)}
                continue
            else:
                sx = s[name]
            wq = torch.from_numpy(p["wq"])
            if wq.dim() == 5:
                wq = conv_s8.fold_depth(wq)
            wq = wq.to(device)
            w[name] = {"wq": wq,
                       "k": torch.from_numpy(p["sw"]).to(device) * sx,
                       "packed": conv_s8.pack_weight(wq)}
            if "bias" in p:
                w[name]["bias"] = torch.from_numpy(p["bias"]).to(device)
        for block in ("up1", "up2", "up3", "up4"):
            w[f"{block}.conv1.skip"]["bias"] = w[f"{block}.conv1"]["bias"]

    def site(self, xq, name, s_out=None, up=None):
        """One conv site (conv3x3_s8_q): int8 in; int8 at s_out, else the
        compute dtype out."""
        p = self.w[name]
        return conv_s8.conv3x3_s8_q(xq, p["wq"], p["k"], p["bias"], s_out,
                                    p["packed"], up, self.dtype)

    def raw(self, xq, name) -> torch.Tensor:
        """The exact int32 conv of a site (conv3x3_s8, raw mode)."""
        p = self.w[name]
        return conv_s8.conv3x3_s8(xq, p["wq"], p["packed"])

    def enc_dc(self, xq, block: str, s_out: float):
        """A 2-D encoder DoubleConv, int8 in and int8 out at s_out."""
        h = self.site(xq, f"{block}.conv1", self.s[f"{block}.conv2"])
        return self.site(h, f"{block}.conv2", s_out)

    def up_q(self, y, skip_q, block: str):
        """The decoder's Up: conv(skip, K_skip) + conv(q(u), K_up), each at
        its own scale (the concat range's for u), in one launch, then
        conv2 to the compute dtype."""
        s, w = self.s, self.w
        u = pad_to_match(self.upsample(y), skip_q.shape[1],
                         skip_q.shape[2])
        qu = w[f"{block}.conv1.up"]
        h = self.site(skip_q, f"{block}.conv1.skip", s[f"{block}.conv2"],
                      (q(u, s[f"{block}.conv1"]), qu["wq"], qu["k"],
                       qu["packed"]))
        return self.site(h, f"{block}.conv2")

    def decode(self, y, skips_q) -> torch.Tensor:
        """The decoder over the int8 skips (f4, f3, f2, f1) and the head:
        float32 logits."""
        for k, skip in zip(range(1, 5), skips_q):
            y = self.up_q(y, skip, f"up{k}")
        return _outc(self.folded, y)


def make_int8_apply(folded, act_scales: dict, dtype=torch.bfloat16,
                    local_upsample: bool = False, model: str = "bidate"):
    """The int8 forward of ``fabric_tpu``'s ``_make_forward`` (or, for a
    multi-date ``model``, of ``quant_multidate``'s) in int8 mode, with the
    serving model's call signature: ``(d1, d2)`` or ``(stack)`` -> float32
    logits (it drops into the scene runners unchanged).  With
    ``local_upsample`` the decoder upsamples with the local op and the
    forward composes with fullconv banding (its ``local_upsample``
    attribute says which, for the fullconv runners' check).  Its
    ``device`` is the weights', and ``replicate(device)`` builds the same
    forward on another device (the sharded runners' replicas)."""
    _check_family(model)
    if model in MULTI_DATE:
        from fabric_tpu_torch.infer import quant_multidate
        forward = quant_multidate.make_int8_forward(folded, act_scales,
                                                    dtype, model,
                                                    local_upsample)
        return _tag(forward, folded, act_scales, dtype, local_upsample,
                    model)
    s = dict(act_scales)
    blocks = Int8Blocks(folded, s, {f"up{k}": s[f"f{5 - k}"]
                                    for k in range(1, 5)}, dtype,
                        local_upsample)

    @torch.inference_mode()
    def forward(x_d1, x_d2):
        x = torch.cat([x_d1, x_d2]).to(dtype)
        enc = [s[k] for k in ("inc.conv1", "down1.conv1", "down2.conv1",
                              "down3.conv1", "down4.conv1", "enc.x5")]
        x = blocks.enc_dc(q(x, enc[0]), "inc", enc[1])
        # after each encoder level, one pass: the fusion relu(d2 * d1) of
        # its int8 codes, requantized straight to int8 at f_k's scale (the
        # decoder's skip), and the pooled input of the next level; f5
        # dequantizes to the compute dtype for the upsample
        f = []
        for k in range(1, 5):
            fk, x = fuse_s8.siamese_fuse_s8(x, enc[k] * enc[k] / s[f"f{k}"])
            f.append(fk)
            x = blocks.enc_dc(x, f"down{k}", enc[k + 1])
        y, _ = fuse_s8.siamese_fuse_s8(x, enc[5] * enc[5], dtype, pool=False)
        return blocks.decode(y, (f[3], f[2], f[1], f[0]))

    return _tag(forward, folded, act_scales, dtype, local_upsample, model)


def _tag(forward, folded, act_scales, dtype, local_upsample, model):
    """An int8 forward with its ``local_upsample``, ``device`` and
    ``replicate``."""
    forward.local_upsample = local_upsample
    forward.device = _device(folded)

    def replicate(device):
        def to(tree):
            return {k: to(v) if isinstance(v, dict) else v.to(device)
                    for k, v in tree.items()}
        return make_int8_apply(to(folded), act_scales, dtype,
                               local_upsample, model)

    forward.replicate = replicate
    return forward
