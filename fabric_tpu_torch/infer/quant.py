"""Int8 post-training-quantized bi-date serving (counterpart of
``fabric_tpu/infer/quant.py``, bi-date model).

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
on the bf16 conv kernel (``ops/conv.py``), tapping the input's absmax first.
"""

from __future__ import annotations

import numpy as np
import torch

from fabric_tpu_torch.models.blocks import max_pool2x2
from fabric_tpu_torch.ops import conv as conv_ops
from fabric_tpu_torch.ops import conv_s8, fuse_s8
from fabric_tpu_torch.ops import fused as fused_ops
from fabric_tpu_torch.ops.conv_s8 import quantize as q
from fabric_tpu_torch.ops.resize import pad_to_match, upsample2x_align_corners

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


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to fabric_tpu_torch "
                               f"yet: ROADMAP.md queue 1 item {item}")


def _check_family(model: str, local_upsample: bool) -> None:
    if model in ("unet_lstm", "unet3d"):
        raise _not_ported(f"int8 serving of model {model!r}",
                          "8 (multi-date models)")
    if model != "bidate":
        raise ValueError(f"no int8 forward for model {model!r}")
    if local_upsample:
        raise _not_ported("int8 with local_upsample (fullconv)",
                          "9 (seamless fullconv)")


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def folded_params(model: torch.nn.Module) -> dict:
    """A folded BiDateNet's parameters as ``fabric_tpu``'s folded params
    tree (``inc/conv1/kernel``, ``down1/conv/conv1/bias``, ...), the tensors
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
    """[(name, path)] for every quantizable conv site of a BN-folded tree:
    every leaf dict holding a ``kernel``, ``conv`` wrapper levels elided
    from the dotted name; the 1x1 head ``outc`` stays unquantized."""
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
    """Symmetric per-output-channel int8 for a (kh, kw, cin, cout) kernel."""
    sw = np.max(np.abs(k), axis=tuple(range(k.ndim - 1))) / 127.0
    sw = np.maximum(sw, 1e-12)
    wq = np.clip(np.rint(k / sw), -127, 127).astype(np.int8)
    return {"wq": wq, "sw": sw}


def quantize_weights(folded) -> dict:
    """{site: {"wq": int8 kernel, "sw": float32 (Cout,), "bias": float32
    (Cout,)}} as numpy, bit-equal to ``fabric_tpu``'s; each ``upK.conv1``
    also gets ``.skip`` / ``.up`` entries, the kernel split at cin // 2 and
    each half quantized with its own per-channel scales."""
    out = {}
    for name, path in derive_conv_sites(folded):
        p = _get(folded, path)
        k = _np(p["kernel"]).astype(np.float32)
        out[name] = dict(_quantize_kernel(k),
                         bias=_np(p["bias"]).astype(np.float32))
        if name.startswith("up") and name.endswith("conv1"):
            cs = k.shape[-2] // 2
            out[name + ".skip"] = _quantize_kernel(k[..., :cs, :])
            out[name + ".up"] = _quantize_kernel(k[..., cs:, :])
    return out


def _absmax(x: torch.Tensor) -> torch.Tensor:
    return x.float().abs().amax()


def make_stats_forward(folded, dtype=torch.bfloat16, local_upsample=False,
                       model: str = "bidate"):
    """The exact folded forward ``(d1, d2) -> (logits, {site: absmax})``,
    the calibration taps: each conv site's input absmax, ``enc.x5`` and the
    fused skips ``f1..f4``.  The absmaxes are 0-dim tensors on the device
    (nothing waits for them here)."""
    _check_family(model, local_upsample)
    sites = dict(derive_conv_sites(folded))
    on_card = _device(folded).type == "cuda"
    packed = {name: (conv_ops.pack_weight(_get(folded, path)["kernel"])
                     if on_card else None) for name, path in sites.items()}

    def dc(x, block, stats):
        for conv in ("conv1", "conv2"):
            name = f"{block}.{conv}"
            stats[name] = _absmax(x)
            p = _get(folded, sites[name])
            x = conv_ops.conv3x3_bias_relu(x, p["kernel"], p["bias"],
                                           packed[name])
        return x

    @torch.inference_mode()
    def forward(x_d1, x_d2):
        stats: dict = {}
        n = x_d1.shape[0]
        x = torch.cat([x_d1, x_d2]).to(dtype)
        feats = [dc(x, "inc", stats)]
        for k in range(1, 5):
            feats.append(dc(max_pool2x2(feats[-1]), f"down{k}", stats))
        stats["enc.x5"] = _absmax(feats[4])
        f = [fused_ops.fused_mul_relu(a[n:], a[:n]) for a in feats]
        for k in range(1, 5):
            stats[f"f{k}"] = _absmax(f[k - 1])
        y = f[4]
        for k, skip in zip(range(1, 5), (f[3], f[2], f[1], f[0])):
            u = pad_to_match(upsample2x_align_corners(y), skip.shape[1],
                             skip.shape[2])
            y = dc(torch.cat([skip, u], dim=-1), f"up{k}", stats)
        return _outc(folded, y), stats

    return forward


def _outc(folded, y: torch.Tensor) -> torch.Tensor:
    """The 1x1 head in the compute dtype, float32 logits."""
    p = folded["outc"]["conv"]
    k = p["kernel"].reshape(p["kernel"].shape[2:])
    return (y @ k.to(y.dtype) + p["bias"].to(y.dtype)).float()


def stack_stats(stats: dict) -> tuple[list[str], torch.Tensor]:
    """A stats forward's taps as (names, one float32 vector on the
    device), so that the host reads them in one copy."""
    names = list(stats)
    return names, torch.stack([stats[k] for k in names])


def _absmaxes(fwd, batches, device) -> dict:
    maxes: dict = {}
    for d1, d2 in batches:
        _, stats = fwd(*(torch.as_tensor(np.asarray(d), device=device)
                         for d in (d1, d2)))
        names, vals = stack_stats(stats)
        for k, v in zip(names, vals.tolist()):
            maxes[k] = max(maxes.get(k, 0.0), v)
    return maxes


def _device(folded) -> torch.device:
    return folded["inc"]["conv1"]["kernel"].device


def calibrate(folded, batches, dtype=torch.bfloat16, headroom: float = 1.0,
              stats_forward=None, local_upsample: bool = False,
              model: str = "bidate") -> dict:
    """{site: scale}: absmax / 127 of each tap over the (d1, d2) NHWC
    ``batches``, times ``headroom`` (0.9 clips the top 10% of the observed
    range).  ``stats_forward``: a cached :func:`make_stats_forward`."""
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


def make_int8_apply(folded, act_scales: dict, dtype=torch.bfloat16,
                    local_upsample: bool = False, model: str = "bidate"):
    """The int8 forward ``(d1, d2) -> float32 logits`` of ``fabric_tpu``'s
    ``_make_forward`` in int8 mode, with the serving model's call signature
    (it drops into ``make_scene_infer`` unchanged).  The weights are
    quantized, moved to the device and packed for the kernel here, once,
    with each site's scale product ``sw * sx`` in float32."""
    _check_family(model, local_upsample)
    device = _device(folded)
    s = dict(act_scales)
    w = {}
    for name, p in quantize_weights(folded).items():
        # the input scale of each site; a decoder conv1's two halves take
        # the fused skip's and the concat range's
        block, _, half = name.partition(".conv1.")
        sx = (s[f"f{5 - int(block[2:])}"] if half == "skip"
              else s[f"{block}.conv1"] if half == "up" else s[name])
        wq = torch.from_numpy(p["wq"]).to(device)
        w[name] = {"wq": wq, "k": torch.from_numpy(p["sw"]).to(device) * sx,
                   "packed": (conv_s8.pack_weight(wq)
                              if device.type == "cuda" else None)}
        if "bias" in p:
            w[name]["bias"] = torch.from_numpy(p["bias"]).to(device)
    for block in ("up1", "up2", "up3", "up4"):
        w[f"{block}.conv1.skip"]["bias"] = w[f"{block}.conv1"]["bias"]

    def site(xq, name, s_out=None, up=None):
        """One conv site (conv3x3_s8_q): int8 in; int8 at s_out, else
        dtype out."""
        p = w[name]
        return conv_s8.conv3x3_s8_q(xq, p["wq"], p["k"], p["bias"], s_out,
                                    p["packed"], up, dtype)

    def enc_dc(xq, block, s_out):
        h = site(xq, f"{block}.conv1", s[f"{block}.conv2"])
        return site(h, f"{block}.conv2", s_out)

    def up_q(y, skip_q, block):
        u = pad_to_match(upsample2x_align_corners(y), skip_q.shape[1],
                         skip_q.shape[2])
        qu = w[f"{block}.conv1.up"]
        # conv(skip, K_skip) + conv(q(u), K_up), each at its own scale (the
        # concat range's for u), in one launch
        h = site(skip_q, f"{block}.conv1.skip", s[f"{block}.conv2"],
                 (q(u, s[f"{block}.conv1"]), qu["wq"], qu["k"],
                  qu["packed"]))
        return site(h, f"{block}.conv2")

    @torch.inference_mode()
    def forward(x_d1, x_d2):
        x = torch.cat([x_d1, x_d2]).to(dtype)
        enc = [s[k] for k in ("inc.conv1", "down1.conv1", "down2.conv1",
                              "down3.conv1", "down4.conv1", "enc.x5")]
        x = enc_dc(q(x, enc[0]), "inc", enc[1])
        # after each encoder level, one pass: the fusion relu(d2 * d1) of
        # its int8 codes, requantized straight to int8 at f_k's scale (the
        # decoder's skip), and the pooled input of the next level; f5
        # dequantizes to the compute dtype for the upsample
        f = []
        for k in range(1, 5):
            fk, x = fuse_s8.siamese_fuse_s8(x, enc[k] * enc[k] / s[f"f{k}"])
            f.append(fk)
            x = enc_dc(x, f"down{k}", enc[k + 1])
        y, _ = fuse_s8.siamese_fuse_s8(x, enc[5] * enc[5], dtype, pool=False)
        for k in range(1, 5):
            y = up_q(y, f[4 - k], f"up{k}")
        return _outc(folded, y)

    return forward
