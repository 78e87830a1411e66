"""Import a checkpoint of the reference's PyTorch BiDateNet into a
checkpoint in ``fabric_tpu``'s format (counterpart of
``fabric_tpu/tools/import_torch.py``).

The reference trains with torch and saves whole pickled models
(``torch.save(model, ...)``) or ``state_dict``s.  A user moving to the
port should not have to retrain: this tool maps either into a checkpoint
directory that ``--resume``, ``cli.infer``, ``ScenePredictor`` and
``tools/export`` of either package accept.

The conversion is a layout mapping only: OIHW conv weights become HWIO
kernels, and each BatchNorm's affine and running tensors split into the
``params`` and ``batch_stats`` trees.  It follows the reference's module
tree (``double_conv`` = Sequential[Conv, BN, ReLU, Conv, BN, ReLU];
``down`` = Sequential[MaxPool, double_conv]; ``inc`` / ``up`` hold a
double_conv at ``.conv``; the levels are named inc, down1-4, up1-4 and
outc).  A ``state_dict`` converts without any of the reference's code; a
whole pickled model needs the reference's ``models`` package importable
(``--ref_path``).  The checkpoint is written through the port's
``train/state.create_state`` and ``checkpoint.save``, as the port's
training writes one, after the weights are loaded into a BiDateNet on
``device`` (the card unless the caller asks for the CPU), which checks
every name and shape.

    python -m fabric_tpu_torch.tools.import_torch --pt checkpoint_epoch_5.pt \
        --out ./imported_ckpt [--ref_path /path/to/reference] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

log = logging.getLogger("fabric_tpu_torch")


def _np(v) -> np.ndarray:
    if hasattr(v, "detach"):  # a torch tensor
        v = v.detach().cpu().numpy()
    return np.array(v, copy=True)


def load_state_dict(path: str, ref_path: str | None = None) -> dict:
    """Load ``path`` with torch and return a flat name -> tensor dict.

    Takes a bare ``state_dict`` or a whole pickled ``nn.Module`` (whose
    unpickling needs ``ref_path`` on ``sys.path`` so that the reference's
    ``models.bidate_model`` resolves).  ``nn.DataParallel``'s ``module.``
    prefix is stripped."""
    import torch

    inserted = False
    if ref_path:
        sys.path.insert(0, ref_path)
        inserted = True
    try:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    finally:
        if inserted:
            sys.path.pop(0)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if not isinstance(obj, dict):
        raise ValueError(f"{path!r} is neither a state_dict nor a module "
                         f"(got {type(obj).__name__})")
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in obj.items()}


def convert_state_dict(sd: dict) -> tuple[dict, dict, dict]:
    """The reference's BiDateNet state_dict -> (params, batch_stats, arch):
    numpy trees in ``fabric_tpu``'s layout, and the inferred
    ``n_channels`` / ``n_classes`` / ``base``."""

    def conv(prefix):
        w = _np(sd[f"{prefix}.weight"])
        return {"kernel": w.transpose(2, 3, 1, 0),  # OIHW -> HWIO
                "bias": _np(sd[f"{prefix}.bias"])}

    def bn(prefix):
        p = {"scale": _np(sd[f"{prefix}.weight"]),
             "bias": _np(sd[f"{prefix}.bias"])}
        s = {"mean": _np(sd[f"{prefix}.running_mean"]),
             "var": _np(sd[f"{prefix}.running_var"])}
        return p, s

    def double(prefix):
        # Sequential[Conv(0), BN(1), ReLU(2), Conv(3), BN(4), ReLU(5)]
        p, s = {}, {}
        p["conv1"] = conv(f"{prefix}.0")
        p["bn1"], s["bn1"] = bn(f"{prefix}.1")
        p["conv2"] = conv(f"{prefix}.3")
        p["bn2"], s["bn2"] = bn(f"{prefix}.4")
        return p, s

    params, stats = {}, {}
    params["inc"], stats["inc"] = double("inc.conv.conv")
    for name in ("down1", "down2", "down3", "down4"):
        p, s = double(f"{name}.mpconv.1.conv")
        params[name], stats[name] = {"conv": p}, {"conv": s}
    for name in ("up1", "up2", "up3", "up4"):
        p, s = double(f"{name}.conv.conv")
        params[name], stats[name] = {"conv": p}, {"conv": s}
    params["outc"] = {"conv": conv("outc.conv")}

    w0 = params["inc"]["conv1"]["kernel"]
    head = params["outc"]["conv"]["kernel"]
    arch = {"n_channels": int(w0.shape[2]), "base": int(w0.shape[3]),
            "n_classes": int(head.shape[3])}
    return params, stats, arch


def import_checkpoint(pt_path: str, out_dir: str,
                      ref_path: str | None = None, device=None) -> str:
    """Convert ``pt_path`` and write a checkpoint into ``out_dir`` (epoch
    0, with latest / best pointers); returns the checkpoint file's path."""
    from fabric_tpu_torch import checkpoint as ckpt
    from fabric_tpu_torch.config import Config
    from fabric_tpu_torch.infer.service import resolve_device
    from fabric_tpu_torch.models import build_model
    from fabric_tpu_torch.train.state import create_state

    device = resolve_device(device)
    params, stats, arch = convert_state_dict(load_state_dict(pt_path,
                                                             ref_path))
    log.info("converted torch checkpoint: n_channels=%d n_classes=%d "
             "base=%d", arch["n_channels"], arch["n_classes"], arch["base"])
    cfg = Config(model_base=arch["base"])
    if (arch["n_channels"], arch["n_classes"]) != (cfg.n_channels,
                                                  cfg.n_classes):
        raise ValueError(
            f"checkpoint is a BiDateNet({arch['n_channels']}, "
            f"{arch['n_classes']}); fabric-tpu's config derives "
            f"({cfg.n_channels}, {cfg.n_classes}) from band_ids — adjust "
            "band_ids in your config to serve a non-OSCD channel count")
    model = build_model(cfg, device, fold_bn=False,
                        variables=(params, stats), train=True)
    path = ckpt.save(create_state(cfg, model), out_dir, epoch=0,
                     metadata={"imported_from": pt_path,
                               "source_format": "torch", **arch})
    log.info("wrote %s", path)
    return path


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pt", required=True,
                    help="torch checkpoint: a state_dict .pt or the "
                         "reference's whole pickled model")
    ap.add_argument("--out", required=True,
                    help="output checkpoint directory (usable as --resume "
                         "/ ScenePredictor checkpoint=)")
    ap.add_argument("--ref_path", default=None,
                    help="path to the reference repo, only needed to "
                         "unpickle whole-model saves")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    import_checkpoint(args.pt, args.out, args.ref_path, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
