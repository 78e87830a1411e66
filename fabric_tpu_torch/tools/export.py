"""Export a trained checkpoint as a self-contained serving bundle
(counterpart of ``fabric_tpu/tools/export.py``, in its format byte for
byte).

Loads a checkpoint once, folds BatchNorm into the conv weights on the host
(``ops/fold_bn.py``, float64 intermediates), optionally calibrates the
int8 activation scales (``infer/quant.py``, on the synthetic
``RandomState(0)`` batches ``fabric_tpu`` uses), and writes ONE ``.npz``:
``params//<path>`` keys holding the folded tree in ``fabric_tpu``'s layout
and dtype, ``scales//<site>`` keys for int8, and a ``__meta__`` JSON
(``format_version`` 1).  ``ScenePredictor(..., bundle=...)`` of either
package serves it: no optimizer state, no BatchNorm statistics, no
calibration at serving time.  With ``--aot_dir`` it also freezes, for
each scene bucket, the forward the bucket's runner calls (``infer/aot.py``);
with ``--output_store`` it mirrors the bundle (and the artifact) to the
store.

    python -m fabric_tpu_torch.tools.export --config cfg.json \
        --resume ./outputs --out model_bundle.npz [--quant int8] \
        [--headroom 1.0] [--aot_dir DIR --aot_scene HxW [--aot_pack N] \
        [--aot_fullconv ROWS] [--aot_bucket 512]] [--device cpu]
"""

from __future__ import annotations

import json
import os

import numpy as np

_SEP = "//"
_META_KEY = "__meta__"
FAMILIES = ("bidate", "unet_lstm", "unet3d")


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{_SEP}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _calibration_batches(cfg) -> list:
    """``fabric_tpu``'s default int8 calibration input: one synthetic
    N(0, 1) batch from ``RandomState(0)`` (the normalised inputs' law), a
    (d1, d2) pair of 8 patches, or for a multi-date model a stack of 4."""
    rng = np.random.RandomState(0)
    p = cfg.patch_size
    if cfg.model in FAMILIES[1:]:
        return [rng.randn(4, cfg.num_dates, p, p, cfg.n_channels)
                .astype(np.float32)]
    return [(rng.randn(8, p, p, cfg.n_channels).astype(np.float32),
             rng.randn(8, p, p, cfg.n_channels).astype(np.float32))]


def export_bundle(cfg, checkpoint: str, out_path: str, quant: str = "none",
                  calib_batches=None, headroom: float = 1.0,
                  device=None) -> dict:
    """Fold, optionally calibrate (on ``device``: the card unless "cpu"
    is asked for), write the bundle; returns its meta.  Every model family
    exports.  ``calib_batches``: int8 calibration inputs, (d1, d2) NHWC
    pairs or (N, T, patch, patch, C) stacks; default
    :func:`_calibration_batches`."""
    from fabric_tpu_torch import checkpoint as ckpt
    from fabric_tpu_torch.ops.fold_bn import fold_tree

    if cfg.model not in FAMILIES:
        raise ValueError(f"unknown model for a serving bundle: "
                         f"{cfg.model!r}")
    path = ckpt.resolve(checkpoint)
    folded = fold_tree(*ckpt.load_variables(path))
    meta = {"format_version": 1,
            "model": cfg.model, "model_base": cfg.model_base,
            "n_channels": cfg.n_channels, "n_classes": cfg.n_classes,
            "patch_size": cfg.patch_size, "dtype": cfg.dtype,
            "quant": quant, "source_checkpoint": os.path.abspath(path),
            "fold_bn": True}
    if cfg.model in FAMILIES[1:]:
        meta["num_dates"] = cfg.num_dates
    arrays = {f"params{_SEP}{k}": v for k, v in _flatten(folded).items()}
    if quant == "int8":
        import torch

        from fabric_tpu_torch.infer import quant as q
        from fabric_tpu_torch.infer.service import resolve_device
        from fabric_tpu_torch.models import compute_dtype
        dev = resolve_device(device)

        def to_device(tree):
            return {k: to_device(v) if isinstance(v, dict)
                    else torch.from_numpy(np.asarray(v)).to(dev)
                    for k, v in tree.items()}
        scales = q.calibrate(to_device(folded),
                             calib_batches or _calibration_batches(cfg),
                             compute_dtype(cfg), headroom=headroom,
                             model=cfg.model)
        for k, v in scales.items():
            arrays[f"scales{_SEP}{k}"] = np.float32(v)
    arrays[_META_KEY] = np.frombuffer(json.dumps(meta).encode(),
                                      dtype=np.uint8)
    tmp = out_path + ".tmp.npz"
    np.savez_compressed(tmp.removesuffix(".npz"), **arrays)
    os.replace(tmp, out_path)
    return meta


def load_bundle(path: str) -> tuple[dict, dict | None, dict]:
    """-> (folded params tree of numpy arrays, int8 scales or None,
    meta)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z[_META_KEY]).decode())
        if meta.get("format_version", 1) > 1:
            raise ValueError(
                f"bundle {path!r} has format_version "
                f"{meta['format_version']}; this build reads <= 1")
        params_flat, scales = {}, {}
        for key in z.files:
            if key == _META_KEY:
                continue
            head, rest = key.split(_SEP, 1)
            if head == "params":
                params_flat[rest] = z[key]
            elif head == "scales":
                scales[rest] = float(z[key])
    return _unflatten(params_flat), (scales or None), meta


def main(argv=None) -> int:
    import argparse
    import sys

    from fabric_tpu_torch.config import load_config

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                 add_help=False)
    ap.add_argument("--out", required=True, help="output .npz bundle path")
    ap.add_argument("--quant", choices=["none", "int8"], default="none")
    ap.add_argument("--headroom", type=float, default=1.0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--aot_dir", default=None,
                    help="also freeze each scene bucket's forward "
                         "(infer/aot.py) into this directory, served by "
                         "ScenePredictor(bundle=..., aot_dir=...)")
    ap.add_argument("--aot_scene", action="append", default=None,
                    metavar="HxW",
                    help="scene shape(s) whose buckets to freeze "
                         "(repeatable); required with --aot_dir")
    ap.add_argument("--aot_platform", action="append", default=None,
                    help="the platform the artifact serves on: cuda "
                         "(default) or cpu")
    ap.add_argument("--aot_bucket", type=int, default=512,
                    help="the bucket the artifact is keyed by (the serving "
                         "ScenePredictor's bucket=)")
    ap.add_argument("--aot_pack", action="append", type=int, default=None,
                    metavar="N",
                    help="also freeze the fleet-packed buckets of N scenes "
                         "(repeatable; grid mode only), served by "
                         "predict_many(pack=N)")
    ap.add_argument("--aot_fullconv", type=int, default=0, metavar="ROWS",
                    help="freeze the seamless fullconv forward of this many "
                         "band rows instead of the grid one (the serving "
                         "ScenePredictor's fullconv_band_rows=)")
    args, rest = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    cfg = load_config(argv=rest)
    if not cfg.resume:
        ap.error("--resume <checkpoint or run dir> is required")
    if args.aot_dir and not args.aot_scene:
        ap.error("--aot_dir needs at least one --aot_scene HxW")
    meta = export_bundle(cfg, cfg.resume, args.out, quant=args.quant,
                         headroom=args.headroom, device=args.device)
    if args.aot_dir:
        from fabric_tpu_torch.infer.aot import export_aot
        from fabric_tpu_torch.infer.service import ScenePredictor
        shapes = []
        for s in args.aot_scene:
            h, w = s.lower().split("x")
            shapes.append((int(h), int(w)))
        pred = ScenePredictor(cfg, bundle=args.out, bucket=args.aot_bucket,
                              fullconv_band_rows=args.aot_fullconv,
                              device=args.device)
        aot_meta = export_aot(pred, args.aot_dir, shapes,
                              platforms=tuple(args.aot_platform or ["cuda"]),
                              packs=tuple(args.aot_pack or ()))
        meta = dict(meta, aot=aot_meta)
    if cfg.output_store:
        # mirror the serving artifacts to the store, synchronously, so the
        # command exits with them uploaded
        from fabric_tpu_torch.store import ArtifactStore
        store = ArtifactStore(cfg.output_store, blocking=True)
        store.upload(args.out, os.path.join("bundles",
                                            os.path.basename(args.out)))
        if args.aot_dir:
            store.upload_dir(args.aot_dir, rel=os.path.join(
                "bundles", os.path.basename(os.path.normpath(
                    args.aot_dir))))
        meta = dict(meta, output_store=cfg.output_store)
    print(json.dumps(meta))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
