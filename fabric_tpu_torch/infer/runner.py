"""Whole-scene inference of a city: load, tile, forward, stitch
(counterpart of ``fabric_tpu/infer/runner.py``, grid mode).

The scene goes through the port's device tiler (``infer/device_tiling.py``:
the reference grid and paste order, tiles cut and pasted on the card);
``fabric_tpu``'s own tests pin that tiler's masks as equal to its host
runner's.  Overlap-averaged stitching is not ported yet and raises.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from fabric_tpu_torch.data.geotiff import band_dims
from fabric_tpu_torch.data.oscd import load_city
from fabric_tpu_torch.infer.device_tiling import make_scene_infer
from fabric_tpu_torch.infer.service import resolve_device


def predict_scene(model, d1: np.ndarray, d2: np.ndarray, patch_size: int,
                  batch_size: int, device=None,
                  overlap: int = 0) -> np.ndarray:
    """(H, W) uint8 change mask of an (H, W, C) scene pair through
    ``model`` (on ``device``; None means the card): reference grid tiling,
    argmax per tile, paste-back."""
    device = resolve_device(device)
    h, w = d1.shape[:2]
    if h < patch_size or w < patch_size:
        raise ValueError(f"scene {h}x{w} smaller than patch {patch_size}")
    run = make_scene_infer(model, patch_size, (h, w), batch_size=batch_size,
                           overlap=overlap, dtype=model.dtype)
    a1, a2 = (torch.from_numpy(np.ascontiguousarray(d)).to(device)
              for d in (d1, d2))
    return run(a1, a2).cpu().numpy()


def scene_dims(data_dir: str, city: str) -> tuple[int, int]:
    """(H, W) template dims of a city scene: those of the third sorted band
    file of date 1, as the reference takes them."""
    d1_dir = os.path.join(data_dir, "images", city, "imgs_1")
    files = sorted(glob.glob(os.path.join(d1_dir, "*")))
    if len(files) < 3:
        raise FileNotFoundError(f"not enough band files in {d1_dir}")
    width, height = band_dims(files[2])
    return height, width


def infer_city(model, cfg, city: str, device=None) -> np.ndarray:
    """The (H, W) uint8 change mask of a dataset city (``cfg.dataset_dir``)
    at ``cfg.patch_size`` and ``cfg.eval_batch_size``."""
    dims = scene_dims(cfg.dataset_dir, city)
    d1, d2 = load_city(cfg.dataset_dir, city, cfg, out_shape=dims)
    return predict_scene(model, d1, d2, patch_size=cfg.patch_size,
                         batch_size=cfg.eval_batch_size, device=device,
                         overlap=cfg.infer_overlap)
