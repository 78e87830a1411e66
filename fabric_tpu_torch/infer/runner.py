"""Whole-scene inference of a city: load, tile, forward, stitch
(counterpart of ``fabric_tpu/infer/runner.py``).

The scene goes through the port's device tiler (``infer/device_tiling.py``:
the reference grid and paste order, or overlap-averaged stitching; tiles
cut and stitched on the card); ``fabric_tpu``'s own tests pin that tiler's
masks as equal to its host runner's.  A multi-date model gets all of
``cfg.num_dates`` dates.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from fabric_tpu_torch.data.geotiff import band_dims
from fabric_tpu_torch.data.oscd import load_city
from fabric_tpu_torch.infer.device_tiling import (make_scene_infer,
                                                  make_scene_infer_multidate)
from fabric_tpu_torch.infer.service import resolve_device
from fabric_tpu_torch.models import MULTI_DATE


def predict_scene(model, *dates: np.ndarray, patch_size: int,
                  batch_size: int, device=None,
                  overlap: int = 0) -> np.ndarray:
    """(H, W) uint8 change mask of a scene, given as its (H, W, C) dates
    (two for the bi-date model, T for a multi-date one), through ``model``
    (on ``device``; None means the card): reference grid tiling with
    argmax per tile and paste-back, or with ``overlap`` > 0 the
    overlap-averaged probabilities thresholded at 0.5."""
    device = resolve_device(device)
    h, w = dates[0].shape[:2]
    if h < patch_size or w < patch_size:
        raise ValueError(f"scene {h}x{w} smaller than patch {patch_size}")
    arrays = [torch.from_numpy(np.ascontiguousarray(d)).to(device)
              for d in dates]
    if getattr(model, "multi_date", False):
        run = make_scene_infer_multidate(
            model, patch_size, (h, w), num_dates=len(dates),
            batch_size=batch_size, overlap=overlap, dtype=model.dtype)
        return run(torch.stack(arrays)).cpu().numpy()
    run = make_scene_infer(model, patch_size, (h, w), batch_size=batch_size,
                           overlap=overlap, dtype=model.dtype)
    return run(*arrays).cpu().numpy()


def scene_dims(data_dir: str, city: str) -> tuple[int, int]:
    """(H, W) template dims of a city scene: those of the third sorted band
    file of date 1, as the reference takes them."""
    d1_dir = os.path.join(data_dir, "images", city, "imgs_1")
    files = sorted(glob.glob(os.path.join(d1_dir, "*")))
    if len(files) < 3:
        raise FileNotFoundError(f"not enough band files in {d1_dir}")
    width, height = band_dims(files[2])
    return height, width


def load_scene(cfg, city: str) -> np.ndarray:
    """(T, H, W, C) float32: the dates of a dataset city
    (``cfg.dataset_dir``) that ``cfg.model`` takes (two, or
    ``cfg.num_dates`` for a multi-date model), at the city's template
    dims."""
    num_dates = cfg.num_dates if cfg.model in MULTI_DATE else 2
    return load_city(cfg.dataset_dir, city, cfg,
                     out_shape=scene_dims(cfg.dataset_dir, city),
                     num_dates=num_dates)


def infer_city(model, cfg, city: str, device=None) -> np.ndarray:
    """The (H, W) uint8 change mask of a dataset city (``cfg.dataset_dir``)
    at ``cfg.patch_size``, ``cfg.eval_batch_size`` and
    ``cfg.infer_overlap``."""
    return predict_scene(model, *load_scene(cfg, city),
                         patch_size=cfg.patch_size,
                         batch_size=cfg.eval_batch_size, device=device,
                         overlap=cfg.infer_overlap)
