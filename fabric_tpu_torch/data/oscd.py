"""OSCD/Onera dataset: city listing, patch grids, city loading
(counterpart of ``fabric_tpu/data/oscd.py``).

On-disk layout: ``images/<city>/imgs_{1,2}/<prefix><BAND>.{tif,npy}`` and
``labels/<city>/cm/cm.png``.  ``load_city`` reads each band, normalises it
as ``(x - mean) * (1 / std)`` in float32 (the formula of ``fabric_tpu``'s
native host library, which its loader uses where built), resizes it to the
label's dims and stacks the bands last: (T, H, W, 13).
"""

from __future__ import annotations

import glob
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from fabric_tpu_torch.data.geotiff import read_band
from fabric_tpu_torch.data.image import read_png_gray, resize_bilinear


def list_cities(data_dir: str) -> list[str]:
    """Sorted city names under labels/."""
    root = os.path.join(data_dir, "labels")
    return sorted(c for c in os.listdir(root) if not c.startswith(".")
                  and os.path.isdir(os.path.join(root, c)))


def patch_grid(label_shape: tuple[int, int], patch_size: int,
               stride: int) -> list[tuple[int, int]]:
    """Stride-grid patch corners whose patch fits inside the raster."""
    h, w = label_shape
    return [(i, j) for i in range(0, h, stride) for j in range(0, w, stride)
            if i + patch_size <= h and j + patch_size <= w]


def _metadata(shapes: dict, val_cities: list[str], patch_size: int,
              stride: int):
    train_cities = sorted(set(shapes) - set(val_cities))

    def enumerate_for(cities):
        return [(city, i, j) for city in cities
                for i, j in patch_grid(shapes[city], patch_size, stride)]
    return enumerate_for(train_cities), enumerate_for(val_cities)


def get_train_val_metadata(data_dir: str, val_cities: list[str],
                           patch_size: int, stride: int):
    """([(city, i, j)], [(city, i, j)]) for train and validation: per
    sorted city, row-major grid."""
    shapes = {c: load_label(data_dir, c).shape for c in list_cities(data_dir)}
    for c in val_cities:
        shapes.setdefault(c, load_label(data_dir, c).shape)
    return _metadata(shapes, val_cities, patch_size, stride)


def metadata_from_dataset(dataset: dict, val_cities: list[str],
                          patch_size: int, stride: int):
    """:func:`get_train_val_metadata` over an in-memory dataset dict."""
    return _metadata({c: d["labels"].shape for c, d in dataset.items()},
                     val_cities, patch_size, stride)


def load_label(data_dir: str, city: str) -> np.ndarray:
    """(H, W) uint8 change mask in {0, 1}."""
    path = os.path.join(data_dir, "labels", city, "cm", "cm.png")
    return (read_png_gray(path).astype(np.float64) / 255).astype(np.uint8)


def band_files(image_dir: str, band_ids: list[str]) -> list[str]:
    """The per-band files of one date directory, in band_ids order."""
    files = sorted(glob.glob(os.path.join(image_dir, "*")))
    out = []
    for band in band_ids:
        hits = [f for f in files
                if os.path.splitext(os.path.basename(f))[0].endswith(band)]
        if not hits:
            raise FileNotFoundError(f"band {band} not found in {image_dir}")
        out.append(hits[0])
    return out


def num_dates_on_disk(data_dir: str, city: str) -> int:
    """The count of a city's ``imgs_1`` .. ``imgs_T`` date directories."""
    root = os.path.join(data_dir, "images", city)
    t = 0
    while os.path.isdir(os.path.join(root, f"imgs_{t + 1}")):
        t += 1
    return t


def load_city(data_dir: str, city: str, cfg,
              out_shape: tuple[int, int] | None = None,
              num_dates: int | None = None) -> np.ndarray:
    """(T, H, W, 13) float32: the first ``num_dates`` dates (None: every
    date on disk, or 2 where none is found), normalised, resized to the
    label dims (or ``out_shape``)."""
    out_h, out_w = (load_label(data_dir, city).shape if out_shape is None
                    else out_shape)
    if num_dates is None:
        num_dates = num_dates_on_disk(data_dir, city) or 2
    means, stds = cfg.band_stats_arrays()
    inv = np.float32(1) / stds
    dates = []
    for t in range(num_dates):
        image_dir = os.path.join(data_dir, "images", city, f"imgs_{t + 1}")
        bands = []
        for k, path in enumerate(band_files(image_dir, cfg.band_ids)):
            band = read_band(path)
            if band.shape != (out_h, out_w):
                band = resize_bilinear(band, out_h, out_w)
            bands.append((band - means[k]) * inv[k])
        dates.append(np.stack(bands, axis=-1))
    return np.stack(dates)


def full_load(data_dir: str, cfg, max_workers: int | None = None) -> dict:
    """{city: {'images': (T, H, W, 13) float32, 'labels': (H, W) uint8}},
    the whole dataset in host memory, T = ``cfg.num_dates``."""
    cities = list_cities(data_dir)
    workers = max_workers or max(2, (os.cpu_count() or 1) * 2)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        labels = list(pool.map(lambda c: load_label(data_dir, c), cities))
        images = list(pool.map(
            lambda c: load_city(data_dir, c, cfg, num_dates=cfg.num_dates),
            cities))
    return {c: {"images": img, "labels": lab}
            for c, img, lab in zip(cities, images, labels)}
