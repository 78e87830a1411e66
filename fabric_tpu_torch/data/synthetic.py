"""Synthetic OSCD-layout dataset for tests and smoke runs (a copy of
``fabric_tpu/data/synthetic.py``).

Writes ``images/<city>/imgs_{1..T}/<city>_<date>_<BAND>.npy``,
``labels/<city>/cm/cm.png`` and ``images/<city>/pair/img{1,2}.png`` (the
first and the last date), with band values whose normalised form is
~N(0, 1), blob-shaped change masks, and each date t shifted by 2t/(T-1)
inside the change regions (T = 2 for the bi-date model; more for the
multi-date ones): enough signal that a few training steps measurably
reduce the loss.  The same seed writes the same files as ``fabric_tpu``'s
generator.
"""

from __future__ import annotations

import os

import numpy as np

from fabric_tpu_torch.data.image import write_png


def _blob_mask(h: int, w: int, rng: np.random.RandomState,
               n_blobs: int = 4) -> np.ndarray:
    mask = np.zeros((h, w), bool)
    yy, xx = np.ogrid[:h, :w]
    for _ in range(n_blobs):
        cy, cx = rng.randint(0, h), rng.randint(0, w)
        ry = rng.randint(h // 16 + 1, h // 4 + 2)
        rx = rng.randint(w // 16 + 1, w // 4 + 2)
        mask |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
    return mask


def generate_synthetic_dataset(root: str, cfg, cities: list[str] | None = None,
                               sizes: list[tuple[int, int]] | None = None,
                               seed: int = 0, num_dates: int = 2) -> list[str]:
    """Create a synthetic dataset of ``num_dates`` dates under ``root``;
    returns the city list."""
    rng = np.random.RandomState(seed)
    cities = cities or ["alpha", "beta", "gamma"]
    sizes = sizes or [(97, 113), (128, 96), (75, 75)]
    means, stds = cfg.band_stats_arrays()
    nb = len(cfg.band_ids)
    for city, (h, w) in zip(cities, sizes):
        mask = _blob_mask(h, w, rng)
        base = rng.randn(h, w, nb).astype(np.float32)
        dates = []
        for t in range(num_dates):
            d = base + rng.randn(h, w, nb).astype(np.float32) * 0.1
            # the change ramps up over the sequence (0 at date 1)
            d[mask] += 2.0 * t / max(num_dates - 1, 1)
            dates.append(d)
        for t, cube in enumerate(dates):
            date = f"imgs_{t + 1}"
            ddir = os.path.join(root, "images", city, date)
            os.makedirs(ddir, exist_ok=True)
            for k, band in enumerate(cfg.band_ids):
                raw = cube[:, :, k] * stds[k] + means[k]
                np.save(os.path.join(ddir, f"{city}_{date}_{band}.npy"),
                        raw.astype(np.float32))
        ldir = os.path.join(root, "labels", city, "cm")
        os.makedirs(ldir, exist_ok=True)
        write_png(os.path.join(ldir, "cm.png"), mask.astype(np.uint8) * 255)
        pdir = os.path.join(root, "images", city, "pair")
        os.makedirs(pdir, exist_ok=True)
        for t, cube in enumerate((dates[0], dates[-1])):
            rgb = np.clip((cube[:, :, 1:4] + 3) * 42, 0, 255).astype(np.uint8)
            write_png(os.path.join(pdir, f"img{t + 1}.png"), rgb)
    return list(cities)
