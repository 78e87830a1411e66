"""Per-band mean and std over a dataset (counterpart of
``fabric_tpu/tools/band_stats.py``): the offline step whose output is the
``band_means`` / ``band_stds`` block of metadata.json.

Every pixel of every band of every city and date on disk, accumulated as
float64 sums and sums of squares while the bands stream past, so a
dataset of any size fits in constant memory.  Host-only (numpy).

Usage: python -m fabric_tpu_torch.tools.band_stats --dataset_dir ./onera/
       [--output stats.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from fabric_tpu_torch.config import Config
from fabric_tpu_torch.data.geotiff import read_band
from fabric_tpu_torch.data.oscd import (band_files, list_cities,
                                        num_dates_on_disk)


def compute_band_stats(data_dir: str, band_ids: list[str]) -> dict:
    """{'band_means': {...}, 'band_stds': {...}} over all cities/dates."""
    count = np.zeros(len(band_ids), np.float64)
    total = np.zeros(len(band_ids), np.float64)
    total_sq = np.zeros(len(band_ids), np.float64)
    for city in list_cities(data_dir):
        t = num_dates_on_disk(data_dir, city)
        for d in range(t):
            image_dir = os.path.join(data_dir, "images", city, f"imgs_{d + 1}")
            for k, path in enumerate(band_files(image_dir, band_ids)):
                band = read_band(path).astype(np.float64)
                count[k] += band.size
                total[k] += band.sum()
                total_sq[k] += (band * band).sum()
    mean = total / np.maximum(count, 1)
    var = total_sq / np.maximum(count, 1) - mean * mean
    std = np.sqrt(np.maximum(var, 0))
    return {
        "band_means": {b: float(mean[k]) for k, b in enumerate(band_ids)},
        "band_stds": {b: float(std[k]) for k, b in enumerate(band_ids)},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset_dir", required=True)
    ap.add_argument("--output", default=None,
                    help="write JSON here (default: stdout)")
    args = ap.parse_args(argv)
    stats = compute_band_stats(args.dataset_dir, Config().band_ids)
    text = json.dumps(stats, indent=2)
    if args.output:
        with open(args.output, "w") as fout:
            fout.write(text)
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
