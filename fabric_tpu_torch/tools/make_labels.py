"""Rasterize polygon annotations into change-mask PNGs (counterpart of
``fabric_tpu/tools/make_labels.py``).

An even-odd scanline fill of GeoJSON-style polygons in pixel coordinates
(each polygon's exterior ring), without GDAL.  Host-only (numpy).

Usage: python -m fabric_tpu_torch.tools.make_labels --geojson polys.json
       --height H --width W --output labels/<city>/cm/cm.png
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from fabric_tpu_torch.data.image import write_png


def rasterize_polygon(mask: np.ndarray, ring: list) -> None:
    """Even-odd scanline fill of one polygon ring ([[x, y], ...]) into a
    boolean mask, in place.  Coordinates are pixel units (x=col, y=row)."""
    h, w = mask.shape
    pts = np.asarray(ring, np.float64)
    if len(pts) < 3:
        return
    ys = pts[:, 1]
    y0 = max(int(np.floor(ys.min())), 0)
    y1 = min(int(np.ceil(ys.max())), h - 1)
    n = len(pts)
    for y in range(y0, y1 + 1):
        yc = y + 0.5
        xs = []
        for i in range(n):
            x1_, y1_ = pts[i]
            x2_, y2_ = pts[(i + 1) % n]
            if (y1_ <= yc < y2_) or (y2_ <= yc < y1_):
                t = (yc - y1_) / (y2_ - y1_)
                xs.append(x1_ + t * (x2_ - x1_))
        xs.sort()
        for a, b in zip(xs[::2], xs[1::2]):
            ca = max(int(np.ceil(a - 0.5)), 0)
            cb = min(int(np.floor(b - 0.5)), w - 1)
            if cb >= ca:
                mask[y, ca:cb + 1] = True


def rasterize_geojson(geojson: dict, height: int, width: int) -> np.ndarray:
    """(H, W) uint8 {0,1} mask from a FeatureCollection / geometry dict."""
    mask = np.zeros((height, width), bool)
    features = geojson.get("features", [geojson])
    for feat in features:
        geom = feat.get("geometry", feat)
        gtype = geom.get("type")
        coords = geom.get("coordinates", [])
        polys = coords if gtype == "MultiPolygon" else [coords]
        for poly in polys:
            if poly:
                rasterize_polygon(mask, poly[0])  # exterior ring
    return mask.astype(np.uint8)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--geojson", required=True)
    ap.add_argument("--height", type=int, required=True)
    ap.add_argument("--width", type=int, required=True)
    ap.add_argument("--output", required=True)
    args = ap.parse_args(argv)
    with open(args.geojson) as fin:
        gj = json.load(fin)
    mask = rasterize_geojson(gj, args.height, args.width)
    import os
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    write_png(args.output, mask * 255)
    print(f"wrote {args.output} ({mask.mean() * 100:.2f}% positive)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
