"""Raster band readers (counterpart of ``fabric_tpu/data/geotiff.py``).

``.npy`` (the synthetic and test format) is read with numpy; ``.tif`` /
``.tiff`` with rasterio, else tifffile, else OpenCV, whichever is
installed, and raises when none is.  Every reader returns the first band
as a 2-D float32 array (``rasterio.read()[0]``).
"""

from __future__ import annotations

import os

import numpy as np


def read_band(path: str) -> np.ndarray:
    """Read one raster band file as float32 (H, W)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        arr = np.load(path)
    elif ext in (".tif", ".tiff"):
        arr = _read_tif(path)
    else:
        raise ValueError(f"unsupported band file: {path}")
    arr = np.asarray(arr)
    if arr.ndim == 3:  # (bands, H, W) or (H, W, C): take the first plane
        arr = arr[0] if arr.shape[0] < arr.shape[-1] else arr[..., 0]
    return arr.astype(np.float32)


def _read_tif(path: str) -> np.ndarray:
    try:
        import rasterio
    except ImportError:
        pass
    else:
        with rasterio.open(path) as src:
            return src.read()[0]
    try:
        import tifffile
        return tifffile.imread(path)
    except (ImportError, ValueError, OSError):  # not installed or unreadable
        pass
    try:
        import cv2
    except ImportError:
        pass
    else:
        arr = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if arr is not None:
            return arr
    raise RuntimeError(
        f"no GeoTIFF backend available for {path} "
        "(install rasterio or tifffile, or convert bands to .npy)")


def band_dims(path: str) -> tuple[int, int]:
    """(width, height) of a raster: the template dims of whole-scene
    inference."""
    if os.path.splitext(path)[1].lower() == ".npy":
        arr = np.load(path, mmap_mode="r")
        return arr.shape[1], arr.shape[0]
    arr = _read_tif(path)
    return arr.shape[1], arr.shape[0]
