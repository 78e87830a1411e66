"""Host image helpers: percentile stretch, min-max scale, bilinear resize
and PNG reading/writing (the parts of ``fabric_tpu/utils/image.py`` the
data loaders and the tracker use).

The resize is OpenCV's; PNGs are written without dependencies and read
with PIL (else OpenCV).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def stretch_8bit(band: np.ndarray, lower_percent: float = 2,
                 higher_percent: float = 98) -> np.ndarray:
    """2-98 percentile contrast stretch to uint8, percentiles taken over
    the strictly positive pixels."""
    real = band.reshape(-1)
    real = real[real > 0]
    if real.size == 0:
        return np.zeros(band.shape, np.uint8)
    c = np.percentile(real, lower_percent)
    d = np.percentile(real, higher_percent)
    denom = (d - c) if d != c else 1.0
    t = np.clip((band.astype(np.float64) - c) * (255.0 / denom), 0, 255)
    return t.astype(np.uint8)


def scale(x: np.ndarray, out_range=(0, 255)) -> np.ndarray:
    """Min-max scale to a range."""
    lo, hi = float(np.min(x)), float(np.max(x))
    denom = (hi - lo) if hi != lo else 1.0
    y = (x - (hi + lo) / 2.0) / denom
    return (y * (out_range[1] - out_range[0])
            + (out_range[1] + out_range[0]) / 2.0)


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize of an (H, W) or (H, W, C) array with OpenCV's
    ``INTER_LINEAR``, the resize the reference's loader uses."""
    import cv2
    return cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_LINEAR)


def write_png(path: str, array: np.ndarray) -> None:
    """Write an (H, W) gray or (H, W, 3) RGB uint8 image as PNG."""
    arr = np.asarray(array)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    if arr.ndim == 2:
        data, color_type = arr[:, :, None], 0
    elif arr.ndim == 3 and arr.shape[2] in (1, 3):
        data, color_type = arr, (0 if arr.shape[2] == 1 else 2)
    else:
        raise ValueError(f"unsupported PNG shape {arr.shape}")
    h, w = data.shape[:2]
    raw = b"".join(b"\x00" + data[i].tobytes() for i in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as fout:
        fout.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                   + chunk(b"IDAT", zlib.compress(raw, 6))
                   + chunk(b"IEND", b""))


def read_png_gray(path: str) -> np.ndarray:
    """A PNG as (H, W) grayscale uint8 (PIL's "L" conversion; OpenCV's
    where PIL is missing)."""
    try:
        from PIL import Image
    except ImportError:
        import cv2
        return cv2.imread(path, 0)
    return np.array(Image.open(path).convert("L"), np.uint8)
