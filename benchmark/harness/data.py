"""Seeded inputs, made on the device in a few large draws and handed to
the program (and to the reference) as host arrays, as a caller would.

A scene is normalised 13-band imagery (each band about N(0, 1)): a smooth
field (a coarse normal draw upsampled bilinearly) plus per-pixel noise.
The later date adds noise and shifts the bands inside a few elliptical
"change" blobs; a stack of T dates ramps the shift from 0 at the first
date to its full size at the last.  Every seed gives the same sizes; the
seed changes only the values.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _generator(seed: int, device, stream: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + stream) % (2 ** 63))
    return gen


def _blobs(h: int, w: int, gen: torch.Generator, device,
           n: int = 6) -> torch.Tensor:
    """(h, w) bool mask of ``n`` random ellipses."""
    p = torch.rand(n, 4, generator=gen, device=device)
    cy, cx = p[:, 0] * h, p[:, 1] * w
    ry = (0.03 + 0.12 * p[:, 2]) * h
    rx = (0.03 + 0.12 * p[:, 3]) * w
    yy = torch.arange(h, device=device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, None, :]
    d = ((yy - cy[:, None, None]) / ry[:, None, None]) ** 2 \
        + ((xx - cx[:, None, None]) / rx[:, None, None]) ** 2
    return (d <= 1.0).any(0)


def _field(dates: int, h: int, w: int, c: int, gen: torch.Generator,
           device) -> tuple[torch.Tensor, torch.Tensor]:
    """(dates, h, w, c) float32 imagery and its (h, w) change mask."""
    coarse = torch.randn(1, c, max(h // 32, 2), max(w // 32, 2),
                         generator=gen, device=device)
    base = F.interpolate(coarse, size=(h, w), mode="bilinear",
                         align_corners=False)[0].permute(1, 2, 0)
    base = 0.8 * base + 0.6 * torch.randn(h, w, c, generator=gen,
                                          device=device)
    mask = _blobs(h, w, gen, device)
    noise = torch.randn(dates, h, w, c, generator=gen, device=device)
    ramp = torch.linspace(0.0, 1.5, dates, device=device)
    out = base[None] + 0.2 * noise + ramp[:, None, None, None] \
        * mask[None, :, :, None]
    return out, mask


def scene_pool(seed: int, count: int, height: int, width: int,
               channels: int, device) -> list[tuple[np.ndarray, np.ndarray]]:
    """``count`` distinct (d1, d2) pairs of (height, width, channels)
    float32 host arrays."""
    gen = _generator(seed, device, 1)
    pool = []
    for _ in range(count):
        stack, _ = _field(2, height, width, channels, gen, device)
        host = stack.cpu().numpy()
        pool.append((host[0], host[1]))
    return pool


def cities(seed: int, count: int, height: int, width: int, channels: int,
           dates: int, device) -> dict:
    """An in-memory dataset of ``count`` cities, as the program's loader
    takes it: ``{name: {"images": (dates, H, W, C) float32, "labels": (H,
    W) uint8}}``."""
    gen = _generator(seed, device, 2)
    out = {}
    for i in range(count):
        stack, mask = _field(dates, height, width, channels, gen, device)
        out[f"city{i:03d}"] = {"images": stack.cpu().numpy(),
                               "labels": mask.to(torch.uint8).cpu().numpy()}
    return out
