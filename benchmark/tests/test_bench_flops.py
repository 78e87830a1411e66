"""The operation counts against a count by hand, and the seeded weights
against the configuration's parameter count."""

import numpy as np
import pytest
import torch

from benchmark.harness import manifest, peaks, unet_counts
from benchmark.harness import weights as bench_weights


def _hand_forward(c: int, k: int, b: int, h: int, w: int,
                  dates: int) -> float:
    """Every 3x3 conv of the U-Net written out: 2 * 9 * cin * cout per
    output pixel; the 1x1 head 2 * b * k per pixel."""
    enc = [(c, b, 1), (b, b, 1), (b, 2 * b, 2), (2 * b, 2 * b, 2),
           (2 * b, 4 * b, 4), (4 * b, 4 * b, 4), (4 * b, 8 * b, 8),
           (8 * b, 8 * b, 8), (8 * b, 8 * b, 16), (8 * b, 8 * b, 16)]
    dec = [(16 * b, 4 * b, 8), (4 * b, 4 * b, 8), (8 * b, 2 * b, 4),
           (2 * b, 2 * b, 4), (4 * b, b, 2), (b, b, 2), (2 * b, b, 1),
           (b, b, 1)]
    total = sum(dates * 2 * 9 * ci * co * (h // s) * (w // s)
                for ci, co, s in enc)
    total += sum(2 * 9 * ci * co * (h // s) * (w // s) for ci, co, s in dec)
    return total + 2 * b * k * h * w


@pytest.mark.parametrize("dates", [2, 5])
def test_forward_flops_by_hand(dates):
    got = unet_counts.forward_flops(3, 2, 4, 32, 48, dates)
    assert got == _hand_forward(3, 2, 4, 32, 48, dates)


def test_config_counts():
    f = manifest.flops("bidate-b64")
    # 1.41 MFLOP a pixel at 64^2 tiles, 13 GFLOP an example at 96^2
    assert abs(f.forward_flops(64, 64) / 4096 - 1.4126e6) < 1e3
    assert f.train_flops(96, 96) == 3 * f.forward_flops(96, 96)


def test_conv_bound_counts_weights_once_a_launch():
    one = unet_counts.conv3x3_bound_s(13, 64, 64, 64, 2, 1,
                                      peaks.BF16_FLOPS, peaks.HBM_BYTES)
    many = unet_counts.conv3x3_bound_s(13, 64, 64, 64, 2, 256,
                                       peaks.BF16_FLOPS, peaks.HBM_BYTES)
    assert many < 256 * one
    flops = unet_counts.forward_flops(13, 2, 64, 64, 64, 2) \
        - 2 * 64 * 2 * 64 * 64
    assert many >= 256 * flops / peaks.BF16_FLOPS * (1 - 1e-12)


@pytest.mark.parametrize("config", [c["name"] for c in
                                    manifest.manifest()["configs"]])
def test_seeded_weights(config):
    cfg = manifest.config(config)
    params, stats = bench_weights.make(cfg, 7, torch.device("cpu"))
    n = sum(v.numel() for v in bench_weights.flatten(params).values())
    assert n == cfg["parameters"]
    again, _ = bench_weights.make(cfg, 7, torch.device("cpu"))
    a, b = bench_weights.flatten(params), bench_weights.flatten(again)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(np.isfinite(v.numpy()).all()
               for v in bench_weights.flatten(stats).values())
