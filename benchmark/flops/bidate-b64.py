"""Operation and byte counts of the ``bidate-b64`` configuration
(``configs/bidate-b64.json``), from its layer shapes."""

import os

from benchmark.harness import manifest, peaks, unet_counts

CONFIG = manifest.config(os.path.splitext(os.path.basename(__file__))[0])
DATES = CONFIG.get("num_dates", 2)


def forward_flops(h: int, w: int) -> float:
    """Operations of one forward of one example at (h, w)."""
    return unet_counts.forward_flops(
        CONFIG["n_channels"], CONFIG["n_classes"], CONFIG["model_base"], h,
        w, DATES)


def train_flops(h: int, w: int) -> float:
    """A training step's operations an example: the forward and a backward
    of twice its work."""
    return 3 * forward_flops(h, w)


def conv3x3_bound_s(h: int, w: int, batch: int) -> float:
    """The least time of the 3x3 convs of one forward of ``batch``
    examples at (h, w) on the card, in the configuration's dtype."""
    return unet_counts.conv3x3_bound_s(
        CONFIG["n_channels"], CONFIG["model_base"], h, w, DATES, batch,
        peaks.PEAK_FLOPS[CONFIG["dtype"]], peaks.HBM_BYTES)
