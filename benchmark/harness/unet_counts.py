"""Operation and byte counts of the U-Nets, worked out from their layer
shapes: the model's work, whatever implements it.  A multiply-add is two
operations.  The ``flops/<config>.py`` files call these with their
configuration's widths."""

from __future__ import annotations


def double_convs(n_channels: int, base: int, h: int, w: int):
    """[(level, encoder?, h, w, cin, cout)] of every DoubleConv of one
    image's U-Net at (h, w): inc and down1-4 (at h / 2**k), up1-4."""
    b = base
    enc = [("inc", 1, n_channels, b), ("down1", 2, b, 2 * b),
           ("down2", 4, 2 * b, 4 * b), ("down3", 8, 4 * b, 8 * b),
           ("down4", 16, 8 * b, 8 * b)]
    dec = [("up1", 8, 16 * b, 4 * b), ("up2", 4, 8 * b, 2 * b),
           ("up3", 2, 4 * b, b), ("up4", 1, 2 * b, b)]
    return ([(n, True, h // s, w // s, ci, co) for n, s, ci, co in enc]
            + [(n, False, h // s, w // s, ci, co) for n, s, ci, co in dec])


def forward_flops(n_channels: int, n_classes: int, base: int, h: int,
                  w: int, dates: int) -> float:
    """Operations of one forward at (h, w): the encoder once a date, the
    decoder and the 1x1 head once."""
    total = 0.0
    for _, enc, hh, ww, ci, co in double_convs(n_channels, base, h, w):
        macs = hh * ww * 9 * (ci * co + co * co)
        total += 2 * macs * (dates if enc else 1)
    total += 2 * h * w * base * n_classes
    return total


def conv3x3_bound_s(n_channels: int, base: int, h: int, w: int, dates: int,
                    batch: int, peak_flops: float, peak_bytes: float,
                    elem_bytes: int = 2) -> float:
    """The least time of the DoubleConvs of one forward of ``batch``
    examples at (h, w): per block, the larger of its operations over the
    peak and its bytes (every image's input and output once, the weights
    once; the intermediate need not leave the chip) over the bandwidth,
    summed over the blocks."""
    total = 0.0
    for _, enc, hh, ww, ci, co in double_convs(n_channels, base, h, w):
        k = batch * (dates if enc else 1)
        ops = 2 * k * hh * ww * 9 * (ci * co + co * co)
        data = elem_bytes * (k * hh * ww * (ci + co)
                             + 9 * (ci * co + co * co))
        total += max(ops / peak_flops, data / peak_bytes)
    return total
