"""Serving: percent of the traced window in which no operation (kernel,
copy or memset) ran on the card.  Layer: the device."""

from benchmark.harness import readers


def read(ctx):
    return readers.idle_share(ctx)
