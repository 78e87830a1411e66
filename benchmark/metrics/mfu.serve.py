"""Serving: percent of the card's bf16 peak that the forward's operations
(``flops/<config>.py``, every tile served in the traced window) make over
the traced window.  Layer: the forward."""

from benchmark.harness import readers


def read(ctx):
    p = ctx["workload"]["patch"]
    tiles = ctx["counts"].get("tiles", 0)
    return readers.mfu(ctx, tiles * ctx["flops"].forward_flops(p, p))
