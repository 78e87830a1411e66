"""Training: percent of the card's bf16 peak that the steps' operations
(forward and backward, ``flops/<config>.py`` ``train_flops``, every
example of the traced window) make over the traced window.  Layer: the
train step as a whole."""

from benchmark.harness import readers


def read(ctx):
    p = ctx["counts"].get("patch", 0)
    n = ctx["counts"].get("examples", 0)
    return readers.mfu(ctx, n * ctx["flops"].train_flops(p, p))
