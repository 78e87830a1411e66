"""Training: one train step on a batch already on the card, ms (CUDA
events over the driver's ``step_repeats`` steps, after the traced
window).  Against the loop's rate it shows the host data pipeline's
share.  Layer: train step."""


def read(ctx):
    return ctx["timings"].get("device_step_ms")
