"""Serving: the device-resident grid runner's rate, Mpx/s, on a scene pair
already on the card (CUDA events over the driver's ``runner_repeats``
runs, after the traced window).  Against ``serve_mpx_s`` it shows what
the host front costs.  Layer: tiling and runner."""


def read(ctx):
    return ctx["timings"].get("runner_mpx_s")
