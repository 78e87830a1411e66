"""Serving: percent of the 3x3 convs' roofline bound that their kernels
reach in the traced window.  The bound is the configuration's
(``flops/<config>.py`` ``conv3x3_bound_s``: per DoubleConv of a forward
of ``tile_batch`` tiles, the larger of operations over the peak and bytes
over the bandwidth) for every forward the window served; the time is the
device time of the kernels named below (the port's conv kernels, and
cuDNN's should a conv take that route).
Layer: kernels."""

from benchmark.harness import readers

CONV_KERNELS = ("conv3x3_bias_relu_kernel", "double_conv_kernel",
                "conv3x3_bias_relu_f32_kernel", "double_conv_f32_kernel",
                "conv3x3_s8_kernel", "cudnn", "fprop", "implicit_convolve",
                "conv2d")


def read(ctx):
    seconds = readers.op_seconds(ctx, CONV_KERNELS)
    tiles = ctx["counts"].get("tiles", 0)
    if seconds <= 0 or not tiles:
        return None
    p, b = ctx["workload"]["patch"], ctx["workload"]["tile_batch"]
    bound = tiles / b * ctx["flops"].conv3x3_bound_s(p, p, b)
    return 100.0 * bound / seconds
