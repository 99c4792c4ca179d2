"""The model's convolution and matmul FLOPs done in the traced window over the window and the card's dense peak in the configuration's precision, %."""

from bench_port.readers import mfu


def read(ctx):
    return mfu(ctx)
