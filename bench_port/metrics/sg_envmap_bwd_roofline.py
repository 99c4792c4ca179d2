"""The sg_envmap_bwd kernel's share of its roofline over the traced window: the larger of its launches' bytes over the memory rate and float32 operations over the float32 rate, summed, over its device time, %."""

from bench_port.readers import roofline


def read(ctx):
    return roofline(ctx, "sg_envmap_bwd")
