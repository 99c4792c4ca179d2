"""Device time of kernels launched under convolution ops, in the traced window, over its images, ms an image."""

from bench_port.readers import conv_ms_per_img


def read(ctx):
    return conv_ms_per_img(ctx)
