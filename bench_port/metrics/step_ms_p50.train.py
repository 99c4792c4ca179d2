"""Median device time of a training step (CUDA events around each step of the window's untraced part), ms."""

from bench_port.readers import median


def read(ctx):
    return median(ctx.step_ms)
