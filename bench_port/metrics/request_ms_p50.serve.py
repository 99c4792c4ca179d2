"""Median host time of a request, call to synchronised outputs, over the window's untraced part, ms."""

from bench_port.readers import median


def read(ctx):
    return median(ctx.call_ms)
