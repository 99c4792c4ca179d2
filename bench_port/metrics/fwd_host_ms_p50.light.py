"""Median host time of a step's loss (the program's ``train.forward`` spans, under the traced window's profiler), ms."""

from bench_port.program_spans import host_ms_p50


def read(ctx):
    return host_ms_p50("train.forward")
