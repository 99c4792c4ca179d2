"""Median host time of a step's Adam update (the program's ``train.optimizer`` spans, under the traced window's profiler), ms."""

from bench_port.program_spans import host_ms_p50


def read(ctx):
    return host_ms_p50("train.optimizer")
