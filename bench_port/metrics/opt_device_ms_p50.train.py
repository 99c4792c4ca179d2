"""Median device time of a step's Adam update (CUDA events of the program's ``train.optimizer`` spans in the traced window), ms."""

from bench_port.program_spans import device_ms_p50


def read(ctx):
    return device_ms_p50("train.optimizer")
