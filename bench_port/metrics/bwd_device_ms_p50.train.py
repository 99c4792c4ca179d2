"""Median device time of a step's gradients (CUDA events of the program's ``train.backward`` spans in the traced window), ms."""

from bench_port.program_spans import device_ms_p50


def read(ctx):
    return device_ms_p50("train.backward")
