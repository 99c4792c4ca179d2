"""Readers of the program's own spans
(``inverserenderingofindoorscene_torch/utils/spans.py``): the records its
``span`` keeps while a profiler records, which in a run are those of the
traced window.  Each returns None where the program has no such module
or kept no record of the span, and a device reader on the CPU, where a
record holds no events."""

from __future__ import annotations

import importlib

from bench_port.readers import median


def _spans():
    try:
        return importlib.import_module(
            "inverserenderingofindoorscene_torch.utils.spans")
    except ModuleNotFoundError:
        return None


def host_ms_p50(name: str):
    """The median host duration of the span ``name``, ms."""
    spans = _spans()
    if spans is None:
        return None
    return median([(r.end_ns - r.start_ns) / 1e6 for r in spans.records()
                   if r.name == name])


def device_ms_p50(name: str):
    """The median device time of the span ``name`` (its CUDA events),
    ms."""
    spans = _spans()
    if spans is None:
        return None
    ms = [spans.device_ms(r) for r in spans.records() if r.name == name]
    return median([m for m in ms if m is not None])
