"""The benchmark's seven readers of the port's spans
(``bench_port/metrics/*_ms_p50.*.py`` over ``bench_port/program_spans.py``):
the median host duration of their span in ms, None from the device
readers on the CPU, None from an empty buffer."""

import json
import statistics
import sys
import time
from pathlib import Path

import pytest
from torch.profiler import ProfilerActivity, profile

from inverserenderingofindoorscene_torch.utils import spans

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port import harness  # noqa: E402

HOST = {"step_host_ms_p50.light": "train.step",
        "fwd_host_ms_p50.light": "train.forward",
        "bwd_host_ms_p50.light": "train.backward",
        "opt_host_ms_p50.light": "train.optimizer"}
DEVICE = {"fwd_device_ms_p50.train": "train.forward",
          "bwd_device_ms_p50.train": "train.backward",
          "opt_device_ms_p50.train": "train.optimizer"}
SLEEPS_MS = (4.0, 12.0, 8.0)  # median 8
# a span's host time over its sleep: the record's stamps, the range's
# enter and exit, a sleep's overshoot on a loaded machine
OVER_MS = 5.0


@pytest.fixture(autouse=True)
def empty_buffer():
    spans.clear()
    yield
    spans.clear()


def test_readers_are_the_benchmarks_entries():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in HOST:
        assert entries[name]["workloads"] == ["c0-light-train-b5"]
        assert entries[name]["source"] == "host_clock"
    for name in DEVICE:
        assert entries[name]["workloads"] == ["c0-brdf-train-b16"]
        assert entries[name]["source"] == "device_trace"


@pytest.mark.parametrize("name", sorted(HOST) + sorted(DEVICE))
def test_reader_median_of_its_span(name):
    read = harness.metric_reader(name)
    assert read(None) is None  # an empty buffer
    span_name = {**HOST, **DEVICE}[name]
    with profile(activities=[ProfilerActivity.CPU]):
        for ms in SLEEPS_MS:
            with spans.span("other"):
                time.sleep(0.02)
            with spans.span(span_name, device="cpu"):
                time.sleep(ms / 1e3)
    got = read(None)
    if name in DEVICE:
        assert got is None  # no CUDA events on the CPU
        return
    want = statistics.median(SLEEPS_MS)
    assert want <= got <= want + OVER_MS
