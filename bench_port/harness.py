"""The benchmark's general part: the cell's files found by name, the
measured window, the trace, the metrics, the comparison's verdict and the
result line.

A cell of ``BENCHMARK.json`` names a configuration
(``bench_port/configs/<config>.json``) and a traffic mix
(``bench_port/traffic/<traffic>.json``, whose ``driver`` names the code
that runs it, ``bench_port/traffic/<driver>.py``); the cell's own file
(``bench_port/workloads/<cell>.json``) holds the limits of its
comparison.  Each per-layer metric is read by
``bench_port/metrics/<metric>.py``.  Later cells and metrics add files;
nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level modules that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "optax",
             "inverserenderingofindoorscene_tpu")
FLUSH_STEPS = 16  # metrics read back every 16 steps (--logFlushSteps 16)


def cache_env(root: Path = ROOT) -> dict:
    """The build and kernel caches of a run, at fixed paths inside the
    checkout (set before torch is imported)."""
    build = root / "build"
    return {"TORCH_EXTENSIONS_DIR": str(build / "torch_extensions"),
            "TRITON_CACHE_DIR": str(build / "triton"),
            "TORCHINDUCTOR_CACHE_DIR": str(build / "inductor"),
            "CUDA_CACHE_PATH": str(build / "nv_compute_cache"),
            "USE_FLAX": "0"}


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def read_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic and limits, and the metrics that apply to it."""
    bench = read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(root / configs[cell["config"]]["file"])
    traffic = read_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    limits = read_json(BENCH / "workloads" / f"{name}.json")

    def applies(metric):
        return "workloads" not in metric or name in metric["workloads"]

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return {"name": name, "cell": cell, "config": config,
            "traffic": traffic, "limits": limits, "end_to_end": e2e,
            "per_layer": per_layer}


def driver(traffic: dict):
    return importlib.import_module(f"bench_port.traffic.{traffic['driver']}")


def metric_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_port.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def quantile(values, q: float) -> float:
    """The q-quantile of ``values`` by linear interpolation between order
    statistics (numpy's default)."""
    xs = sorted(values)
    pos = q * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


class Window:
    """The timed loop: ``session.call(i)`` (one step or one request,
    returning the images it completed) until ``seconds`` have passed,
    then the session's ``end_window`` and a synchronize."""

    def __init__(self, session, seconds: float, sync):
        self.session, self.seconds, self.sync = session, seconds, sync
        self.calls = self.images = 0
        self.elapsed = 0.0

    def run(self, start_index: int = 0) -> int:
        """Calls from ``start_index`` on; returns the next call's index."""
        s = self.session
        self.sync()
        t0 = time.perf_counter()
        i = start_index
        while True:
            self.images += s.call(i)
            i += 1
            self.calls += 1
            if time.perf_counter() - t0 >= self.seconds:
                break
        s.end_window()
        self.sync()
        self.elapsed = time.perf_counter() - t0
        return i


class PhaseLog:
    """Seconds of a set-up's phases, each ending at a synchronize, for
    the run's standard error."""

    def __init__(self, sync):
        self.sync, self.t = sync, time.perf_counter()
        self.parts = []

    def __call__(self, name: str) -> None:
        self.sync()
        now = time.perf_counter()
        self.parts.append(f"{name} {now - self.t:.3f} s")
        self.t = now

    def text(self) -> str:
        return ", ".join(self.parts)


def compare(readings: dict, limits: dict) -> tuple:
    """(correct, checks): each reading beside its limit; a missing limit,
    a missing or non-finite reading, or one above its limit is not
    correct."""
    checks, correct = {}, True
    for name, limit in limits.items():
        value = readings.get(name)
        ok = (value is not None and limit is not None and math.isfinite(value)
              and value <= limit)
        correct = correct and ok
        checks[name] = {"value": value, "limit": limit}
    return correct, checks


def emit(result: dict) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output (``checks`` its last key)."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
