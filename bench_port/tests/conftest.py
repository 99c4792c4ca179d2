"""Shared settings of the benchmark's tests: the checkout's root on the
path, and the ``card`` marker of the tests that need a CUDA card (each
decides inside itself, and skips on a machine without one)."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a small run on the CPU: 64x64 photos, a 32x32 lighting grid
SMALL = {"config": {"im_height": 64, "im_width": 64, "env_rows": 32,
                    "env_cols": 32}}


# the batch of a training cell at 64x64 on the CPU
BATCH = {"c0-brdf-train-b16": 4, "c0-light-train-b5": 2}

# the serving cell, held back from BENCHMARK.json until the program's
# render kernel shades as accurately as its control (PERF.md); its files
# stay under bench_port/, and the tests run it on the CPU
SERVE = "l2-serve-fused-b4"
SERVE_ENTRIES = {
    "configs": {"name": "irois-l2-240x320",
                "source": "https://github.com/lzqsd/InverseRenderingOfIndoorScene",
                "file": "bench_port/configs/irois-l2-240x320.json",
                "reduced": [],
                "why": "both cascades, lighting and bilateral refinement as "
                       "testReal --level 2 serves, f32 with TF32 off"},
    "workloads": {"name": SERVE, "config": "irois-l2-240x320",
                  "traffic": "serve-fused-b4", "chips": 1,
                  "why": "a photo service batching uploads: 4 photos a call, "
                         "one closed-loop client"},
    "end_to_end": {"name": "serve_img_per_s", "unit": "images/s",
                   "better": "higher", "bound": 0.25, "source": "host_clock",
                   "workloads": [SERVE]},
}


@pytest.fixture
def serve_root(tmp_path):
    """A checkout whose BENCHMARK.json also lists the serving cell."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for key, entry in SERVE_ENTRIES.items():
        bench[key].append(entry)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "bench_port").symlink_to(ROOT / "bench_port")
    return tmp_path


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
