"""The controls on the card: for each cell, the reference computed one
precision below its configuration's (``reference/precision.py``) in the
program's place, on three seeds, fails a number it reads.  At 64x64 here
(a test run's size); the readings at the cells' own sizes are in
PERF.md (``calibrate.py --control-seeds``).  Skips without a card."""

import json

import pytest

from bench_port import harness
from bench_port.calibrate import control, overrides_of
from conftest import ROOT

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    limits = harness.load_cell(cell, ROOT)["limits"]["limits"]
    for seed in (11, 12, 13):
        # after a short run of the program, so that a training cell's
        # control takes the replay from the state its window left
        _, readings = control(cell, seed, "cuda", overrides_of("64x64"),
                              seconds=1.0)
        # the numbers the control reads (all but window_steps)
        read = {k: v for k, v in limits.items() if k in readings}
        assert read, readings
        correct, checks = harness.compare(readings, read)
        assert not correct, (seed, checks)
