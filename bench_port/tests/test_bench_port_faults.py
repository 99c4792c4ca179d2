"""Runs of the harness on the CPU at 64x64 with the timed path broken
underneath (``bench_port/faults.py``): each fault a cell can have comes
out as not correct."""

import time

import pytest

from bench_port.faults import FAULTS
from bench_port.runner import execute
from conftest import BATCH, ROOT, SERVE, SMALL

CASES = [("c0-brdf-train-b16", "unchanged"),
         ("c0-brdf-train-b16", "half_batch"),
         ("c0-brdf-train-b16", "window_unchanged"),
         ("c0-brdf-train-b16", "window_half_batch"),
         ("c0-light-train-b5", "unchanged"),
         ("c0-light-train-b5", "half_batch"),
         ("c0-light-train-b5", "window_half_batch")]


def run(cell, fault, root=ROOT, seed=1234567890123):
    ov = {"config": SMALL["config"]}
    if cell in BATCH:
        ov["traffic"] = {"batch": BATCH[cell]}
    readings = {}
    r = execute(cell, seed, 0.3, False, time.perf_counter(), device="cpu",
                overrides=ov, patch=fault and FAULTS[fault], root=root,
                readings=readings)
    return r, readings


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(cell, fault, one_thread):
    r, _ = run(cell, fault)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", ["half_batch", "altered"])
def test_serving_fault_is_not_correct(fault, serve_root, one_thread):
    r, _ = run(SERVE, fault, serve_root)
    assert not r["correct"], r["checks"]


def test_serving_shading_fault_moves_the_render_number(serve_root,
                                                       one_thread):
    """The shading altered where the kernel produces it: the render
    number (which has no limit while the serving cell is held back) reads
    it ten times above a sound run of the same seed."""
    _, sound = run(SERVE, None, serve_root)
    _, fault = run(SERVE, "shading", serve_root)
    assert fault["render"] > 10 * sound["render"], (sound, fault)
