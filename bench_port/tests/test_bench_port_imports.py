"""What a run loads: no module whose top-level name is JAX's or the JAX
package's, and a reference that loads nothing of the program."""

import subprocess
import sys

from conftest import ROOT

RUN = """
import sys, time
sys.path.insert(0, {root!r})
import torch
from bench_port import harness
from bench_port.runner import execute
ov = {{"config": {{"im_height": 64, "im_width": 64, "env_rows": 32,
                   "env_cols": 32}}, "traffic": {{"batch": 2}}}}
for cell in ("c0-brdf-train-b16", "c0-light-train-b5"):
    execute(cell, 7, 0.2, False, time.perf_counter(), device="cpu",
            overrides=ov)
import bench_port.run, bench_port.calibrate
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""

REFERENCE = """
import sys
sys.path.insert(0, {root!r})
import bench_port.reference.nets, bench_port.reference.serve
import bench_port.reference.train, bench_port.reference.precision
import bench_port.reference.bilateral
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def loaded(code):
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    from bench_port.harness import FORBIDDEN

    names = loaded(RUN)
    assert "inverserenderingofindoorscene_torch" in names
    assert not names & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    names = loaded(REFERENCE)
    assert "inverserenderingofindoorscene_torch" not in names
    assert "jax" not in names
