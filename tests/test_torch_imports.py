"""The port and chip_smoke.py load neither JAX nor the JAX package.

The machine with the card has no JAX, so a fresh interpreter imports
every module of ``inverserenderingofindoorscene_torch`` (the training
modules included) and ``chip_smoke`` (whose imports are all at module
level) and then checks ``sys.modules``.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, pkgutil, sys
import inverserenderingofindoorscene_torch as port
names = [m.name for m in
         pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
need = {"data.synthetic", "losses.masked", "train.steps", "pipeline.light",
        "ops.sg_render", "ops.bilateral", "pipeline.bilateral",
        "models.bilateral_net", "pipeline.export", "utils.io",
        "data.openrooms", "losses.ranking", "pipeline.finetune",
        "eval.metrics"}
assert {port.__name__ + "." + n for n in need} <= set(names)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                    "inverserenderingofindoorscene_tpu"))
print(len(names), bad)
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    n_modules, loaded = int(out[0]), " ".join(out[1:])
    assert n_modules >= 30, n_modules
    assert loaded == "[]", loaded
