"""The port and chip_smoke.py load neither JAX nor the JAX package.

The machine with the card has no JAX, so a fresh interpreter imports
every module of ``inverserenderingofindoorscene_torch`` (the training
modules, the loaders, the native decoder's bindings and the CLIs
included) and ``chip_smoke`` (whose imports are all at module level) and
then checks ``sys.modules``.  Imports inside functions (the loaders' cv2,
PIL and h5py, the fixture writer's oracle) are read from the sources:
none names JAX, the JAX package or the repository's ``tests``.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

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
        "eval.metrics", "native.hdr", "data.iiw", "data.nyu",
        "data.fixture", "data._oracle_np", "utils.checkpoint",
        "utils.logging", "cli.common", "cli.train_brdf", "cli.train_light",
        "data.cache", "cli.build_cache", "cli.train_bilateral",
        "cli.train_finetune_iiw", "cli.train_finetune_nyu",
        "cli.output_brdf_light", "cli.test_synthetic", "cli.test_real",
        "cli.compare", "cli.run_convergence"}
assert {port.__name__ + "." + n for n in need} <= set(names)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "tests",
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


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tests",
             "inverserenderingofindoorscene_tpu")


def imported_roots(path):
    """The top-level package of every import statement in ``path``,
    those inside functions included; a relative import gives ''."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add("" if node.level else node.module.split(".")[0])
    return roots


def test_no_module_of_the_port_imports_jax_or_tests():
    port = Path(ROOT) / "inverserenderingofindoorscene_torch"
    files = sorted(port.rglob("*.py")) + [Path(ROOT) / "chip_smoke.py"]
    assert port / "data" / "fixture.py" in files
    for path in files:
        bad = imported_roots(path) & set(FORBIDDEN)
        assert not bad, (path, bad)
    assert "tests" not in imported_roots(port / "data" / "fixture.py")
