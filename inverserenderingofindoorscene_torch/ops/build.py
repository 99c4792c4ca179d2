"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, loaded with ``ctypes``.
Libraries go to ``build/torch_kernels/`` at the root of the checkout,
named by a hash of the source, the shared ``csrc/*.cuh`` headers and the
flags, so a checkout builds its own kernels on first use and a changed
source or header is rebuilt.  ``csrc/*.cpp`` sources are host code (the
hand-off files' LZF), built the same way with ``g++`` (``load_host``).
Nothing here runs at import time.  The launch helpers at the end are
shared by every kernel wrapper.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("sg_render_env", "sg_render", "sg_envmap", "bilateral_blur")
GXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (set CUDA_HOME or PATH)")
    return str(path)


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives.  Every
    header is hashed with every source: a source includes what it needs."""
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    (target, temp output, process) or None."""
    target = library_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc


def build_all(names=SOURCES) -> dict:
    """Compile every named source that is not built yet, all nvcc
    processes at once.  Returns {name: compiler output} for the sources
    built by this call; raises with the output if one fails."""
    started = {n: s for n in names if (s := _start(n)) is not None}
    logs, failed = {}, []
    for name, (target, tmp, proc) in started.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}:\n{out}")
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<name>.cu``."""
    build_all((name,))
    return ctypes.CDLL(str(library_path(name)))


def host_library_path(name: str) -> Path:
    """Where the host library built from ``csrc/<name>.cpp`` lives."""
    digest = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


@functools.lru_cache(maxsize=None)
def load_host(name: str) -> ctypes.CDLL:
    """Build (if needed) with ``g++`` and load the host library of
    ``csrc/<name>.cpp``.  A per-process temp file and an atomic rename let
    loader processes build it at once."""
    target = host_library_path(name)
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = f"{target}.tmp.{os.getpid()}"
        proc = subprocess.run(
            ["g++", *GXX_FLAGS, "-o", tmp, str(CSRC / f"{name}.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {name}:\n{proc.stdout}")
        os.replace(tmp, target)
    return ctypes.CDLL(str(target))


def on_card(fn: str, x) -> bool:
    """True for a CUDA tensor, False for a CPU one; raise for the rest.
    A wrapper launches its kernel on the first and runs its plain version
    on the second."""
    if x.device.type == "cpu":
        return False
    if x.device.type == "cuda":
        return True
    raise ValueError(f"{fn}: unsupported device {x.device}")


def raise_on(fn: str, err: int) -> None:
    """Raise for the nonzero ``cudaGetLastError()`` a launch returned."""
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {err}")


def stream(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a pointer."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
