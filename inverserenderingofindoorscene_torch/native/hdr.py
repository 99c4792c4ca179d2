"""ctypes bindings for the native RGBE decoder (``rgbe_decode.c``).

The counterpart of the JAX package's ``native/hdr.py``, with the same C
source byte for byte.  The shared library is compiled on first use with
the system C compiler (``cc``, ``gcc`` or ``clang``, -O3) into
``build/torch_native/`` at the root of the checkout, named by a hash of
the source and the flags, as ``ops/build.py`` names the CUDA libraries; a
per-pid temp file and an atomic rename keep loader worker processes from
seeing a torn library.  Every entry point releases the GIL (plain ctypes
calls), so the loader's prefetch threads decode in parallel.

``native_available()`` is False when no compiler is present or the
library's ABI version differs from :data:`_ABI`; the OpenRooms loader then
decodes with cv2.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "rgbe_decode.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CC_FLAGS = ("-O3", "-fPIC", "-shared")

# Must equal rgbe_abi_version() in rgbe_decode.c: a library with another
# exported surface is refused, not called through wrong argtypes.
_ABI = 2

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(
        SRC.read_bytes() + " ".join(CC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"rgbe_decode-{digest[:16]}.so"


def _build(target: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = f"{target}.tmp.{os.getpid()}"
    for cc in ("cc", "gcc", "clang"):
        try:
            subprocess.run([cc, *CC_FLAGS, "-o", tmp, str(SRC), "-lm"],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            continue
        os.replace(tmp, target)
        return True
    return False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        target = library_path()
        if not target.is_file() and not _build(target):
            return None
        try:
            lib = ctypes.CDLL(str(target))
            abi = lib.rgbe_abi_version
        except (OSError, AttributeError):
            return None
        abi.restype = ctypes.c_long
        abi.argtypes = []
        if abi() != _ABI:
            return None
        lib.rgbe_dims.restype = ctypes.c_int
        lib.rgbe_dims.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
        ]
        lib.rgbe_decode_pooled.restype = ctypes.c_int
        lib.rgbe_decode_pooled.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_float),
            ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.c_long, ctypes.c_long, ctypes.c_float,
        ]
        lib.rgbe_decode.restype = ctypes.c_int
        lib.rgbe_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_float),
            ctypes.c_long, ctypes.c_long,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    """Build (once) and load the library; False where that fails."""
    return _load() is not None


def _require_lib():
    lib = _load()
    if lib is None:
        raise RuntimeError("the native RGBE decoder is unavailable (no C "
                           "compiler, or an ABI mismatch)")
    return lib


def decode_rgbe_pooled(path: str, rows: int, cols: int, eh0: int, ew0: int,
                       eh: int, ew: int, scale: float = 1.0) -> np.ndarray:
    """Decode a [rows*eh0, cols*ew0] RGBE file straight into the pooled
    [rows, cols, eh*ew, 3] float32 envmap tensor, channels in cv2's BGR
    order (the reference's envmap reader does not flip them).  ``scale``
    is folded into the pooling weight.  Raises ValueError on a malformed
    or mismatched file."""
    lib = _require_lib()
    with open(path, "rb") as f:
        buf = f.read()
    out = np.zeros((rows, cols, eh * ew, 3), np.float32)
    rc = lib.rgbe_decode_pooled(
        buf, len(buf), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        rows, cols, eh0, ew0, eh, ew, float(scale),
    )
    if rc != 0:
        raise ValueError(f"rgbe_decode_pooled({path}) failed: {rc}")
    return out


def decode_rgbe(path: str) -> np.ndarray:
    """Full-resolution decode -> [H, W, 3] float32 in BGR order, equal to
    ``cv2.imread(path, -1)`` (byte * 2^(E-136), 0 when E == 0).  Raises
    ValueError on a malformed file."""
    lib = _require_lib()
    with open(path, "rb") as f:
        buf = f.read()
    h_c, w_c = ctypes.c_long(), ctypes.c_long()
    if lib.rgbe_dims(buf, len(buf), ctypes.byref(h_c),
                     ctypes.byref(w_c)) != 0:
        raise ValueError(f"bad RGBE header in {path}")
    h, w = h_c.value, w_c.value
    if h <= 0 or w <= 0 or h * w > (1 << 30):
        raise ValueError(f"implausible RGBE dims {h}x{w} in {path}")
    out = np.empty((h, w, 3), np.float32)
    rc = lib.rgbe_decode(
        buf, len(buf), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        h, w,
    )
    if rc != 0:
        raise ValueError(f"rgbe_decode({path}) failed: {rc}")
    return out
