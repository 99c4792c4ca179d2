"""Pinhole camera ray geometry (numpy; a copy of the JAX package's
``core/camera.py``, kept here so the port imports nothing of that package).

Builds the per-pixel unit view vector v (surface -> camera) for a camera at
the origin looking down -z with a given horizontal field of view: x spans
[-tan(fov/2), tan(fov/2)] across columns, y spans top->bottom from +yRange
to -yRange (image row 0 is the top), z = -1, and v = -p/|p|.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def view_dirs(
    height: int, width: int, fov_deg: float = 57.0, dtype=np.float64
) -> np.ndarray:
    """Per-pixel unit view vectors, shape [height, width, 3]."""
    fov = fov_deg / 180.0 * np.pi
    x_range = np.tan(fov / 2.0)
    y_range = float(height) / float(width) * x_range
    x, y = np.meshgrid(
        np.linspace(-x_range, x_range, width),
        np.linspace(-y_range, y_range, height),
    )
    y = np.flip(y, axis=0)
    z = -np.ones((height, width), dtype=np.float64)
    p = np.stack([x, y, z], axis=-1)
    v = -p / np.sqrt(np.maximum(np.sum(p * p, axis=-1, keepdims=True), 1e-12))
    return v.astype(dtype)
