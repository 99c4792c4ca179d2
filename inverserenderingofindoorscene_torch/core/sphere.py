"""Hemisphere direction grids and solid-angle weights (numpy; a copy of the
JAX package's ``core/sphere.py``).

The lighting model discretizes the upper hemisphere (around the surface
normal) into an ``env_height x env_width`` grid of directions in the local
tangent frame: azimuth centers span [-pi, pi) and elevation centers span
(0, pi/2), with solid-angle quadrature weight ``sin(El) * pi^2 / (W * H)``.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def hemisphere_dirs(env_height: int = 8, env_width: int = 16) -> np.ndarray:
    """Unit directions of the hemisphere grid, shape [env_height*env_width, 3].

    Component order is (x, y, z) in the local frame whose z axis is the
    surface normal: x = sin(El)cos(Az), y = sin(El)sin(Az), z = cos(El).
    """
    az = ((np.arange(env_width) + 0.5) / env_width - 0.5) * 2 * np.pi
    el = ((np.arange(env_height) + 0.5) / env_height) * np.pi / 2.0
    az, el = np.meshgrid(az, el)
    lx = np.sin(el) * np.cos(az)
    ly = np.sin(el) * np.sin(az)
    lz = np.cos(el)
    return np.stack([lx, ly, lz], axis=-1).reshape(-1, 3).astype(np.float64)


@functools.lru_cache(maxsize=None)
def hemisphere_weights(env_height: int = 8, env_width: int = 16) -> np.ndarray:
    """Solid-angle quadrature weights, shape [env_height*env_width].

    weight = sin(El) * pi^2 / (env_width * env_height); the pi^2/(W*H)
    factor is dAz*dEl = (2pi/W)*(pi/2/H).
    """
    el = ((np.arange(env_height) + 0.5) / env_height) * np.pi / 2.0
    w = np.sin(el) * np.pi * np.pi / env_width / env_height
    return np.repeat(w, env_width).reshape(env_height, env_width).reshape(-1)
