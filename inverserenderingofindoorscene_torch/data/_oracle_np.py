"""Float64 numpy shading oracle for the fixture writer.

The port's own copy of the functions of the repository's
``tests/oracle_np.py`` that ``data/fixture.py`` renders with
(``hemisphere_dirs_np``, ``hemisphere_weights_np``, ``view_dirs_np``,
``render_envmap_np``), so the package imports nothing of ``tests``.  The
arithmetic is the same line for line: a fixture written with it is
byte-identical to the JAX package's.  Layouts are NHWC.
"""

from __future__ import annotations

import numpy as np


def hemisphere_dirs_np(env_height=8, env_width=16):
    az = ((np.arange(env_width) + 0.5) / env_width - 0.5) * 2 * np.pi
    el = ((np.arange(env_height) + 0.5) / env_height) * np.pi / 2.0
    az, el = np.meshgrid(az, el)
    ls = np.stack(
        [np.sin(el) * np.cos(az), np.sin(el) * np.sin(az), np.cos(el)], axis=-1
    )
    return ls.reshape(-1, 3)


def hemisphere_weights_np(env_height=8, env_width=16):
    az = ((np.arange(env_width) + 0.5) / env_width - 0.5) * 2 * np.pi
    el = ((np.arange(env_height) + 0.5) / env_height) * np.pi / 2.0
    az, el = np.meshgrid(az, el)
    return (np.sin(el) * np.pi * np.pi / env_width / env_height).reshape(-1)


def view_dirs_np(height, width, fov_deg=57.0):
    fov = fov_deg / 180.0 * np.pi
    xr = np.tan(fov / 2.0)
    yr = float(height) / float(width) * xr
    x, y = np.meshgrid(np.linspace(-xr, xr, width), np.linspace(-yr, yr, height))
    y = np.flip(y, axis=0)
    p = np.stack([x, y, -np.ones_like(x)], axis=-1)
    return -p / np.sqrt(np.maximum(np.sum(p * p, axis=-1, keepdims=True), 1e-12))


def render_envmap_np(albedo, normal, rough, envmap, fov_deg=57.0, f0=0.05,
                     env_height=8, env_width=16):
    """NHWC shading oracle; equations from models.py:461-522.

    albedo [B,H,W,3], normal [B,H,W,3], rough [B,H,W,1],
    envmap [B,H,W,D,3]. Returns (diffuse, specular) [B,H,W,3].
    """
    b, h, w, _ = albedo.shape
    ls = hemisphere_dirs_np(env_height, env_width)
    wgt = hemisphere_weights_np(env_height, env_width)
    v = view_dirs_np(h, w, fov_deg)  # [H,W,3]

    normal = normal / np.sqrt(
        np.clip(np.sum(normal**2, axis=-1, keepdims=True), 1e-6, 1.0)
    )

    up = np.array([0.0, 1.0, 0.0])
    proj = np.sum(up * normal, axis=-1, keepdims=True) * normal
    camy = up - proj
    camy = camy / np.maximum(
        np.linalg.norm(camy, axis=-1, keepdims=True), 1e-12
    )
    cx = np.cross(camy, normal)
    camx = -cx / np.maximum(np.linalg.norm(cx, axis=-1, keepdims=True), 1e-12)

    l = (
        ls[:, 0, None] * camx[..., None, :]
        + ls[:, 1, None] * camy[..., None, :]
        + ls[:, 2, None] * normal[..., None, :]
    )  # [B,H,W,D,3]

    hv = (v[..., None, :] + l) / 2.0
    hv = hv / np.sqrt(
        np.maximum(np.sum(hv * hv, axis=-1, keepdims=True), 1e-6)
    )

    vdh = np.sum(v[..., None, :] * hv, axis=-1)
    frac0 = f0 + (1 - f0) * np.power(2.0, (-5.55472 * vdh - 6.98316) * vdh)

    diffuse_b = albedo / np.pi
    r = (rough[..., 0] + 1.0) / 2.0
    k = (r + 1.0) ** 2 / 8.0
    alpha2 = (r * r) ** 2

    ndv = np.clip(np.sum(normal * v, axis=-1), 0, 1)
    ndh = np.clip(np.sum(normal[..., None, :] * hv, axis=-1), 0, 1)
    ndl = np.clip(np.sum(normal[..., None, :] * l, axis=-1), 0, 1)

    frac = alpha2[..., None] * frac0
    nom0 = ndh * ndh * (alpha2[..., None] - 1) + 1
    nom1 = ndv[..., None] * (1 - k[..., None]) + k[..., None]
    nom2 = ndl * (1 - k[..., None]) + k[..., None]
    nom = np.clip(4 * np.pi * nom0 * nom0 * nom1 * nom2, 1e-6, 4 * np.pi)
    spec = frac / nom

    env_w = envmap * wgt[:, None]
    diffuse = diffuse_b * np.sum(ndl[..., None] * env_w, axis=-2)
    specular = np.sum((spec * ndl)[..., None] * env_w, axis=-2)
    return diffuse, specular
