"""Spherical-Gaussian lighting and hemisphere shading (``models.py``
output2env / renderingLayer), plain float32 on NHWC tensors.

Per pixel, ``K`` lobes (unit axis in the pixel's tangent frame, sharpness
``lamb``, RGB ``weight``) decode to an ``env_height x env_width``
hemisphere envmap; a Lambertian + GGX BRDF is integrated against it with
solid-angle weights.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TAN_SQUASH_EPS = 0.999


def hemisphere_dirs(env_height: int, env_width: int) -> np.ndarray:
    """[D, 3] local directions: azimuth centres over [-pi, pi), elevation
    centres over (0, pi/2)."""
    az = ((np.arange(env_width) + 0.5) / env_width - 0.5) * 2 * np.pi
    el = ((np.arange(env_height) + 0.5) / env_height) * np.pi / 2.0
    az, el = np.meshgrid(az, el)
    return np.stack([np.sin(el) * np.cos(az), np.sin(el) * np.sin(az),
                     np.cos(el)], axis=-1).reshape(-1, 3)


def hemisphere_weights(env_height: int, env_width: int) -> np.ndarray:
    """[D] solid angles sin(el) pi^2 / (W H)."""
    el = ((np.arange(env_height) + 0.5) / env_height) * np.pi / 2.0
    w = np.sin(el) * np.pi * np.pi / env_width / env_height
    return np.repeat(w, env_width)


def view_dirs(height: int, width: int, fov_deg: float) -> np.ndarray:
    """[H, W, 3] unit vectors from the surface to a pinhole camera at the
    origin looking down -z, horizontal fov ``fov_deg``, row 0 at the top."""
    fov = fov_deg / 180.0 * np.pi
    xr = np.tan(fov / 2.0)
    yr = float(height) / float(width) * xr
    x, y = np.meshgrid(np.linspace(-xr, xr, width),
                       np.linspace(-yr, yr, height))
    y = np.flip(y, axis=0)
    p = np.stack([x, y, -np.ones_like(x)], axis=-1)
    return -p / np.sqrt(np.maximum(np.sum(p * p, axis=-1, keepdims=True),
                                   1e-12))


def _t(a, like):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=like.dtype,
                           device=like.device)


def unsquash(x: torch.Tensor) -> torch.Tensor:
    return torch.tan((math.pi / 2.0) * (TAN_SQUASH_EPS * x))


def dot3(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def sg_to_envmap(axis, lamb, weight, env_height: int, env_width: int):
    """axis [..., K, 3], lamb [..., K], weight [..., K, 3] (physical) ->
    envmap [..., D, 3]."""
    ls = _t(hemisphere_dirs(env_height, env_width), axis)
    cos = dot3(axis[..., :, None, :], ls)
    e = torch.exp(lamb[..., :, None] * (cos - 1.0))
    return torch.sum(e[..., None] * weight[..., :, None, :], dim=-3)


def render_envmap(albedo, normal, rough, envmap, fov_deg: float,
                  env_height: int, env_width: int, f0: float = 0.05,
                  rounding=None):
    """Diffuse and specular [B,h,w,3] of albedo [B,h,w,3], normal [B,h,w,3],
    rough [B,h,w,1] in [-1, 1] against envmap [B,h,w,D,3], in the inputs'
    dtype.  ``rounding`` (a control's) rounds both operands of the sums
    over the D directions, as a tensor core's contraction would."""
    h_img, w_img = albedo.shape[-3], albedo.shape[-2]
    ls = _t(hemisphere_dirs(env_height, env_width), albedo)
    wgt = _t(hemisphere_weights(env_height, env_width), albedo)
    v = _t(view_dirs(h_img, w_img, fov_deg), albedo)
    normal = normal / torch.sqrt(torch.clamp(
        torch.sum(normal * normal, dim=-1, keepdim=True), 1e-6, 1.0))
    up = _t(np.array([0.0, 1.0, 0.0]), albedo)
    camy = up - torch.sum(up * normal, dim=-1, keepdim=True) * normal
    camy = camy / torch.linalg.vector_norm(
        camy, dim=-1, keepdim=True).clamp_min(1e-12)
    camx = -torch.linalg.cross(camy, normal, dim=-1)
    camx = camx / torch.linalg.vector_norm(
        camx, dim=-1, keepdim=True).clamp_min(1e-12)
    l = (ls[:, 0, None] * camx[..., None, :]
         + ls[:, 1, None] * camy[..., None, :]
         + ls[:, 2, None] * normal[..., None, :])
    h = (v[..., None, :] + l) / 2.0
    h = h / torch.sqrt(torch.clamp(torch.sum(h * h, dim=-1, keepdim=True),
                                   min=1e-6))
    vdh = torch.sum(v[..., None, :] * h, dim=-1)
    frac0 = f0 + (1.0 - f0) * torch.exp2((-5.55472 * vdh - 6.98316) * vdh)
    r = (rough[..., 0] + 1.0) / 2.0
    k = (r + 1.0) ** 2 / 8.0
    alpha2 = (r * r) ** 2
    ndv = torch.clamp(torch.sum(normal * v, dim=-1), 0.0, 1.0)
    ndh = torch.clamp(torch.sum(normal[..., None, :] * h, dim=-1), 0.0, 1.0)
    ndl = torch.clamp(torch.sum(normal[..., None, :] * l, dim=-1), 0.0, 1.0)
    nom0 = ndh * ndh * (alpha2[..., None] - 1.0) + 1.0
    nom1 = ndv[..., None] * (1.0 - k[..., None]) + k[..., None]
    nom2 = ndl * (1.0 - k[..., None]) + k[..., None]
    four_pi = 4.0 * math.pi
    nom = torch.clamp(four_pi * nom0 * nom0 * nom1 * nom2, 1e-6, four_pi)
    spec = alpha2[..., None] * frac0 / nom
    env_w = envmap * wgt[:, None]
    brdf_d, brdf_s = ndl, spec * ndl
    if rounding is not None:
        env_w, brdf_d, brdf_s = (rounding(x) for x in (env_w, brdf_d, brdf_s))
    diffuse = albedo / math.pi * torch.sum(brdf_d[..., None] * env_w, dim=-2)
    specular = torch.sum(brdf_s[..., None] * env_w, dim=-2)
    return diffuse, specular
