"""Differentiable per-pixel shading against a hemisphere envmap.

Evaluates a Lambertian + GGX microfacet BRDF against the per-pixel
``env_height x env_width`` environment map and integrates with the
solid-angle quadrature weights, returning separate diffuse and specular
images.  This is the plain PyTorch version of the shading half of the CUDA
kernel in ``ops/csrc/sg_render_env.cu``; its semantics are those of the JAX
package's ``core/brdf.py``:

  * tangent frame from the normal with up=(0,1,0):
      camy = normalize(up - (up.n) n),  camx = -normalize(camy x n)
  * world light dir l = lx*camx + ly*camy + lz*n
  * half vector h = normalize((v + l)/2)
  * Schlick Fresnel with F0 and the 2^((-5.55472 vdh - 6.98316) vdh) approx
  * GGX D/G with k = (r+1)^2/8, alpha = r^2 (r in [0,1])
  * spec = alpha^2 * F / clamp(4 pi (ndh^2(alpha^2-1)+1)^2
                               * (ndv(1-k)+k) * (ndl(1-k)+k), 1e-6, 4 pi)
  * out_d = sum_l albedo/pi * ndl * env(l) * w(l)
    out_s = sum_l spec      * ndl * env(l) * w(l)

All tensors are pixel-leading ([B, H, W, C], NHWC).
"""

from __future__ import annotations

import math

import torch

from inverserenderingofindoorscene_torch.core import tables


def tangent_frame(normal: torch.Tensor):
    """Per-pixel tangent frame (camx, camy) for z = normal.

    normal: [..., 3] unit normals. Returns (camx, camy) each [..., 3].
    """
    up = tables.up(normal.dtype, normal.device)
    proj = torch.sum(up * normal, dim=-1, keepdim=True) * normal
    camy = up - proj
    norm = torch.linalg.vector_norm
    camy = camy / norm(camy, dim=-1, keepdim=True).clamp_min(1e-12)
    camx = -torch.linalg.cross(camy, normal, dim=-1)
    camx = camx / norm(camx, dim=-1, keepdim=True).clamp_min(1e-12)
    return camx, camy


def render_envmap(
    albedo: torch.Tensor,
    normal: torch.Tensor,
    rough: torch.Tensor,
    envmap: torch.Tensor,
    fov_deg: float = 57.0,
    f0: float = 0.05,
    env_height: int = 8,
    env_width: int = 16,
):
    """Shade each pixel against its environment map.

    albedo [B,H,W,3] in [0,1]; normal [B,H,W,3] (re-normalized inside);
    rough [B,H,W,1] in [-1,1]; envmap [B,H,W,D,3], D = env_height*env_width.
    Returns (diffuse, specular), each [B,H,W,3].
    """
    h_img, w_img = albedo.shape[-3], albedo.shape[-2]
    dtype, dev = albedo.dtype, albedo.device
    ls = tables.hemisphere(env_height, env_width, dtype, dev)  # [D,3]
    wgt = tables.hemisphere_weight(env_height, env_width, dtype, dev)  # [D]
    v = tables.view(h_img, w_img, fov_deg, dtype, dev)  # [H,W,3]

    normal = normal / torch.sqrt(
        torch.clamp(torch.sum(normal * normal, dim=-1, keepdim=True), 1e-6, 1.0)
    )
    camx, camy = tangent_frame(normal)

    # world-space light directions: [B,H,W,D,3]
    l = (
        ls[:, 0, None] * camx[..., None, :]
        + ls[:, 1, None] * camy[..., None, :]
        + ls[:, 2, None] * normal[..., None, :]
    )
    h = (v[..., None, :] + l) / 2.0
    h = h / torch.sqrt(
        torch.clamp(torch.sum(h * h, dim=-1, keepdim=True), min=1e-6)
    )

    vdh = torch.sum(v[..., None, :] * h, dim=-1)  # [B,H,W,D]
    frac0 = f0 + (1.0 - f0) * torch.exp2((-5.55472 * vdh - 6.98316) * vdh)

    diffuse_b = albedo / math.pi
    r = (rough[..., 0] + 1.0) / 2.0  # [B,H,W]
    k = (r + 1.0) ** 2 / 8.0
    alpha2 = (r * r) ** 2

    ndv = torch.clamp(torch.sum(normal * v, dim=-1), 0.0, 1.0)
    ndh = torch.clamp(torch.sum(normal[..., None, :] * h, dim=-1), 0.0, 1.0)
    ndl = torch.clamp(torch.sum(normal[..., None, :] * l, dim=-1), 0.0, 1.0)

    frac = alpha2[..., None] * frac0
    nom0 = ndh * ndh * (alpha2[..., None] - 1.0) + 1.0
    nom1 = ndv[..., None] * (1.0 - k[..., None]) + k[..., None]
    nom2 = ndl * (1.0 - k[..., None]) + k[..., None]
    four_pi = 4.0 * math.pi
    nom = torch.clamp(four_pi * nom0 * nom0 * nom1 * nom2, 1e-6, four_pi)
    spec = frac / nom  # [B,H,W,D]

    env_w = envmap * wgt[:, None]  # [B,H,W,D,3]
    diffuse = diffuse_b * torch.sum(ndl[..., None] * env_w, dim=-2)
    specular = torch.sum((spec * ndl)[..., None] * env_w, dim=-2)
    return diffuse, specular
