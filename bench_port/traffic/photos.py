"""Seeded inputs made on the device: indoor-like photos for serving and
training batches of such scenes with their ground truth.

Photos follow the recipe of the measured package's OpenRooms-format
fixture: Voronoi patches of albedo with a mild smooth modulation, normals
and depth from one smooth height field with a planar tilt, roughness half
smooth and half tied to the albedo's luminance, and a spatially varying
lighting of three SG lobes (one narrow and bright), rendered with the
reference's shading on the lighting grid and upsampled.  The refinement's
grids then have the vertex counts of piecewise-smooth photos, not of
noise.  Every draw comes from a ``torch.Generator`` on the device, in a
few large calls, so a seed gives the same tensors and set-up stays short.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench_port.reference import sg
from bench_port.weights import generator

N_PATCHES = 10
N_LOBES = 3


def _smooth(g, n, ch, hw, cell, device):
    """[n, ch, H, W] low-frequency fields in [0, 1], each min-max
    normalised."""
    h, w = hw
    small = torch.rand((n, ch, max(2, h // cell) + 1, max(2, w // cell) + 1),
                       generator=g, device=device)
    big = F.interpolate(small, size=(h, w), mode="bicubic",
                        align_corners=False)
    lo = big.amin(dim=(1, 2, 3), keepdim=True)
    hi = big.amax(dim=(1, 2, 3), keepdim=True)
    return (big - lo) / torch.clamp(hi - lo, min=1e-6)


def _fields(g, n, hw, device):
    """albedo [n,3,H,W], normal [n,3,H,W], rough01 [n,1,H,W], depth
    [n,1,H,W] (NCHW)."""
    h, w = hw
    pts = torch.rand((n, N_PATCHES, 2), generator=g, device=device)
    cols = 0.1 + 0.85 * torch.rand((n, N_PATCHES, 3), generator=g,
                                   device=device)
    yy, xx = torch.meshgrid(torch.linspace(0, 1, h, device=device),
                            torch.linspace(0, 1, w, device=device),
                            indexing="ij")
    grid = torch.stack([yy, xx], dim=-1).reshape(1, h * w, 1, 2)
    nearest = ((grid - pts[:, None]) ** 2).sum(-1).argmin(-1)  # [n, HW]
    albedo = torch.gather(cols, 1, nearest[..., None].expand(-1, -1, 3))
    albedo = albedo.reshape(n, h, w, 3).permute(0, 3, 1, 2)
    albedo = torch.clamp(albedo * (0.9 + 0.2 * _smooth(g, n, 1, hw, 20,
                                                       device)), 0.05, 1.0)
    tilt = torch.rand((n, 2, 1, 1), generator=g, device=device) - 0.5
    relief = 0.5 + 0.8 * torch.rand((n, 1, 1, 1), generator=g, device=device)
    surf = (relief * _smooth(g, n, 1, hw, 20, device)
            + tilt[:, :1] * (xx - 0.5) + tilt[:, 1:] * (yy - 0.5))
    gain = 12.0 + 18.0 * torch.rand((n, 1, 1, 1), generator=g, device=device)
    gy, gx = torch.gradient(surf * gain, dim=(2, 3))
    normal = torch.cat([gx, gy, torch.ones_like(gx)], dim=1)
    normal = normal / torch.linalg.vector_norm(normal, dim=1, keepdim=True)
    base = 2.2 + torch.rand((n, 1, 1, 1), generator=g, device=device)
    depth = torch.clamp(base - surf, 0.6, 6.0)
    lum = albedo.mean(1, keepdim=True)
    lo = lum.amin(dim=(2, 3), keepdim=True)
    hi = lum.amax(dim=(2, 3), keepdim=True)
    lum = (lum - lo) / torch.clamp(hi - lo, min=1e-6)
    rough01 = 0.15 + 0.75 * (0.5 * _smooth(g, n, 1, hw, 16, device)
                             + 0.5 * lum)
    return albedo, normal, rough01, depth


def _lighting(g, n, depth_g, rc, eh, ew, device):
    """[n, r, c, D, 3] SG envmaps: three lobes, one narrow and bright, a
    smooth spatial modulation and an intensity falling with depth."""
    axis = torch.randn((n, N_LOBES, 3), generator=g, device=device)
    axis[..., 2] = axis[..., 2].abs() + 0.5
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    u = torch.rand((n, N_LOBES, 5), generator=g, device=device)
    lamb = 2.0 + 13.0 * u[..., 0]
    lamb[:, 0] = 15.0 + 25.0 * u[:, 0, 0]
    amp = 0.3 + 1.7 * u[..., 1:4]
    amp[:, 0] = (2.0 + 2.0 * u[:, 0, 4:5]) * (0.7 + 0.3 * u[:, 0, 1:4])
    mod = 0.25 + 0.75 * _smooth(g, n, N_LOBES, rc, 24, device)  # [n,K,r,c]
    mod = mod * ((2.4 / depth_g) ** (0.8 + 0.4 * torch.rand(
        (n, 1, 1, 1), generator=g, device=device)))
    ls = torch.as_tensor(sg.hemisphere_dirs(eh, ew), dtype=torch.float32,
                         device=device)
    e = torch.exp(lamb[..., None] * (axis @ ls.T - 1.0))  # [n, K, D]
    # env[n, r, c, d, x] = sum_k mod[n,k,r,c] e[n,k,d] amp[n,k,x]
    return torch.einsum("nkrc,nkd,nkx->nrcdx", mod, e, amp)


def make_scenes(seed: int, label, n: int, im_hw, env_rc, env_hw, device,
                fov: float = 57.0, chunk: int = 4, with_env: bool = False):
    """``n`` scenes as NHWC float32 tensors: the rendered linear image
    ``im`` [n,H,W,3] (not yet exposed) and its ground truth ``albedo``,
    ``normal``, ``rough`` (in [-1, 1]), ``depth``, the object and area
    masks ``seg_brdf`` / ``seg_all`` (bands of a smooth field, as the
    fixture's masks); ``with_env`` adds the lighting the image was
    rendered under, ``env_gt`` [n,r,c,D,3]."""
    g = generator(device, seed, "scenes", label)
    parts = []
    for start in range(0, n, chunk):
        m = min(chunk, n - start)
        albedo, normal, rough01, depth = _fields(g, m, im_hw, device)
        band = _smooth(g, m, 1, im_hw, 16, device)
        pool = [F.adaptive_avg_pool2d(x, env_rc)
                for x in (albedo, normal, rough01, depth)]
        nrm = pool[1] / torch.linalg.vector_norm(pool[1], dim=1, keepdim=True)
        env = _lighting(g, m, pool[3], env_rc, *env_hw, device)

        def nhwc(x):
            return x.permute(0, 2, 3, 1)

        diffuse, specular = sg.render_envmap(
            nhwc(pool[0]), nhwc(nrm), nhwc(2.0 * pool[2] - 1.0), env, fov,
            *env_hw)
        im_g = torch.clamp(diffuse + specular, min=0.0).permute(0, 3, 1, 2)
        im = F.interpolate(im_g, size=tuple(im_hw), mode="bilinear",
                           align_corners=False)
        obj = (band < 0.75).float()
        part = {"im": nhwc(im), "albedo": nhwc(albedo),
                "normal": nhwc(normal), "rough": nhwc(2.0 * rough01 - 1.0),
                "depth": nhwc(depth), "seg_brdf": nhwc(obj),
                "seg_all": nhwc(obj + ((band >= 0.75) & (band < 0.9)).float())}
        if with_env:
            part["env_gt"] = env
        parts.append(part)
    return {k: torch.cat([p[k] for p in parts]).contiguous() for k in parts[0]}


def make_photos(seed: int, n: int, im_hw, env_rc, env_hw, device):
    """``n`` photos: (im [n,H,W,3], im_small [n,r,c,3]), the linear image
    divided by its maximum and its area resize to the lighting grid (what
    ``load_real_image`` hands the renderer)."""
    im = make_scenes(seed, "photos", n, im_hw, env_rc, env_hw, device)["im"]
    im = im / torch.clamp(im.amax(dim=(1, 2, 3), keepdim=True), min=1e-6)
    small = F.adaptive_avg_pool2d(im.permute(0, 3, 1, 2), env_rc)
    return im.contiguous(), small.permute(0, 2, 3, 1).contiguous()


def make_train_batch(seed: int, index: int, batch: int, im_hw, env_rc,
                     env_hw, device, with_env: bool = False) -> dict:
    """A training batch of ``batch`` distinct scenes, exposed as the
    OpenRooms loader does (the image scaled so that its 95th-percentile
    intensity under the masks is 0.9, then clipped to [0, 1]): im,
    albedo, normal, rough, depth, seg_brdf, seg_all; ``with_env`` adds
    the scenes' lighting ``env_gt`` [batch, r, c, D, 3] on the lighting
    grid and ``env_ind`` [batch, 1] (every envmap valid)."""
    s = make_scenes(seed, ("batch", index), batch, im_hw, env_rc, env_hw,
                    device, with_env=with_env)
    b = s["im"].shape[0]
    masked = (s["im"] * s["seg_all"]).reshape(b, -1)
    scale = 0.9 / torch.clamp(torch.quantile(masked, 0.95, dim=1), min=1e-6)
    scale = scale.reshape(b, 1, 1, 1)
    s["im"] = torch.clamp(s["im"] * scale, 0.0, 1.0)
    if with_env:
        s["env_gt"] = s["env_gt"] * scale.reshape(b, 1, 1, 1, 1)
        s["env_ind"] = torch.ones((b, 1), device=s["im"].device)
    return s
