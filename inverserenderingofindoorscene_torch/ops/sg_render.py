"""Fused SG decode + shading + envmap for serving: the CUDA kernel's wrapper
and its plain PyTorch version.

``render_sg_env`` is the counterpart of the JAX package's
``ops/sg_render.py:render_sg_env`` (the Pallas kernel ``_fwd_env5_kernel``)
with the same NHWC API.  On CUDA tensors it launches the hand-written
kernel in ``csrc/sg_render_env.cu`` (design and bound are noted there); on
CPU tensors it runs :func:`render_sg_env_plain`, the same function in
plain PyTorch.  There is no other route: a CUDA tensor the kernel does not
take raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from inverserenderingofindoorscene_torch.core.brdf import render_envmap
from inverserenderingofindoorscene_torch.core.camera import view_dirs
from inverserenderingofindoorscene_torch.core.sg import sg_to_envmap
from inverserenderingofindoorscene_torch.core.sphere import (
    hemisphere_dirs,
    hemisphere_weights,
)
from inverserenderingofindoorscene_torch.ops import build

# dynamic shared memory a block may take without an opt-in attribute
_SMEM_LIMIT = 48 * 1024


def render_sg_env_plain(albedo, normal, rough, axis, lamb, weight,
                        fov_deg=57.0, f0=0.05, env_height=8, env_width=16):
    """``render_envmap(albedo, normal, rough, sg_to_envmap(axis, lamb,
    weight))`` plus that envmap: the kernel's function in plain PyTorch."""
    env = sg_to_envmap(axis, lamb, weight, env_height, env_width)
    diffuse, specular = render_envmap(
        albedo, normal, rough, env, fov_deg=fov_deg, f0=f0,
        env_height=env_height, env_width=env_width,
    )
    return diffuse, specular, env


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("sg_render_env")
    p = ctypes.c_void_p
    lib.sg_render_env_f32.argtypes = [p] * 11 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, p,
    ]
    lib.sg_render_env_f32.restype = ctypes.c_int
    lib.sg_render_env_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.sg_render_env_smem_bytes.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=16)
def _dir_consts(env_height, env_width, device) -> torch.Tensor:
    """[D, 4] f32: hemisphere direction xyz and solid-angle weight."""
    c = np.concatenate(
        [hemisphere_dirs(env_height, env_width),
         hemisphere_weights(env_height, env_width)[:, None]], axis=1,
    )
    return torch.as_tensor(c.astype(np.float32), device=device)


@functools.lru_cache(maxsize=16)
def _view(height, width, fov_deg, device) -> torch.Tensor:
    """[H*W, 3] f32 view vectors (float64 numpy cast to f32)."""
    v = view_dirs(height, width, fov_deg).reshape(-1, 3)
    return torch.as_tensor(v.astype(np.float32), device=device)


def render_sg_env(albedo, normal, rough, axis, lamb, weight, fov_deg=57.0,
                  f0=0.05, env_height=8, env_width=16):
    """Fused SG decode + shading + envmap output, NHWC API (serving).

    albedo [B,H,W,3], normal [B,H,W,3], rough [B,H,W,1], axis
    [B,H,W,K,3], lamb [B,H,W,K] (physical sharpness), weight [B,H,W,K,3]
    (physical amplitude).  Returns diffuse, specular [B,H,W,3] and the
    decoded envmap [B,H,W,D,3], D = env_height*env_width.  Forward only.

    PRECONDITION (kernel route): |normal| <= 1 per pixel, as for the JAX
    kernel; the plain version has no such precondition.  CUDA tensors must
    be contiguous float32 on one device.  ``render_sg_env.launches``
    counts kernel launches.
    """
    if albedo.device.type == "cpu":
        return render_sg_env_plain(albedo, normal, rough, axis, lamb, weight,
                                   fov_deg, f0, env_height, env_width)
    if albedo.device.type != "cuda":
        raise ValueError(f"render_sg_env: unsupported device {albedo.device}")
    b, h, w = albedo.shape[:3]
    k = lamb.shape[-1]
    d = env_height * env_width
    expect = {
        "albedo": (albedo, (b, h, w, 3)),
        "normal": (normal, (b, h, w, 3)),
        "rough": (rough, (b, h, w, 1)),
        "axis": (axis, (b, h, w, k, 3)),
        "lamb": (lamb, (b, h, w, k)),
        "weight": (weight, (b, h, w, k, 3)),
    }
    for name, (x, shape) in expect.items():
        if tuple(x.shape) != shape:
            raise ValueError(
                f"render_sg_env: {name} {tuple(x.shape)} != {shape}")
        if x.dtype != torch.float32 or x.device != albedo.device:
            raise ValueError(f"render_sg_env: {name} must be float32 on "
                             f"{albedo.device}, got {x.dtype} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"render_sg_env: {name} must be contiguous")
    if d > 1024:
        raise ValueError(f"render_sg_env: {d} directions > 1024 threads")
    lib = _lib()
    if lib.sg_render_env_smem_bytes(k, d) > _SMEM_LIMIT:
        raise ValueError(f"render_sg_env: K={k}, D={d} exceed shared memory")

    n = b * h * w
    dev = albedo.device
    diffuse = torch.empty((b, h, w, 3), dtype=torch.float32, device=dev)
    specular = torch.empty_like(diffuse)
    env = torch.empty((b, h, w, d, 3), dtype=torch.float32, device=dev)
    if n == 0:
        return diffuse, specular, env
    view = _view(h, w, float(fov_deg), dev)
    dirs = _dir_consts(env_height, env_width, dev)
    err = lib.sg_render_env_f32(
        albedo.data_ptr(), normal.data_ptr(), rough.data_ptr(),
        axis.data_ptr(), lamb.data_ptr(), weight.data_ptr(),
        view.data_ptr(), dirs.data_ptr(), diffuse.data_ptr(),
        specular.data_ptr(), env.data_ptr(), n, h * w, k, d, float(f0),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"sg_render_env launch failed: cudaError {err}")
    render_sg_env.launches += 1
    return diffuse, specular, env


render_sg_env.launches = 0
