"""SG lighting kernels: the CUDA kernels' wrappers, their plain PyTorch
versions and the autograd Functions of the training pair.

Counterparts of the JAX package's ``ops/sg_render.py``, with its NHWC API:

* ``render_sg_env`` (serving, forward only; ``csrc/sg_render_env.cu``);
* ``render_sg`` (decode + shading, differentiable; its forward is the
  serving kernel's walk without the envmap stores, ``csrc/sg_render_env.cu``,
  its backward ``csrc/sg_render.cu``);
* ``sg_envmap`` (decode to the per-pixel envmap, differentiable; its
  forward is the same walk without the shading, ``csrc/sg_render_env.cu``,
  its backward ``csrc/sg_envmap.cu``).

Each kernel has a launch wrapper (``render_sg_env``, ``render_sg_fwd``,
``render_sg_bwd``, ``sg_envmap_fwd``, ``sg_envmap_bwd``) that on CUDA
tensors launches the hand-written kernel and counts it in its
``launches`` attribute, on CPU tensors runs the kernel's plain PyTorch
version, and raises for anything else: there is no other route.  The plain
versions of the backwards (``render_sg_bwd_plain``, ``sg_envmap_bwd_plain``)
are the hand-derived adjoints written out in PyTorch in the same order as
the CUDA code (``csrc/sg_common.cuh``), so that the derivation is checked
against torch.autograd and jax.vjp on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import math
from types import SimpleNamespace

import numpy as np
import torch

from inverserenderingofindoorscene_torch.core.brdf import render_envmap
from inverserenderingofindoorscene_torch.core.camera import view_dirs
from inverserenderingofindoorscene_torch.core.sg import dot3, sg_to_envmap
from inverserenderingofindoorscene_torch.core.sphere import (
    hemisphere_dirs,
    hemisphere_weights,
)
from inverserenderingofindoorscene_torch.core.tables import hemisphere
from inverserenderingofindoorscene_torch.ops import build
from inverserenderingofindoorscene_torch.utils.spans import span

# dynamic shared memory a block may take on Hopper with the opt-in
# attribute (227 KB; the render backward's and the walk's launches opt in
# above 48 KB)
_SMEM_OPTIN_LIMIT = 227 * 1024
# directions: the render backward's bound (its API's; it walks the
# directions in chunks), and the shading walk's (the envmap walk takes any
# D)
_MAX_BWD_DIRS = 128
_MAX_WALK_DIRS = 1024

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong
_SIGNATURES = {
    "sg_render_env": {
        "sg_render_env_f32": [_P] * 11 + [_LL, _I, _I, _I, _F, _P],
        "render_sg_fwd_f32": [_P] * 10 + [_LL, _I, _I, _I, _F, _P],
        "sg_envmap_fwd_f32": [_P] * 5 + [_LL, _I, _I, _P],
        "sg_walk_smem_bytes": [_I, _I],
    },
    "sg_render": {
        "render_sg_bwd_f32": [_P] * 16 + [_LL, _I, _I, _I, _F, _P],
        "render_sg_bwd_smem_bytes": [_I, _I],
    },
    "sg_envmap": {
        "sg_envmap_bwd_f32": [_P] * 8 + [_LL, _I, _I, _P],
    },
}


@functools.lru_cache(maxsize=None)
def _lib(source: str) -> ctypes.CDLL:
    lib = build.load(source)
    for fn, argtypes in _SIGNATURES[source].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _dir_table(env_height, env_width) -> np.ndarray:
    """[D, 4] float64: hemisphere direction xyz and solid-angle weight."""
    return np.concatenate(
        [hemisphere_dirs(env_height, env_width),
         hemisphere_weights(env_height, env_width)[:, None]], axis=1,
    )


@functools.lru_cache(maxsize=16)
def _dir_consts(env_height, env_width, device) -> torch.Tensor:
    """The kernels' [D, 4] f32 direction table on ``device``."""
    return torch.as_tensor(_dir_table(env_height, env_width).astype(
        np.float32), device=device)


@functools.lru_cache(maxsize=16)
def _view(height, width, fov_deg, device) -> torch.Tensor:
    """[H*W, 3] f32 view vectors (float64 numpy cast to f32)."""
    v = view_dirs(height, width, fov_deg).reshape(-1, 3)
    return torch.as_tensor(v.astype(np.float32), device=device)


def _check(fn: str, device, expect: dict) -> None:
    """Raise unless every {name: (tensor, shape)} is a contiguous float32
    tensor of that shape on ``device``."""
    for name, (x, shape) in expect.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{fn}: {name} {tuple(x.shape)} != {shape}")
        if x.dtype != torch.float32 or x.device != device:
            raise ValueError(f"{fn}: {name} must be float32 on {device}, "
                             f"got {x.dtype} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")


def _shading_inputs(fn, albedo, normal, rough, axis, lamb, weight):
    """Check the six shading inputs of a CUDA launch; returns (b, h, w, k)."""
    b, h, w = albedo.shape[:3]
    k = lamb.shape[-1]
    _check(fn, albedo.device, {
        "albedo": (albedo, (b, h, w, 3)),
        "normal": (normal, (b, h, w, 3)),
        "rough": (rough, (b, h, w, 1)),
        "axis": (axis, (b, h, w, k, 3)),
        "lamb": (lamb, (b, h, w, k)),
        "weight": (weight, (b, h, w, k, 3)),
    })
    return b, h, w, k


def _walk_inputs(fn, albedo, normal, rough, axis, lamb, weight, fov_deg,
                 env_height, env_width):
    """Check a launch of the shading walk (``render_sg_env``,
    ``render_sg_fwd``); returns the library, (b, h, w, k, d) and the view
    and direction tables."""
    b, h, w, k = _shading_inputs(fn, albedo, normal, rough, axis, lamb,
                                 weight)
    d = env_height * env_width
    if d > _MAX_WALK_DIRS:
        raise ValueError(f"{fn}: {d} directions > {_MAX_WALK_DIRS}")
    lib = _lib("sg_render_env")
    _check_smem(fn, k, lib.sg_walk_smem_bytes(k, 1), _SMEM_OPTIN_LIMIT)
    dev = albedo.device
    tables = (_view(h, w, float(fov_deg), dev),
              _dir_consts(env_height, env_width, dev))
    return lib, (b, h, w, k, d), tables


def _check_smem(fn, k, smem, limit):
    if smem > limit:
        raise ValueError(f"{fn}: K={k} needs {smem} B of shared memory a "
                         f"block, more than {limit}")


# ---------------------------------------------------------------------------
# render_sg_env: serving, forward only
# ---------------------------------------------------------------------------


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


def render_sg_env(albedo, normal, rough, axis, lamb, weight, fov_deg=57.0,
                  f0=0.05, env_height=8, env_width=16):
    """Fused SG decode + shading + envmap output, NHWC API (serving).

    albedo [B,H,W,3], normal [B,H,W,3], rough [B,H,W,1], axis
    [B,H,W,K,3], lamb [B,H,W,K] (physical sharpness), weight [B,H,W,K,3]
    (physical amplitude).  Returns diffuse, specular [B,H,W,3] and the
    decoded envmap [B,H,W,D,3], D = env_height*env_width.  Forward only.

    PRECONDITION (kernel route): |normal| <= 1 per pixel, as for the JAX
    kernel; the plain version has no such precondition.  CUDA tensors must
    be contiguous float32 on one device; D <= 1024 and K <= 312 (the
    block's shared memory), else ValueError.
    ``render_sg_env.launches`` counts kernel launches.

    The call goes through the custom op ``irois_torch::render_sg_env``:
    its CUDA implementation launches the kernel, its CPU one runs
    :func:`render_sg_env_plain`, and its fake one gives the output shapes,
    so ``torch.export`` holds the kernel as one node of a program.
    """
    if build.on_card("render_sg_env", albedo):
        # checked before the dispatch, so a bad input raises the same
        # ValueError wherever the call comes from
        _shading_inputs("render_sg_env", albedo, normal, rough, axis, lamb,
                        weight)
    return _render_sg_env_op(albedo, normal, rough, axis, lamb, weight,
                             float(fov_deg), float(f0), int(env_height),
                             int(env_width))


@torch.library.custom_op("irois_torch::render_sg_env", mutates_args=(),
                         device_types="cpu")
def _render_sg_env_op(albedo: torch.Tensor, normal: torch.Tensor,
                      rough: torch.Tensor, axis: torch.Tensor,
                      lamb: torch.Tensor, weight: torch.Tensor,
                      fov_deg: float, f0: float, env_height: int,
                      env_width: int
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return render_sg_env_plain(albedo, normal, rough, axis, lamb, weight,
                               fov_deg, f0, env_height, env_width)


@_render_sg_env_op.register_kernel("cuda")
def _render_sg_env_launch(albedo, normal, rough, axis, lamb, weight,
                          fov_deg, f0, env_height, env_width):
    lib, (b, h, w, k, d), tables = _walk_inputs(
        "render_sg_env", albedo, normal, rough, axis, lamb, weight, fov_deg,
        env_height, env_width)
    n = b * h * w
    dev = albedo.device
    diffuse = torch.empty((b, h, w, 3), dtype=torch.float32, device=dev)
    specular = torch.empty_like(diffuse)
    env = torch.empty((b, h, w, d, 3), dtype=torch.float32, device=dev)
    if n == 0:
        return diffuse, specular, env
    ptrs = [x.data_ptr()
            for x in (albedo, normal, rough, axis, lamb, weight, *tables)]
    with span("kernel.render_sg_env"):
        build.raise_on("sg_render_env", lib.sg_render_env_f32(
            *ptrs, diffuse.data_ptr(), specular.data_ptr(),
            env.data_ptr(), n, h * w, k, d, float(f0), build.stream(dev)))
    render_sg_env.launches += 1
    return diffuse, specular, env


@_render_sg_env_op.register_fake
def _render_sg_env_shapes(albedo, normal, rough, axis, lamb, weight,
                          fov_deg, f0, env_height, env_width):
    lead = tuple(albedo.shape[:3])
    d = env_height * env_width
    return (albedo.new_empty(lead + (3,)), albedo.new_empty(lead + (3,)),
            albedo.new_empty(lead + (d, 3)))


render_sg_env.launches = 0


# ---------------------------------------------------------------------------
# sg_envmap: SG mixture -> per-pixel envmap (the reconstruction loss)
# ---------------------------------------------------------------------------


def sg_envmap_plain(axis, lamb, weight, env_height=8, env_width=16):
    """The forward kernel's function in plain PyTorch: ``sg_to_envmap``."""
    return sg_to_envmap(axis, lamb, weight, env_height, env_width)


def sg_envmap_bwd_plain(axis, lamb, weight, g_env, env_height=8,
                        env_width=16):
    """The backward kernel's function in plain PyTorch, as the explicit
    adjoint of ``csrc/sg_common.cuh`` (``lobe``, ``lobe_adjoint``,
    ``write_lobe_grads``).  g_env [...,D,3] is the envmap's adjoint;
    returns (d_axis, d_lamb, d_weight) shaped like axis, lamb, weight."""
    ls = hemisphere(env_height, env_width, axis.dtype, axis.device)  # [D,3]
    # the contractions as broadcast products and sums, as in sg_to_envmap
    cosm1 = dot3(axis[..., :, None, :], ls) - 1.0
    e = torch.exp(lamb[..., None] * cosm1)  # [...,K,D]
    ge = dot3(g_env[..., None, :, :], weight[..., :, None, :])  # [...,K,D]
    d_weight = torch.sum(g_env[..., None, :, :] * e[..., None], dim=-2)
    gee = ge * e
    d_lamb = torch.sum(gee * cosm1, dim=-1)
    d_axis = lamb[..., None] * torch.sum(gee[..., None] * ls, dim=-2)
    return d_axis, d_lamb, d_weight


def _envmap_inputs(fn, axis, lamb, weight):
    """Check the lobe inputs of a CUDA launch; returns (n pixels, k)."""
    b, h, w, k = lamb.shape
    _check(fn, axis.device, {
        "axis": (axis, (b, h, w, k, 3)),
        "lamb": (lamb, (b, h, w, k)),
        "weight": (weight, (b, h, w, k, 3)),
    })
    return b * h * w, k


def sg_envmap_fwd(axis, lamb, weight, env_height=8, env_width=16):
    """Launch the forward kernel, the SG walk without the shading
    (CUDA; any D, K <= 329, the block's shared memory, else ValueError),
    or run :func:`sg_envmap_plain` (CPU).  Not differentiable;
    :func:`sg_envmap` is."""
    if not build.on_card("sg_envmap_fwd", axis):
        return sg_envmap_plain(axis, lamb, weight, env_height, env_width)
    n, k = _envmap_inputs("sg_envmap_fwd", axis, lamb, weight)
    lib = _lib("sg_render_env")
    _check_smem("sg_envmap_fwd", k, lib.sg_walk_smem_bytes(k, 0),
                _SMEM_OPTIN_LIMIT)
    d = env_height * env_width
    dev = axis.device
    env = torch.empty(lamb.shape[:3] + (d, 3), dtype=torch.float32,
                      device=dev)
    if n == 0:
        return env
    consts = _dir_consts(env_height, env_width, dev)
    with span("kernel.sg_envmap_fwd"):
        build.raise_on("sg_envmap_fwd", lib.sg_envmap_fwd_f32(
            axis.data_ptr(), lamb.data_ptr(), weight.data_ptr(),
            consts.data_ptr(), env.data_ptr(), n, k, d, build.stream(dev),
        ))
    sg_envmap_fwd.launches += 1
    return env


def sg_envmap_bwd(axis, lamb, weight, g_env, env_height=8, env_width=16):
    """Launch the backward kernel (CUDA; any D, K <= 768, else the launch
    raises) or run :func:`sg_envmap_bwd_plain` (CPU).  Returns (d_axis,
    d_lamb, d_weight)."""
    if not build.on_card("sg_envmap_bwd", axis):
        return sg_envmap_bwd_plain(axis, lamb, weight, g_env, env_height,
                                   env_width)
    n, k = _envmap_inputs("sg_envmap_bwd", axis, lamb, weight)
    lib = _lib("sg_envmap")
    d = env_height * env_width
    _check("sg_envmap_bwd", axis.device,
           {"g_env": (g_env, lamb.shape[:3] + (d, 3))})
    d_axis, d_lamb, d_weight = (torch.empty_like(x)
                                for x in (axis, lamb, weight))
    if n == 0:
        return d_axis, d_lamb, d_weight
    dev = axis.device
    consts = _dir_consts(env_height, env_width, dev)
    with span("kernel.sg_envmap_bwd"):
        build.raise_on("sg_envmap_bwd", lib.sg_envmap_bwd_f32(
            axis.data_ptr(), lamb.data_ptr(), weight.data_ptr(),
            consts.data_ptr(), g_env.data_ptr(), d_axis.data_ptr(),
            d_lamb.data_ptr(), d_weight.data_ptr(), n, k, d,
            build.stream(dev),
        ))
    sg_envmap_bwd.launches += 1
    return d_axis, d_lamb, d_weight


sg_envmap_fwd.launches = 0
sg_envmap_bwd.launches = 0


class _SGEnvmap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, lamb, weight, env_height, env_width):
        ctx.save_for_backward(axis, lamb, weight)
        ctx.env_hw = (env_height, env_width)
        return sg_envmap_fwd(axis, lamb, weight, env_height, env_width)

    @staticmethod
    def backward(ctx, g_env):
        grads = sg_envmap_bwd(*ctx.saved_tensors, g_env.contiguous(),
                              *ctx.env_hw)
        return (*grads, None, None)


def sg_envmap(axis, lamb, weight, env_height=8, env_width=16):
    """Fused SG -> per-pixel envmap, NHWC API, differentiable.

    axis [B,H,W,K,3], lamb [B,H,W,K] (physical), weight [B,H,W,K,3]
    (physical).  Returns envmap [B,H,W,D,3] with the semantics of
    ``core.sg.sg_to_envmap``; on CUDA tensors the forward is the walk of
    ``csrc/sg_render_env.cu`` without the shading and the backward the
    kernel of ``csrc/sg_envmap.cu``, on CPU tensors their plain
    versions."""
    axis, lamb, weight = (x.contiguous() for x in (axis, lamb, weight))
    return _SGEnvmap.apply(axis, lamb, weight, int(env_height),
                           int(env_width))


# ---------------------------------------------------------------------------
# render_sg: SG decode + shading (the render loss)
# ---------------------------------------------------------------------------


def render_sg_plain(albedo, normal, rough, axis, lamb, weight, fov_deg=57.0,
                    f0=0.05, env_height=8, env_width=16):
    """The forward kernel's function in plain PyTorch:
    ``render_envmap(..., sg_to_envmap(...))``."""
    return render_sg_env_plain(albedo, normal, rough, axis, lamb, weight,
                               fov_deg, f0, env_height, env_width)[:2]


def _above(x, lo):
    """d max(x, lo)/dx with jnp's tie rule (1/2 at the bound)."""
    return (x > lo).to(x.dtype) + 0.5 * (x == lo).to(x.dtype)


def _below(x, hi):
    return (x < hi).to(x.dtype) + 0.5 * (x == hi).to(x.dtype)


def _inside(x, lo, hi):
    return _above(x, lo) * _below(x, hi)


def _frame(normal, rough, v):
    """``make_frame`` of csrc/sg_common.cuh on [N] columns."""
    f = SimpleNamespace()
    f.nx, f.ny, f.nz = normal.unbind(-1)
    f.vx, f.vy, f.vz = v.unbind(-1)
    f.s = f.nx * f.nx + f.ny * f.ny + f.nz * f.nz
    f.inv_n = 1.0 / torch.sqrt(torch.clamp(f.s, 1e-6, 1.0))
    f.ux, f.uy, f.uz = f.nx * f.inv_n, f.ny * f.inv_n, f.nz * f.inv_n
    f.cy0x, f.cy0y, f.cy0z = -f.uy * f.ux, 1.0 - f.uy * f.uy, -f.uy * f.uz
    f.q1 = f.cy0x * f.cy0x + f.cy0y * f.cy0y + f.cy0z * f.cy0z
    f.inv_cy = 1.0 / torch.sqrt(torch.clamp(f.q1, min=1e-12))
    f.cyx, f.cyy, f.cyz = (f.cy0x * f.inv_cy, f.cy0y * f.inv_cy,
                           f.cy0z * f.inv_cy)
    f.cx0x = f.cyy * f.uz - f.cyz * f.uy
    f.cx0y = f.cyz * f.ux - f.cyx * f.uz
    f.cx0z = f.cyx * f.uy - f.cyy * f.ux
    f.q2 = f.cx0x * f.cx0x + f.cx0y * f.cx0y + f.cx0z * f.cx0z
    f.inv_cx = 1.0 / torch.sqrt(torch.clamp(f.q2, min=1e-12))
    f.cxx, f.cxy, f.cxz = (-f.cx0x * f.inv_cx, -f.cx0y * f.inv_cx,
                           -f.cx0z * f.inv_cx)
    f.nn = f.ux * f.ux + f.uy * f.uy + f.uz * f.uz
    f.nv = f.ux * f.vx + f.uy * f.vy + f.uz * f.vz
    f.v_cx = f.vx * f.cxx + f.vy * f.cxy + f.vz * f.cxz
    f.v_cy = f.vx * f.cyx + f.vy * f.cyy + f.vz * f.cyz
    f.n_cy = (f.uy - f.uy * f.nn) * f.inv_cy
    f.r = (rough + 1.0) * 0.5
    f.kg = (f.r + 1.0) * (f.r + 1.0) * (1.0 / 8.0)
    f.a2 = (f.r * f.r) * (f.r * f.r)
    f.ndv = torch.clamp(f.nv, 0.0, 1.0)
    f.nom1 = f.ndv * (1.0 - f.kg) + f.kg
    return f


def _shade(f, c, f0):
    """``shade<true>`` of csrc/sg_common.cuh, the backward's, with nom0 as
    a2 ndh^2 + |n x h|^2 where ``s.cross``: per-pixel columns [N, 1]
    against direction rows c [4, D] -> [N, D] terms."""
    col = {k: v[:, None] for k, v in vars(f).items()}
    lx, ly, lz, wq = c
    s = SimpleNamespace()
    s.vl = lx * col["v_cx"] + ly * col["v_cy"] + lz * col["nv"]
    s.h2 = (1.0 + s.vl) * 0.5
    s.inv_h = 1.0 / torch.sqrt(torch.clamp(s.h2, min=1e-6))
    s.vdh = s.h2 * s.inv_h
    s.ex2 = torch.exp2((-5.55472 * s.vdh - 6.98316) * s.vdh)
    s.frac0 = f0 + (1.0 - f0) * s.ex2
    s.nl = ly * col["n_cy"] + lz * col["nn"]
    s.t = (col["nv"] + s.nl) * 0.5 * s.inv_h
    s.ndh = torch.clamp(s.t, 0.0, 1.0)
    s.ndl = torch.clamp(s.nl, 0.0, 1.0)
    s.cross = ((col["s"] >= 1e-6) & (s.h2 >= 1e-6) & (s.t > 0.0)
               & (s.t < 1.0))
    s.sx, s.sy = lx + col["v_cx"], ly + col["v_cy"]
    sin2 = (s.sx * s.sx + s.sy * s.sy) * 0.25 * s.inv_h * s.inv_h
    s.nom0 = torch.where(s.cross, col["a2"] * s.ndh * s.ndh + sin2,
                         s.ndh * s.ndh * (col["a2"] - 1.0) + 1.0)
    s.nom2 = s.ndl * (1.0 - col["kg"]) + col["kg"]
    s.nomr = 4.0 * math.pi * s.nom0 * s.nom0 * col["nom1"] * s.nom2
    s.nom = torch.clamp(s.nomr, 1e-6, 4.0 * math.pi)
    s.spec = col["a2"] * s.frac0 / s.nom
    s.ndl_w = s.ndl * wq
    s.spec_w = s.spec * s.ndl_w
    return col, s


def _shade_adjoint(f, col, s, c, f0, e_d, e_s):
    """``shade_adjoint`` of csrc/sg_common.cuh, summed over directions."""
    lx, ly, lz, wq = c
    four_pi = 4.0 * math.pi
    g_ndlw = e_d + s.spec * e_s
    g_spec = s.ndl_w * e_s
    g_ndl = g_ndlw * wq
    frac = col["a2"] * s.frac0
    g_frac = g_spec / s.nom
    g_nom = -g_spec * frac / (s.nom * s.nom)
    g_nomr = g_nom * _inside(s.nomr, 1e-6, four_pi)
    cg = four_pi * g_nomr
    g_nom0 = cg * 2.0 * s.nom0 * col["nom1"] * s.nom2
    g_nom1 = cg * s.nom0 * s.nom0 * s.nom2
    g_nom2 = cg * s.nom0 * s.nom0 * col["nom1"]
    g_a2 = g_frac * s.frac0 + g_nom0 * s.ndh * s.ndh
    g_frac0 = g_frac * col["a2"]
    g_vdh = (g_frac0 * (1.0 - f0) * s.ex2 * math.log(2.0)
             * (-2.0 * 5.55472 * s.vdh - 6.98316))
    g_ndh = g_nom0 * 2.0 * s.ndh * torch.where(s.cross, col["a2"],
                                               col["a2"] - 1.0)
    g_sin2 = g_nom0 * s.cross.to(s.t.dtype)
    g_s = g_sin2 * 0.5 * s.inv_h * s.inv_h
    g_ndl = g_ndl + g_nom2 * (1.0 - col["kg"])
    g_kg = g_nom2 * (1.0 - s.ndl) + g_nom1 * (1.0 - col["ndv"])
    g_nl = g_ndl * _inside(s.nl, 0.0, 1.0)
    g_t = g_ndh * _inside(s.t, 0.0, 1.0)
    g_nv = (g_t * 0.5 * s.inv_h
            + g_nom1 * (1.0 - col["kg"]) * _inside(col["nv"], 0.0, 1.0))
    g_nl = g_nl + g_t * 0.5 * s.inv_h
    g_invh = (g_t * (col["nv"] + s.nl) * 0.5 + g_vdh * s.h2
              + g_sin2 * (s.sx * s.sx + s.sy * s.sy) * 0.5 * s.inv_h)
    g_h2 = (g_vdh * s.inv_h
            + g_invh * -0.5 * s.inv_h * s.inv_h * s.inv_h
            * _above(s.h2, 1e-6))
    g_vl = 0.5 * g_h2
    g_nv = g_nv + g_vl * lz
    return SimpleNamespace(
        r=torch.sum(g_a2 * 4.0 * col["r"] ** 3
                    + g_kg * (col["r"] + 1.0) * 0.25, dim=-1),
        nv=torch.sum(g_nv, dim=-1),
        v_cx=torch.sum(g_vl * lx + g_s * s.sx, dim=-1),
        v_cy=torch.sum(g_vl * ly + g_s * s.sy, dim=-1),
        n_cy=torch.sum(g_nl * ly, dim=-1),
        nn=torch.sum(g_nl * lz, dim=-1),
    )


def _frame_adjoint(f, g):
    """``frame_adjoint`` of csrc/sg_common.cuh: (d_normal [N,3], d_rough
    [N])."""
    d_rough = 0.5 * g.r
    gux = torch.zeros_like(g.n_cy)
    guy = g.n_cy * (1.0 - f.nn) * f.inv_cy
    guz = torch.zeros_like(g.n_cy)
    g_nn = g.nn - g.n_cy * f.uy * f.inv_cy
    g_invcy = g.n_cy * (f.uy - f.uy * f.nn)
    gux = gux + 2.0 * g_nn * f.ux + g.nv * f.vx
    guy = guy + 2.0 * g_nn * f.uy + g.nv * f.vy
    guz = guz + 2.0 * g_nn * f.uz + g.nv * f.vz
    gcyx, gcyy, gcyz = g.v_cy * f.vx, g.v_cy * f.vy, g.v_cy * f.vz
    gx0x = -g.v_cx * f.vx * f.inv_cx
    gx0y = -g.v_cx * f.vy * f.inv_cx
    gx0z = -g.v_cx * f.vz * f.inv_cx
    g_invcx = -g.v_cx * (f.vx * f.cx0x + f.vy * f.cx0y + f.vz * f.cx0z)
    g_q2 = g_invcx * -0.5 * f.inv_cx ** 3 * _above(f.q2, 1e-12)
    gx0x = gx0x + 2.0 * g_q2 * f.cx0x
    gx0y = gx0y + 2.0 * g_q2 * f.cx0y
    gx0z = gx0z + 2.0 * g_q2 * f.cx0z
    # cx0 = cy x u
    gcyx = gcyx + f.uy * gx0z - f.uz * gx0y
    gcyy = gcyy + f.uz * gx0x - f.ux * gx0z
    gcyz = gcyz + f.ux * gx0y - f.uy * gx0x
    gux = gux + gx0y * f.cyz - gx0z * f.cyy
    guy = guy + gx0z * f.cyx - gx0x * f.cyz
    guz = guz + gx0x * f.cyy - gx0y * f.cyx
    gy0x, gy0y, gy0z = gcyx * f.inv_cy, gcyy * f.inv_cy, gcyz * f.inv_cy
    g_invcy = g_invcy + gcyx * f.cy0x + gcyy * f.cy0y + gcyz * f.cy0z
    g_q1 = g_invcy * -0.5 * f.inv_cy ** 3 * _above(f.q1, 1e-12)
    gy0x = gy0x + 2.0 * g_q1 * f.cy0x
    gy0y = gy0y + 2.0 * g_q1 * f.cy0y
    gy0z = gy0z + 2.0 * g_q1 * f.cy0z
    gux = gux - gy0x * f.uy
    guy = guy - gy0x * f.ux - 2.0 * gy0y * f.uy - gy0z * f.uz
    guz = guz - gy0z * f.uy
    g_invn = gux * f.nx + guy * f.ny + guz * f.nz
    g_s = g_invn * -0.5 * f.inv_n ** 3 * _inside(f.s, 1e-6, 1.0)
    d_normal = torch.stack([gux * f.inv_n + 2.0 * g_s * f.nx,
                            guy * f.inv_n + 2.0 * g_s * f.ny,
                            guz * f.inv_n + 2.0 * g_s * f.nz], dim=-1)
    return d_normal, d_rough


def render_sg_bwd_plain(albedo, normal, rough, axis, lamb, weight,
                        grad_diffuse, grad_specular, fov_deg=57.0, f0=0.05,
                        env_height=8, env_width=16):
    """The backward kernel's function in plain PyTorch: the explicit
    adjoint of the TPU kernel's shading math (``_shade_tile_math``, with its
    |normal| <= 1 shortcut algebra; nom0 as a2 ndh^2 + |n x h|^2, which
    keeps f32 on the right side of the GGX clamp, csrc/sg_common.cuh),
    formula for formula as
    ``render_sg_bwd_pixel`` (csrc/sg_render_bwd.cuh) runs it, pass for
    pass: (A) radiance adjoint, (B) lobes, (C) shading adjoint, then the
    per-pixel chain.  The kernel runs the three passes per chunk of eight
    directions and sums over directions in another order; here each pass
    covers all directions at once.  Returns the gradients of albedo,
    normal, rough, axis, lamb and weight, shaped like them."""
    b, h, w = albedo.shape[:3]
    k = lamb.shape[-1]
    n = b * h * w
    # the constants in the inputs' dtype from their float64 values, as the
    # plain forward takes them
    c = torch.as_tensor(_dir_table(env_height, env_width).T,
                        dtype=albedo.dtype, device=albedo.device)  # [4,D]
    v = torch.as_tensor(view_dirs(h, w, fov_deg).reshape(-1, 3),
                        dtype=albedo.dtype, device=albedo.device)
    v = v.expand(b, h * w, 3).reshape(n, 3)
    f = _frame(normal.reshape(n, 3), rough.reshape(n), v)
    gd = grad_diffuse.reshape(n, 3)
    gs = grad_specular.reshape(n, 3)
    gda = gd * albedo.reshape(n, 3) * (1.0 / math.pi)
    # (A) radiance adjoint per direction
    col, s = _shade(f, c, f0)
    genv = (gda[:, None, :] * s.ndl_w[..., None]
            + gs[:, None, :] * s.spec_w[..., None])  # [N,D,3]
    # (B) lobes: the mixture and its adjoint
    ax, lm, wt = axis.reshape(n, k, 3), lamb.reshape(n, k), weight.reshape(
        n, k, 3)
    env = sg_to_envmap(ax, lm, wt, env_height, env_width)  # [N,D,3]
    d_axis, d_lamb, d_weight = sg_envmap_bwd_plain(ax, lm, wt, genv,
                                                   env_height, env_width)
    # (C) shading adjoint against the mixture, then the per-pixel chain
    e_d = dot3(gda[:, None, :], env)  # [N,D]
    e_s = dot3(gs[:, None, :], env)
    fg = _shade_adjoint(f, col, s, c, f0, e_d, e_s)
    sd = torch.sum(s.ndl_w[..., None] * env, dim=-2)  # [N,3]
    d_normal, d_rough = _frame_adjoint(f, fg)
    d_albedo = gd * (1.0 / math.pi) * sd
    return (d_albedo.reshape(albedo.shape), d_normal.reshape(normal.shape),
            d_rough.reshape(rough.shape), d_axis.reshape(axis.shape),
            d_lamb.reshape(lamb.shape), d_weight.reshape(weight.shape))


def render_sg_fwd(albedo, normal, rough, axis, lamb, weight, fov_deg=57.0,
                  f0=0.05, env_height=8, env_width=16):
    """Launch the forward kernel, the serving walk without the envmap
    (CUDA), or run :func:`render_sg_plain` (CPU).  Not differentiable;
    :func:`render_sg` is."""
    if not build.on_card("render_sg_fwd", albedo):
        return render_sg_plain(albedo, normal, rough, axis, lamb, weight,
                               fov_deg, f0, env_height, env_width)
    lib, (b, h, w, k, d), tables = _walk_inputs(
        "render_sg_fwd", albedo, normal, rough, axis, lamb, weight, fov_deg,
        env_height, env_width)
    diffuse = torch.empty_like(albedo)
    specular = torch.empty_like(albedo)
    n = b * h * w
    if n == 0:
        return diffuse, specular
    ptrs = [x.data_ptr()
            for x in (albedo, normal, rough, axis, lamb, weight, *tables)]
    with span("kernel.render_sg_fwd"):
        build.raise_on("render_sg_fwd", lib.render_sg_fwd_f32(
            *ptrs, diffuse.data_ptr(), specular.data_ptr(), n, h * w, k, d,
            float(f0), build.stream(albedo.device),
        ))
    render_sg_fwd.launches += 1
    return diffuse, specular


def render_sg_bwd(albedo, normal, rough, axis, lamb, weight, grad_diffuse,
                  grad_specular, fov_deg=57.0, f0=0.05, env_height=8,
                  env_width=16):
    """Launch the backward kernel (CUDA) or run
    :func:`render_sg_bwd_plain` (CPU).  Returns the six input gradients."""
    if not build.on_card("render_sg_bwd", albedo):
        return render_sg_bwd_plain(albedo, normal, rough, axis, lamb, weight,
                                   grad_diffuse, grad_specular, fov_deg, f0,
                                   env_height, env_width)
    b, h, w, k = _shading_inputs("render_sg_bwd", albedo, normal, rough,
                                 axis, lamb, weight)
    lib = _lib("sg_render")
    dev = albedo.device
    view = _view(h, w, float(fov_deg), dev)
    dirs = _dir_consts(env_height, env_width, dev)
    d = env_height * env_width
    if d > _MAX_BWD_DIRS:
        raise ValueError(f"render_sg_bwd: {d} directions > {_MAX_BWD_DIRS}")
    _check_smem("render_sg_bwd", k, lib.render_sg_bwd_smem_bytes(k, d),
                _SMEM_OPTIN_LIMIT)
    _check("render_sg_bwd", albedo.device, {
        "grad_diffuse": (grad_diffuse, (b, h, w, 3)),
        "grad_specular": (grad_specular, (b, h, w, 3)),
    })
    grads = [torch.empty_like(x)
             for x in (albedo, normal, rough, axis, lamb, weight)]
    n = b * h * w
    if n == 0:
        return tuple(grads)
    with span("kernel.render_sg_bwd"):
        build.raise_on("render_sg_bwd", lib.render_sg_bwd_f32(
            albedo.data_ptr(), normal.data_ptr(), rough.data_ptr(),
            axis.data_ptr(), lamb.data_ptr(), weight.data_ptr(),
            view.data_ptr(), dirs.data_ptr(), grad_diffuse.data_ptr(),
            grad_specular.data_ptr(), *(g.data_ptr() for g in grads),
            n, h * w, k, d, float(f0), build.stream(albedo.device),
        ))
    render_sg_bwd.launches += 1
    return tuple(grads)


render_sg_fwd.launches = 0
render_sg_bwd.launches = 0


class _RenderSG(torch.autograd.Function):
    @staticmethod
    def forward(ctx, albedo, normal, rough, axis, lamb, weight, fov_deg, f0,
                env_height, env_width):
        ctx.save_for_backward(albedo, normal, rough, axis, lamb, weight)
        ctx.cfg = (fov_deg, f0, env_height, env_width)
        return render_sg_fwd(albedo, normal, rough, axis, lamb, weight,
                             *ctx.cfg)

    @staticmethod
    def backward(ctx, grad_diffuse, grad_specular):
        grads = render_sg_bwd(*ctx.saved_tensors, grad_diffuse.contiguous(),
                              grad_specular.contiguous(), *ctx.cfg)
        return (*grads, None, None, None, None)


def render_sg(albedo, normal, rough, axis, lamb, weight, fov_deg=57.0,
              f0=0.05, env_height=8, env_width=16):
    """Fused SG decode + shading, NHWC API, differentiable (training).

    albedo [B,H,W,3], normal [B,H,W,3], rough [B,H,W,1], axis
    [B,H,W,K,3], lamb [B,H,W,K] (physical), weight [B,H,W,K,3]
    (physical).  Returns (diffuse, specular) [B,H,W,3].  Gradients reach
    all six inputs; the view direction gets none.  On CUDA tensors the
    forward is the walk of ``csrc/sg_render_env.cu`` and the backward the
    kernel of ``csrc/sg_render.cu`` (D <= 128), on CPU tensors the plain
    forward and the plain adjoint.

    PRECONDITION: |normal| <= 1 per pixel, as for the JAX kernel (pooled
    unit normals only shrink); the backward's shortcut algebra assumes it.
    """
    args = (x.contiguous() for x in (albedo, normal, rough, axis, lamb,
                                     weight))
    return _RenderSG.apply(*args, float(fov_deg), float(f0), int(env_height),
                           int(env_width))
