"""Spherical-Gaussian lighting parameterization.

Per pixel the spatially-varying lighting is a mixture of ``sg_num`` (=12)
spherical-Gaussian lobes, each with a unit axis in the local tangent frame
of the pixel, a sharpness ``lamb`` and an RGB ``weight``:

    L(l) = sum_k  weight_k * exp(lamb_k * (dot(axis_k, l) - 1))

The network emits axis (unit-normalized), and lamb/weight squashed to
[0, 1]; the physical values are recovered with ``tan(pi/2 * 0.999 * x)``.
Arrays are pixel-leading with the small SG/direction axes last, as in the
JAX package's ``core/sg.py``.
"""

from __future__ import annotations

import math

import torch

from inverserenderingofindoorscene_torch.core import tables

TAN_SQUASH_EPS = 0.999


def unsquash(x: torch.Tensor) -> torch.Tensor:
    """Map a [0,1]-squashed network output to [0, +inf): tan(pi/2 * 0.999 x)."""
    return torch.tan((math.pi / 2.0) * (TAN_SQUASH_EPS * x))


def sg_params_from_flat(flat: torch.Tensor, sg_num: int = 12):
    """Split a flat [..., sg_num*7] SG tensor into (axis, lamb, weight).

    Layout: [axis(sg*3) | lamb(sg) | weight(sg*3)], the cascade hand-off
    tensor.  Returns axis [..., sg, 3], lamb [..., sg], weight [..., sg, 3].
    """
    lead = flat.shape[:-1]
    ax = flat[..., : sg_num * 3].reshape(*lead, sg_num, 3)
    lamb = flat[..., sg_num * 3 : sg_num * 4]
    w = flat[..., sg_num * 4 :].reshape(*lead, sg_num, 3)
    return ax, lamb, w


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_c a[..., c] b[..., c] over the last axis of 3, broadcast, as
    multiplies and adds: no BLAS or oneDNN path decides its rounding."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def sg_to_envmap(
    axis: torch.Tensor,
    lamb: torch.Tensor,
    weight: torch.Tensor,
    env_height: int = 8,
    env_width: int = 16,
) -> torch.Tensor:
    """Evaluate the SG mixture on the hemisphere grid.

    axis [..., sg, 3] unit lobe axes (local frame); lamb [..., sg]
    sharpness (un-squashed); weight [..., sg, 3] RGB amplitudes
    (un-squashed).  Returns envmap [..., env_height*env_width, 3].

    Both contractions are broadcast products and sums, never a matmul:
    the CPU's matmul paths round by the matmul precision and by the path
    a process is on, and ``lamb`` up to ~60 in the exponential amplifies
    that (ROADMAP C18).
    """
    ls = tables.hemisphere(env_height, env_width, axis.dtype, axis.device)
    cos = dot3(axis[..., :, None, :], ls)  # [..., sg, dirs]
    e = torch.exp(lamb[..., :, None] * (cos - 1.0))
    return torch.sum(e[..., None] * weight[..., :, None, :], dim=-3)


def squashed_sg_to_envmap(
    axis: torch.Tensor,
    lamb01: torch.Tensor,
    weight01: torch.Tensor,
    env_height: int = 8,
    env_width: int = 16,
):
    """Un-squash lamb/weight then evaluate.

    Returns (envmap [..., dirs, 3], axis, lamb, weight) with the
    un-squashed lamb/weight.
    """
    lamb = unsquash(lamb01)
    weight = unsquash(weight01)
    env = sg_to_envmap(axis, lamb, weight, env_height, env_width)
    return env, axis, lamb, weight
