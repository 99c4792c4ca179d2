"""Constant tables of the plain shading and SG code, as tensors on a
device, made once per key.

The tables (hemisphere directions and weights, view vectors) are float64
numpy arrays (``core/sphere.py``, ``core/camera.py``); making one a CUDA
tensor is a host -> device copy that makes the host wait for the card.
Each function here makes its table on the first call with a key
(shapes, fov, dtype, device) and returns the same tensor after, so the
chain makes no copy after its first call, as ``ops/sg_render.py``'s
``_dir_consts`` and ``_view`` do for the kernels.  A table made while
``torch.export`` (or ``torch.compile``) traces is a placeholder of the
trace and is not kept; a table kept from an eager call enters a trace as a
constant.  A table is never an inference tensor, whatever mode the
first call runs in.
"""

from __future__ import annotations

import functools

import torch

from inverserenderingofindoorscene_torch.core.camera import view_dirs
from inverserenderingofindoorscene_torch.core.sphere import (
    hemisphere_dirs,
    hemisphere_weights,
)


def _made_once(make):
    cache = {}

    @functools.wraps(make)
    def table(*key):
        t = cache.get(key)
        if t is None:
            # never an inference tensor: a table first made under
            # torch.inference_mode (serving) is read by autograd later
            with torch.inference_mode(False):
                t = make(*key)
            if not torch.compiler.is_compiling():
                cache[key] = t
        return t

    return table


@_made_once
def hemisphere(env_height, env_width, dtype, device) -> torch.Tensor:
    """[D, 3] hemisphere grid directions."""
    return torch.as_tensor(hemisphere_dirs(env_height, env_width),
                           dtype=dtype, device=device)


@_made_once
def hemisphere_weight(env_height, env_width, dtype, device) -> torch.Tensor:
    """[D] solid-angle weights of the hemisphere grid."""
    return torch.as_tensor(hemisphere_weights(env_height, env_width),
                           dtype=dtype, device=device)


@_made_once
def view(height, width, fov_deg, dtype, device) -> torch.Tensor:
    """[H, W, 3] per-pixel unit view vectors."""
    return torch.as_tensor(view_dirs(height, width, fov_deg), dtype=dtype,
                           device=device)


@_made_once
def up(dtype, device) -> torch.Tensor:
    """The world up vector (0, 1, 0) of the tangent frame."""
    return torch.tensor([0.0, 1.0, 0.0], dtype=dtype, device=device)
