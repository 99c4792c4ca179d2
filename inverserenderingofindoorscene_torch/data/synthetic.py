"""Deterministic synthetic scene batches.

The counterpart of the JAX package's ``data/synthetic.py``: the same
``np.random.RandomState`` draws in the same order, so a seed gives the
same arrays bit for bit (float64 draws rounded once to float32).  It stands
in for the OpenRooms loader with its tensor contract (NHWC): im in [0,1],
albedo in [0,1], unit normals, rough in [-1,1], depth positive, segs in
{0,1}, env_gt nonnegative HDR.
"""

from __future__ import annotations

import numpy as np
import torch

from inverserenderingofindoorscene_torch.device import resolve_device


def synthetic_batch(
    batch: int = 2,
    im_hw=(240, 320),
    env_rc=(120, 160),
    env_hw=(8, 16),
    cascade_level: int = 0,
    sg_num: int = 12,
    seed: int = 0,
    device=None,
) -> dict:
    """A random-but-deterministic training batch: a dict of NHWC float32
    tensors on ``device`` (``None`` means CUDA)."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    h, w = im_hw
    r, c = env_rc
    d = env_hw[0] * env_hw[1]

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    def u(shape, lo=0.0, hi=1.0):
        return t(rng.uniform(lo, hi, shape))

    normal = rng.uniform(-1, 1, (batch, h, w, 3))
    normal[..., 2] = np.abs(normal[..., 2]) + 0.3
    normal = normal / np.linalg.norm(normal, axis=-1, keepdims=True)

    seg_obj = (rng.uniform(0, 1, (batch, h, w, 1)) > 0.3).astype(np.float64)
    seg_area = (rng.uniform(0, 1, (batch, h, w, 1)) > 0.8).astype(
        np.float64
    ) * (1.0 - seg_obj)
    seg_env = 1.0 - seg_obj - seg_area

    out = {
        "im": u((batch, h, w, 3)),
        "albedo": u((batch, h, w, 3)),
        "normal": t(normal),
        "rough": u((batch, h, w, 1), -1.0, 1.0),
        "depth": u((batch, h, w, 1), 0.1, 5.0),
        "seg_brdf": t(seg_obj),
        "seg_all": t(seg_obj + seg_area),
        "seg_env": t(seg_env),
        "env_gt": u((batch, r, c, d, 3), 0.0, 2.0),
        "env_ind": t(np.ones((batch, 1))),
    }
    if cascade_level > 0:
        out.update(
            {
                "albedo_pre": u((batch, r, c, 3)),
                "normal_pre": t(normal[:, ::2, ::2][:, :r, :c]),
                "rough_pre": u((batch, r, c, 1), -1.0, 1.0),
                "depth_pre": u((batch, r, c, 1), 0.1, 5.0),
                "diffuse_pre": u((batch, r, c, 3)),
                "specular_pre": u((batch, r, c, 3), 0.0, 0.5),
                "env_pre": u((batch, r, c, sg_num * 7)),
            }
        )
    return out
