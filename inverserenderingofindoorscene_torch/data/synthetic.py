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


def synthetic_iiw_batch(batch: int = 2, im_hw=(240, 320), max_num: int = 800,
                        seed: int = 0, device=None):
    """An IIW batch in the IIW loader's output format, and the judgements
    it came from in the IIW JSON's own shape.

    Per image: a linear image in [0, 1] (gamma 2.2, divided by its max);
    ``eq_*`` and ``darker_*`` lists of ``max_num`` rows (r1, c1, r2, c2)
    whose row 0 is the loader's all-zero dummy, ``*_num`` drawn in [1,
    max_num] (the dummy counted) and zero points and weights past it.
    Points come from a small pool, so indices repeat.  The judgements
    (``intrinsic_points`` with id / x / y / opaque,
    ``intrinsic_comparisons`` with point1 / point2 / darker in {1, 2, E}
    / darker_score) hold the same pairs, each point at its pixel's centre:
    a darker pair is stored darker-last, as the loader stores it.
    Returns (batch dict of tensors on ``device``, list of judgements)."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    h, w = im_hw
    im = rng.uniform(0, 1, (batch, h, w, 3)) ** 2.2
    im = im / im.max(axis=(1, 2, 3), keepdims=True)
    lists = {k: np.zeros((batch, max_num, 4), np.int32)
             for k in ("eq", "darker")}
    wts = {k: np.zeros((batch, max_num), np.float32) for k in lists}
    nums = {k: rng.randint(1, max_num + 1, batch).astype(np.int32)
            for k in lists}
    judgements = []
    for n in range(batch):
        pool = np.stack([rng.randint(0, h, 64), rng.randint(0, w, 64)], -1)
        points, comparisons = [], []
        for kind in ("eq", "darker"):
            for row in range(1, nums[kind][n]):
                a, b = pool[rng.randint(0, len(pool), 2)]
                score = rng.uniform(0.1, 1.0)
                lists[kind][n, row] = (*a, *b)
                wts[kind][n, row] = score
                ids = []
                for r, c in (a, b):
                    ids.append(len(points))
                    points.append({"id": len(points), "x": (c + 0.5) / w,
                                   "y": (r + 0.5) / h, "opaque": True})
                darker = "E" if kind == "eq" else "2"
                if kind == "darker" and rng.rand() < 0.5:
                    ids, darker = ids[::-1], "1"  # point1 the darker one
                comparisons.append({"point1": ids[0], "point2": ids[1],
                                    "darker": darker,
                                    "darker_score": float(score)})
        judgements.append({"intrinsic_points": points,
                           "intrinsic_comparisons": comparisons})
    out = {"im": torch.as_tensor(im.astype(np.float32), device=dev)}
    for kind in lists:
        out[f"{kind}_point"] = torch.as_tensor(lists[kind], device=dev)
        out[f"{kind}_weight"] = torch.as_tensor(wts[kind], device=dev)
        out[f"{kind}_num"] = torch.as_tensor(nums[kind], device=dev)
    return out, judgements


def synthetic_nyu_batch(batch: int = 2, im_hw=(240, 320), gt_hw=None,
                        seed: int = 0, device=None) -> dict:
    """An NYU batch in the NYU loader's output format: im [B,H,W,3] in [0,
    1]; at ``gt_hw`` (default ``im_hw``, the loader's output size) unit
    normals with z > 0, depth in (1, 10) but for about 2% of the pixels
    drawn in (0.3, 1) or (10, 12), ``seg_depth`` = 1 < depth < 10 and a
    ``seg_normal`` mask (70% ones).  Tensors on ``device``."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    h, w = im_hw
    gh, gw = im_hw if gt_hw is None else gt_hw
    normal = rng.uniform(-1, 1, (batch, gh, gw, 3))
    normal[..., 2] = np.abs(normal[..., 2]) + 0.3
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    depth = rng.uniform(1.05, 9.95, (batch, gh, gw, 1))
    outside = rng.uniform(0, 1, depth.shape) < 0.02
    depth[outside] = np.where(rng.uniform(0, 1, outside.sum()) < 0.5,
                              rng.uniform(0.3, 1.0, outside.sum()),
                              rng.uniform(10.0, 12.0, outside.sum()))
    arrays = {
        "im": rng.uniform(0, 1, (batch, h, w, 3)),
        "normal": normal,
        "depth": depth,
        "seg_normal": rng.uniform(0, 1, (batch, gh, gw, 1)) > 0.3,
        "seg_depth": np.logical_and(depth > 1, depth < 10),
    }
    return {k: torch.as_tensor(v.astype(np.float32), device=dev)
            for k, v in arrays.items()}
