"""Operations and bytes: the model's convolution and matmul FLOPs, counted
on the reference's nets, and each hand-written kernel's bytes and
operations, from shapes.

Model FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode``
over the reference's nets on the meta device (no memory, no time), so the
count is the published model's and does not change when the program
replaces a convolution by a kernel of its own.  Training counts the
forward and the backward of the trained nets and the forward of frozen
ones; serving counts forwards.

The kernels' formulas count each input byte read once and each output
byte written once, and the float32 operations of the arithmetic as
written: a shading walk 8K + 45 operations a pixel and direction, the
envmap decode 8K, a backward three times its forward; the bilateral blur
11 operations a vertex and channel.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_port.reference import nets as R
from bench_port.reference import train as T


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def _meta(*shape):
    return torch.zeros(shape, device="meta")


def brdf_step_flops(cfg: dict, batch: int) -> int:
    """FLOPs of one cascade-0 BRDF training step at the configuration's
    sizes."""
    h, w = cfg["im_height"], cfg["im_width"]
    with torch.device("meta"):
        brdf = R.BRDFNets(0)
        data = {"im": _meta(batch, h, w, 3), "albedo": _meta(batch, h, w, 3),
                "normal": _meta(batch, h, w, 3),
                "rough": _meta(batch, h, w, 1),
                "depth": _meta(batch, h, w, 1),
                "seg_brdf": _meta(batch, h, w, 1),
                "seg_all": _meta(batch, h, w, 1)}
        return _count(lambda: T.brdf_loss(brdf, data).backward())


def light_step_flops(cfg: dict, batch: int) -> int:
    """FLOPs of one cascade-0 light training step at the configuration's
    sizes: the frozen BRDF nets' forward, the light nets' forward and
    backward."""
    h, w = cfg["im_height"], cfg["im_width"]
    r, c = cfg["env_rows"], cfg["env_cols"]
    eh, ew = cfg["env_height"], cfg["env_width"]
    with torch.device("meta"):
        brdf = R.BRDFNets(0)
        light = R.LightNets(cfg["sg_num"], 0, r, c, eh, ew)
        data = {"im": _meta(batch, h, w, 3),
                "seg_brdf": _meta(batch, h, w, 1),
                "env_gt": _meta(batch, r, c, eh * ew, 3),
                "env_ind": _meta(batch, 1)}
        return _count(lambda: T.light_loss(brdf, light, data).backward())


def serve_flops(cfg: dict, batch: int) -> int:
    """FLOPs of the level-2 chain's nets on ``batch`` photos: both
    cascades' BRDF and light nets and each level's three confidence
    nets."""
    h, w = cfg["im_height"], cfg["im_width"]
    r, c = cfg["env_rows"], cfg["env_cols"]
    k = cfg["sg_num"]

    def chain():
        im = _meta(batch, 3, h, w)
        for level in (0, 1):
            brdf = R.BRDFNets(level)
            brdf(im, im if level == 0 else _meta(batch, 17, h, w))
            light = R.LightNets(k, level, r, c)
            light(_meta(batch, 11, 4 * r, 4 * c), (r, c),
                  _meta(batch, 7 * k, r, c) if level else None)
            bs = R.BilateralNets()
            for name, cin in R.BS_MODES.items():
                bs.confidence(name, im, _meta(batch, cin - 3, h, w))

    with torch.device("meta"), torch.no_grad():
        return _count(chain)


# ---------------------------------------------------------------------------
# the kernels: (bytes, float32 operations) of one launch
# ---------------------------------------------------------------------------


def render_sg_env(b, h, w, k, d):
    n = b * h * w
    return (4 * (n * (7 + 7 * k) + h * w * 3 + d * 4 + n * (6 + 3 * d)),
            n * (8 * k + 45) * d)


def render_sg_fwd(b, h, w, k, d):
    n = b * h * w
    return 4 * (n * (7 + 7 * k) + h * w * 3 + d * 4 + n * 6), \
        n * (8 * k + 45) * d


def render_sg_bwd(b, h, w, k, d):
    n = b * h * w
    return 4 * (2 * n * (7 + 7 * k) + h * w * 3 + d * 4 + n * 6), \
        3 * n * (8 * k + 45) * d


def sg_envmap_fwd(b, h, w, k, d):
    n = b * h * w
    return 4 * (n * 7 * k + d * 4 + n * 3 * d), n * k * 8 * d


def sg_envmap_bwd(b, h, w, k, d):
    n = b * h * w
    return 4 * (2 * n * 7 * k + d * 4 + n * 3 * d), 3 * n * k * 8 * d


def bilateral_blur(v, c):
    return 4 * 2 * v * c + 4 * 10 * v, 11 * v * c

