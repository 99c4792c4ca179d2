"""Image-space ops on NCHW tensors, and the NHWC <-> NCHW views.

PyTorch's own ops already have the semantics that the JAX package's
``core/imageops.py`` rebuilds for the TPU: bilinear resize with
half-pixel centers (antialiased where it shrinks, as
``jax.image.resize(..., "linear")``), adaptive average pooling with the
torch bin rule, and edge-replicate padding.  The TPU speed workarounds there (the depthwise-conv
2x upsample, the hand-written pad VJP, the pooling matrices) are not
ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view (the nets' layout)."""
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> NHWC view (the layout at the public functions)."""
    return x.permute(0, 2, 3, 1)


def resize_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize of NCHW to (H', W') with half-pixel centers, the
    JAX package's ``resize_bilinear``.  Where either side shrinks, the
    filter widens by the shrink factor on that side (antialiasing, as
    ``jax.image.resize`` does); an upscale or identity takes the plain
    bilinear kernel, which is the same function there."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    shrinks = oh < x.shape[-2] or ow < x.shape[-1]
    return F.interpolate(x, size=(oh, ow), mode="bilinear",
                         align_corners=False, antialias=shrinks)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    return resize_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2))


def adaptive_avg_pool(x: torch.Tensor, out_hw) -> torch.Tensor:
    """``F.adaptive_avg_pool2d`` on NCHW (identity at equal size)."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if x.shape[-2:] == (oh, ow):
        return x
    return F.adaptive_avg_pool2d(x, (oh, ow))


def replication_pad(x: torch.Tensor, pad: int = 1) -> torch.Tensor:
    """Edge-replicate pad the two spatial dims of an NCHW tensor."""
    return F.pad(x, (pad, pad, pad, pad), mode="replicate")
