"""Image ops on NCHW tensors: bilinear resize with half-pixel centres
(antialiased where it shrinks), adaptive average pooling and edge-replicate
padding, as ``torch.nn.functional`` computes them."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def resize_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    oh, ow = int(out_hw[0]), int(out_hw[1])
    shrinks = oh < x.shape[-2] or ow < x.shape[-1]
    return F.interpolate(x, size=(oh, ow), mode="bilinear",
                         align_corners=False, antialias=shrinks)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    return resize_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2))


def adaptive_avg_pool(x: torch.Tensor, out_hw) -> torch.Tensor:
    if tuple(x.shape[-2:]) == (int(out_hw[0]), int(out_hw[1])):
        return x
    return F.adaptive_avg_pool2d(x, (int(out_hw[0]), int(out_hw[1])))


def pool_nhwc(x: torch.Tensor, out_hw) -> torch.Tensor:
    return to_nhwc(adaptive_avg_pool(to_nchw(x), out_hw))


def replication_pad(x: torch.Tensor, pad: int = 1) -> torch.Tensor:
    return F.pad(x, (pad,) * 4, mode="replicate")
