"""Convolutions one precision below a configuration's: the controls of
the benchmark's comparison.

* :func:`conv_tf32`: float32 inputs and kernel rounded to TF32 (10
  mantissa bits, round to nearest even), summed in float32: what a float32
  convolution with TF32 allowed computes.  The control of a float32
  configuration with TF32 off.
* :func:`conv_fp8`: input and kernel scaled per tensor onto float8 e4m3
  (amax to 448) and back, summed in float32: an fp8 convolution with
  per-tensor scales.  The control of a bfloat16 configuration.

:data:`ROUNDING` gives each control's rounding for the shading's sums
over directions (``sg.render_envmap``), the contraction a lower-precision
render would hand to tensor cores.

Both round explicitly, so they read the same on every device.  A
gradient passes each rounding unchanged (straight through), as it passes
the casts of a low-precision training step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _straight_through(x, rounded):
    return x + (rounded - x).detach()


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    i = x.detach().float().contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return _straight_through(x, i.view(torch.float32))


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    d = x.detach().float()
    scale = torch.clamp(d.abs().amax(), min=1e-30) / FP8_MAX
    q = (d / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return _straight_through(x, q)


def conv_tf32(x, weight, bias, stride, padding):
    return F.conv2d(round_tf32(x), round_tf32(weight), bias, stride, padding)


def conv_fp8(x, weight, bias, stride, padding):
    return F.conv2d(round_fp8(x), round_fp8(weight), bias, stride, padding)


CONTROLS = {"tf32": conv_tf32, "fp8": conv_fp8}
# a control's rounding of the operands of the shading's sums
ROUNDING = {conv_tf32: round_tf32, conv_fp8: round_fp8}
