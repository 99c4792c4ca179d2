"""MGNet: the cascade BRDF encoder/decoder family (NCHW ``nn.Module``s).

The counterpart of the JAX package's ``models/mgnet.py``: a 6-conv stride-2
encoder (3 or 17 -> 64 -> 128 -> 256 -> 256 -> 512 -> 1024, GroupNorm+ReLU,
replication pad on conv1 / zero pad after) and a U-Net style decoder with
bilinear x2 upsampling and skip concatenation, with per-task output heads:

  mode 0 (albedo): clamp(1.01 tanh, -1, 1)
  mode 1 (normal): clamp(1.01 tanh) then L2-normalize over channels
  mode 2 (rough):  clamp(1.01 tanh) then channel mean
  mode 3:          softmax over channels
  mode 4 (depth):  channel mean then clamp(1.01 tanh)

Submodules carry the reference's state-dict names (``conv{i}``/``gn{i}``,
``dconv{i}``/``dgn{i}``/``dconvFinal``), so a reference checkpoint loads
with ``load_state_dict`` directly.

``compute_dtype`` (a module attribute, not state) is the cast of the
convs, as the JAX modules' ``dtype``: ``torch.bfloat16`` casts each
conv's input, kernel and bias to bf16, GroupNorm takes its statistics
and normalizes in float32 and hands back bf16 (flax promotes a
half-precision input's statistics), and the heads run in float32;
``None`` (float32) casts nothing.  The parameters stay float32 in
either dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from inverserenderingofindoorscene_torch.core.imageops import (
    replication_pad,
    resize_bilinear,
    upsample2x,
)

GN_EPS = 1e-5  # torch nn.GroupNorm default

# the JAX package's ``compute_dtype`` names -> the dtype the convs cast
# to; None: no cast, the params' own dtype (float32, or float64 where a
# check moves a copy of the nets there)
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}

# (out channels, groups, kernel, stride, edge pad) of the six encoder convs
_ENC_SPEC = (
    (64, 4, 4, 2, True),
    (128, 8, 4, 2, False),
    (256, 16, 4, 2, False),
    (256, 16, 4, 2, False),
    (512, 32, 4, 2, False),
    (1024, 64, 3, 1, False),
)
# (out channels, groups) of the six decoder convs
_DEC_SPEC = ((512, 32), (256, 16), (256, 16), (128, 8), (64, 4), (64, 4))


def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialize every conv and GroupNorm of ``module`` from ``generator``.

    Conv kernels: LeCun normal (variance 1/fan_in, the scale of the flax
    ``nn.Conv`` default, untruncated); biases zero; GroupNorm scale 1,
    bias 0.  The draws come from ``generator`` alone, so equal seeds give
    equal weights.  Runs on the CPU tensors of a freshly built module."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.normal_(0.0, math.sqrt(1.0 / fan_in),
                                 generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.GroupNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
    return module


def compute_dtype_of(name: str):
    """The cast of a ``compute_dtype`` name (:data:`COMPUTE_DTYPES`)."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute dtype {name!r} is not one of "
                         f"{sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


class ComputeDtype:
    """The ``compute_dtype`` of a bundle of nets (``BRDFNets``,
    ``LightNets``): a name of :data:`COMPUTE_DTYPES`, set on every net
    named in the class's ``dtype_nets`` as its cast."""

    dtype_nets: tuple = ()

    @property
    def compute_dtype(self) -> str:
        return self._compute_dtype

    @compute_dtype.setter
    def compute_dtype(self, name: str) -> None:
        dtype = compute_dtype_of(name)
        self._compute_dtype = name
        for net in self.dtype_nets:
            getattr(self, net).compute_dtype = dtype


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` promoted to at least float32 (a bf16 tensor to float32)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def conv_in(conv: nn.Conv2d, x: torch.Tensor, dtype) -> torch.Tensor:
    """``conv`` computed in ``dtype``: its input, kernel and bias cast to
    it (flax's ``nn.Conv(dtype=...)``); ``None`` is ``conv(x)``."""
    if dtype is None:
        return conv(x)
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype),
                    conv.stride, conv.padding)


def group_norm_in(gn: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """``gn`` with its statistics and normalization in at least float32,
    returned in ``x``'s dtype (flax's ``nn.GroupNorm(dtype=...)``
    promotes a half-precision input so).  On float32 this is ``gn(x)``."""
    return F.group_norm(at_least_f32(x), gn.num_groups, gn.weight, gn.bias,
                        gn.eps).to(x.dtype)


def conv_block(conv: nn.Conv2d, gn: nn.GroupNorm, x: torch.Tensor,
               edge_pad: bool, dtype=None) -> torch.Tensor:
    """pad -> conv -> GroupNorm -> ReLU in ``dtype`` (``None``: the
    params' own); the conv carries the zero pad."""
    if dtype is not None:
        x = x.to(dtype)
    if edge_pad:
        x = replication_pad(x, 1)
    return F.relu(group_norm_in(gn, conv_in(conv, x, dtype)))


def add_encoder_convs(enc: nn.Module, spec, cin: int) -> None:
    """``conv{i}``/``gn{i}`` from (out, groups, kernel, stride, edge pad)."""
    for i, (cout, groups, k, s, edge) in enumerate(spec, start=1):
        setattr(enc, f"conv{i}",
                nn.Conv2d(cin, cout, k, s, padding=0 if edge else 1))
        setattr(enc, f"gn{i}", nn.GroupNorm(groups, cout, eps=GN_EPS))
        cin = cout


def encoder_feats(enc: nn.Module, spec, x: torch.Tensor):
    """Run the convs of :func:`add_encoder_convs` in the encoder's
    ``compute_dtype``; every block's output."""
    feats = []
    for i, block in enumerate(spec, start=1):
        x = conv_block(getattr(enc, f"conv{i}"), getattr(enc, f"gn{i}"), x,
                       block[4], enc.compute_dtype)
        feats.append(x)
    return tuple(feats)


def add_decoder_convs(dec: nn.Module, spec, skips) -> None:
    """``dconv{i}``/``dgn{i}`` from (out, groups): block i > 1 takes block
    i-1's output concatenated with ``skips[i-2]`` (x5 .. x1 channels)."""
    cin = 1024
    for i, (cout, groups) in enumerate(spec, start=1):
        setattr(dec, f"dconv{i}", nn.Conv2d(cin, cout, 3, 1, padding=1))
        setattr(dec, f"dgn{i}", nn.GroupNorm(groups, cout, eps=GN_EPS))
        if i <= len(skips):
            cin = cout + skips[i - 1]


def _match_hw(x: torch.Tensor, ref_hw) -> torch.Tensor:
    if tuple(x.shape[-2:]) != tuple(ref_hw):
        x = resize_bilinear(x, ref_hw)
    return x


class Encoder(nn.Module):
    """6-conv encoder returning all feature maps for U-Net skips.

    in_channels is 3 at cascade 0 and 17 at cascade >= 1
    (im3 + albedo3 + normal3 + rough1 + depth1 + diffuse3 + specular3).
    The input is cast to ``compute_dtype`` at entry, and so are the
    features.
    """

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.in_channels = in_channels
        self.compute_dtype = None  # set by BRDFNets / LightNets
        add_encoder_convs(self, _ENC_SPEC, in_channels)

    def forward(self, x: torch.Tensor):
        if x.shape[1] != self.in_channels:
            raise ValueError(f"Encoder takes {self.in_channels} channels, "
                             f"got {tuple(x.shape)}")
        return encoder_feats(self, _ENC_SPEC, x)


def apply_head(x_orig: torch.Tensor, mode: int) -> torch.Tensor:
    """Per-task output transform on the final NCHW 3-channel conv output."""
    if mode == 0:
        return torch.clamp(1.01 * torch.tanh(x_orig), -1.0, 1.0)
    if mode == 1:
        x = torch.clamp(1.01 * torch.tanh(x_orig), -1.0, 1.0)
        norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
        return x / torch.clamp(norm, min=1e-6)
    if mode == 2:
        x = torch.clamp(1.01 * torch.tanh(x_orig), -1.0, 1.0)
        return torch.mean(x, dim=1, keepdim=True)
    if mode == 3:
        return torch.softmax(x_orig, dim=1)
    if mode == 4:
        x = torch.mean(x_orig, dim=1, keepdim=True)
        return torch.clamp(1.01 * torch.tanh(x), -1.0, 1.0)
    raise ValueError(f"unknown decoder mode {mode}")


def decoder_trunk(dec: nn.Module, out_hw, feats):
    """The shared U-Net trunk of ``Decoder`` and ``LightDecoder``.

    ``dec`` holds ``dconv1..6``/``dgn1..6``/``dconvFinal``; ``feats`` are
    the six encoder maps.  Each block after the first upsamples the
    concatenation of the previous block and its skip 2x, convolves, and
    is resized to the next skip's size where the 2x does not hit it.
    Everything runs in ``dec.compute_dtype``.  Returns the final conv
    output (no head), in that dtype."""
    dtype = dec.compute_dtype
    skips = list(feats[:-1])
    x = conv_block(dec.dconv1, dec.dgn1, feats[-1], False, dtype)
    for i in range(2, len(feats) + 1):
        skip = skips.pop()
        x = upsample2x(torch.cat([x, skip], dim=1))
        x = conv_block(getattr(dec, f"dconv{i}"), getattr(dec, f"dgn{i}"),
                       x, False, dtype)
        x = _match_hw(x, skips[-1].shape[-2:] if skips else out_hw)
    return conv_in(dec.dconvFinal, replication_pad(x, 1), dtype)


class Decoder(nn.Module):
    """U-Net decoder over the 6 encoder features; output head by ``mode``.

    The trunk runs in ``compute_dtype``; the head math runs in at least
    float32 whatever it is (the LSregress-coupled losses are sensitive to
    the normalize/clamp chain), so a bf16 trunk's output is float32."""

    def __init__(self, mode: int = 0):
        super().__init__()
        self.mode = mode
        self.compute_dtype = None  # set by BRDFNets / LightNets
        add_decoder_convs(self, _DEC_SPEC, (512, 256, 256, 128, 64))
        self.dconvFinal = nn.Conv2d(64, 3, 3, 1, padding=0)

    def forward(self, im: torch.Tensor, feats) -> torch.Tensor:
        x = decoder_trunk(self, im.shape[-2:], feats)
        return apply_head(at_least_f32(x), self.mode)
