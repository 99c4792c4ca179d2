"""LightNet: spatially-varying lighting encoder/decoders (NCHW modules).

The counterpart of the JAX package's ``models/lightnet.py``: the encoder
pre-processes an 11-channel input at 4x the lighting grid (im3 + albedo3 +
0.5(normal+1)3 + 0.5(rough+1)1 + depth1) with two stride-2 convs,
concatenates the previous cascade's SG tensor (sg_num*7 channels) at
cascade >= 1, then runs 6 more convs to 1024 channels.  Three decoders
emit the SG parameters on the lighting grid:

  mode 0 (axis):   3*sg channels, unit-normalized per lobe -> [..., sg, 3]
  mode 1 (lambda): sg channels in [0, 1]
  mode 2 (weight): 3*sg channels in [0, 1] -> [..., sg, 3]

The final conv is applied once, as in the JAX package.  State-dict names
are the reference's: ``preProcess.1/.2/.5/.6`` (an ``nn.Sequential``),
``conv{i}``/``gn{i}``, ``dconv{i}``/``dgn{i}``/``dconvFinal``.
``compute_dtype`` is the convs' dtype, as in ``models/mgnet.py``: the
input and ``env_pre`` are cast to it at entry, and a bf16 last conv's
output goes to float32 before ``1.01 tanh``, so the SG outputs are
float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from inverserenderingofindoorscene_torch.models.mgnet import (
    GN_EPS,
    add_decoder_convs,
    add_encoder_convs,
    at_least_f32,
    conv_block,
    decoder_trunk,
    encoder_feats,
)

# (out channels, groups, kernel, stride, edge pad) of the six convs after
# the preProcess stage
_ENC_SPEC = (
    (128, 8, 4, 2, True),
    (256, 16, 4, 2, False),
    (256, 16, 4, 2, False),
    (512, 32, 4, 2, False),
    (512, 32, 4, 2, False),
    (1024, 64, 3, 1, False),
)
_DEC_SPEC = ((512, 32), (512, 32), (256, 16), (256, 16), (128, 8), (128, 8))


class LightEncoder(nn.Module):
    def __init__(self, sg_num: int = 12, cascade_level: int = 0):
        super().__init__()
        self.sg_num = sg_num
        self.cascade_level = cascade_level
        self.compute_dtype = None  # set by BRDFNets / LightNets
        # 11ch @ 4x grid -> 64ch @ grid: [edge pad, conv, gn, relu,
        # zero pad, conv, gn, relu] (indices 1/2/5/6 carry the params)
        self.preProcess = nn.Sequential(
            nn.ReplicationPad2d(1),
            nn.Conv2d(11, 32, 4, 2),
            nn.GroupNorm(2, 32, eps=GN_EPS),
            nn.ReLU(),
            nn.ZeroPad2d(1),
            nn.Conv2d(32, 64, 4, 2),
            nn.GroupNorm(4, 64, eps=GN_EPS),
            nn.ReLU(),
        )
        add_encoder_convs(self, _ENC_SPEC,
                          64 + (sg_num * 7 if cascade_level > 0 else 0))

    def forward(self, x: torch.Tensor,
                env_pre: Optional[torch.Tensor] = None):
        """x [B,11,4R,4C]; env_pre [B,sg*7,R,C] at cascade >= 1."""
        pp, dtype = self.preProcess, self.compute_dtype
        h = conv_block(pp[1], pp[2], x, True, dtype)
        h = conv_block(pp[5], pp[6], pp[4](h), False, dtype)
        if self.cascade_level > 0:
            if env_pre is None:
                raise ValueError("cascade > 0 needs the previous SG tensor")
            h = torch.cat([h, env_pre.to(h.dtype)], dim=1)
        return encoder_feats(self, _ENC_SPEC, h)


class LightDecoder(nn.Module):
    """mode 0 = axis, 1 = lambda, 2 = weight; output on the env grid.

    Returns NCHW: [B, sg*3, R, C] for axis/weight (lobe-major, xyz/rgb
    minor), [B, sg, R, C] for lambda."""

    def __init__(self, sg_num: int = 12, mode: int = 0):
        super().__init__()
        self.sg_num = sg_num
        self.mode = mode
        self.compute_dtype = None  # set by BRDFNets / LightNets
        add_decoder_convs(self, _DEC_SPEC, (512, 512, 256, 256, 128))
        out_ch = sg_num if mode == 1 else 3 * sg_num
        self.dconvFinal = nn.Conv2d(128, out_ch, 3, 1, padding=0)

    def forward(self, feats, env_hw=(120, 160)) -> torch.Tensor:
        x = 1.01 * torch.tanh(at_least_f32(decoder_trunk(self, env_hw, feats)))
        if self.mode in (1, 2):
            return torch.clamp(0.5 * (x + 1.0), 0.0, 1.0)
        b, _, h, w = x.shape
        x = x.reshape(b, self.sg_num, 3, h, w)
        norm = torch.sqrt(torch.sum(x * x, dim=2, keepdim=True))
        return (x / torch.clamp(norm, min=1e-6)).reshape(b, -1, h, w)
