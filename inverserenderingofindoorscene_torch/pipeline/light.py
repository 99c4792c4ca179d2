"""Lighting stack: the light encoder and its three SG decoders as one
module, and the assembly of the light-encoder input.

The counterpart of the JAX package's ``pipeline/light.py`` (``LightNets``,
``mean_normalize``, ``light_input_from_preds``); the training step comes
with a later part of the port.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from inverserenderingofindoorscene_torch.core.imageops import resize_bilinear
from inverserenderingofindoorscene_torch.models.lightnet import (
    LightDecoder,
    LightEncoder,
)
from inverserenderingofindoorscene_torch.models.mgnet import init_weights

# decoder name -> mode
SG_HEADS = {"axis": 0, "lamb": 1, "weight": 2}


class LightNets(nn.Module):
    """LightEncoder + axis/lamb/weight decoders for one cascade level.

    Weights are drawn from ``generator`` (``None`` means seed 0)."""

    def __init__(self, *, sg_num: int = 12, cascade_level: int = 0,
                 env_rows: int = 120, env_cols: int = 160,
                 env_height: int = 8, env_width: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.sg_num = sg_num
        self.cascade_level = cascade_level
        self.env_rows, self.env_cols = env_rows, env_cols
        self.env_height, self.env_width = env_height, env_width
        self.encoder = LightEncoder(sg_num=sg_num, cascade_level=cascade_level)
        for name, mode in SG_HEADS.items():
            setattr(self, name, LightDecoder(sg_num=sg_num, mode=mode))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights(self, generator)

    @property
    def light_hw(self):
        """Light-encoder input size: 4x the lighting grid."""
        return (self.env_rows * 4, self.env_cols * 4)

    def forward(self, inp: torch.Tensor, env_hw,
                env_pre: Optional[torch.Tensor] = None) -> dict:
        """inp [B,11,4R,4C]; env_pre [B,sg*7,R,C] at cascade >= 1.
        Returns NCHW decoder outputs keyed axis / lamb / weight."""
        feats = self.encoder(inp, env_pre)
        return {name: getattr(self, name)(feats, env_hw) for name in SG_HEADS}


def mean_normalize(x: torch.Tensor) -> torch.Tensor:
    """x / max(mean(x), 1e-10) / 3 per batch element (any layout)."""
    b = x.shape[0]
    m = torch.clamp(torch.mean(x.reshape(b, -1), dim=1), min=1e-10)
    return x / m.reshape((b,) + (1,) * (x.dim() - 1)) / 3.0


def light_input_from_preds(im: torch.Tensor, preds: dict,
                           light_hw=(480, 640)) -> torch.Tensor:
    """The 11-channel light-encoder input, NCHW in and out.

    preds' albedo/depth must already be mean-normalized; normal and rough
    are shifted to [0,1] and everything is bilinearly upsampled to
    light_hw in one 11-channel resize (bilinear interpolation is
    channelwise, so this equals five separate resizes)."""
    stacked = torch.cat(
        [
            im,
            preds["albedo"],
            0.5 * (preds["normal"] + 1.0),
            0.5 * (preds["rough"] + 1.0),
            preds["depth"],
        ],
        dim=1,
    )
    return resize_bilinear(stacked, light_hw)
