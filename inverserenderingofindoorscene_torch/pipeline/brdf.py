"""Cascade BRDF stack: the encoder and its four decoder heads as one module.

The counterpart of the JAX package's ``pipeline/brdf.py:BRDFNets``; here
the bundle owns its weights.  Submodule names (``encoder``, ``albedo``,
``normal``, ``rough``, ``depth``) prefix the reference's per-network
state-dict names.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from inverserenderingofindoorscene_torch.models.mgnet import (
    Decoder,
    Encoder,
    init_weights,
)

# decoder name -> head mode (albedo / normal / rough / depth)
HEADS = {"albedo": 0, "normal": 1, "rough": 2, "depth": 4}


class BRDFNets(nn.Module):
    """Encoder + 4 decoders for one cascade level.

    Weights are drawn from ``generator`` (a seeded ``torch.Generator``;
    ``None`` means seed 0) on the CPU; move the module with ``.to``."""

    def __init__(self, cascade_level: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cascade_level = cascade_level
        self.encoder = Encoder(in_channels=3 if cascade_level == 0 else 17)
        for name, mode in HEADS.items():
            setattr(self, name, Decoder(mode=mode))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights(self, generator)

    def forward(self, im: torch.Tensor, inp: torch.Tensor) -> dict:
        """im [B,3,H,W]; inp the encoder input (im itself at cascade 0).
        Returns the raw head outputs, NCHW, keyed by decoder name."""
        feats = self.encoder(inp)
        return {name: getattr(self, name)(im, feats) for name in HEADS}
