"""Confidence CNN of the bilateral solver (an NCHW ``nn.Module``).

The counterpart of the JAX package's ``models/bilateral_net.py`` (the
reference ``BilateralLayer`` CNN): a 2-down/2-up net (k4s2 conv x2 -> k3
conv -> upsample + skip -> k3 conv -> upsample -> k3 head) predicting a
per-pixel confidence in [0, 1], divided by its maximum over the whole
batch tensor, and over the ranks of a process group when one is given.
Submodules carry the reference's state-dict names (``conv1``/``gn1``,
``conv2``/``gn2``, ``dconv1``/``dgn1``, ``dconv2``/``dgn2``,
``dconvFinal``), so a reference checkpoint loads with ``load_state_dict``
directly.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from inverserenderingofindoorscene_torch.core.imageops import (
    replication_pad,
    resize_bilinear,
)
from inverserenderingofindoorscene_torch.models.mgnet import GN_EPS
from inverserenderingofindoorscene_torch.parallel.collectives import amax

FEATS = 16


class ConfidenceNet(nn.Module):
    """in_channels = 6 for albedo (image 3 + prediction 3), 4 for rough and
    depth.  Weights are left to the caller (``init_weights``)."""

    def __init__(self, in_channels: int = 6):
        super().__init__()
        self.in_channels = in_channels
        self.conv1 = nn.Conv2d(in_channels, FEATS, 4, 2)
        self.gn1 = nn.GroupNorm(2, FEATS, eps=GN_EPS)
        self.conv2 = nn.Conv2d(FEATS, FEATS, 4, 2)
        self.gn2 = nn.GroupNorm(2, FEATS, eps=GN_EPS)
        self.dconv1 = nn.Conv2d(FEATS, FEATS, 3, 1, padding=1)
        self.dgn1 = nn.GroupNorm(2, FEATS, eps=GN_EPS)
        self.dconv2 = nn.Conv2d(2 * FEATS, FEATS, 3, 1, padding=1)
        self.dgn2 = nn.GroupNorm(2, FEATS, eps=GN_EPS)
        self.dconvFinal = nn.Conv2d(FEATS, 1, 3, 1)

    def forward(self, image: torch.Tensor, pred: torch.Tensor,
                group=None) -> torch.Tensor:
        """image [B,3,H,W], pred [B,C,H,W].  Returns conf [B,1,H,W].

        The image is max-normalized per image (clamped to 1e-5..1,
        BilateralLayer.py:246-250) and the input concat is detached, like
        the reference's ``.detach()``.  ``group``: the ranks whose rows
        make up the batch; the divisor is then the maximum over all of
        them, as the JAX step's one SPMD program takes it over the global
        batch, and its gradient reaches the rank that holds it."""
        b = image.shape[0]
        scale = torch.clamp(torch.amax(image.reshape(b, -1), dim=1),
                            1e-5, 1.0).reshape(b, 1, 1, 1)
        x = torch.cat([image / scale, pred], dim=1).detach()
        if x.shape[1] != self.in_channels:
            raise ValueError(f"{x.shape[1]} input channels, expected "
                             f"{self.in_channels}")
        x1 = F.relu(self.gn1(self.conv1(replication_pad(x, 1))))
        x2 = F.relu(self.gn2(self.conv2(replication_pad(x1, 1))))
        dx1 = F.relu(self.dgn1(self.dconv1(x2)))
        dx1 = resize_bilinear(dx1, x1.shape[-2:])
        dx2 = F.relu(self.dgn2(self.dconv2(torch.cat([dx1, x1], dim=1))))
        dx2 = resize_bilinear(dx2, x.shape[-2:])
        out = self.dconvFinal(replication_pad(dx2, 1))
        conf = 0.5 * (torch.tanh(out) + 1.0)
        # the maximum over the whole batch tensor (BilateralLayer.py:269)
        return conf / torch.clamp(amax(conf, group), min=1e-5)
