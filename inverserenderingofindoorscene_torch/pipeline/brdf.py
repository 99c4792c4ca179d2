"""Cascade BRDF stack: the encoder and its four decoder heads as one module,
and its forward and masked errors on a training batch.

The counterpart of the JAX package's ``pipeline/brdf.py``, at both cascade
levels; here the bundle owns its weights.  Submodule names (``encoder``,
``albedo``, ``normal``, ``rough``, ``depth``) prefix the reference's
per-network state-dict names.
Batches and predictions are NHWC, as in the JAX package; the networks run
in NCHW.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from inverserenderingofindoorscene_torch.core.imageops import (
    adaptive_avg_pool,
    resize_bilinear,
    to_nchw,
    to_nhwc,
)
from inverserenderingofindoorscene_torch.core.scale import (
    ls_regress_diff_spec,
    mean_normalize,
)
from inverserenderingofindoorscene_torch.losses.masked import brdf_errors
from inverserenderingofindoorscene_torch.models.mgnet import (
    ComputeDtype,
    Decoder,
    Encoder,
    init_weights,
)

# decoder name -> head mode (albedo / normal / rough / depth)
HEADS = {"albedo": 0, "normal": 1, "rough": 2, "depth": 4}


class BRDFNets(ComputeDtype, nn.Module):
    """Encoder + 4 decoders for one cascade level.

    Weights are drawn from ``generator`` (a seeded ``torch.Generator``;
    ``None`` means seed 0) on the CPU; move the module with ``.to``.
    ``compute_dtype``: "float32" or "bfloat16", the dtype the conv stacks
    run in (the parameters and the heads stay float32); it is not part of
    the state dict, and may be set on built nets."""

    dtype_nets = ("encoder",) + tuple(HEADS)

    def __init__(self, cascade_level: int = 0,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: str = "float32"):
        super().__init__()
        self.cascade_level = cascade_level
        self.encoder = Encoder(in_channels=3 if cascade_level == 0 else 17)
        for name, mode in HEADS.items():
            setattr(self, name, Decoder(mode=mode))
        self.compute_dtype = compute_dtype
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights(self, generator)

    def forward(self, im: torch.Tensor, inp: torch.Tensor,
                heads=tuple(HEADS)) -> dict:
        """im [B,3,H,W]; inp the encoder input (im itself at cascade 0).
        Returns the raw outputs of ``heads`` (decoder names; all four by
        default), NCHW, keyed by decoder name: a decoder not asked for
        does not run."""
        feats = self.encoder(inp)
        return {name: getattr(self, name)(im, feats) for name in heads}


def prepare_cascade_input(batch: dict, im_hw) -> torch.Tensor:
    """The 17-channel encoder input of cascade >= 1, NHWC [B,H,W,17]:
    im, albedo_pre, normal_pre, rough_pre, depth_pre, diffuse_pre,
    specular_pre.

    The ``*_pre`` maps (NHWC, at the lighting grid or at image size) are
    bilinearly upsampled where they are smaller than ``im_hw``; the
    diffuse/specular pair is first fitted onto the image pooled to its
    own size (:func:`ls_regress_diff_spec` on the detached pair); albedo
    and depth are mean-normalized to 1/3."""
    h, w = im_hw
    im = to_nchw(batch["im"])

    def pre(key):
        return to_nchw(batch[key])

    def up(x):
        if x.shape[2] < h or x.shape[3] < w:
            return resize_bilinear(x, (h, w))
        return x

    diffuse, specular = pre("diffuse_pre"), pre("specular_pre")
    diffuse, specular = ls_regress_diff_spec(
        diffuse.detach(), specular.detach(),
        adaptive_avg_pool(im, diffuse.shape[2:]), diffuse, specular)
    return to_nhwc(torch.cat([
        im,
        mean_normalize(up(pre("albedo_pre"))),
        up(pre("normal_pre")),
        up(pre("rough_pre")),
        mean_normalize(up(pre("depth_pre"))),
        up(diffuse),
        up(specular),
    ], dim=1))


def brdf_forward(nets: BRDFNets, batch: dict, heads=tuple(HEADS)) -> dict:
    """Encoder + the decoders ``heads`` (all four by default) on
    ``batch["im"]`` [B,H,W,3]; NHWC preds keyed by head.

    The encoder sees ``im`` at cascade 0 and the 17 channels of
    :func:`prepare_cascade_input` at cascade >= 1; the decoders see
    ``im``.  albedo and depth are mapped from the tanh range to [0,1]
    with 0.5(x+1); normal is unit, rough in [-1,1]."""
    im = to_nchw(batch["im"])
    if nets.cascade_level == 0:
        inp = im
    else:
        inp = to_nchw(prepare_cascade_input(batch, im.shape[2:]))
    out = nets(im, inp, heads)
    return {k: to_nhwc(0.5 * (v + 1.0) if k in ("albedo", "depth") else v)
            for k, v in out.items()}


def brdf_step(nets: BRDFNets, batch: dict, group=None):
    """Forward + masked errors, global over ``group``'s ranks
    (``losses.masked``).  Returns (preds, errors)."""
    preds = brdf_forward(nets, batch)
    errors, _ = brdf_errors(preds["albedo"], preds["normal"], preds["rough"],
                            preds["depth"], batch, group)
    return preds, errors


def brdf_total_error(errors: dict, albedo_w: float = 1.5,
                     normal_w: float = 1.0, rough_w: float = 0.5,
                     depth_w: float = 0.5) -> torch.Tensor:
    """4 albedo_w albedo + normal_w normal + rough_w rough + depth_w depth."""
    return (4.0 * albedo_w * errors["albedo"] + normal_w * errors["normal"]
            + rough_w * errors["rough"] + depth_w * errors["depth"])
