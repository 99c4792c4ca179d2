"""Lighting stack: the light encoder and its three SG decoders as one
module, the assembly of the light-encoder input, and the forward and
losses of lighting training.

The counterpart of the JAX package's ``pipeline/light.py`` (``LightNets``,
``light_input_from_preds``, ``light_forward``, ``light_step``), at both
cascade levels; its ``mean_normalize`` is ``core/scale.py``'s.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from inverserenderingofindoorscene_torch.core import sg
from inverserenderingofindoorscene_torch.core.imageops import (
    resize_bilinear,
    to_nchw,
    to_nhwc,
)
from inverserenderingofindoorscene_torch.core.render_layer import (
    RenderLayer,
    pool_nhwc,
)
from inverserenderingofindoorscene_torch.core.scale import mean_normalize
from inverserenderingofindoorscene_torch.losses.masked import (
    envmap_reconst_error,
    render_error,
)
from inverserenderingofindoorscene_torch.models.lightnet import (
    LightDecoder,
    LightEncoder,
)
from inverserenderingofindoorscene_torch.models.mgnet import (
    ComputeDtype,
    compute_dtype_of,
    init_weights,
)
from inverserenderingofindoorscene_torch.ops.sg_render import (
    render_sg,
    sg_envmap,
)
from inverserenderingofindoorscene_torch.pipeline.brdf import brdf_step

# decoder name -> mode
SG_HEADS = {"axis": 0, "lamb": 1, "weight": 2}


class LightNets(ComputeDtype, nn.Module):
    """LightEncoder + axis/lamb/weight decoders for one cascade level.

    Weights are drawn from ``generator`` (``None`` means seed 0).
    ``compute_dtype`` as in ``BRDFNets``: the conv stacks' dtype, the
    parameters and the SG outputs float32."""

    dtype_nets = ("encoder",) + tuple(SG_HEADS)

    def __init__(self, *, sg_num: int = 12, cascade_level: int = 0,
                 env_rows: int = 120, env_cols: int = 160,
                 env_height: int = 8, env_width: int = 16,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: str = "float32"):
        super().__init__()
        self.sg_num = sg_num
        self.cascade_level = cascade_level
        self.env_rows, self.env_cols = env_rows, env_cols
        self.env_height, self.env_width = env_height, env_width
        self.encoder = LightEncoder(sg_num=sg_num, cascade_level=cascade_level)
        for name, mode in SG_HEADS.items():
            setattr(self, name, LightDecoder(sg_num=sg_num, mode=mode))
        self.compute_dtype = compute_dtype
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


def light_input_from_preds(im: torch.Tensor, preds: dict,
                           light_hw=(480, 640),
                           dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    """The 11-channel light-encoder input, NCHW in and out.

    preds' albedo/depth must already be mean-normalized; normal and rough
    are shifted to [0,1] and everything is bilinearly upsampled to
    light_hw in one 11-channel resize (bilinear interpolation is
    channelwise, so this equals five separate resizes).  ``dtype``: a
    cast applied BEFORE the resize, as the JAX package does for a bf16
    encoder (the input is detached; the float32 preds still feed the
    losses)."""
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
    if dtype is not None:
        stacked = stacked.to(dtype)
    return resize_bilinear(stacked, light_hw)


def light_forward(nets: LightNets, im: torch.Tensor, brdf_preds: dict,
                  env_pre: Optional[torch.Tensor] = None) -> dict:
    """Light encoder + 3 SG decoders on NHWC inputs.

    preds' albedo/depth must already be mean-normalized.  The 11-channel
    input (and env_pre) are detached, as in the reference.  Returns axis
    [B,R,C,K,3], lamb01 [B,R,C,K], weight01 [B,R,C,K,3] and the flat
    ``sg_flat`` [B,R,C,7K] ([axis | lamb | weight]), all NHWC."""
    inp = light_input_from_preds(
        to_nchw(im), {k: to_nchw(v) for k, v in brdf_preds.items()},
        nets.light_hw,
        # bf16: assemble and resize in bf16, as the JAX light_forward does
        dtype=compute_dtype_of(nets.compute_dtype),
    ).detach()
    if nets.cascade_level > 0:
        env_pre = to_nchw(env_pre.detach())
    r, c = nets.env_rows, nets.env_cols
    out = {k: to_nhwc(v) for k, v in nets(inp, (r, c), env_pre).items()}
    b, k = out["lamb"].shape[0], nets.sg_num
    return {
        "axis": out["axis"].reshape(b, r, c, k, 3),
        "lamb01": out["lamb"],
        "weight01": out["weight"].reshape(b, r, c, k, 3),
        "sg_flat": torch.cat([out["axis"], out["lamb"], out["weight"]],
                             dim=-1),
    }


def light_step(brdf_nets, light_nets: LightNets, batch: dict,
               offset: float = 1.0, use_kernels: bool = True):
    """The BRDF + light forward and the losses of lighting training.

    batch: NHWC tensors im/albedo/normal/rough/depth/seg_brdf/seg_all
    (image resolution), env_gt [B,R,C,D,3] and env_ind [B,1], and at
    cascade >= 1 the previous cascade's ``*_pre`` maps and ``env_pre``
    [B,R,C,7K] (the light encoder's extra input).  The BRDF
    stack is frozen: it runs under ``torch.no_grad()`` and its four errors
    are reported only.  ``use_kernels`` mirrors the JAX package's
    ``use_pallas``: the SG decode of the reconstruction loss and the
    decode + shading of the render loss go through ``ops.sg_render``'s
    ``sg_envmap`` and ``render_sg`` (the CUDA kernels on CUDA tensors)
    instead of ``sg_to_envmap`` + ``RenderLayer``.

    Returns (losses, aux): losses albedo/normal/rough/depth/reconst/render.
    """
    with torch.no_grad():
        preds, errors = brdf_step(brdf_nets, batch)
    preds = dict(preds)
    preds["albedo"] = mean_normalize(preds["albedo"])
    preds["depth"] = mean_normalize(preds["depth"])

    im = batch["im"]
    env_pre = batch["env_pre"] if light_nets.cascade_level > 0 else None
    sg_out = light_forward(light_nets, im, preds, env_pre)
    r, c = light_nets.env_rows, light_nets.env_cols
    eh, ew = light_nets.env_height, light_nets.env_width
    im_small = pool_nhwc(im, (r, c))
    seg_small = pool_nhwc(batch["seg_brdf"], (r, c))

    env_gt = batch["env_gt"]  # [B,R,C,D,3]
    not_dark = torch.mean(env_gt, dim=(-2, -1))[..., None] > 0.001
    env_ind = batch["env_ind"].reshape(-1, 1, 1, 1)
    seg_env = seg_small * env_ind * not_dark.to(im.dtype)  # [B,R,C,1]

    axis = sg_out["axis"]
    lamb = sg.unsquash(sg_out["lamb01"])
    weight = sg.unsquash(sg_out["weight01"])
    if use_kernels:
        env_pred = sg_envmap(axis, lamb, weight, eh, ew)
    else:
        env_pred = sg.sg_to_envmap(axis, lamb, weight, eh, ew)
    reconst_err, env_scaled = envmap_reconst_error(env_pred, env_gt, seg_env,
                                                   offset)

    albedo = preds["albedo"].detach()
    if use_kernels:
        # decode + shade in one kernel; env_pred above only feeds the
        # reconstruction loss
        diffuse, specular = render_sg(
            pool_nhwc(albedo, (r, c)), pool_nhwc(preds["normal"], (r, c)),
            pool_nhwc(preds["rough"], (r, c)), axis, lamb, weight,
            env_height=eh, env_width=ew,
        )
    else:
        layer = RenderLayer(env_rows=r, env_cols=c, env_height=eh,
                            env_width=ew)
        diffuse, specular = layer.forward_env(albedo, preds["normal"],
                                              preds["rough"], env_pred)
    render_err, rendered = render_error(diffuse, specular, im_small,
                                        seg_small)

    losses = dict(errors)
    losses["reconst"] = reconst_err
    losses["render"] = render_err
    aux = {
        "brdf_preds": preds,
        "sg": sg_out,
        "env_pred": env_pred,
        "env_scaled": env_scaled,
        "diffuse": diffuse,
        "specular": specular,
        "rendered": rendered,
    }
    return losses, aux
