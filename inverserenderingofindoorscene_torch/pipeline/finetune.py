"""Real-data fine-tunes: the IIW and NYU halves of the alternating cycle,
and the inline synthesis of a cascade-1 real-data batch's ``*_pre`` maps.

The counterpart of the JAX package's ``pipeline/finetune.py`` (the
reference's wrapperIIW / wrapperNYU).  The fine-tune CLIs alternate
one synthetic batch (the BRDF step) and one real-data batch on one
optimizer; here each half is a function of the nets and the batch, and
``train/steps.py`` holds the steps.  Tensors are NHWC.
"""

from __future__ import annotations

import math

import torch

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
from inverserenderingofindoorscene_torch.core.scale import (
    ls_regress,
    ls_regress_diff_spec,
    mean_normalize,
)
from inverserenderingofindoorscene_torch.losses.masked import global_sums
from inverserenderingofindoorscene_torch.losses.ranking import (
    batched_ranking_loss,
)
from inverserenderingofindoorscene_torch.ops.sg_render import render_sg
from inverserenderingofindoorscene_torch.parallel.collectives import psum
from inverserenderingofindoorscene_torch.pipeline.brdf import (
    HEADS,
    brdf_forward,
)
from inverserenderingofindoorscene_torch.pipeline.light import light_forward

PRE_KEYS = ("albedo_pre", "normal_pre", "rough_pre", "depth_pre",
            "diffuse_pre", "specular_pre", "env_pre")


@torch.no_grad()
def synthesize_pre(brdf_nets0, light_nets0, batch: dict,
                   use_kernels: bool = True) -> dict:
    """The ``*_pre`` inputs of a cascade-1 real-data batch from the frozen
    cascade-0 BRDF + light stack (the reference's
    trainFineTune*_cascade1): albedo and depth mean-normalized, normal and
    rough shifted to [0, 1], diffuse and specular shaded at the lighting
    grid and fitted onto the pooled image (``ls_regress_diff_spec``), and
    ``env_pre`` = the SG tensor ``sg_flat`` [B,R,C,7K].

    ``use_kernels`` as in ``light_step``: the decode + shading runs
    through ``ops.sg_render.render_sg`` on the pooled maps (one
    ``render_sg_fwd`` launch a call on CUDA tensors) instead of
    ``sg_to_envmap`` + ``RenderLayer``.  Returns ``batch`` with the seven
    keys added, all without gradient."""
    im = batch["im"]
    preds = dict(brdf_forward(brdf_nets0, {"im": im}))
    preds["albedo"] = mean_normalize(preds["albedo"])
    preds["depth"] = mean_normalize(preds["depth"])

    sg_out = light_forward(light_nets0, im, preds)
    lamb = sg.unsquash(sg_out["lamb01"])
    weight = sg.unsquash(sg_out["weight01"])
    r, c = light_nets0.env_rows, light_nets0.env_cols
    eh, ew = light_nets0.env_height, light_nets0.env_width
    if use_kernels:
        diffuse, specular = render_sg(
            pool_nhwc(preds["albedo"], (r, c)),
            pool_nhwc(preds["normal"], (r, c)),
            pool_nhwc(preds["rough"], (r, c)), sg_out["axis"], lamb, weight,
            env_height=eh, env_width=ew)
    else:
        env_img = sg.sg_to_envmap(sg_out["axis"], lamb, weight, eh, ew)
        layer = RenderLayer(env_rows=r, env_cols=c, env_height=eh,
                            env_width=ew)
        diffuse, specular = layer.forward_env(preds["albedo"], preds["normal"],
                                              preds["rough"], env_img)
    diffuse, specular = ls_regress_diff_spec(
        diffuse, specular, pool_nhwc(im, (r, c)), diffuse, specular)

    out = dict(batch)
    out.update({
        "albedo_pre": preds["albedo"],
        "normal_pre": 0.5 * (preds["normal"] + 1.0),
        "rough_pre": 0.5 * (preds["rough"] + 1.0),
        "depth_pre": preds["depth"],
        "diffuse_pre": diffuse,
        "specular_pre": specular,
        "env_pre": sg_out["sg_flat"],
    })
    return out


def iiw_step(nets, batch: dict, heads=tuple(HEADS)):
    """The BRDF forward and the per-image ranking losses averaged over the
    batch (the reference's wrapperIIW).

    batch keys: im [B,H,W,3], eq_point [B,N,4], eq_weight [B,N], eq_num
    [B], darker_* likewise, and at cascade >= 1 the ``*_pre`` maps
    (:func:`synthesize_pre`).  ``heads``: the decoders to run (the loss
    reads albedo only).  Returns (preds, eq_loss, darker_loss)."""
    preds = brdf_forward(nets, batch, heads)
    eq_l, dk_l = batched_ranking_loss(
        preds["albedo"], batch["eq_point"], batch["eq_weight"],
        batch["darker_point"], batch["darker_weight"], batch["eq_num"],
        batch["darker_num"])
    b = preds["albedo"].shape[0]
    return preds, torch.sum(eq_l) / b, torch.sum(dk_l) / b


def nyu_step(nets, batch: dict, heads=tuple(HEADS), group=None):
    """The BRDF forward and the NYU normal and depth losses (the
    reference's wrapperNYU): :func:`brdf_forward` then
    :func:`nyu_losses`.

    batch keys: im, the ground truth normal [B,h,w,3] and depth [B,h,w,1]
    at its own size, seg_normal and seg_depth [B,h,w,1], and at cascade
    >= 1 the ``*_pre`` maps; ``heads``, the decoders to run (the losses
    read normal and depth); ``group`` as in :func:`nyu_losses`.  Returns
    (preds, losses); preds gain ``normal_full`` and ``depth_full`` at the
    ground truth's size."""
    preds = brdf_forward(nets, batch, heads)
    losses, normal_pred, depth_pred = nyu_losses(preds["normal"],
                                                 preds["depth"], batch, group)
    preds = dict(preds)
    preds["normal_full"] = normal_pred
    preds["depth_full"] = depth_pred
    return preds, losses


def nyu_losses(normal_pred, depth_pred, batch: dict, group=None):
    """The NYU losses of NHWC normal and depth predictions, which are
    bilinearly resized to the ground truth's size first.

    The depth is rescaled onto the ground truth under seg_depth
    (``ls_regress``, coefficient detached, per image).  Returns (losses,
    normal, depth at the ground truth's size): ``normal`` and ``depth``
    (the masked errors, sums over the batch over the mask's pixel count,
    normal also over its 3 channels) and ``angle_deg``, the masked mean
    angle in degrees, reported only (computed without gradient, so
    arccos's slope at +-1 reaches none).  Over ``group``'s ranks, each
    holding its rows of the batch, both counts, both errors and the angle
    are summed before the division (JAX ``nyu_step``'s ``psum``), and the
    summed counts clamped."""
    normal_gt, depth_gt = batch["normal"], batch["depth"]
    hw = normal_gt.shape[1:3]

    def resize(x):
        return to_nhwc(resize_bilinear(to_nchw(x), hw))

    normal_pred = resize(normal_pred)
    depth_pred = resize(depth_pred)
    seg_n, seg_d = batch["seg_normal"], batch["seg_depth"]
    depth_pred = ls_regress(depth_pred.detach() * seg_d, depth_gt * seg_d,
                            depth_pred)

    normal_sum, n_normal = global_sums(
        torch.sum((normal_pred - normal_gt) ** 2 * seg_n), torch.sum(seg_n),
        group)
    depth_sum, n_depth = global_sums(
        torch.sum((torch.log(depth_pred + 0.1)
                   - torch.log(depth_gt + 0.1)) ** 2 * seg_d),
        torch.sum(seg_d), group)
    n_normal = torch.clamp(n_normal, min=1e-5)
    n_depth = torch.clamp(n_depth, min=1e-5)
    normal_err = normal_sum / n_normal / 3.0
    depth_err = depth_sum / n_depth
    with torch.no_grad():
        cos = torch.clamp(torch.sum(normal_pred * normal_gt, dim=-1,
                                    keepdim=True), -1.0, 1.0)
        angle = psum(torch.sum(torch.arccos(cos) / math.pi * 180.0 * seg_n),
                     group)
        angle = angle / n_normal

    losses = {"normal": normal_err, "depth": depth_err, "angle_deg": angle}
    return losses, normal_pred, depth_pred
