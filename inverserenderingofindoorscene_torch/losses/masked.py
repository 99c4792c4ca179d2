"""Masked scale-invariant losses with the reference normalization.

The counterpart of the JAX package's ``losses/masked.py``: each error is
the masked squared error summed over the WHOLE batch, divided by the
global masked pixel count (and the channel count).  Every
``stop_gradient`` there is a ``.detach()`` here, in the same place.  Each
error takes ``group``, the counterpart of ``axis_name``: over a process
group of ranks that each hold their rows of the batch, the numerator and
the pixel count are both summed over the ranks (``parallel.collectives.
psum``, one all_reduce for the two), so the error is the global one and a
rank's gradient its share of it.  The per-image ``ls_regress`` fits stay
local: they sum within an image.  Tensors are NHWC, as in the JAX package.
"""

from __future__ import annotations

import torch

from inverserenderingofindoorscene_torch.core.scale import (
    ls_regress,
    ls_regress_diff_spec,
)
from inverserenderingofindoorscene_torch.parallel.collectives import psum


def global_sums(num: torch.Tensor, den: torch.Tensor, group):
    """(num, den) summed over the group's ranks in one all_reduce (JAX's
    two ``_maybe_psum``); ``group`` None returns them as they are."""
    if group is None:
        return num, den
    return psum(torch.stack([num, den]), group).unbind()


def masked_sq_sum(pred: torch.Tensor, gt: torch.Tensor, seg: torch.Tensor,
                  channels: float = 1.0, group=None) -> torch.Tensor:
    """sum((pred-gt)^2 * seg) / max(sum(seg), 1e-5) / channels, global over
    the batch (and over ``group``'s ranks); ``seg`` broadcasts against
    pred ([B,H,W,1] vs [B,H,W,C])."""
    num, den = global_sums(torch.sum((pred - gt) ** 2 * seg), torch.sum(seg),
                           group)
    return num / torch.clamp(den, min=1e-5) / channels


def brdf_errors(albedo_pred, normal_pred, rough_pred, depth_pred,
                batch: dict, group=None):
    """The four masked BRDF errors.

    batch keys: albedo/normal/rough/depth ground truth, seg_brdf (the
    object mask) and seg_all (object + area), each [B,H,W,C].  The albedo
    and depth predictions are rescaled onto the ground truth under the mask
    first (albedo then clamped to [0,1]); no gradient flows through the
    fitted coefficients.  ``group``: as in :func:`masked_sq_sum`.
    Returns (errors dict, scaled preds dict)."""
    seg_brdf = batch["seg_brdf"]
    seg_all = batch["seg_all"]

    albedo_gt = batch["albedo"] * seg_brdf
    albedo_p1 = ls_regress(albedo_pred.detach() * seg_brdf,
                           albedo_gt * seg_brdf, albedo_pred)
    albedo_p1 = torch.clamp(albedo_p1, 0.0, 1.0)

    depth_p1 = ls_regress(depth_pred.detach() * seg_all,
                          batch["depth"] * seg_all, depth_pred)

    errors = {
        "albedo": masked_sq_sum(albedo_p1, albedo_gt, seg_brdf, 3.0, group),
        "normal": masked_sq_sum(normal_pred, batch["normal"], seg_all, 3.0,
                                group),
        "rough": masked_sq_sum(rough_pred, batch["rough"], seg_brdf, 1.0,
                               group),
        "depth": masked_sq_sum(torch.log(depth_p1 + 1.0),
                               torch.log(batch["depth"] + 1.0), seg_all, 1.0,
                               group),
    }
    return errors, {"albedo": albedo_p1, "depth": depth_p1}


def envmap_reconst_error(env_pred: torch.Tensor, env_gt: torch.Tensor,
                         seg_env: torch.Tensor, offset: float = 1.0,
                         group=None):
    """Log-space masked envmap reconstruction error.

    env_pred/env_gt [B,R,C,D,3]; seg_env [B,R,C,1] (validity and not-dark
    masks already in).  The prediction is rescaled onto the ground truth
    under the mask first; the sum is divided by the pixel count, 3 and D,
    both summed over ``group``'s ranks.  Returns (error, scaled
    env_pred)."""
    d = env_pred.shape[-2]
    seg5 = seg_env[..., None, :]  # [B,R,C,1,1]
    env_scaled = ls_regress(env_pred.detach() * seg5, env_gt * seg5, env_pred)
    num = torch.sum(
        (torch.log(env_scaled + offset) - torch.log(env_gt + offset)) ** 2
        * seg5
    )
    num, den = global_sums(num, torch.sum(seg_env), group)
    return num / torch.clamp(den, min=1e-5) / 3.0 / d, env_scaled


def render_error(diffuse_pred: torch.Tensor, specular_pred: torch.Tensor,
                 im_small: torch.Tensor, seg_small: torch.Tensor,
                 group=None):
    """Rendering loss against the pooled input image: the diffuse/specular
    pair is fitted onto the image (2x2 least squares, on detached inputs),
    their sum clamped to [0,1], then the masked MSE (over ``group``'s
    ranks).  Returns (error, rendered image)."""
    diffuse_s, specular_s = ls_regress_diff_spec(
        diffuse_pred.detach(), specular_pred.detach(), im_small,
        diffuse_pred, specular_pred,
    )
    rendered = torch.clamp(diffuse_s + specular_s, 0.0, 1.0)
    return masked_sq_sum(rendered, im_small, seg_small, 3.0, group), rendered
