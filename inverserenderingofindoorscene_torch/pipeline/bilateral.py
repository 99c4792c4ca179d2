"""Bilateral refinement: the three confidence nets, the refinement of
albedo / rough / depth, and the forward and losses of bilateral training.

The counterpart of the JAX package's ``pipeline/bilateral.py``
(``BilateralNets``, ``normalized_guide``, ``refine``, ``bilateral_step``,
``bilateral_total_error``) and of ``bs_prep`` of its
``pipeline/inference.py``.  The frozen BRDF stack's albedo, roughness and
depth are refined by the bilateral solver (``ops/bilateral.py``) with
confidences from the three CNNs; normal passes through.  Both raw and
refined predictions are fitted onto the ground truth (``ls_regress``) and
scored by the masked errors.  Public functions take NHWC tensors; the
nets run in NCHW.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from inverserenderingofindoorscene_torch.core.imageops import to_nchw, to_nhwc
from inverserenderingofindoorscene_torch.core.scale import ls_regress
from inverserenderingofindoorscene_torch.losses.masked import masked_sq_sum
from inverserenderingofindoorscene_torch.models.bilateral_net import (
    ConfidenceNet,
)
from inverserenderingofindoorscene_torch.models.mgnet import init_weights
from inverserenderingofindoorscene_torch.ops.bilateral import (
    MODE_PARAMS,
    bilateral_solve_stats,
)
from inverserenderingofindoorscene_torch.pipeline.brdf import brdf_forward

# refined map -> (confidence-net input channels, MODE_PARAMS id), in the
# order the reference solves them
BS_MODES = {"albedo": (6, 0), "rough": (4, 2), "depth": (4, 4)}


class BilateralNets(nn.Module):
    """The albedo / rough / depth confidence CNNs of one cascade level.

    Weights are drawn from ``generator`` (``None`` means seed 0)."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        for name, (cin, _) in BS_MODES.items():
            setattr(self, name, ConfidenceNet(cin))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights(self, generator)

    def confidence(self, name: str, im: torch.Tensor, target: torch.Tensor,
                   group=None) -> torch.Tensor:
        """Mode ``name``'s confidence [B,H,W,1] of NHWC im and target
        (divided by its maximum over ``group``'s ranks, ConfidenceNet)."""
        net = getattr(self, name)
        return to_nhwc(net(to_nchw(im), to_nchw(target), group))


def normalized_guide(albedo_pred: torch.Tensor) -> torch.Tensor:
    """The solver's grid guide: the detached albedo prediction divided by
    its per-image maximum clamped to 1e-5..1 (BilateralLayer.py:250-253)."""
    guide = albedo_pred.detach()
    b = guide.shape[0]
    gmax = torch.clamp(torch.amax(guide.reshape(b, -1), dim=1), 1e-5, 1.0)
    return guide / gmax.reshape(b, 1, 1, 1)


def bs_prep(im, preds, nets=None, group=None):
    """The refinement's inputs: the guide (:func:`normalized_guide`), the
    per-mode targets (rough mapped to [0, 1]), and the confidences of
    ``nets`` (a :class:`BilateralNets`; over ``group``'s ranks), or unit
    confidence when it is None.  Returns (guide, targets dict, confs
    dict)."""
    targets = {"albedo": preds["albedo"],
               "rough": 0.5 * (preds["rough"] + 1.0),
               "depth": preds["depth"]}
    if nets is None:
        ones = torch.ones(im.shape[:3] + (1,), dtype=im.dtype,
                          device=im.device)
        confs = dict.fromkeys(BS_MODES, ones)
    else:
        confs = {k: nets.confidence(k, im, targets[k], group)
                 for k in BS_MODES}
    return normalized_guide(preds["albedo"]), targets, confs


def refine(nets: Optional[BilateralNets], im: torch.Tensor, preds: dict,
           use_kernels: bool = True, group=None):
    """Refine albedo / rough / depth (trainBRDFBilateral.py:267-281,
    testReal.py:532-540); normal passes through, detached.

    The rough map is solved in [0, 1] and mapped back with clamp(2x - 1,
    -1, 1).  ``nets`` None means unit confidence.  ``use_kernels``: blur
    with the CUDA kernel (on CUDA tensors) or its plain version.
    ``group``: as in :func:`bs_prep`.  Returns (refined dict, confs dict,
    stats dict)."""
    guide, targets, confs = bs_prep(im, preds, nets, group)
    refined, stats = {}, {}
    for name, (_, mode) in BS_MODES.items():
        refined[name], stats[name] = bilateral_solve_stats(
            guide, targets[name], confs[name], MODE_PARAMS[mode],
            use_kernels)
    refined["rough"] = torch.clamp(2.0 * refined["rough"] - 1.0, -1.0, 1.0)
    refined["normal"] = preds["normal"].detach()
    return refined, confs, stats


def bilateral_step(brdf_nets, bs_nets: BilateralNets, batch: dict,
                   use_kernels: bool = True, group=None):
    """Frozen BRDF forward + refinement + masked errors.

    batch: NHWC tensors im/albedo/normal/rough/depth/seg_brdf/seg_all.
    The BRDF stack runs under ``torch.no_grad()``.  ``group``: a process
    group whose ranks each hold their rows of the batch; the confidences'
    maximum and every error are then global.  Returns (losses with
    ``_raw`` and ``_bs`` variants and ``normal_raw``, aux)."""
    with torch.no_grad():
        preds = brdf_forward(brdf_nets, batch)
    refined, confs, stats = refine(bs_nets, batch["im"], preds, use_kernels,
                                   group)
    seg_brdf, seg_all = batch["seg_brdf"], batch["seg_all"]

    def fit(p, gt, seg):
        return ls_regress(p * seg, gt * seg, p)

    albedo_gt = batch["albedo"]
    log_depth_gt = torch.log(batch["depth"] + 1.0)
    losses = {}
    for tag, pr in (("raw", preds), ("bs", refined)):
        a = torch.clamp(fit(pr["albedo"], albedo_gt, seg_brdf), 0.0, 1.0)
        d = fit(pr["depth"], batch["depth"], seg_all)
        losses[f"albedo_{tag}"] = masked_sq_sum(a, albedo_gt, seg_brdf, 3.0,
                                                group)
        losses[f"rough_{tag}"] = masked_sq_sum(pr["rough"], batch["rough"],
                                               seg_brdf, 1.0, group)
        losses[f"depth_{tag}"] = masked_sq_sum(torch.log(d + 1.0),
                                               log_depth_gt, seg_all, 1.0,
                                               group)
    losses["normal_raw"] = masked_sq_sum(preds["normal"], batch["normal"],
                                         seg_all, 3.0, group)
    aux = {"preds": preds, "refined": refined, "confs": confs,
           "grid_stats": stats}
    return losses, aux


def bilateral_total_error(losses: dict, albedo_w: float = 1.5,
                          rough_w: float = 0.5,
                          depth_w: float = 0.5) -> torch.Tensor:
    """trainBRDFBilateral.py:345-347: 4 albedo_w albedo_bs + rough_w
    rough_bs + depth_w depth_bs (normal is not refined)."""
    return (4.0 * albedo_w * losses["albedo_bs"]
            + rough_w * losses["rough_bs"] + depth_w * losses["depth_bs"])
