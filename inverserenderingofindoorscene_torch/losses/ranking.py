"""IIW pairwise reflectance ranking loss.

The counterpart of the JAX package's ``losses/ranking.py`` (the
reference's ``BatchRankingLoss``): the predicted albedo is channel-mean
reduced to a reflectance map, log(r + 1e-3), and human point-pair
judgements are scored as

  equal pairs:  w * (log r1 - log r2)^2
  darker pairs: w * relu(log r2 - log r1 + tau)^2,  tau = 0.5

each sum divided by max(num, 1), the row count of the loader's padded
list (its leading all-zero dummy row included; padding rows weigh 0).
The pairs are gathered by advanced indexing, whose backward accumulates
repeated indices through ``index_put_(accumulate=True)``, in one order on
every run (``gather``'s backward, ``scatter_add``, sums with atomics on
CUDA).
"""

from __future__ import annotations

import torch

TAU = 0.5


def _log_reflectance(albedo: torch.Tensor) -> torch.Tensor:
    """[B,H,W,3] -> log(mean_c + 1e-3), flattened to [B, H*W]."""
    return torch.log(torch.mean(albedo, dim=-1) + 0.001).flatten(1)


def batched_ranking_loss(albedo_pred: torch.Tensor, eq_point: torch.Tensor,
                         eq_weight: torch.Tensor, darker_point: torch.Tensor,
                         darker_weight: torch.Tensor, eq_num=None,
                         darker_num=None):
    """Per-image (eq_loss, darker_loss), each [B].

    albedo_pred [B,H,W,3]; eq_point / darker_point [B,N,4] integer rows
    (r1, c1, r2, c2), gathered at flat indices r * W + c; eq_weight /
    darker_weight [B,N] (0 for padding); eq_num / darker_num [B], the row
    counts (default: the padded length N)."""
    width = albedo_pred.shape[2]
    reflect_log = _log_reflectance(albedo_pred)
    rows = torch.arange(reflect_log.shape[0],
                        device=reflect_log.device)[:, None]

    def pair(points):
        points = points.long()
        p1 = points[..., 0] * width + points[..., 1]
        p2 = points[..., 2] * width + points[..., 3]
        return reflect_log[rows, p1], reflect_log[rows, p2]

    def denominator(num, weight):
        if num is None:
            return float(weight.shape[-1])
        return torch.clamp(torch.as_tensor(num, device=weight.device),
                           min=1).to(weight.dtype)

    rf1, rf2 = pair(eq_point)
    eq_loss = (torch.sum(eq_weight * (rf1 - rf2) ** 2, dim=-1)
               / denominator(eq_num, eq_weight))
    rf1, rf2 = pair(darker_point)
    darker_loss = (torch.sum(darker_weight * torch.relu(rf2 - rf1 + TAU) ** 2,
                             dim=-1)
                   / denominator(darker_num, darker_weight))
    return eq_loss, darker_loss


def batch_ranking_loss(albedo_pred: torch.Tensor, eq_point: torch.Tensor,
                       eq_weight: torch.Tensor, darker_point: torch.Tensor,
                       darker_weight: torch.Tensor, eq_num=None,
                       darker_num=None):
    """(eq_loss, darker_loss) of one image, the JAX signature:
    albedo_pred [H,W,3], points [N,4], weights [N], counts scalars."""

    def one(x):
        return None if x is None else torch.as_tensor(x)[None]

    eq, dk = batched_ranking_loss(
        albedo_pred[None], eq_point[None], eq_weight[None], darker_point[None],
        darker_weight[None], one(eq_num), one(darker_num))
    return eq[0], dk[0]
