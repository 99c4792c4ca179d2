"""Benchmark metrics (numpy; run on saved predictions).

The counterpart of the JAX package's ``eval/metrics.py``, a copy of its
numpy code (that module loads no JAX, but importing it loads the JAX
package), so the results are bit-equal.  The reference's metric
definitions:
  * WHDR on IIW human judgements, delta=0.1 (CompareWHDR.py);
  * masked mean/median normal angle in degrees (CompareNormal.py);
  * scale-invariant log-depth RMSE under the 1<d<10 mask (CompareDepth.py;
    the log means are subtracted over the FULL image, as there).
"""

from __future__ import annotations

import numpy as np


def compute_whdr(reflectance: np.ndarray, judgements: dict, delta: float = 0.1):
    """Weighted Human Disagreement Rate.

    reflectance: [H, W, C] linear reflectance; judgements: the IIW JSON dict.
    Returns (whdr, whdr_equal, whdr_inequal) or None if no valid pairs.
    """
    points = judgements["intrinsic_points"]
    comparisons = judgements["intrinsic_comparisons"]
    id_to_points = {p["id"]: p for p in points}
    rows, cols = reflectance.shape[0:2]

    error_sum = weight_sum = 0.0
    error_eq = weight_eq = 0.0
    error_ineq = weight_ineq = 0.0

    for c in comparisons:
        darker = c["darker"]
        if darker not in ("1", "2", "E"):
            continue
        weight = c["darker_score"]
        if weight is None or weight <= 0.0:
            continue
        p1 = id_to_points[c["point1"]]
        p2 = id_to_points[c["point2"]]
        if not p1["opaque"] or not p2["opaque"]:
            continue
        l1 = max(
            1e-10,
            np.mean(reflectance[int(p1["y"] * rows), int(p1["x"] * cols), ...]),
        )
        l2 = max(
            1e-10,
            np.mean(reflectance[int(p2["y"] * rows), int(p2["x"] * cols), ...]),
        )
        if l2 / l1 > 1.0 + delta:
            alg = "1"
        elif l1 / l2 > 1.0 + delta:
            alg = "2"
        else:
            alg = "E"
        if darker == "E":
            error_eq += weight * (darker != alg)
            weight_eq += weight
        else:
            error_ineq += weight * (darker != alg)
            weight_ineq += weight
        error_sum += weight * (darker != alg)
        weight_sum += weight

    if not weight_sum:
        return None
    return (
        error_sum / weight_sum,
        error_eq / (weight_eq + 1e-10),
        error_ineq / (weight_ineq + 1e-10),
    )


def normal_angle_error(normal_pred: np.ndarray, normal_gt: np.ndarray,
                       mask: np.ndarray):
    """Masked mean and median angular error in degrees.

    normal_pred/normal_gt: [H, W, 3] (gt is unit-normalized inside);
    mask: [H, W] in {0, 1}. Returns (mean_deg, median_deg)."""
    gt = normal_gt / np.sqrt(
        np.sum(normal_gt * normal_gt, axis=2, keepdims=True)
    )
    cos = np.clip(np.sum(normal_pred * gt, axis=2), -1, 1)
    theta = np.arccos(cos) / np.pi * 180.0
    mean = np.sum(theta * mask) / np.sum(mask)
    median = np.median(theta[mask != 0])
    return mean, median


def si_log_depth_rmse(depth_pred: np.ndarray, depth_gt: np.ndarray):
    """Scale-invariant log RMSE with the reference's exact recipe.

    mask = 1 < gt < 10; log means are subtracted over the FULL image
    (CompareDepth.py:28-30) before the masked RMSE."""
    mask = np.logical_and(depth_gt > 1, depth_gt < 10).astype(np.float64)
    dp = np.log(depth_pred + 1e-20)
    dg = np.log(depth_gt + 1e-20)
    dp = dp - np.mean(dp)
    dg = dg - np.mean(dg)
    return float(np.sqrt(np.sum((dp - dg) ** 2 * mask) / np.sum(mask)))
