"""Closed-form scale-invariance solvers.

Albedo, depth and lighting are only recoverable up to a global scale from a
single image, so every loss first fits a per-image scalar (or a diffuse /
specular pair) in closed form, or normalizes albedo and depth to a mean of
1/3 (:func:`mean_normalize`).  Gradients do not flow through the fitted
coefficients: every ``stop_gradient`` of the JAX package's ``core/scale.py``
is a ``.detach()`` here.  The functions only sum per batch element, so they
take any layout as long as all arguments share it.
"""

from __future__ import annotations

import torch


def mean_normalize(x: torch.Tensor) -> torch.Tensor:
    """x / max(mean(x), 1e-10) / 3 per batch element (any layout)."""
    b = x.shape[0]
    m = torch.clamp(torch.mean(x.reshape(b, -1), dim=1), min=1e-10)
    return x / m.reshape((b,) + (1,) * (x.dim() - 1)) / 3.0


def ls_regress(pred: torch.Tensor, gt: torch.Tensor,
               origin: torch.Tensor) -> torch.Tensor:
    """One-parameter least-squares rescale of ``origin`` onto ``gt``.

    coef = <pred, gt> / max(<pred, pred>, 1e-5) per batch element, detached
    and clamped to [1e-3, 1e3]; returns origin * coef.
    """
    b = pred.shape[0]
    p = pred.reshape(b, -1)
    g = gt.reshape(b, -1)
    coef = torch.sum(p * g, dim=1) / torch.clamp(torch.sum(p * p, dim=1),
                                                 min=1e-5)
    coef = torch.clamp(coef.detach(), 0.001, 1000.0)
    return origin * coef.reshape((b,) + (1,) * (pred.dim() - 1))


def ls_regress_diff_spec(
    diff: torch.Tensor,
    spec: torch.Tensor,
    im_orig: torch.Tensor,
    diff_orig: torch.Tensor,
    spec_orig: torch.Tensor,
):
    """Jointly scale diffuse+specular onto the image (2x2 LS system).

      * bright pixels (im >= 0.9) are masked out of the fit;
      * solve [a11 a12; a12 a22][c1;c2] = [b1;b2];
      * if the system is near-singular (det/(C*H*W) <= 1e-2), fall back to
        a diffuse-only fit c3 = b1/a11 (clamped), c4 = 0;
      * a second 1-parameter pass fits clamp(c1*d + c2*s, 0, 1) onto the
        unmasked image (coefficient detached).

    Callers pass detached diff/spec for the fit and the differentiable
    tensors as diff_orig/spec_orig.  All [B, ...] of one shape.
    Returns (diff_scaled, spec_scaled).
    """
    b = diff.shape[0]
    numel = diff[0].numel()  # C*H*W per image
    ones = (1,) * (diff.dim() - 1)

    mask = (im_orig < 0.9).to(diff.dtype)
    d = (diff * mask).reshape(b, -1)
    s = (spec * mask).reshape(b, -1)
    im = (im_orig * mask).reshape(b, -1)

    a11 = torch.sum(d * d, dim=1)
    a22 = torch.sum(s * s, dim=1)
    a12 = torch.sum(d * s, dim=1)

    frac = a11 * a22 - a12 * a12
    b1 = torch.sum(d * im, dim=1)
    b2 = torch.sum(s * im, dim=1)

    coef1 = (b1 * a22 - b2 * a12) / torch.clamp(frac, min=1e-2)
    coef2 = (-b1 * a12 + a11 * b2) / torch.clamp(frac, min=1e-2)

    coef3 = torch.clamp(b1 / torch.clamp(a11, min=1e-5), 0.001, 1000.0)
    coef4 = torch.zeros_like(coef3)

    frac_ind = ((frac / numel).detach() > 1e-2).to(diff.dtype)
    coef_d = frac_ind * coef1 + (1.0 - frac_ind) * coef3
    coef_s = frac_ind * coef2 + (1.0 - frac_ind) * coef4

    coef_d = torch.clamp(coef_d, 0.0, 1000.0).reshape(b, *ones)
    coef_s = torch.clamp(coef_s, 0.0, 1000.0).reshape(b, *ones)

    diff_scaled = coef_d * diff_orig
    spec_scaled = coef_s * spec_orig

    rendered = torch.clamp(diff_scaled + spec_scaled, 0.0, 1.0).reshape(b, -1)
    im_flat = im_orig.reshape(b, -1)
    coef_im = torch.sum(rendered * im_flat, dim=1) / torch.clamp(
        torch.sum(rendered * rendered, dim=1), min=1e-5
    )
    coef_im = torch.clamp(coef_im.detach(), 0.001, 1000.0).reshape(b, *ones)

    return coef_im * diff_scaled, coef_im * spec_scaled
