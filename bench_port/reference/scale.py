"""Scale fits and masked losses (``models.py`` LSregress /
LSregressDiffSpec, ``trainBRDF.py``'s errors), plain
float32; no gradient flows through a fitted coefficient."""

from __future__ import annotations

import torch


def mean_normalize(x):
    b = x.shape[0]
    m = torch.clamp(torch.mean(x.reshape(b, -1), dim=1), min=1e-10)
    return x / m.reshape((b,) + (1,) * (x.dim() - 1)) / 3.0


def ls_regress(pred, gt, origin):
    b = pred.shape[0]
    p, g = pred.reshape(b, -1), gt.reshape(b, -1)
    coef = torch.sum(p * g, dim=1) / torch.clamp(torch.sum(p * p, dim=1),
                                                 min=1e-5)
    coef = torch.clamp(coef.detach(), 0.001, 1000.0)
    return origin * coef.reshape((b,) + (1,) * (pred.dim() - 1))


def ls_regress_diff_spec(diff, spec, im_orig, diff_orig, spec_orig):
    """Joint diffuse / specular scale onto the image (pixels >= 0.9
    masked out), diffuse-only where the 2x2 system is near-singular, then
    one scale of the clamped sum onto the whole image."""
    b = diff.shape[0]
    numel = diff[0].numel()
    ones = (1,) * (diff.dim() - 1)
    mask = (im_orig < 0.9).to(diff.dtype)
    d = (diff * mask).reshape(b, -1)
    s = (spec * mask).reshape(b, -1)
    im = (im_orig * mask).reshape(b, -1)
    a11, a22, a12 = (d * d).sum(1), (s * s).sum(1), (d * s).sum(1)
    frac = a11 * a22 - a12 * a12
    b1, b2 = (d * im).sum(1), (s * im).sum(1)
    coef1 = (b1 * a22 - b2 * a12) / torch.clamp(frac, min=1e-2)
    coef2 = (-b1 * a12 + a11 * b2) / torch.clamp(frac, min=1e-2)
    coef3 = torch.clamp(b1 / torch.clamp(a11, min=1e-5), 0.001, 1000.0)
    ind = ((frac / numel).detach() > 1e-2).to(diff.dtype)
    coef_d = torch.clamp(ind * coef1 + (1.0 - ind) * coef3, 0.0, 1000.0)
    coef_s = torch.clamp(ind * coef2, 0.0, 1000.0)
    diff_s = coef_d.reshape(b, *ones) * diff_orig
    spec_s = coef_s.reshape(b, *ones) * spec_orig
    rendered = torch.clamp(diff_s + spec_s, 0.0, 1.0).reshape(b, -1)
    im_flat = im_orig.reshape(b, -1)
    coef_im = torch.sum(rendered * im_flat, dim=1) / torch.clamp(
        torch.sum(rendered * rendered, dim=1), min=1e-5)
    coef_im = torch.clamp(coef_im.detach(), 0.001, 1000.0).reshape(b, *ones)
    return coef_im * diff_s, coef_im * spec_s


def masked_sq_sum(pred, gt, seg, channels: float = 1.0):
    return (torch.sum((pred - gt) ** 2 * seg)
            / torch.clamp(torch.sum(seg), min=1e-5) / channels)


def brdf_errors(albedo, normal, rough, depth, batch):
    """The four masked errors of trainBRDF (NHWC)."""
    seg_brdf, seg_all = batch["seg_brdf"], batch["seg_all"]
    albedo_gt = batch["albedo"] * seg_brdf
    a = torch.clamp(ls_regress(albedo.detach() * seg_brdf,
                               albedo_gt * seg_brdf, albedo), 0.0, 1.0)
    d = ls_regress(depth.detach() * seg_all, batch["depth"] * seg_all, depth)
    return {
        "albedo": masked_sq_sum(a, albedo_gt, seg_brdf, 3.0),
        "normal": masked_sq_sum(normal, batch["normal"], seg_all, 3.0),
        "rough": masked_sq_sum(rough, batch["rough"], seg_brdf, 1.0),
        "depth": masked_sq_sum(torch.log(d + 1.0),
                               torch.log(batch["depth"] + 1.0), seg_all, 1.0),
    }
