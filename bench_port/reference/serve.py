"""The serving chain of ``testReal.py`` at level 2 with lighting and the
bilateral refinement, one photo at a time, plain float32.

BRDF cascade 0 -> lighting 0 (SG decode, shading, the diffuse /
specular fit, the cLight / cAlbedo disambiguation) -> BRDF cascade 1 on
the 17-channel input -> lighting 1 -> the refinement of each level's
albedo, roughness and depth with its confidence nets.

:func:`serve` runs the chain from the photo.  :func:`stages` computes
each stage from the photo and the judged side's own outputs of the
stages before it, so that each stage is judged on its own inputs: the
refinement's grid cells, the cascades and the diffuse / specular fit
amplify a last-bit difference upstream into differences that say nothing
of the stage itself.  It shades in float64.
"""

from __future__ import annotations

import torch

from bench_port.reference import bilateral, sg
from bench_port.reference.imageops import (
    pool_nhwc,
    resize_bilinear,
    to_nchw,
    to_nhwc,
)
from bench_port.reference.scale import ls_regress_diff_spec, mean_normalize


def predict_brdf(nets, im, extra=None):
    """NHWC im [B,H,W,3] (and the cascade-1 extra maps) -> NHWC maps,
    albedo and depth mean-normalized to 1/3."""
    im_c = to_nchw(im)
    inp = im_c if extra is None else torch.cat(
        [im_c] + [to_nchw(e) for e in extra], dim=1)
    out = nets(im_c, inp)
    preds = {"albedo": mean_normalize(0.5 * (out["albedo"] + 1.0)),
             "normal": out["normal"], "rough": out["rough"],
             "depth": mean_normalize(0.5 * (out["depth"] + 1.0))}
    return {k: to_nhwc(v) for k, v in preds.items()}


def light_input(im_c, preds_c, light_hw):
    stacked = torch.cat([im_c, preds_c["albedo"],
                         0.5 * (preds_c["normal"] + 1.0),
                         0.5 * (preds_c["rough"] + 1.0), preds_c["depth"]],
                        dim=1)
    return resize_bilinear(stacked, light_hw)


def light_sg(nets, im, preds, im_small, env_pre=None):
    """The light nets' SG parameters [B,r,c,7K] ([axis | lamb | weight],
    in [0, 1] but the axis) on the lighting grid of ``im_small``."""
    eh, ew = im_small.shape[1:3]
    inp = light_input(to_nchw(im), {k: to_nchw(v) for k, v in preds.items()},
                      (eh * 4, ew * 4))
    out = nets(inp, (eh, ew), None if env_pre is None else to_nchw(env_pre))
    return torch.cat([to_nhwc(out[k]) for k in ("axis", "lamb", "weight")],
                     dim=-1)


def shade(preds, sg_flat, im_small, fov, cascade, env_hw,
          dtype=torch.float32, rounding=None):
    """The shading stage of ``sg_flat`` and the maps ``preds``: the SG
    decode, the shading of the maps pooled to the lighting grid, the
    diffuse / specular fit onto the photo and the per-image scale
    disambiguation (testReal.py:382-432).  The lobes are unsquashed in
    float32, as the measured program hands them to its kernel; the rest
    runs in ``dtype``.  ``rounding``: a control's (``sg.render_envmap``).
    Returns the envmap ``env`` before cLight and ``env_img`` after it,
    ``diffuse_raw`` / ``specular_raw`` before the fit, ``diffuse`` /
    ``specular`` after it, ``c_albedo`` and ``c_light``."""
    b, eh, ew = sg_flat.shape[:3]
    k = sg_flat.shape[-1] // 7
    flat = sg_flat.float()
    axis = flat[..., :3 * k].reshape(b, eh, ew, k, 3)
    lamb = sg.unsquash(flat[..., 3 * k:4 * k])
    weight = sg.unsquash(flat[..., 4 * k:]).reshape(b, eh, ew, k, 3)
    env = sg.sg_to_envmap(axis.to(dtype), lamb.to(dtype), weight.to(dtype),
                          *env_hw)
    rc = (eh, ew)
    albedo = pool_nhwc(preds["albedo"], rc)
    diffuse_raw, specular_raw = sg.render_envmap(
        albedo.to(dtype), pool_nhwc(preds["normal"], rc).to(dtype),
        pool_nhwc(preds["rough"], rc).to(dtype), env, fov, *env_hw,
        rounding=rounding)
    small = im_small.to(dtype)
    diffuse, specular = ls_regress_diff_spec(diffuse_raw, specular_raw,
                                             small, diffuse_raw,
                                             specular_raw)

    def per_image(x):
        return torch.sum(x.reshape(b, -1), dim=1)

    c_diff = per_image(diffuse) / per_image(diffuse_raw)
    c_spec = per_image(specular) / per_image(specular_raw)
    ca_hi = 1.0 / torch.amax(preds["albedo"].reshape(b, -1), dim=1).to(dtype)
    degenerate = (c_spec < 1e-3) if cascade == 0 else (c_spec <= 0.0)
    c_albedo = torch.where(degenerate, ca_hi, torch.minimum(
        torch.clamp(c_diff / c_spec, min=1e-3), ca_hi))
    c_light = c_diff / c_albedo
    return {"env": env, "env_img": env * c_light.reshape(b, 1, 1, 1, 1),
            "diffuse_raw": diffuse_raw, "specular_raw": specular_raw,
            "diffuse": diffuse, "specular": specular,
            "c_albedo": c_albedo, "c_light": c_light}


def predict_light(nets, im, preds, im_small, fov, cascade, env_pre=None,
                  rounding=None):
    """The light nets, the SG decode and shading, the fit and the scales,
    in float32 (with a control's ``rounding``)."""
    sg_flat = light_sg(nets, im, preds, im_small, env_pre)
    out = shade(preds, sg_flat, im_small, fov, cascade,
                (nets.env_height, nets.env_width), rounding=rounding)
    out["sg_flat"] = sg_flat
    return out


def cascade1_extra(im, preds, diffuse, specular):
    hw = im.shape[1:3]

    def up(x):
        return to_nhwc(resize_bilinear(to_nchw(x), hw))

    return [up(preds["albedo"]), 0.5 * (up(preds["normal"]) + 1.0),
            0.5 * (up(preds["rough"]) + 1.0), up(preds["depth"]),
            up(diffuse), up(specular)]


def refine(bs_nets, im, preds):
    """Each image's albedo / roughness (in [0, 1]) / depth refined on the
    grid of its albedo divided by its maximum; normal passes through."""
    b = im.shape[0]
    guide = preds["albedo"]
    gmax = torch.clamp(torch.amax(guide.reshape(b, -1), dim=1), 1e-5, 1.0)
    guide = guide / gmax.reshape(b, 1, 1, 1)
    targets = {"albedo": preds["albedo"],
               "rough": 0.5 * (preds["rough"] + 1.0),
               "depth": preds["depth"]}
    refined, nvert = {}, {}
    for name, params in bilateral.MODES.items():
        conf = to_nhwc(bs_nets.confidence(name, to_nchw(im),
                                          to_nchw(targets[name])))
        outs = [bilateral.solve(guide[i], targets[name][i], conf[i], params)
                for i in range(b)]
        refined[name] = torch.stack([o for o, _ in outs])
        nvert[name] = [v for _, v in outs]
    refined["rough"] = torch.clamp(2.0 * refined["rough"] - 1.0, -1.0, 1.0)
    refined["normal"] = preds["normal"]
    return refined, nvert


@torch.no_grad()
def serve(stacks, bs_nets, im, im_small, fov, rounding=None):
    """stacks [(BRDFNets, LightNets)] of cascades 0 and 1; bs_nets one
    BilateralNets a level; ``rounding``: a control's, for the shading.
    Returns {"preds", "lights", "refined", "nvert"}, lists by level."""
    preds0 = predict_brdf(stacks[0][0], im)
    light0 = predict_light(stacks[0][1], im, preds0, im_small, fov, 0,
                           rounding=rounding)
    extra = cascade1_extra(im, preds0, light0["diffuse"], light0["specular"])
    preds1 = predict_brdf(stacks[1][0], im, extra)
    light1 = predict_light(stacks[1][1], im, preds1, im_small, fov, 1,
                           light0["sg_flat"], rounding=rounding)
    refined, nvert = zip(*(refine(n, im, p)
                           for n, p in zip(bs_nets, (preds0, preds1))))
    return {"preds": [preds0, preds1], "lights": [light0, light1],
            "refined": list(refined), "nvert": list(nvert)}


@torch.no_grad()
def stages(stacks, bs_nets, im, im_small, fov, prev):
    """Each stage's output for a batch of photos, from ``prev`` (the
    judged side's "preds" and "lights" of both levels for these photos):
    the cascade-0 maps from the photo; each level's SG parameters from
    that level's maps in ``prev``; each level's shading, fit and scales,
    in float64, from that level's maps and SG parameters in ``prev``;
    the cascade-1 maps from the cascade-0 maps and lighting in ``prev``;
    each level's refinement from that level's maps in ``prev``."""
    p, lt = prev["preds"], prev["lights"]
    env_hw = (stacks[0][1].env_height, stacks[0][1].env_width)

    def light(lvl, env_pre=None):
        out = shade(p[lvl], lt[lvl]["sg_flat"], im_small, fov, lvl, env_hw,
                    torch.float64)
        out["sg_flat"] = light_sg(stacks[lvl][1], im, p[lvl], im_small,
                                  env_pre)
        return out

    preds0 = predict_brdf(stacks[0][0], im)
    extra = cascade1_extra(im, p[0], lt[0]["diffuse"], lt[0]["specular"])
    preds1 = predict_brdf(stacks[1][0], im, extra)
    refined, nvert = zip(*(refine(n, im, q) for n, q in zip(bs_nets, p)))
    return {"preds": [preds0, preds1],
            "lights": [light(0), light(1, lt[0]["sg_flat"])],
            "refined": list(refined), "nvert": list(nvert)}
