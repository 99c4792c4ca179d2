"""In-the-wild two-cascade inference as a library API (staged mode).

The counterpart of the JAX package's ``pipeline/inference.py``: stage
functions (:func:`predict_brdf`, :func:`predict_light_core`,
:func:`predict_light`, :func:`bs_prep`, :func:`refine_bs`) plus
:class:`InverseRenderer`, which runs image ->
albedo/normal/rough/depth/lighting through both cascades, and optionally
the bilateral refinement of every cascade's maps, in one call.  Public
functions take and return NHWC tensors like the JAX package; the networks
inside run in NCHW.

:func:`load_real_image` reads a photo from disk with OpenCV (imported
where it is called), and :meth:`InverseRenderer.render_file` runs the
chain on it.  Not ported yet: the fused single-program mode and its
``serialize`` export (ROADMAP A8).
The JAX package's vertex-capacity option ``v_max`` has no counterpart:
the port's grids have exactly as many vertices as occupied cells.
"""

from __future__ import annotations

import numpy as np
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
    ls_regress_diff_spec,
    mean_normalize,
)
from inverserenderingofindoorscene_torch.device import resolve_device
from inverserenderingofindoorscene_torch.ops.sg_render import render_sg_env
from inverserenderingofindoorscene_torch.pipeline.bilateral import (
    BS_MODES,
    bs_prep,
    refine,
)
from inverserenderingofindoorscene_torch.pipeline.light import (
    light_input_from_preds,
)


def load_real_image(path, im_hw, env_rc, return_original=False):
    """A photo from disk, resized keeping its aspect, with the fov of its
    orientation (testReal.py:290-343).

    Returns (im [1,h,w,3] linear, im_small [1,eh,ew,3], fov_deg) as
    float32 numpy; with ``return_original`` also the unresized uint8 RGB
    photo (the reference writes it out as a product, testReal.py:
    659-660)."""
    import cv2

    im_cpu = cv2.imread(path)
    if im_cpu is None:
        raise ValueError(f"cv2 cannot read {path}")
    im_cpu = im_cpu[:, :, ::-1]
    nh, nw = im_cpu.shape[:2]

    def fit_dims(nh0, nw0, max_h, max_w):
        if nh0 < nw0:
            w = max_w
            h = int(float(max_w) / nw0 * nh0)
        else:
            h = max_h
            w = int(float(max_h) / nh0 * nw0)
        return h, w

    def resize_gamma(h, w, ref_h):
        # the reference's choice, kept (testReal.py:306-309): INTER_AREA
        # where it enlarges (ref_h < h), INTER_LINEAR where it shrinks
        interp = cv2.INTER_AREA if ref_h < h else cv2.INTER_LINEAR
        out = cv2.resize(im_cpu, (w, h), interpolation=interp)
        out = out.astype(np.float32) / 255.0
        out = out / out.max()
        return (out ** 2.2)[None]

    h0, w0 = fit_dims(nh, nw, *im_hw)
    im = resize_gamma(h0, w0, nh)
    # the reference fits the lighting size after `nh, nw =
    # newImHeight[-1], newImWidth[-1]` (testReal.py:318): its target, its
    # interpolation choice and the fov all follow the last level's dims
    eh, ew = fit_dims(h0, w0, *env_rc)
    im_small = resize_gamma(eh, ew, h0)
    fov = 57.0 if h0 < w0 else 42.75
    if return_original:
        return im, im_small, fov, im_cpu
    return im, im_small, fov


def predict_brdf(brdf_nets, im, extra=None):
    """Encoder + decoders with the serving mean normalization.

    im [B,H,W,3]; ``extra`` the cascade-1 NHWC maps of
    :func:`_cascade1_extra`.  Returns NHWC albedo/normal/rough/depth."""
    im_c = to_nchw(im)
    inp = im_c if extra is None else torch.cat(
        [im_c] + [to_nchw(e) for e in extra], dim=1
    )
    out = brdf_nets(im_c, inp)
    preds = {
        "albedo": mean_normalize(0.5 * (out["albedo"] + 1.0)),
        "normal": out["normal"],
        "rough": out["rough"],
        "depth": mean_normalize(0.5 * (out["depth"] + 1.0)),
    }
    return {k: to_nhwc(v) for k, v in preds.items()}


def predict_light_core(light_nets, im, preds, im_small, fov, env_pre=None,
                       use_kernels=True):
    """Light stack + render + LSregressDiffSpec (NHWC in and out).

    ``use_kernels`` mirrors the JAX package's ``use_pallas``: route the SG
    decode and the shading integral through
    ``ops.sg_render.render_sg_env`` (the CUDA kernel on CUDA tensors)
    instead of the plain ``sg_to_envmap`` + ``RenderLayer`` path."""
    eh, ew = im_small.shape[1:3]
    inp = light_input_from_preds(
        to_nchw(im), {k: to_nchw(v) for k, v in preds.items()},
        (eh * 4, ew * 4)
    )
    out = light_nets(inp, (eh, ew),
                     None if env_pre is None else to_nchw(env_pre))
    axis_flat = to_nhwc(out["axis"]).contiguous()
    lamb01 = to_nhwc(out["lamb"]).contiguous()
    weight01 = to_nhwc(out["weight"]).contiguous()
    b, k = lamb01.shape[0], lamb01.shape[-1]
    sg_flat = torch.cat([axis_flat, lamb01, weight01], dim=-1)
    axis = axis_flat.reshape(b, eh, ew, k, 3)
    weight01 = weight01.reshape(b, eh, ew, k, 3)
    if use_kernels:
        # one launch: decode + shade + envmap product, the SG mixture
        # evaluated once
        rc = (eh, ew)
        diffuse, specular, env_img = render_sg_env(
            pool_nhwc(preds["albedo"], rc).contiguous(),
            pool_nhwc(preds["normal"], rc).contiguous(),
            pool_nhwc(preds["rough"], rc).contiguous(),
            axis, sg.unsquash(lamb01), sg.unsquash(weight01),
            fov_deg=fov,
            env_height=light_nets.env_height,
            env_width=light_nets.env_width,
        )
    else:
        env_img, _, _, _ = sg.squashed_sg_to_envmap(
            axis, lamb01, weight01, light_nets.env_height,
            light_nets.env_width,
        )
        layer = RenderLayer(
            env_rows=eh, env_cols=ew,
            env_height=light_nets.env_height,
            env_width=light_nets.env_width,
            fov_deg=fov,
        )
        diffuse, specular = layer.forward_env(
            preds["albedo"], preds["normal"], preds["rough"], env_img
        )
    diffuse_new, specular_new = ls_regress_diff_spec(
        diffuse, specular, im_small, diffuse, specular
    )
    return {
        "sg_flat": sg_flat,
        "env_img": env_img,
        "diffuse_raw": diffuse,
        "specular_raw": specular,
        "diffuse": diffuse_new,
        "specular": specular_new,
        # per-image max: [B]
        "albedo_max": torch.amax(preds["albedo"].reshape(b, -1), dim=1),
    }


def predict_light(core_out, cascade=0):
    """cLight/cAlbedo global-scale disambiguation on the host (batch 1).

    ``cascade`` selects the degenerate-specular threshold: ``cSpec < 1e-3``
    at cascade 0, ``cSpec <= 0`` at cascade 1."""
    c_diff = (torch.sum(core_out["diffuse"])
              / torch.sum(core_out["diffuse_raw"])).item()
    c_spec = (torch.sum(core_out["specular"])
              / torch.sum(core_out["specular_raw"])).item()
    albedo_max = core_out["albedo_max"].reshape(-1)[0].item()
    if (c_spec < 1e-3) if cascade == 0 else (c_spec <= 0.0):
        c_albedo = 1.0 / albedo_max
        c_light = c_diff / c_albedo
    else:
        c_light = c_spec
        c_albedo = float(np.clip(c_diff / c_light, 1e-3, 1.0 / albedo_max))
        c_light = c_diff / c_albedo
    return {
        "sg_flat": core_out["sg_flat"],
        "env_img": core_out["env_img"] * c_light,
        "diffuse": core_out["diffuse"],
        "specular": core_out["specular"],
        "c_albedo": c_albedo,
        "c_light": c_light,
    }


def _cascade1_extra(im, preds, diffuse, specular):
    """Cascade-1 encoder extra channels: the cascade-0 maps and rendered
    components upsampled to image resolution (NHWC)."""
    hw = im.shape[1:3]

    def up(x):
        return to_nhwc(resize_bilinear(to_nchw(x), hw))

    return [
        up(preds["albedo"]),
        0.5 * (up(preds["normal"]) + 1.0),
        0.5 * (up(preds["rough"]) + 1.0),
        up(preds["depth"]),
        up(diffuse),
        up(specular),
    ]


def refine_bs(im, preds, bs_nets=None, use_kernels=True):
    """Bilateral refinement of albedo / rough / depth (testReal.py:532-540)
    with the confidences of ``bs_nets`` (a ``BilateralNets``; None means
    unit confidence).  ``use_kernels`` blurs with the CUDA kernel
    ``ops.bilateral.bilateral_blur`` (on CUDA tensors) or its plain
    version.  Returns the refined NHWC maps keyed albedo / rough / depth."""
    refined, _, _ = refine(bs_nets, im, preds, use_kernels)
    return {k: refined[k] for k in BS_MODES}


class InverseRenderer:
    """Single-image inverse rendering as one call (staged mode).

    ``stacks``: [(BRDFNets, LightNets)] per cascade level (1 or 2); the
    modules are moved to ``device`` in place.  ``device=None`` means
    ``cuda`` and raises without CUDA; pass ``device="cpu"`` to run on the
    CPU.  ``use_kernels`` routes the lighting decode + shading through the
    CUDA kernel ``ops.sg_render.render_sg_env`` and the refinement's blur
    through ``ops.bilateral.bilateral_blur``.

    ``is_bs`` refines every level's albedo / rough / depth with the
    bilateral solver (:func:`refine_bs`).  ``bs_nets``: the confidence
    nets, one ``BilateralNets`` per level (a list; an entry may be None
    for unit confidence) or one applied to every level, or None for unit
    confidence everywhere.  ``fused`` is not ported and raises
    ``NotImplementedError``.
    """

    def __init__(self, stacks, *, is_light=True, is_bs=False, bs_nets=None,
                 use_kernels=True, fused=False, device=None):
        self.level = len(stacks)
        if self.level not in (1, 2):
            raise ValueError(f"level must be 1 or 2, got {self.level}")
        if fused:
            raise NotImplementedError("the fused single-program mode is not "
                                      "ported; use the staged mode")
        self.device = resolve_device(device)
        # at level 2 lighting runs at every level (cascade 1 needs the
        # cascade-0 diffuse/specular); is_light gates the cascade-1 light
        self.is_light = is_light
        self.use_kernels = use_kernels
        self._nets = [
            (b.to(self.device).eval(), l.to(self.device).eval())
            for b, l in stacks
        ]
        self.is_bs = is_bs
        if isinstance(bs_nets, (list, tuple)):
            if len(bs_nets) != self.level:
                raise ValueError(f"{len(bs_nets)} bs_nets for "
                                 f"{self.level} levels")
            bs_list = list(bs_nets)
        else:
            bs_list = [bs_nets] * self.level
        self._bs_nets = [None if n is None else n.to(self.device).eval()
                         for n in bs_list]

    def _light(self, level, im, preds, im_small, fov, env_pre=None):
        core = predict_light_core(
            self._nets[level][1], im, preds, im_small, fov, env_pre,
            use_kernels=self.use_kernels,
        )
        return predict_light(core, cascade=level)

    def __call__(self, im, im_small, fov=57.0):
        """im [1,H,W,3] linear RGB in 0..1; im_small [1,eh,ew,3] (the
        lighting-grid resize of the same photo); fov in degrees.  Arrays
        or tensors; they are moved to the renderer's device.

        Returns {"preds": [per-cascade NHWC pred dicts], "lights":
        [per-level light dicts], "light": the final level's light dict or
        None, "refined": [per-level refined dicts] with ``is_bs``, else
        None}."""
        im = torch.as_tensor(im, dtype=torch.float32, device=self.device)
        im_small = torch.as_tensor(im_small, dtype=torch.float32,
                                   device=self.device)
        if (self.is_light or self.level == 2) and im.shape[0] != 1:
            raise ValueError(
                "staged mode fits one global cLight/cAlbedo scale "
                "(the reference testReal.py's strictly-B1 semantics)"
            )
        with torch.inference_mode():
            preds = predict_brdf(self._nets[0][0], im)
            all_preds = [preds]
            lights = []
            if self.is_light or self.level == 2:
                lights.append(self._light(0, im, preds, im_small, fov))
            if self.level == 2:
                extra = _cascade1_extra(
                    im, preds, lights[0]["diffuse"], lights[0]["specular"]
                )
                preds = predict_brdf(self._nets[1][0], im, extra)
                all_preds.append(preds)
                if self.is_light:
                    lights.append(self._light(1, im, preds, im_small, fov,
                                              lights[0]["sg_flat"]))
            refined = [
                refine_bs(im, p, nets, self.use_kernels)
                for p, nets in zip(all_preds, self._bs_nets)
            ] if self.is_bs else None
        return {
            "preds": all_preds,
            "lights": lights,
            "light": lights[-1] if lights else None,
            "refined": refined,
        }

    def render_file(self, path, im_hw=(240, 320), env_rc=(120, 160)):
        """A photo from disk through the chain: :func:`load_real_image`
        (aspect-preserving resize, gamma to linear, fov by orientation),
        then :meth:`__call__`."""
        im, im_small, fov = load_real_image(path, im_hw, env_rc)
        return self(im, im_small, fov)


__all__ = [
    "InverseRenderer",
    "load_real_image",
    "predict_brdf",
    "predict_light_core",
    "predict_light",
    "bs_prep",
    "refine_bs",
]
