"""In-the-wild two-cascade inference as a library API.

The counterpart of the JAX package's ``pipeline/inference.py``: stage
functions (:func:`predict_brdf`, :func:`predict_light_core`,
:func:`predict_light`, :func:`predict_light_traced`, :func:`bs_prep`,
:func:`refine_bs`) plus :class:`InverseRenderer`, which runs image ->
albedo/normal/rough/depth/lighting through both cascades, and optionally
the bilateral refinement of every cascade's maps, in one call: staged
(the host scale fit, one photo a call) or fused (the traced per-image
fit, batches, no host sync inside the chain).  Public functions take and
return NHWC tensors like the JAX package; the networks inside run in
NCHW.

:func:`load_real_image` reads a photo from disk with OpenCV (imported
where it is called), and :meth:`InverseRenderer.render_file` runs the
chain on it.  :meth:`InverseRenderer.serialize` exports the fused chain
through ``torch.export`` and :func:`deserialize_chain` serves it without
the model classes.
The JAX package's vertex-capacity option ``v_max`` has no counterpart:
the port's grids have exactly as many vertices as occupied cells.  Its
``param_sharding`` (replicated weights, the batch sharded over a mesh)
is ``InverseRenderer(..., fused=True, group=g)``: every rank of the
``torch.distributed`` group serves rank 0's weights on its own rows of
the batch.
"""

from __future__ import annotations

import functools
import io

import numpy as np
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
from inverserenderingofindoorscene_torch.core.scale import (
    ls_regress_diff_spec,
    mean_normalize,
)
from inverserenderingofindoorscene_torch.device import resolve_device
from inverserenderingofindoorscene_torch.ops.sg_render import render_sg_env
from inverserenderingofindoorscene_torch.parallel.mesh import replicate_
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


def predict_light_traced(core_out, cascade=0):
    """The cLight/cAlbedo disambiguation of :func:`predict_light` with its
    branch as ``torch.where``: no ``.item()``, no host branch, so the
    chain runs without a host sync (testReal.py:421-432).

    Both reference branches end at ``c_light = c_diff / c_albedo``; only
    ``c_albedo`` differs: the upper clip bound where the specular fit is
    degenerate (``c_spec < 1e-3`` at cascade 0, ``<= 0`` at cascade 1),
    the clipped ratio otherwise.  The degenerate branch's discarded ratio
    may be inf or nan; ``torch.where`` never selects it.  The fit is per
    image: ``c_albedo`` / ``c_light`` are [B] tensors and ``env_img`` is
    scaled image by image; at B=1 it is the host fit in float32."""
    b = core_out["diffuse"].shape[0]

    def per_image_sum(x):
        return torch.sum(x.reshape(b, -1), dim=1)

    c_diff = (per_image_sum(core_out["diffuse"])
              / per_image_sum(core_out["diffuse_raw"]))
    c_spec = (per_image_sum(core_out["specular"])
              / per_image_sum(core_out["specular_raw"]))
    ca_hi = 1.0 / core_out["albedo_max"]
    degenerate = (c_spec < 1e-3) if cascade == 0 else (c_spec <= 0.0)
    c_albedo = torch.where(
        degenerate, ca_hi,
        torch.minimum(torch.clamp(c_diff / c_spec, min=1e-3), ca_hi))
    c_light = c_diff / c_albedo
    env = core_out["env_img"]
    return {
        "sg_flat": core_out["sg_flat"],
        "env_img": env * c_light.reshape((b,) + (1,) * (env.dim() - 1)),
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


def refine_bs(im, preds, bs_nets=None, use_kernels=True, group=None):
    """Bilateral refinement of albedo / rough / depth (testReal.py:532-540)
    with the confidences of ``bs_nets`` (a ``BilateralNets``; None means
    unit confidence).  ``use_kernels`` blurs with the CUDA kernel
    ``ops.bilateral.bilateral_blur`` (on CUDA tensors) or its plain
    version.  ``group``: the ranks whose rows make up the batch; the
    confidences are then divided by their maximum over every rank's
    images (a collective call).  Returns the refined NHWC maps keyed
    albedo / rough / depth."""
    refined, _, _ = refine(bs_nets, im, preds, use_kernels, group)
    return {k: refined[k] for k in BS_MODES}


class InverseRenderer:
    """Inverse rendering of photos as one call (the testReal chain).

    ``stacks``: [(BRDFNets, LightNets)] per cascade level (1 or 2); the
    modules are moved to ``device`` in place.  ``device=None`` means
    ``cuda`` and raises without CUDA; pass ``device="cpu"`` to run on the
    CPU.  ``use_kernels`` routes the lighting decode + shading through the
    CUDA kernel ``ops.sg_render.render_sg_env`` and the refinement's blur
    through ``ops.bilateral.bilateral_blur``.

    Staged mode (the default) fits one cLight/cAlbedo scale on the host
    (:func:`predict_light`) and takes one photo a call, as the reference
    driver does.  ``fused=True`` fits the scales with
    :func:`predict_light_traced` instead: the BRDF -> light -> BRDF ->
    light chain runs with no host sync inside it, takes batches of B >= 1
    photos, and gives each photo its own [B] scales;
    :meth:`serialize` exports it.  The bilateral refinement runs after
    the chain in both modes (its grid build reads the vertex count on the
    host), each image on its own grid.

    ``is_bs`` refines every level's albedo / rough / depth with the
    bilateral solver (:func:`refine_bs`).  ``bs_nets``: the confidence
    nets, one ``BilateralNets`` per level (a list; an entry may be None
    for unit confidence) or one applied to every level, or None for unit
    confidence everywhere.  The stacks serve in their own
    ``compute_dtype`` (``test_real --computeDtype bfloat16`` builds bf16
    stacks); their heads, and so every kernel's inputs, are float32
    either way.

    ``group`` (fused mode only): a ``torch.distributed`` process group
    to serve on, data-parallel, the counterpart of the JAX renderer's
    ``param_sharding``.  Construction broadcasts rank 0's weights to
    every rank (``parallel.mesh.replicate_``, collective), and every call
    is collective: each rank passes its own rows of the batch (split by
    ``parallel.mesh.shard_batch`` / ``multihost.local_batch_slice``) and
    gets their outputs.  The chain needs no communication (each image has
    its own scales); the confidence nets divide by their maximum over
    every rank's images, as the JAX program does over the global batch.
    """

    def __init__(self, stacks, *, is_light=True, is_bs=False, bs_nets=None,
                 use_kernels=True, fused=False, device=None, group=None):
        self.level = len(stacks)
        if self.level not in (1, 2):
            raise ValueError(f"level must be 1 or 2, got {self.level}")
        self.device = resolve_device(device)
        # at level 2 lighting runs at every level (cascade 1 needs the
        # cascade-0 diffuse/specular); is_light gates the cascade-1 light
        self.is_light = is_light
        self.use_kernels = use_kernels
        self.fused = fused
        if group is not None and not fused:
            raise ValueError(
                "serving on a group needs fused=True: staged mode fits one "
                "global cLight/cAlbedo scale on the host, a photo a call")
        self.group = group
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
        for net in [n for pair in self._nets for n in pair] + self._bs_nets:
            if net is not None:
                replicate_(net, group)

    def _run_chain(self, im, im_small, fov, light_post):
        """BRDF -> light -> BRDF -> light on device tensors, with the
        scale fit ``light_post``: :func:`predict_light` (staged) or
        :func:`predict_light_traced` (fused, exported).

        The lighting gates are the reference's: cascade-0 light when
        ``is_light or level == 2`` (testReal.py:382: level 2 needs its
        diffuse/specular), cascade-1 light only with ``is_light``
        (testReal.py:475).  Returns {"preds", "lights", "light"}."""
        preds = predict_brdf(self._nets[0][0], im)
        all_preds = [preds]
        lights = []
        if self.is_light or self.level == 2:
            lights.append(light_post(predict_light_core(
                self._nets[0][1], im, preds, im_small, fov,
                use_kernels=self.use_kernels), cascade=0))
        if self.level == 2:
            extra = _cascade1_extra(
                im, preds, lights[0]["diffuse"], lights[0]["specular"]
            )
            preds = predict_brdf(self._nets[1][0], im, extra)
            all_preds.append(preds)
            if self.is_light:
                lights.append(light_post(predict_light_core(
                    self._nets[1][1], im, preds, im_small, fov,
                    lights[0]["sg_flat"], use_kernels=self.use_kernels),
                    cascade=1))
        return {
            "preds": all_preds,
            "lights": lights,
            "light": lights[-1] if lights else None,
        }

    def __call__(self, im, im_small, fov=57.0):
        """im [B,H,W,3] linear RGB in 0..1; im_small [B,eh,ew,3] (the
        lighting-grid resize of the same photos); fov in degrees.  Arrays
        or tensors; they are moved to the renderer's device.  B must be 1
        in staged mode wherever lighting runs.

        Returns {"preds": [per-cascade NHWC pred dicts], "lights":
        [per-level light dicts], "light": the final level's light dict or
        None, "refined": [per-level refined dicts] with ``is_bs``, else
        None}.  A light dict's ``c_albedo`` / ``c_light`` are floats in
        staged mode and [B] tensors in fused mode."""
        im = torch.as_tensor(im, dtype=torch.float32, device=self.device)
        im_small = torch.as_tensor(im_small, dtype=torch.float32,
                                   device=self.device)
        if (not self.fused and (self.is_light or self.level == 2)
                and im.shape[0] != 1):
            raise ValueError(
                "staged mode fits one global cLight/cAlbedo scale "
                "(the reference testReal.py's strictly-B1 semantics); use "
                "fused=True for batched serving with per-image scales"
            )
        light_post = predict_light_traced if self.fused else predict_light
        with torch.inference_mode():
            out = self._run_chain(im, im_small, fov, light_post)
            out["refined"] = [
                refine_bs(im, p, nets, self.use_kernels, self.group)
                for p, nets in zip(out["preds"], self._bs_nets)
            ] if self.is_bs else None
        return out

    def render_file(self, path, im_hw=(240, 320), env_rc=(120, 160)):
        """A photo from disk through the chain: :func:`load_real_image`
        (aspect-preserving resize, gamma to linear, fov by orientation),
        then :meth:`__call__`."""
        im, im_small, fov = load_real_image(path, im_hw, env_rc)
        return self(im, im_small, fov)

    def serialize(self, im_hw, env_rc, fov=57.0, batch=1):
        """Export the fused chain ahead of time with ``torch.export``.

        Returns ``(blob, params)``: ``blob`` is the bytes of
        ``torch.export.save`` of the chain (:meth:`_run_chain` with
        :func:`predict_light_traced`) at static shapes, im [batch, *im_hw,
        3] and im_small [batch, *env_rc, 3] float32 on the renderer's
        device, with ``fov`` baked in; ``params`` the {name: tensor}
        weights the program takes as its first argument.
        :func:`deserialize_chain` serves the two without the model
        classes.  Requires ``fused=True``.  On the kernel route the
        program holds ``render_sg_env`` as the custom op
        ``irois_torch::render_sg_env``: the process that loads it must
        import ``inverserenderingofindoorscene_torch.ops.sg_render``,
        which registers the op (and builds the kernel on first use).
        Export the kernel route on the card; the plain route exports on
        either device."""
        if not self.fused:
            raise ValueError("serialize requires fused=True")
        if self.group is not None:
            raise ValueError("serialize exports one process's chain; build "
                             "the renderer without a group")
        chain = _Chain(self, float(fov))
        params = {k: v.detach() for k, v in chain.named_parameters()}
        example = (
            params,
            torch.zeros((batch, *im_hw, 3), device=self.device),
            torch.zeros((batch, *env_rc, 3), device=self.device),
        )
        with torch.no_grad():
            program = torch.export.export(_Program(chain), example)
        # the example inputs would be saved with the program, the weights
        # among them
        program.example_inputs = None
        buf = io.BytesIO()
        torch.export.save(program, buf)
        return buf.getvalue(), params


class _Chain(nn.Module):
    """A renderer's nets as one module, whose forward is its fused chain
    at a fixed fov (the lights without the ``light`` alias)."""

    def __init__(self, renderer, fov):
        super().__init__()
        self.stacks = nn.ModuleList(nn.ModuleList(s) for s in renderer._nets)
        self._run = functools.partial(renderer._run_chain, fov=fov,
                                      light_post=predict_light_traced)

    def forward(self, im, im_small):
        out = self._run(im, im_small)
        return {"preds": out["preds"], "lights": out["lights"]}


class _Program(nn.Module):
    """``(params, im, im_small) -> chain``: the weights are inputs of the
    exported program, not a state of it (the chain module is kept out of
    this module's parameters)."""

    def __init__(self, chain):
        super().__init__()
        self._chain = [chain]

    def forward(self, params, im, im_small):
        return torch.func.functional_call(self._chain[0], params,
                                          (im, im_small))


def deserialize_chain(blob):
    """A :meth:`InverseRenderer.serialize` artifact as a callable
    ``(params, im, im_small) -> {"preds", "lights", "light"}``, the fused
    chain's outputs, that needs none of the port's model classes (on the
    kernel route, the op library of ``ops/sg_render.py`` imported)."""
    program = torch.export.load(io.BytesIO(blob)).module()

    def chain(params, im, im_small):
        with torch.no_grad():
            out = program(params, im, im_small)
        lights = out["lights"]
        return {"preds": out["preds"], "lights": lights,
                "light": lights[-1] if lights else None}

    return chain


__all__ = [
    "InverseRenderer",
    "deserialize_chain",
    "load_real_image",
    "predict_brdf",
    "predict_light_core",
    "predict_light",
    "predict_light_traced",
    "bs_prep",
    "refine_bs",
]
