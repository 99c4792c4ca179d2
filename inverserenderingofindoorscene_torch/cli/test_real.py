"""In-the-wild two-cascade inference CLI (the testReal.py equivalent).

The counterpart of the JAX package's ``cli/test_real.py``.  A photo at a
time (testReal.py:285-660): :func:`load_real_image` (aspect-preserving
resize, fov 57 landscape / 42.75 portrait, gamma 2.2 to linear), then
``InverseRenderer``: cascade-0 BRDF -> light -> render -> the global
light / albedo scale from the diffuse / specular fit -> cascade 1 (the
17-channel input with the rendered components) -> light 1 -> the
bilateral refinement of albedo / rough / depth; then the npy / png / npz
products, each level's.  The lighting runs on the ``render_sg_env``
kernel, twice a photo at level 2, and the refinement's blur on
``bilateral_blur`` (``--noKernels``: their plain versions;
``--device cpu`` needs it).  ``--computeDtype bfloat16`` runs both
stacks' convolutions in bf16 (float32 by default, as in the JAX CLI).
``--fused`` serves with ``InverseRenderer(fused=True)``: the scale fit
traced per image, no host sync inside the chain.

Usage: python -m inverserenderingofindoorscene_torch.cli.test_real \
    --imList images.txt --output out/ [--level 2] [--isLight] [--isBS]
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np

from inverserenderingofindoorscene_torch.cli import common
from inverserenderingofindoorscene_torch.pipeline.bilateral import (
    BilateralNets,
)
from inverserenderingofindoorscene_torch.pipeline.brdf import BRDFNets
from inverserenderingofindoorscene_torch.pipeline.inference import (
    InverseRenderer,
    load_real_image,
)
from inverserenderingofindoorscene_torch.pipeline.light import LightNets
from inverserenderingofindoorscene_torch.utils import checkpoint as ckpt
from inverserenderingofindoorscene_torch.utils.io import (
    pred_to_shading,
    write_envmap_mosaic,
    write_image,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--imList", required=True,
                   help="text file of image paths (png/jpg)")
    p.add_argument("--output", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device of the chain (cpu for a run without "
                        "the card)")
    p.add_argument("--level", type=int, default=2, choices=[1, 2])
    p.add_argument("--isLight", action="store_true")
    p.add_argument("--isBS", action="store_true")
    p.add_argument("--imHeight", type=int, default=240)
    p.add_argument("--imWidth", type=int, default=320)
    p.add_argument("--envRow", type=int, default=120)
    p.add_argument("--envCol", type=int, default=160)
    p.add_argument("--envHeight", type=int, default=8)
    p.add_argument("--envWidth", type=int, default=16)
    p.add_argument("--SGNum", type=int, default=12)
    p.add_argument("--experimentBRDF0", default=None)
    p.add_argument("--experimentBRDF1", default=None)
    p.add_argument("--experimentLight0", default=None)
    p.add_argument("--experimentLight1", default=None)
    p.add_argument("--epochBRDF", type=int, default=None)
    p.add_argument("--epochLight", type=int, default=None)
    p.add_argument("--bsExperiment", default=None,
                   help="trained confidence-net checkpoint dir for every "
                        "level; unit confidence where there is none")
    p.add_argument("--bsExperiment0", default=None,
                   help="the level's own --bsExperiment (the reference "
                        "loads a bilateral stack a cascade level)")
    p.add_argument("--bsExperiment1", default=None)
    p.add_argument("--bsEpoch", type=int, default=None)
    p.add_argument("--vMax", default="auto",
                   help="bilateral vertex capacity: 'auto' or 'full', "
                        "both the exact grid here; an integer cap is not "
                        "ported")
    p.add_argument("--seed", type=int, default=0)
    common.add_dtype_flag(p, "float32")
    p.add_argument("--fused", action="store_true",
                   help="the fused chain: the cLight/cAlbedo fit traced "
                        "per image (torch.where), no host sync between "
                        "the cascades; the staged chain fits on the host")
    common.add_kernel_flags(p)
    return p.parse_args(argv)


def load_stack(opt, device):
    """The [(BRDFNets, LightNets)] of each level, from their checkpoints
    where there are any (random nets, seeded, where not)."""
    import torch

    gen = torch.Generator().manual_seed(opt.seed)
    stacks = []
    for lvl in range(opt.level):
        brdf = BRDFNets(cascade_level=lvl, generator=gen,
                        compute_dtype=opt.computeDtype)
        light = LightNets(
            sg_num=opt.SGNum, cascade_level=lvl, env_rows=opt.envRow,
            env_cols=opt.envCol, env_height=opt.envHeight,
            env_width=opt.envWidth, generator=gen,
            compute_dtype=opt.computeDtype)
        for stage, nets, exp, ep, kw in (
                ("brdf", brdf, getattr(opt, f"experimentBRDF{lvl}"),
                 opt.epochBRDF, {}),
                ("light", light, getattr(opt, f"experimentLight{lvl}"),
                 opt.epochLight, {"offset": 1.0})):
            exp = exp or common.default_experiment_name(
                opt, stage, cascade=lvl, **kw)
            if ep is None:
                ep = ckpt.latest_epoch(exp, stage, lvl)
            if ep is not None:
                ckpt.load_train_state(ckpt.restore_checkpoint(
                    exp, stage, lvl, ep, map_location=device), nets)
                print(f"loaded {stage} level {lvl} from {exp} epoch {ep}")
        stacks.append((brdf, light))
    return stacks


def load_bs_nets(opt, device):
    """Each level's trained confidence nets, or None (unit confidence)
    where there is no checkpoint (testReal.py:184-202)."""
    out = []
    for lvl in range(opt.level):
        exp = getattr(opt, f"bsExperiment{lvl}") or (
            opt.bsExperiment
            or common.default_experiment_name(opt, "bs", cascade=lvl))
        ep = opt.bsEpoch
        if ep is None:
            ep = ckpt.latest_epoch(exp, "bs", lvl)
        if ep is None:
            out.append(None)
            continue
        nets = BilateralNets()
        ckpt.load_train_state(ckpt.restore_checkpoint(
            exp, "bs", lvl, ep, map_location=device), nets)
        print(f"loaded level-{lvl} confidence nets from {exp} epoch {ep}")
        out.append(nets)
    return out


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def write_products(opt, name, im_np, im_orig, result):
    """One photo's products, each level's, under the reference's names
    (testReal.py:542-660).  The PNGs are resized to the last level's
    fitted input size, as testReal.py:318 sets nh / nw before its write
    loop; the normal npy is saved resized (testReal.py:565), the other
    npys at network resolution."""
    import cv2
    from PIL import Image

    def out(n):
        return osp.join(opt.output, n)

    nh, nw = im_np.shape[1:3]

    def to_nwnh(arr):
        arr = np.asarray(arr, np.float32)
        if arr.shape[:2] == (nh, nw):
            return arr
        return cv2.resize(arr, (nw, nh), interpolation=cv2.INTER_LINEAR)

    # the unresized photo, a product of its own (testReal.py:659-660)
    Image.fromarray(np.ascontiguousarray(im_orig)).save(out(f"{name}.png"))
    lights = result["lights"]
    # a level's cAlbedo / cLight: the scale fit of the level whose light
    # ran (testReal.py:546-549)
    scales = [(float(lo["c_albedo"]), float(lo["c_light"])) for lo in lights]

    for lvl, preds in enumerate(result["preds"]):
        c_albedo = scales[lvl][0] if lvl < len(scales) else 1.0
        albedo = _np(preds["albedo"][0]) * c_albedo
        np.save(out(f"{name}_albedo{lvl}.npy"), albedo)
        # the gamma before the resize (testReal.py:551-553)
        write_image(to_nwnh(np.clip(albedo, 0, None) ** (1.0 / 2.2)),
                    out(f"{name}_albedo{lvl}.png"))
        normal_r = to_nwnh(_np(preds["normal"][0]))
        np.save(out(f"{name}_normal{lvl}.npy"), normal_r)
        write_image(0.5 * (normal_r + 1.0), out(f"{name}_normal{lvl}.png"))
        rough = _np(preds["rough"][0])
        np.save(out(f"{name}_rough{lvl}.npy"), rough)
        write_image(0.5 * (to_nwnh(rough) + 1.0),
                    out(f"{name}_rough{lvl}.png"))
        d = _np(preds["depth"][0])
        np.save(out(f"{name}_depth{lvl}.npy"), d)
        # mean-normalized to 3, resized, 1/(d+1) (testReal.py:578-588)
        dn = to_nwnh(d / max(float(d.mean()), 1e-10) * 3.0)
        write_image(1.0 / np.clip(dn + 1.0, 1e-6, 10.0),
                    out(f"{name}_depth{lvl}.png"))

    # the light products only with --isLight (testReal.py:622)
    for lvl, light in enumerate(lights if opt.isLight else []):
        c_albedo, c_light = scales[lvl]
        env_img = _np(light["env_img"][0])
        er, ec = env_img.shape[:2]
        # 'env' [R, C, eh, ew, 3] in the dataset's BGR order
        # (testReal.py:629-634)
        np.savez_compressed(
            out(f"{name}_envmap{lvl}.npz"),
            env=np.ascontiguousarray(env_img.reshape(
                er, ec, opt.envHeight, opt.envWidth, 3)[..., ::-1]))
        sg_flat = _np(light["sg_flat"][0])
        # [1, SGNum*7, R, C] (testReal.py:636-638)
        np.save(out(f"{name}_envmapSG{lvl}.npy"),
                sg_flat.transpose(2, 0, 1)[None])
        write_envmap_mosaic(env_img, out(f"{name}_envmap{lvl}.png"),
                            nrows=24, ncols=16, env_height=opt.envHeight,
                            env_width=opt.envWidth)
        # max-normalized, gamma before the resize (testReal.py:648-654)
        rendered = _np((light["diffuse"] + light["specular"])[0])
        rp = (rendered / max(float(rendered.max()), 1e-10)) ** (1.0 / 2.2)
        write_image(to_nwnh(rp), out(f"{name}_rendered{lvl}.png"))
        # the SG's diffuse shading, mean-normalized to 1/3
        # (testReal.py:639-644, utils.predToShading)
        shading = pred_to_shading(sg_flat, sg_num=opt.SGNum)
        shading = shading / max(float(shading.mean()), 1e-10) / 3.0
        write_image(np.clip(shading, 0, 1), out(f"{name}_shading{lvl}.png"),
                    gamma=True)
        np.save(out(f"{name}_cLight{lvl}.npy"), np.array([c_albedo, c_light]))
        from scipy.io import savemat

        savemat(out(f"{name}_cLight{lvl}.mat"),
                {"cLight": np.asarray(c_light),
                 "cAlbedo": np.asarray(c_albedo)})

    # 'BS': the reference's names, which CompareWHDR.py:72 and
    # CompareDepth.py:10 read (testReal.py:592-625)
    for lvl, bso in enumerate(result["refined"] or []):
        c_albedo = scales[lvl][0] if lvl < len(scales) else 1.0
        albedo_bs = _np(bso["albedo"][0]) * c_albedo
        np.save(out(f"{name}_albedoBS{lvl}.npy"), albedo_bs)
        write_image(to_nwnh(np.clip(albedo_bs, 0, None) ** (1.0 / 2.2)),
                    out(f"{name}_albedoBS{lvl}.png"))
        rough_bs = _np(bso["rough"][0])
        np.save(out(f"{name}_roughBS{lvl}.npy"), rough_bs)
        write_image(0.5 * (to_nwnh(rough_bs) + 1.0),
                    out(f"{name}_roughBS{lvl}.png"))
        d_bs = _np(bso["depth"][0])
        np.save(out(f"{name}_depthBS{lvl}.npy"), d_bs)
        dn = to_nwnh(d_bs / max(float(d_bs.mean()), 1e-10) * 3.0)
        write_image(1.0 / np.clip(dn + 1.0, 1e-6, 10.0),
                    out(f"{name}_depthBS{lvl}.png"))


def main(argv=None):
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    opt = parse_args(argv)
    common.check_ported(opt)
    device = common.setup_device(opt)
    os.makedirs(opt.output, exist_ok=True)
    with open(opt.imList) as f:
        im_list = [x.strip() for x in f if x.strip()]
    renderer = InverseRenderer(
        load_stack(opt, device), is_light=opt.isLight, is_bs=opt.isBS,
        bs_nets=load_bs_nets(opt, device) if opt.isBS else None,
        use_kernels=opt.useKernels, fused=opt.fused, device=device)

    def load(p):
        return load_real_image(p, (opt.imHeight, opt.imWidth),
                               (opt.envRow, opt.envCol),
                               return_original=True)

    # the next photos are read on host threads while the card runs this
    # one (the reference's loop is serial, testReal.py:285-343); two
    # ahead bound the host memory
    pool = ThreadPoolExecutor(max_workers=2)
    try:
        pending = deque(pool.submit(load, p) for p in im_list[:2])
        for idx, im_path in enumerate(im_list):
            name = osp.splitext(osp.basename(im_path))[0]
            im_np, im_small_np, fov, im_orig = pending.popleft().result()
            if idx + 2 < len(im_list):
                pending.append(pool.submit(load, im_list[idx + 2]))
            result = renderer(im_np, im_small_np, fov)
            write_products(opt, name, im_np, im_orig, result)
            print(f"done {im_path} -> {opt.output}/{name}_*")
    finally:
        pool.shutdown()


if __name__ == "__main__":
    main()
