"""Shared plumbing for the stage CLIs.

The counterpart of the JAX package's ``cli/common.py``: what every
reference training script repeats (the argparse conventions, the
experiment-dir naming of trainBRDF.py:65-69 / trainLight.py:65-67, seed
pinning trainBRDF.py:71-74, the checkpoint cadence trainBRDF.py:
392-396), the loader set-up, and the staging of a numpy batch onto the
device.  The CLIs run on ``--device`` (``cuda`` unless the caller asks
for ``cpu``).
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import random

import numpy as np
import torch

from inverserenderingofindoorscene_torch.utils import checkpoint as ckpt


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--dataRoot", help="path to the OpenRooms dataset")
    p.add_argument("--experiment", default=None, help="experiment directory")
    p.add_argument("--device", default="cuda",
                   help="torch device the nets train on (cpu for a run "
                        "without the card)")
    p.add_argument("--imHeight", type=int, default=240)
    p.add_argument("--imWidth", type=int, default=320)
    p.add_argument("--envRow", type=int, default=120)
    p.add_argument("--envCol", type=int, default=160)
    p.add_argument("--envHeight", type=int, default=8)
    p.add_argument("--envWidth", type=int, default=16)
    p.add_argument("--SGNum", type=int, default=12)
    p.add_argument("--cascadeLevel", type=int, default=0)
    p.add_argument("--batchSize", type=int, default=16)
    p.add_argument("--nepoch", type=int, default=14)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--numWorkers", type=int, default=4)
    p.add_argument("--loaderMode", default=None,
                   choices=[None, "thread", "process"],
                   help="prefetch worker kind; default: process for "
                        "BRDF-stage loaders (GIL-held PIL/numpy work), "
                        "thread for light-stage loaders (GIL-releasing "
                        "native envmap decode, large items)")
    p.add_argument("--itemCache", default=None,
                   help="the packed decode cache of the JAX package; not "
                        "ported yet (an error here)")
    p.add_argument("--computeDtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="conv-stack compute dtype; the port runs float32 "
                        "only (bfloat16 is an error here)")
    p.add_argument("--saveEvery", type=int, default=1,
                   help="epochs between checkpoints")
    p.add_argument("--maxSteps", type=int, default=None,
                   help="optional cap on steps per epoch (smoke runs)")
    p.add_argument("--ckptEverySteps", type=int, default=0,
                   help="mid-epoch checkpoints every N steps (0 = per-epoch "
                        "only, the reference's cadence)")
    p.add_argument("--ckptKeep", type=int, default=2,
                   help="step checkpoints retained (older ones pruned)")
    p.add_argument("--resume", default="epoch",
                   choices=["auto", "epoch", "none"],
                   help="'auto': most recent of epoch/step checkpoints "
                        "(restores mid-epoch data position + LR "
                        "schedule); 'epoch': latest epoch checkpoint; "
                        "'none': fresh start")
    p.add_argument("--logFlushSteps", type=int, default=16,
                   help="steps of metrics pulled to the host at once "
                        "(MetricLogger.log_device); 1 = the reference's "
                        "per-iteration cadence")
    return p


def check_ported(opt) -> None:
    """Refuse the options whose code is not ported yet, never replacing
    them with something else."""
    if getattr(opt, "itemCache", None):
        raise NotImplementedError(
            "--itemCache: the packed item cache (data/cache.py, "
            "cli/build_cache.py) is not ported yet (ROADMAP Queue A, the "
            "cache); run without it to decode every epoch")
    if getattr(opt, "computeDtype", "float32") != "float32":
        raise NotImplementedError(
            f"--computeDtype {opt.computeDtype}: the port computes in "
            "float32 only until ROADMAP A9 (bf16 and TF32)")


def default_experiment_name(opt, kind: str, offset=None,
                            cascade=None) -> str:
    """The reference checkpoint-dir naming (trainBRDF.py:66,
    trainLight.py:66-67, trainBRDFBilateral.py:71-75): the one place
    these format strings live, so producers and consumers agree.
    ``cascade`` overrides opt.cascadeLevel."""
    if cascade is None:
        cascade = opt.cascadeLevel
    if kind == "brdf":
        return "check_cascade%d_w%d_h%d" % (
            cascade, opt.imWidth, opt.imHeight
        )
    if kind == "light":
        off = offset if offset is not None else getattr(opt, "offset", 1.0)
        return "check_cascadeLight%d_sg%d_offset%.1f" % (
            cascade, opt.SGNum, off
        )
    if kind == "bs":
        return "checkBs_cascade%d_w%d_h%d" % (
            cascade, opt.imWidth, opt.imHeight
        )
    return "check_" + kind


def experiment_dir(opt, kind: str) -> str:
    """``--experiment`` or the reference's default name, created, with a
    snapshot of the source."""
    if opt.experiment is not None:
        exp = opt.experiment
    else:
        exp = default_experiment_name(opt, kind)
    os.makedirs(exp, exist_ok=True)
    snapshot_source(exp)
    return exp


def snapshot_source(exp_dir: str):
    """Copy the port's package into the experiment dir once (the
    reference's ``cp *.py``, trainBRDF.py:68-69)."""
    import shutil

    pkg_root = osp.dirname(osp.dirname(osp.abspath(__file__)))
    dst = osp.join(exp_dir, "src_snapshot")
    if osp.isdir(dst):
        return
    shutil.copytree(
        pkg_root, osp.join(dst, osp.basename(pkg_root)),
        ignore=shutil.ignore_patterns("__pycache__"),
    )


def pin_seeds(seed: int) -> torch.Generator:
    """Seed python, numpy and torch; returns a seeded generator for the
    nets' initial weights."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def stage_batch(batch: dict, device, drop=("name",)) -> dict:
    """numpy batch dict -> tensors on ``device`` (the reference's
    ``.cuda()`` staging, trainBRDF.py:149-174), without ``drop``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items() if k not in drop}


def make_loader(opt, phase: str, is_light: bool, shuffle=True):
    """The OpenRooms ``BatchIterator`` of a stage.  Default prefetch:
    process workers for BRDF-stage items (GIL-held PIL and numpy work),
    threads for light-stage items (the GIL-releasing native envmap
    decode, and a 22 MB ``env_gt`` that pickling would copy); threads
    below two workers."""
    from inverserenderingofindoorscene_torch.data.openrooms import (
        BatchIterator,
        OpenRoomsDataset,
    )

    ds = OpenRoomsDataset(
        opt.dataRoot,
        im_hw=(opt.imHeight, opt.imWidth),
        phase=phase,
        cascade_level=opt.cascadeLevel,
        is_light=is_light,
        is_all_light=is_light,
        env_hw=(opt.envHeight, opt.envWidth),
        env_rc=(opt.envRow, opt.envCol),
        sg_num=opt.SGNum,
        seed=opt.seed,
    )
    mode = opt.loaderMode or ("thread" if is_light else "process")
    if opt.numWorkers <= 1:
        mode = "thread"
    return BatchIterator(
        ds, opt.batchSize, shuffle=shuffle, num_workers=opt.numWorkers,
        seed=opt.seed, mode=mode,
    )


def dump_preview(exp, epoch, step, arrays: dict):
    """PNG dumps, ``{name}_{epoch}_{step}.png``: 4-D arrays as
    whole-batch grids (the reference's ``vutils.save_image`` previews,
    trainBRDF.py:334-369).  ``arrays``: name -> (tensor or array, gamma)."""
    from inverserenderingofindoorscene_torch.utils.io import (
        write_image,
        write_image_grid,
    )

    for name, (img, gamma) in arrays.items():
        if isinstance(img, torch.Tensor):
            img = img.detach().cpu().numpy()
        path = osp.join(exp, f"{name}_{epoch}_{step}.png")
        if img.ndim == 4:
            write_image_grid(img, path, gamma=gamma)
        else:
            write_image(img, path, gamma=gamma)


def resume_train_state(opt, exp, stage, cascade, nets, optimizer,
                       scheduler=None, explicit_epoch=None):
    """Resume a train CLI in place -> (start_epoch, skip).

    ``--resume epoch`` (default): the latest epoch checkpoint (or
    ``--resumeEpoch``), going on at the next epoch, the reference's
    granularity (trainBRDF.py:90-103).  ``--resume auto``: the most
    recent of the epoch and step checkpoints; a step checkpoint after
    step j of epoch e goes on at batch j + 1 of epoch e, the LR schedule
    in the restored scheduler and the data position from the loaders'
    (seed, epoch, item)-keyed streams.  ``--resume none``: a fresh start.
    The state loads onto the nets' device."""
    mode = getattr(opt, "resume", "epoch")
    if mode == "none":
        return 0, 0
    device = next(nets.parameters()).device
    ep = explicit_epoch
    if ep is None:
        ep = ckpt.latest_epoch(exp, stage, cascade)
    best = None if ep is None else ("epoch", ep)
    if mode == "auto" and explicit_epoch is None:
        steps = ckpt.list_step_checkpoints(exp, stage, cascade)
        if steps:
            e2, j2 = steps[-1]
            # an epoch-e checkpoint resumes at (e+1, 0); a step checkpoint
            # after step j of epoch e at (e, j+1)
            if ep is None or (e2, j2 + 1) > (ep + 1, 0):
                best = ("step", (e2, j2))
    if best is None:
        return 0, 0
    if best[0] == "epoch":
        state = ckpt.restore_checkpoint(exp, stage, cascade, best[1],
                                        map_location=device)
        ckpt.load_train_state(state, nets, optimizer, scheduler)
        print(f"resumed from epoch {best[1]}")
        return best[1] + 1, 0
    e2, j2 = best[1]
    state, _, _ = ckpt.restore_step_checkpoint(exp, stage, cascade, e2, j2,
                                               map_location=device)
    ckpt.load_train_state(state, nets, optimizer, scheduler)
    print(f"resumed from step checkpoint epoch {e2} step {j2}")
    return e2, j2 + 1


def maybe_save_step_checkpoint(opt, exp, stage, cascade, state_fn, epoch, j,
                               logger=None):
    """Every ``--ckptEverySteps`` steps, save ``state_fn()`` as a step
    checkpoint.  The logger is flushed first, so a kill right after the
    save loses no line of a step the checkpoint covers (a resume skips
    those steps without logging them again)."""
    n = getattr(opt, "ckptEverySteps", 0) or 0
    if n > 0 and (j + 1) % n == 0:
        if logger is not None:
            logger.flush()
        ckpt.save_step_checkpoint(exp, stage, cascade, state_fn(), epoch, j,
                                  keep=getattr(opt, "ckptKeep", 2))
