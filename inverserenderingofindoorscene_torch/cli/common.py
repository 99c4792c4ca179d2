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
                   help="directory of the packed item cache "
                        "(data/cache.py): the dataset decoded once into "
                        "memmapped shards, an epoch a slice and the "
                        "exposure multiply an item; unset: decode every "
                        "epoch, as the reference does")
    p.add_argument("--itemCacheHalf", action="store_true",
                   help="store the cached HDR tensors (im, env_gt) as "
                        "float16: half the bytes, ~1e-3 relative error; "
                        "every other field stays exact")
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


def add_dtype_flag(p: argparse.ArgumentParser, default: str) -> None:
    """``--computeDtype``: the conv stacks' compute dtype (the CLIs whose
    JAX counterparts take it: train_brdf and train_light default to
    bfloat16, test_real to float32)."""
    p.add_argument("--computeDtype", default=default,
                   choices=["float32", "bfloat16"],
                   help="conv-stack compute dtype (params and heads stay "
                        "float32)")


def add_kernel_flags(p: argparse.ArgumentParser) -> None:
    """``--useKernels`` (the default) / ``--noKernels``."""
    p.add_argument("--useKernels", action="store_true", default=True,
                   help="the hand-written CUDA kernels (default)")
    p.add_argument("--noKernels", dest="useKernels", action="store_false",
                   help="the kernels' plain PyTorch versions")


def check_ported(opt) -> None:
    """Refuse the options whose code is not ported yet, never replacing
    them with something else."""
    v_max = getattr(opt, "vMax", "full")
    if v_max not in ("full", "auto"):
        raise NotImplementedError(
            f"--vMax {v_max}: the port's grids have exactly one vertex an "
            "occupied cell, so the solve is always exact and 'full' and "
            "'auto' both mean it; a capacity cap is left out on purpose "
            "(ROADMAP Queue A, left out: v_max / e_max)")


def setup_device(opt) -> torch.device:
    """``--device`` resolved; refuses the kernels off the card, and turns
    on cuDNN's per-shape autotuning (ROADMAP C7) unless
    ``torch.use_deterministic_algorithms`` is on: autotuning picks the
    algorithms by timing, so two runs may take different ones, and a
    deterministic run keeps it off."""
    from inverserenderingofindoorscene_torch.device import resolve_device

    device = resolve_device(opt.device)
    if device.type != "cuda" and getattr(opt, "useKernels", False):
        raise ValueError("the CUDA kernels need --device cuda; pass "
                         "--noKernels to run their plain versions")
    torch.backends.cudnn.benchmark = (
        not torch.are_deterministic_algorithms_enabled())
    return device


def require_h5py(what: str) -> None:
    """Fail at start-up, not after minutes of compute, where ``what``
    reads or writes the hand-off's ``.h5`` files and h5py is missing."""
    try:
        import h5py  # noqa: F401
    except ImportError as e:
        raise ImportError(f"{what} reads or writes the cascade hand-off's "
                          ".h5 files, and h5py does not import here") from e


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


def make_dataset(opt, phase: str, is_light: bool):
    """The OpenRooms dataset of a stage, from the common options."""
    from inverserenderingofindoorscene_torch.data.openrooms import (
        OpenRoomsDataset,
    )

    return OpenRoomsDataset(
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


def make_loader(opt, phase: str, is_light: bool, shuffle=True):
    """The OpenRooms ``BatchIterator`` of a stage, over the packed item
    cache with ``--itemCache`` (built on first use).  Default prefetch:
    process workers for BRDF-stage items (GIL-held PIL and numpy work),
    threads for light-stage items (the GIL-releasing native envmap
    decode, and a 22 MB ``env_gt`` that pickling would copy) and for
    cached items (memmap slices, which pickling would copy again);
    threads below two workers."""
    from inverserenderingofindoorscene_torch.data.openrooms import (
        BatchIterator,
    )

    ds = make_dataset(opt, phase, is_light)
    if opt.itemCache:
        from inverserenderingofindoorscene_torch.data.cache import (
            CachedOpenRoomsDataset,
        )

        ds = CachedOpenRoomsDataset(ds, opt.itemCache,
                                    workers=max(opt.numWorkers, 1),
                                    half=opt.itemCacheHalf)
    mode = opt.loaderMode or (
        "thread" if is_light or opt.itemCache else "process")
    if opt.numWorkers <= 1:
        mode = "thread"
    return BatchIterator(
        ds, opt.batchSize, shuffle=shuffle, num_workers=opt.numWorkers,
        seed=opt.seed, mode=mode,
    )


def zip_max_cycle(loader_a, loader_b):
    """Pairs of batches over an epoch of max(len) pairs, the shorter
    loader starting again where it ends (the reference's ConcatDataset,
    iiwDataLoader.py:14-22; ``zip`` would cut the epoch to the small
    real-data set).  Returns (pairs, n)."""
    import itertools

    n = max(len(loader_a), len(loader_b))

    def cyc(ld):
        while True:
            yield from ld

    return itertools.islice(zip(cyc(loader_a), cyc(loader_b)), n), n


def load_frozen_cascade0(opt, generator, device):
    """The frozen cascade-0 BRDF and light stacks that synthesize a
    cascade-1 real-data batch's ``*_pre`` maps
    (trainFineTuneIIW_cascade1.py:300-362), from ``--brdf0Experiment`` /
    ``--light0Experiment`` (default: the reference's names; at cascade 1
    ``--brdfExperiment`` names the cascade-1 start).  A missing
    checkpoint is an error: random frozen nets would train against
    meaningless inputs.  Returns (brdf_nets0, light_nets0)."""
    import copy

    from inverserenderingofindoorscene_torch.cli.output_brdf_light import (
        load_frozen_light,
    )
    from inverserenderingofindoorscene_torch.cli.train_light import (
        load_frozen_brdf,
    )

    opt0 = copy.copy(opt)
    opt0.cascadeLevel = 0
    opt0.offset = getattr(opt, "offset", 1.0)
    opt0.brdfExperiment = getattr(opt, "brdf0Experiment", None)
    opt0.brdfEpoch = getattr(opt, "brdf0Epoch", None)
    opt0.lightExperiment = getattr(opt, "light0Experiment", None)
    opt0.lightEpoch = getattr(opt, "light0Epoch", None)
    bexp = opt0.brdfExperiment or default_experiment_name(opt0, "brdf")
    if opt0.brdfEpoch is None and ckpt.latest_epoch(bexp, "brdf", 0) is None:
        raise FileNotFoundError(
            f"the cascade-1 synthesis needs a trained cascade-0 BRDF; no "
            f"checkpoint under {bexp!r} (--brdf0Experiment/--brdf0Epoch)")
    lexp = opt0.lightExperiment or default_experiment_name(
        opt0, "light", offset=opt0.offset)
    if (opt0.lightEpoch is None
            and ckpt.latest_epoch(lexp, "light", 0) is None):
        raise FileNotFoundError(
            f"the cascade-1 synthesis needs a trained cascade-0 light "
            f"stack; no checkpoint under {lexp!r} "
            f"(--light0Experiment/--light0Epoch)")
    brdf_nets0 = load_frozen_brdf(opt0, generator, device)
    light_nets0 = load_frozen_light(opt0, generator, device)
    return brdf_nets0, light_nets0


def make_pre_synth(opt, generator, device):
    """The ``*_pre`` synthesis of the cascade-1 fine-tunes
    (trainFineTune*_cascade1.py:300-374): ``pipeline/finetune.
    synthesize_pre`` on the frozen cascade-0 stack, through the
    ``render_sg_fwd`` kernel with ``--useKernels``.  Returns batch ->
    batch with the seven ``*_pre`` keys."""
    from inverserenderingofindoorscene_torch.pipeline.finetune import (
        synthesize_pre,
    )

    bn0, ln0 = load_frozen_cascade0(opt, generator, device)
    bn0.to(device).eval()
    ln0.to(device).eval()
    use_kernels = getattr(opt, "useKernels", False)
    return lambda b: synthesize_pre(bn0, ln0, b, use_kernels=use_kernels)


def add_finetune_args(p: argparse.ArgumentParser, lr: float,
                      lr_help: str) -> None:
    """The options the IIW and NYU fine-tune CLIs share."""
    p.add_argument("--albedoWeight", type=float, default=1.5)
    p.add_argument("--normalWeight", type=float, default=1.0)
    p.add_argument("--roughWeight", type=float, default=0.5)
    p.add_argument("--depthWeight", type=float, default=0.5)
    p.add_argument("--lr", type=float, default=lr, help=lr_help)
    p.add_argument("--brdfExperiment", default=None)
    p.add_argument("--brdfEpoch", type=int, default=None)
    p.add_argument("--brdf0Experiment", default=None,
                   help="cascade-0 BRDF experiment of the inline *_pre "
                        "synthesis at --cascadeLevel 1 (--brdfExperiment "
                        "then names the cascade-1 start)")
    p.add_argument("--brdf0Epoch", type=int, default=None)
    p.add_argument("--light0Experiment", default=None,
                   help="cascade-0 light experiment of the inline *_pre "
                        "synthesis at --cascadeLevel 1")
    p.add_argument("--light0Epoch", type=int, default=None)
    add_kernel_flags(p)
    p.set_defaults(nepoch=3)


def run_finetune(opt, kind: str, real_ds, make_real_step) -> None:
    """The fine-tune loop of ``train_finetune_iiw`` / ``_nyu``: each cycle
    one synthetic batch through the BRDF step and one ``real_ds`` batch
    through ``make_real_step(syn_step)``, on the synthetic step's Adam
    (the JAX CLIs' one ``TrainState``), over max(len) pairs an epoch
    (:func:`zip_max_cycle`).  At cascade 1 the real batch's ``*_pre`` maps
    come from :func:`make_pre_synth`.  Checkpoints under the stage name
    ``kind``; ``--resume`` as the other train CLIs."""
    from inverserenderingofindoorscene_torch.cli.train_light import (
        load_frozen_brdf,
    )
    from inverserenderingofindoorscene_torch.data.openrooms import (
        BatchIterator,
    )
    from inverserenderingofindoorscene_torch.train.steps import (
        BRDFTrainStep,
    )
    from inverserenderingofindoorscene_torch.utils.logging import (
        MetricLogger,
    )

    check_ported(opt)
    if opt.cascadeLevel > 0:
        # the synthetic batches carry the cascade-0 *_pre files
        require_h5py(f"train_finetune_{kind} --cascadeLevel 1")
    device = setup_device(opt)
    opt.experiment = opt.experiment or "check%s_cascade%d_w%d_h%d" % (
        kind.upper(), opt.cascadeLevel, opt.imWidth, opt.imHeight)
    exp = experiment_dir(opt, kind)
    gen = pin_seeds(opt.seed)

    # the start point, trained here (not frozen)
    nets = load_frozen_brdf(opt, gen, device)
    syn_loader = make_loader(opt, "TRAIN", is_light=False)
    real_loader = BatchIterator(real_ds, opt.batchSize, seed=opt.seed,
                                num_workers=opt.numWorkers)
    syn_step = BRDFTrainStep(nets, opt.albedoWeight, opt.normalWeight,
                             opt.roughWeight, opt.depthWeight, device=device,
                             lr=opt.lr)
    real_step = make_real_step(syn_step)
    synth = None
    if opt.cascadeLevel > 0:
        synth = make_pre_synth(
            opt, torch.Generator().manual_seed(opt.seed + 7), device)

    def state():
        return ckpt.train_state(syn_step.brdf_nets, syn_step.optimizer,
                                syn_step.scheduler)

    start_epoch, skip = resume_train_state(
        opt, exp, kind, opt.cascadeLevel, syn_step.brdf_nets,
        syn_step.optimizer, syn_step.scheduler)

    logger = MetricLogger(f"{exp}/trainingLog.txt",
                          flush_steps=opt.logFlushSteps)
    try:
        for epoch in range(start_epoch, opt.nepoch):
            pairs, _ = zip_max_cycle(syn_loader, real_loader)
            for j, (syn_np, real_np) in enumerate(pairs):
                if opt.maxSteps is not None and j >= opt.maxSteps:
                    break
                if epoch == start_epoch and j < skip:
                    continue  # mid-epoch resume: replay position, not steps
                m1 = syn_step(stage_batch(syn_np, device))
                real = stage_batch(real_np, device)
                if synth is not None:
                    real = synth(real)
                m2 = real_step(real)
                logger.log_device(epoch, j, {
                    **{f"syn_{k}": v for k, v in m1.items()},
                    **{f"{kind}_{k}": v for k, v in m2.items()}})
                maybe_save_step_checkpoint(opt, exp, kind, opt.cascadeLevel,
                                           state, epoch, j, logger=logger)
            ckpt.save_checkpoint(exp, kind, opt.cascadeLevel, epoch, state())
            logger.save_curves(exp, epoch)
    finally:
        syn_loader.close()
        real_loader.close()
    logger.close()


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
