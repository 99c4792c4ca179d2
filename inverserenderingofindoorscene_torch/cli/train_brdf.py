"""Cascade BRDF training CLI (the trainBRDF.py equivalent).

The counterpart of the JAX package's ``cli/train_brdf.py``: one
``BRDFTrainStep`` per batch, Adam(1e-4, betas=(0.5, 0.999)) over the
encoder and the four decoders with the LR halved every 10 epochs; loss
``4*1.5*albedo + 1.0*normal + 0.5*rough + 0.5*depth``; a checkpoint per
epoch under the reference's ``check_cascade{k}_w{W}_h{H}`` naming, and
per-step checkpoints with ``--ckptEverySteps``.  At cascade 1 the loader
reads the cascade-0 ``*_pre`` maps.  The conv stacks compute in
``--computeDtype``, bfloat16 by default as in the JAX CLI.

Usage: python -m inverserenderingofindoorscene_torch.cli.train_brdf \
    --dataRoot ... [--device cpu]
"""

from __future__ import annotations

import torch

from inverserenderingofindoorscene_torch.cli import common
from inverserenderingofindoorscene_torch.pipeline.brdf import (
    BRDFNets,
    brdf_forward,
)
from inverserenderingofindoorscene_torch.train.steps import BRDFTrainStep
from inverserenderingofindoorscene_torch.utils import checkpoint as ckpt
from inverserenderingofindoorscene_torch.utils.logging import MetricLogger


def parse_args(argv=None):
    p = common.base_parser(__doc__)
    p.add_argument("--albedoWeight", type=float, default=1.5)
    p.add_argument("--normalWeight", type=float, default=1.0)
    p.add_argument("--roughWeight", type=float, default=0.5)
    p.add_argument("--depthWeight", type=float, default=0.5)
    p.add_argument("--resumeEpoch", type=int, default=None)
    p.add_argument("--previewEvery", type=int, default=2000,
                   help="dump GT/pred PNGs every N steps (trainBRDF.py:334)")
    common.add_dtype_flag(p, "bfloat16")
    return p.parse_args(argv)


def preview(exp, epoch, j, nets, batch):
    """The GT and predicted maps of ``batch`` as PNG grids."""
    with torch.no_grad():
        preds = brdf_forward(nets, batch)
    common.dump_preview(exp, epoch, j, {
        "im": (batch["im"], True),
        "albedoGt": (batch["albedo"], True),
        "albedoPred": (preds["albedo"], True),
        "normalPred": (0.5 * (preds["normal"] + 1.0), False),
        "roughPred": (0.5 * (preds["rough"] + 1.0), False),
        "depthPred": (1.0 / torch.clamp(preds["depth"], min=0.1) * 0.3,
                      False),
    })


def main(argv=None):
    opt = parse_args(argv)
    common.check_ported(opt)
    if opt.cascadeLevel > 0:
        common.require_h5py("train_brdf --cascadeLevel 1")
    device = common.setup_device(opt)
    exp = common.experiment_dir(opt, "brdf")
    gen = common.pin_seeds(opt.seed)

    nets = BRDFNets(cascade_level=opt.cascadeLevel, generator=gen,
                    compute_dtype=opt.computeDtype)
    loader = common.make_loader(opt, "TRAIN", is_light=False)
    step = BRDFTrainStep(
        nets, opt.albedoWeight, opt.normalWeight, opt.roughWeight,
        opt.depthWeight, device=device, lr=1e-4,
        epoch_decay_steps=10 * max(len(loader), 1))

    def state():
        return ckpt.train_state(step.brdf_nets, step.optimizer,
                                step.scheduler)

    start_epoch, skip = common.resume_train_state(
        opt, exp, "brdf", opt.cascadeLevel, step.brdf_nets, step.optimizer,
        step.scheduler, explicit_epoch=opt.resumeEpoch)

    logger = MetricLogger(f"{exp}/trainingLog.txt",
                          flush_steps=opt.logFlushSteps)
    try:
        for epoch in range(start_epoch, opt.nepoch):
            for j, np_batch in enumerate(loader):
                if opt.maxSteps is not None and j >= opt.maxSteps:
                    break
                if epoch == start_epoch and j < skip:
                    continue  # mid-epoch resume: replay position, not steps
                batch = common.stage_batch(np_batch, device)
                metrics = step(batch)
                logger.log_device(epoch, j, metrics)
                common.maybe_save_step_checkpoint(
                    opt, exp, "brdf", opt.cascadeLevel, state, epoch, j,
                    logger=logger)
                if opt.previewEvery and j % opt.previewEvery == 0:
                    preview(exp, epoch, j, step.brdf_nets, batch)
            if epoch % opt.saveEvery == 0 or epoch == opt.nepoch - 1:
                ckpt.save_checkpoint(exp, "brdf", opt.cascadeLevel, epoch,
                                     state())
                logger.save_curves(exp, epoch)
    finally:
        loader.close()
    logger.close()


if __name__ == "__main__":
    main()
