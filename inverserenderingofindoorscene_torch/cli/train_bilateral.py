"""Bilateral refinement training CLI (the trainBRDFBilateral.py
equivalent).

The counterpart of the JAX package's ``cli/train_bilateral.py``: frozen
BRDF nets from the BRDF stage's checkpoint; Adam on the three confidence
nets through the bilateral solver, loss ``4*1.5*albedoBs + 0.5*roughBs
+ 0.5*depthBs`` (trainBRDFBilateral.py:98-149, 345-352).  The grid blur
runs on the ``bilateral_blur`` kernel (``--noKernels``: its plain
version; a run with ``--device cpu`` needs it).  The port's grids have
exactly one vertex an occupied cell, so ``--vMax`` takes only ``full``
and ``auto``, which both mean that exact solve.

Usage: python -m inverserenderingofindoorscene_torch.cli.train_bilateral \
    --dataRoot ... --brdfExperiment check_cascade0_w320_h240
"""

from __future__ import annotations

from inverserenderingofindoorscene_torch.cli import common
from inverserenderingofindoorscene_torch.cli.train_light import (
    load_frozen_brdf,
)
from inverserenderingofindoorscene_torch.pipeline.bilateral import (
    BilateralNets,
)
from inverserenderingofindoorscene_torch.train.steps import (
    BilateralTrainStep,
)
from inverserenderingofindoorscene_torch.utils import checkpoint as ckpt
from inverserenderingofindoorscene_torch.utils.logging import MetricLogger


def parse_args(argv=None):
    p = common.base_parser(__doc__)
    p.add_argument("--albedoWeight", type=float, default=1.5)
    p.add_argument("--roughWeight", type=float, default=0.5)
    p.add_argument("--depthWeight", type=float, default=0.5)
    p.add_argument("--brdfExperiment", default=None)
    p.add_argument("--brdfEpoch", type=int, default=None)
    p.add_argument("--resumeEpoch", type=int, default=None)
    p.add_argument("--vMax", default="full",
                   help="solver vertex capacity: 'full' or 'auto', both "
                        "the exact grid here; an integer cap is not "
                        "ported")
    common.add_kernel_flags(p)
    p.set_defaults(batchSize=2, nepoch=1)
    return p.parse_args(argv)


def main(argv=None):
    opt = parse_args(argv)
    common.check_ported(opt)
    device = common.setup_device(opt)
    exp = common.experiment_dir(opt, "bs")
    gen = common.pin_seeds(opt.seed)

    brdf_nets = load_frozen_brdf(opt, gen, device)
    bs_nets = BilateralNets(generator=gen)
    loader = common.make_loader(opt, "TRAIN", is_light=False)
    step = BilateralTrainStep(
        brdf_nets, bs_nets, albedo_w=opt.albedoWeight,
        rough_w=opt.roughWeight, depth_w=opt.depthWeight,
        use_kernels=opt.useKernels, device=device)

    def state():
        return ckpt.train_state(step.bs_nets, step.optimizer, step.scheduler)

    start_epoch, skip = common.resume_train_state(
        opt, exp, "bs", opt.cascadeLevel, step.bs_nets, step.optimizer,
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
                metrics = step(common.stage_batch(np_batch, device))
                logger.log_device(epoch, j, metrics)
                common.maybe_save_step_checkpoint(
                    opt, exp, "bs", opt.cascadeLevel, state, epoch, j,
                    logger=logger)
            ckpt.save_checkpoint(exp, "bs", opt.cascadeLevel, epoch, state())
            logger.save_curves(exp, epoch)
    finally:
        loader.close()
    logger.close()


if __name__ == "__main__":
    main()
