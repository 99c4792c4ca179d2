"""Lighting training CLI (the trainLight.py equivalent).

The counterpart of the JAX package's ``cli/train_light.py``: loads the
frozen cascade-k BRDF nets from the BRDF stage's checkpoint and trains the
light encoder and its three SG decoders, loss ``10*reconst + 1*render``,
through the hand-written CUDA kernels of the SG decode and the shading
(trainLight.py:99-244).  ``--noKernels`` takes their plain PyTorch
versions instead; a run with ``--device cpu`` needs it.  The light nets
compute in ``--computeDtype`` (bfloat16 by default, as in the JAX CLI);
the frozen BRDF nets in float32, as there.

Usage: python -m inverserenderingofindoorscene_torch.cli.train_light \
    --dataRoot ... --brdfExperiment check_cascade0_w320_h240 --brdfEpoch 13
"""

from __future__ import annotations

from inverserenderingofindoorscene_torch.cli import common
from inverserenderingofindoorscene_torch.pipeline.brdf import BRDFNets
from inverserenderingofindoorscene_torch.pipeline.light import LightNets
from inverserenderingofindoorscene_torch.train.steps import LightTrainStep
from inverserenderingofindoorscene_torch.utils import checkpoint as ckpt
from inverserenderingofindoorscene_torch.utils.logging import MetricLogger


def parse_args(argv=None):
    p = common.base_parser(__doc__)
    p.add_argument("--reconstWeight", type=float, default=10.0)
    p.add_argument("--renderWeight", type=float, default=1.0)
    p.add_argument("--offset", type=float, default=1.0)
    p.add_argument("--lr", type=float, default=1e-4,
                   help="reference: trainLight.py:28 (1e-4)")
    p.add_argument("--brdfExperiment", required=False, default=None)
    p.add_argument("--brdfEpoch", type=int, default=None)
    p.add_argument("--resumeEpoch", type=int, default=None)
    common.add_dtype_flag(p, "bfloat16")
    common.add_kernel_flags(p)
    p.set_defaults(batchSize=5)
    return p.parse_args(argv)


def load_frozen_brdf(opt, generator, device) -> BRDFNets:
    """The cascade's BRDF nets from the BRDF stage's latest (or
    ``--brdfEpoch``) checkpoint under ``--brdfExperiment`` (default: the
    reference's name); random nets, with a warning, where there is
    none."""
    nets = BRDFNets(cascade_level=opt.cascadeLevel, generator=generator)
    exp = opt.brdfExperiment or common.default_experiment_name(opt, "brdf")
    epoch = opt.brdfEpoch
    if epoch is None:
        epoch = ckpt.latest_epoch(exp, "brdf", opt.cascadeLevel)
    if epoch is not None:
        state = ckpt.restore_checkpoint(exp, "brdf", opt.cascadeLevel, epoch,
                                        map_location=device)
        ckpt.load_train_state(state, nets)
        print(f"loaded frozen BRDF from {exp} epoch {epoch}")
    else:
        print("WARNING: no BRDF checkpoint found; using random frozen nets")
    return nets


def main(argv=None):
    opt = parse_args(argv)
    common.check_ported(opt)
    device = common.setup_device(opt)
    exp = common.experiment_dir(opt, "light")
    gen = common.pin_seeds(opt.seed)

    brdf_nets = load_frozen_brdf(opt, gen, device)
    light_nets = LightNets(
        sg_num=opt.SGNum,
        cascade_level=opt.cascadeLevel,
        env_rows=opt.envRow,
        env_cols=opt.envCol,
        env_height=opt.envHeight,
        env_width=opt.envWidth,
        generator=gen,
        compute_dtype=opt.computeDtype,
    )
    loader = common.make_loader(opt, "TRAIN", is_light=True)
    step = LightTrainStep(
        brdf_nets, light_nets, reconst_w=opt.reconstWeight,
        render_w=opt.renderWeight, offset=opt.offset,
        use_kernels=opt.useKernels, device=device, lr=opt.lr,
        epoch_decay_steps=10 * max(len(loader), 1))

    def state():
        return ckpt.train_state(step.light_nets, step.optimizer,
                                step.scheduler)

    start_epoch, skip = common.resume_train_state(
        opt, exp, "light", opt.cascadeLevel, step.light_nets, step.optimizer,
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
                    opt, exp, "light", opt.cascadeLevel, state, epoch, j,
                    logger=logger)
            if epoch % opt.saveEvery == 0 or epoch == opt.nepoch - 1:
                ckpt.save_checkpoint(exp, "light", opt.cascadeLevel, epoch,
                                     state())
                logger.save_curves(exp, epoch)
    finally:
        loader.close()
    logger.close()


if __name__ == "__main__":
    main()
