"""Cascade hand-off exporter (the outputBRDFLight.py equivalent).

The counterpart of the JAX package's ``cli/output_brdf_light.py``: runs
the frozen cascade-k BRDF + light stack over the TRAIN or TEST split and
writes each image's seven products as ``*_{k}.h5`` files beside it,
skipping files that exist (outputBRDFLight.py:195-301), through
``pipeline/export.py``; the SG decode and the shading run on the
``sg_envmap_fwd`` and ``render_sg_fwd`` kernels (``--noKernels``: their
plain versions; a run with ``--device cpu`` needs it).  The files are
written by the port's HDF5 codec (``utils/h5.py``), h5py's bytes.

Usage: python -m inverserenderingofindoorscene_torch.cli.output_brdf_light \
    --dataRoot ... [--mode TEST]
"""

from __future__ import annotations

from inverserenderingofindoorscene_torch.cli import common
from inverserenderingofindoorscene_torch.cli.train_light import (
    load_frozen_brdf,
)
from inverserenderingofindoorscene_torch.pipeline.export import (
    export_step,
    write_products,
)
from inverserenderingofindoorscene_torch.pipeline.light import LightNets
from inverserenderingofindoorscene_torch.utils import checkpoint as ckpt
from inverserenderingofindoorscene_torch.utils.logging import MetricLogger


def parse_args(argv=None):
    p = common.base_parser(__doc__)
    p.add_argument("--mode", default="TRAIN", choices=["TRAIN", "TEST"])
    p.add_argument("--offset", type=float, default=1.0)
    p.add_argument("--brdfExperiment", default=None)
    p.add_argument("--brdfEpoch", type=int, default=None)
    p.add_argument("--lightExperiment", default=None)
    p.add_argument("--lightEpoch", type=int, default=None)
    common.add_kernel_flags(p)
    p.set_defaults(batchSize=4)
    return p.parse_args(argv)


def load_frozen_light(opt, generator, device) -> LightNets:
    """The cascade's light nets from the light stage's latest (or
    ``--lightEpoch``) checkpoint under ``--lightExperiment`` (default:
    the reference's name, with ``--trainOffset`` where the CLI has one);
    random nets, with a warning, where there is none."""
    nets = LightNets(
        sg_num=opt.SGNum, cascade_level=opt.cascadeLevel,
        env_rows=opt.envRow, env_cols=opt.envCol,
        env_height=opt.envHeight, env_width=opt.envWidth,
        generator=generator)
    naming_offset = getattr(opt, "trainOffset", None)
    if naming_offset is None:
        naming_offset = getattr(opt, "offset", 1.0)
    exp = opt.lightExperiment or common.default_experiment_name(
        opt, "light", offset=naming_offset)
    epoch = opt.lightEpoch
    if epoch is None:
        epoch = ckpt.latest_epoch(exp, "light", opt.cascadeLevel)
    if epoch is not None:
        state = ckpt.restore_checkpoint(exp, "light", opt.cascadeLevel, epoch,
                                        map_location=device)
        ckpt.load_train_state(state, nets)
        print(f"loaded frozen Light from {exp} epoch {epoch}")
    else:
        print("WARNING: no Light checkpoint found; using random frozen nets")
    return nets


def main(argv=None):
    opt = parse_args(argv)
    common.check_ported(opt)
    device = common.setup_device(opt)
    gen = common.pin_seeds(opt.seed)

    brdf_nets = load_frozen_brdf(opt, gen, device).to(device)
    light_nets = load_frozen_light(opt, gen, device).to(device)
    loader = common.make_loader(opt, opt.mode, is_light=True, shuffle=False)
    logger = MetricLogger()
    try:
        for j, np_batch in enumerate(loader):
            if opt.maxSteps is not None and j >= opt.maxSteps:
                break
            products, losses = export_step(
                brdf_nets, light_nets, common.stage_batch(np_batch, device),
                offset=opt.offset, use_kernels=opt.useKernels)
            logger.log(0, j, {k: float(v) for k, v in losses.items()})
            written = write_products(
                products, np_batch["name"], opt.cascadeLevel,
                env_ind=np_batch["env_ind"][:, 0])
            print(f"batch {j}: wrote {len(written)} files")
    finally:
        loader.close()


if __name__ == "__main__":
    main()
