"""NYU fine-tune CLI (the trainFineTuneNYU.py equivalent).

The counterpart of the JAX package's ``cli/train_finetune_nyu.py``: each
cycle one synthetic batch (the full BRDF losses) and one NYU batch (the
normal and depth losses, weights 4.5 / 4.5), on one Adam at lr 5e-5
(trainFineTuneNYU.py:170-264).  At ``--cascadeLevel 1`` the NYU batch's
``*_pre`` maps are synthesized by the frozen cascade-0 stack on the
``render_sg_fwd`` kernel (``--noKernels``: its plain version;
``--device cpu`` needs it).

Usage: python -m inverserenderingofindoorscene_torch.cli.train_finetune_nyu \
    --dataRoot ... --nyuImRoot ... --nyuNormalRoot ... --nyuDepthRoot ... \
    --nyuSegRoot ... --brdfExperiment check_cascade0_w320_h240
"""

from __future__ import annotations

from inverserenderingofindoorscene_torch.cli import common
from inverserenderingofindoorscene_torch.data.nyu import NYUDataset
from inverserenderingofindoorscene_torch.train.steps import NYUTrainStep


def parse_args(argv=None):
    p = common.base_parser(__doc__)
    p.add_argument("--nyuImRoot")
    p.add_argument("--nyuNormalRoot")
    p.add_argument("--nyuDepthRoot")
    p.add_argument("--nyuSegRoot")
    p.add_argument("--nyuList", default="NYUTrain.txt")
    p.add_argument("--normalNYUWeight", type=float, default=4.5)
    p.add_argument("--depthNYUWeight", type=float, default=4.5)
    common.add_finetune_args(
        p, 5e-5, "reference: trainFineTuneNYU.py:100,122 "
                 "(1e-4 * lr_scale=0.5)")
    return p.parse_args(argv)


def main(argv=None):
    opt = parse_args(argv)
    ds = NYUDataset(opt.nyuImRoot, opt.nyuNormalRoot, opt.nyuDepthRoot,
                    opt.nyuSegRoot, opt.nyuList,
                    im_hw=(opt.imHeight, opt.imWidth), seed=opt.seed)
    common.run_finetune(opt, "nyu", ds, lambda syn: NYUTrainStep(
        syn.brdf_nets, normal_w=opt.normalNYUWeight,
        depth_w=opt.depthNYUWeight, device=syn.device,
        optimizer=syn.optimizer, scheduler=syn.scheduler))


if __name__ == "__main__":
    main()
