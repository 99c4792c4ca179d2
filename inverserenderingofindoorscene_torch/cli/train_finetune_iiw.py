"""IIW fine-tune CLI (the trainFineTuneIIW.py equivalent).

The counterpart of the JAX package's ``cli/train_finetune_iiw.py``: each
cycle one synthetic batch (the full BRDF losses) and one IIW batch (the
ranking losses, weight ``--rankWeight`` 2), on one Adam over the whole
BRDF stack at the reference's lr 1e-4 (trainFineTuneIIW.py:147-263).  At
``--cascadeLevel 1`` the IIW batch's ``*_pre`` maps are synthesized by
the frozen cascade-0 stack (``--brdf0Experiment`` /
``--light0Experiment``) on the ``render_sg_fwd`` kernel
(``--noKernels``: its plain version; ``--device cpu`` needs it).

Usage: python -m inverserenderingofindoorscene_torch.cli.train_finetune_iiw \
    --dataRoot ... --iiwRoot ... --brdfExperiment check_cascade0_w320_h240
"""

from __future__ import annotations

from inverserenderingofindoorscene_torch.cli import common
from inverserenderingofindoorscene_torch.data.iiw import IIWDataset
from inverserenderingofindoorscene_torch.train.steps import IIWTrainStep


def parse_args(argv=None):
    p = common.base_parser(__doc__)
    p.add_argument("--iiwRoot", help="path to the IIW data")
    p.add_argument("--iiwList", default="IIWTrain.txt")
    p.add_argument("--rankWeight", type=float, default=2.0)
    common.add_finetune_args(
        p, 1e-4, "reference: trainFineTuneIIW.py:94,115 (lr_scale=1)")
    return p.parse_args(argv)


def main(argv=None):
    opt = parse_args(argv)
    ds = IIWDataset(opt.iiwRoot, opt.iiwList,
                    im_hw=(opt.imHeight, opt.imWidth), seed=opt.seed)
    common.run_finetune(opt, "iiw", ds, lambda syn: IIWTrainStep(
        syn.brdf_nets, rank_w=opt.rankWeight, device=syn.device,
        optimizer=syn.optimizer, scheduler=syn.scheduler))


if __name__ == "__main__":
    main()
