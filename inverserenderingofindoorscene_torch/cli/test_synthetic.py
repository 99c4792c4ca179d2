"""Held-out-split evaluation CLI (testBRDF / testLight /
testBRDFBilateral).

The counterpart of the JAX package's ``cli/test_synthetic.py``: the
masked errors over the TEST split, and the reference test drivers'
files (testBRDF.py, testLight.py, testBRDFBilateral.py):

  * ``testingLog_{epoch}.txt``: each batch's error lines and the running
    means, in the reference's ``[epoch/j] name:v .`` format
    (testBRDF.py:128,257-278, utils.writeErrToFile);
  * ``{key}Error_{epoch}.npy``: a row of errors a batch
    (testBRDF.py:313-316); at the bilateral stage each row is the pair
    [raw, refined] (testBRDFBilateral.py:179-183);
  * each batch's prediction / ground-truth image grids and envmap mosaic
    (testBRDF.py:282-310, testLight.py:293-309), every ``--imageEvery``.

The light stage runs ``light_step`` forward on the ``sg_envmap_fwd`` and
``render_sg_fwd`` kernels, the bilateral stage the refinement on the
``bilateral_blur`` kernel (``--noKernels``: their plain versions;
``--device cpu`` needs it).  The envmap's log offset is 1e-3 here
(testLight.py:222).

Usage: python -m inverserenderingofindoorscene_torch.cli.test_synthetic \
    --stage light --dataRoot ...
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np
import torch

from inverserenderingofindoorscene_torch.cli import common
from inverserenderingofindoorscene_torch.cli.output_brdf_light import (
    load_frozen_light,
)
from inverserenderingofindoorscene_torch.cli.train_light import (
    load_frozen_brdf,
)
from inverserenderingofindoorscene_torch.pipeline.bilateral import (
    BilateralNets,
    bilateral_step,
)
from inverserenderingofindoorscene_torch.pipeline.brdf import brdf_step
from inverserenderingofindoorscene_torch.pipeline.light import light_step
from inverserenderingofindoorscene_torch.utils import checkpoint as ckpt


def parse_args(argv=None):
    p = common.base_parser(__doc__)
    p.add_argument("--stage", default="brdf",
                   choices=["brdf", "light", "bilateral"])
    p.add_argument("--offset", type=float, default=1e-3,
                   help="envmap log offset at eval (testLight.py:222)")
    p.add_argument("--trainOffset", type=float, default=1.0,
                   help="the offset the light stage was trained with; "
                        "names its checkpoint directory only")
    p.add_argument("--brdfExperiment", default=None)
    p.add_argument("--brdfEpoch", type=int, default=None)
    p.add_argument("--lightExperiment", default=None)
    p.add_argument("--lightEpoch", type=int, default=None)
    p.add_argument("--bsExperiment", default=None)
    p.add_argument("--bsEpoch", type=int, default=None)
    p.add_argument("--testRoot", default=None,
                   help="output dir (default test_<stage>_cascade<L>)")
    p.add_argument("--imageEvery", type=int, default=1,
                   help="dump image grids every N batches; 0 disables")
    common.add_kernel_flags(p)
    p.set_defaults(batchSize=4)
    return p.parse_args(argv)


def _depth_viz(d):
    """The reference's depth image: 1/clamp(d+1, 1e-6, 10)
    (testBRDF.py:288,299)."""
    return 1.0 / np.clip(np.asarray(d) + 1.0, 1e-6, 10.0)


class _ErrLog:
    """The testing log and a row of errors a batch (testBRDF.py:
    126-316)."""

    def __init__(self, test_root, epoch):
        self.epoch = epoch
        self.rows = {}
        self.fh = open(osp.join(test_root, f"testingLog_{epoch}.txt"), "w")

    def _fmt(self, name, vals, j):
        return f"[{self.epoch}/{j}] {name}:" + "".join(
            f"{v:.6f} " for v in np.atleast_1d(vals)) + "."

    def record(self, j, errors: dict):
        """errors: name -> a scalar, or a [raw, bs] pair (the bilateral
        stage)."""
        for name, v in errors.items():
            row = np.atleast_1d(np.asarray(v, np.float32))
            self.rows.setdefault(name, []).append(row)
            line = self._fmt(name, row, j)
            print(line)
            self.fh.write(line + "\n")
        for name in errors:
            acc = np.mean(np.stack(self.rows[name]), axis=0)
            line = self._fmt(name + "Accu", acc, j)
            print(line)
            self.fh.write(line + "\n")

    def save(self, test_root):
        self.fh.close()
        for name, rows in self.rows.items():
            np.save(osp.join(test_root, f"{name}Error_{self.epoch}.npy"),
                    np.stack(rows))

    def means(self):
        """Each key's mean over the batches; a [raw, refined] record (the
        bilateral stage) gives ``{name}_raw`` and ``{name}_bs``."""
        out = {}
        for k, v in self.rows.items():
            acc = np.mean(np.stack(v), axis=0)
            if acc.size == 2:
                out[f"{k}_raw"] = float(acc[0])
                out[f"{k}_bs"] = float(acc[1])
            else:
                out[k] = float(np.mean(acc))
        return out


def _latest(opt, exp, kind, stage, **kw):
    exp = exp or common.default_experiment_name(opt, kind, **kw)
    return ckpt.latest_epoch(exp, stage, opt.cascadeLevel)


def main(argv=None):
    opt = parse_args(argv)
    common.check_ported(opt)
    device = common.setup_device(opt)
    gen = common.pin_seeds(opt.seed)
    brdf_nets = load_frozen_brdf(opt, gen, device).to(device).eval()

    test_root = opt.testRoot or f"test_{opt.stage}_cascade{opt.cascadeLevel}"
    os.makedirs(test_root, exist_ok=True)

    if opt.stage == "brdf":
        epoch = opt.brdfEpoch
        if epoch is None:
            epoch = _latest(opt, opt.brdfExperiment, "brdf", "brdf")

        def run(b):
            preds, errors = brdf_step(brdf_nets, b)
            return errors, preds
        is_light = False
    elif opt.stage == "light":
        light_nets = load_frozen_light(opt, gen, device).to(device).eval()
        epoch = opt.lightEpoch
        if epoch is None:
            epoch = _latest(opt, opt.lightExperiment, "light", "light",
                            offset=opt.trainOffset)

        def run(b):
            losses, aux = light_step(brdf_nets, light_nets, b,
                                     offset=opt.offset,
                                     use_kernels=opt.useKernels)
            return losses, {"env_scaled": aux["env_scaled"],
                            "rendered": aux["rendered"]}
        is_light = True
    else:
        bs_nets = BilateralNets(generator=gen)
        exp = opt.bsExperiment or common.default_experiment_name(opt, "bs")
        epoch = opt.bsEpoch
        if epoch is None:
            epoch = ckpt.latest_epoch(exp, "bs", opt.cascadeLevel)
        if epoch is not None:
            ckpt.load_train_state(ckpt.restore_checkpoint(
                exp, "bs", opt.cascadeLevel, epoch, map_location=device),
                bs_nets)
        bs_nets.to(device).eval()

        def run(b):
            losses, aux = bilateral_step(brdf_nets, bs_nets, b,
                                         use_kernels=opt.useKernels)
            return losses, {"raw": aux["preds"], "bs": aux["refined"]}
        is_light = False

    loader = common.make_loader(opt, "TEST", is_light=is_light,
                                shuffle=False)
    epoch = epoch if epoch is not None else 0
    elog = _ErrLog(test_root, epoch)
    try:
        for j, np_batch in enumerate(loader):
            if opt.maxSteps is not None and j >= opt.maxSteps:
                break
            batch = common.stage_batch(np_batch, device)
            with torch.no_grad():
                losses, extras = run(batch)
            losses = {k: float(v) for k, v in losses.items()}
            if opt.stage == "bilateral":
                # [raw, refined] rows (testBRDFBilateral.py:179-183)
                rec = {k: np.array([losses[f"{k}_raw"], losses[f"{k}_bs"]])
                       for k in ("albedo", "rough", "depth")}
                rec["normal"] = losses["normal_raw"]
            else:
                rec = losses
            elog.record(j, rec)
            if opt.imageEvery and j % opt.imageEvery == 0:
                _dump_images(opt, test_root, j, batch, extras)
    finally:
        loader.close()
    elog.save(test_root)
    means = elog.means()
    print("FINAL " + " ".join(f"{k}={v:.6f}"
                              for k, v in sorted(means.items())))
    return means


def _dump_images(opt, test_root, j, batch, extras):
    """A batch's prediction and ground-truth grids (testBRDF.py:282-310,
    testLight.py:293-309)."""
    from inverserenderingofindoorscene_torch.utils.io import (
        write_envmap_mosaic,
        write_image_grid,
    )

    def host(x):
        return x.detach().cpu().numpy() if torch.is_tensor(x) else x

    def grid(name, arr, gamma=False):
        write_image_grid(host(arr), osp.join(test_root, f"{j}_{name}.png"),
                         gamma=gamma)

    grid("im", batch["im"], gamma=True)
    if opt.stage in ("brdf", "bilateral"):
        tagged = ([("Pred", extras)] if opt.stage == "brdf"
                  else [("Pred", extras["raw"]), ("Bs", extras["bs"])])
        grid("albedoGt_0", batch["albedo"], gamma=True)
        grid("normalGt_0", 0.5 * (host(batch["normal"]) + 1.0))
        grid("roughGt_0", 0.5 * (host(batch["rough"]) + 1.0))
        grid("depthGt_0", _depth_viz(host(batch["depth"])))
        for tag, preds in tagged:
            grid(f"albedo{tag}_0", preds["albedo"], gamma=True)
            grid(f"normal{tag}_0", 0.5 * (host(preds["normal"]) + 1.0))
            grid(f"rough{tag}_0", 0.5 * (host(preds["rough"]) + 1.0))
            grid(f"depth{tag}_0", _depth_viz(host(preds["depth"])))
    else:
        grid("imRendered", extras["rendered"], gamma=True)
        env = host(extras["env_scaled"])  # [B,R,C,D,3]
        write_envmap_mosaic(
            env[0].reshape(env.shape[1], env.shape[2], opt.envHeight,
                           opt.envWidth, 3),
            osp.join(test_root, f"{j}_envmapPred.png"),
            env_height=opt.envHeight, env_width=opt.envWidth)


if __name__ == "__main__":
    main()
