"""The benchmark metrics over saved predictions (CompareWHDR /
CompareNormal / CompareDepth).

The counterpart of the JAX package's ``cli/compare.py``, on the port's
``eval/metrics.py``:
  whdr    the IIW WHDR of ``*_albedo{lvl}.npy`` against each image's
          .json judgements (CompareWHDR.py);
  normal  the mean and median angle of ``*_normal{lvl}.npy`` against the
          ground-truth PNGs (CompareNormal.py);
  depth   the scale-invariant log RMSE of ``*_depth{lvl}.npy`` against
          the ground-truth .tiff (CompareDepth.py).

Usage: python -m inverserenderingofindoorscene_torch.cli.compare whdr \
    --predRoot IIW_results --gtRoot <iiw_data> --level 1
"""

from __future__ import annotations

import argparse
import glob
import json
import os.path as osp

import numpy as np

from inverserenderingofindoorscene_torch.eval.metrics import (
    compute_whdr,
    normal_angle_error,
    si_log_depth_rmse,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("metric", choices=["whdr", "normal", "depth"])
    p.add_argument("--predRoot", required=True)
    p.add_argument("--gtRoot", required=True)
    p.add_argument("--level", type=int, default=1)
    p.add_argument("--useBS", action="store_true",
                   help="score the bilateral-refined products "
                        "(*_albedoBS / *_depthBS, the reference's own "
                        "inputs: CompareWHDR.py:72 globs albedoBS1, "
                        "CompareDepth.py:10 _depthBS1.npy)")
    return p.parse_args(argv)


def run_whdr(opt):
    total = cnt = 0.0
    stem = "albedoBS" if opt.useBS else "albedo"
    for pred in sorted(glob.glob(
            osp.join(opt.predRoot, f"*_{stem}{opt.level}.npy"))):
        name = osp.basename(pred).replace(f"_{stem}{opt.level}.npy", "")
        jpath = osp.join(opt.gtRoot, name + ".json")
        if not osp.isfile(jpath):
            continue
        refl = np.load(pred)
        with open(jpath) as f:
            res = compute_whdr(refl, json.load(f))
        if res is None:
            continue
        total += res[0]
        cnt += 1
        print(f"{name}: whdr {res[0]:.4f}  running mean {total / cnt:.4f}")
    print(f"FINAL WHDR: {total / max(cnt, 1):.4f} over {int(cnt)} images")
    return total / max(cnt, 1)


def run_normal(opt):
    import cv2

    tm = tmed = cnt = 0.0
    for pred in sorted(glob.glob(
            osp.join(opt.predRoot, f"*_normal{opt.level}.npy"))):
        name = osp.basename(pred).replace(f"_normal{opt.level}.npy", "")
        gt_path = osp.join(opt.gtRoot, name + ".png")
        mask_path = osp.join(opt.gtRoot, name + "_mask.png")
        if not osp.isfile(gt_path):
            continue
        normal = np.load(pred)
        gt = cv2.imread(gt_path)[:, :, ::-1].astype(np.float32)
        gt = (gt - 127.5) / 127.5
        if osp.isfile(mask_path):
            mask = (np.min(cv2.imread(mask_path), axis=2) == 255).astype(
                np.float32)
        else:
            mask = np.ones(gt.shape[:2], np.float32)
        if normal.shape[:2] != gt.shape[:2]:
            normal = cv2.resize(normal, (gt.shape[1], gt.shape[0]),
                                interpolation=cv2.INTER_LINEAR)
        mean, med = normal_angle_error(normal, gt, mask)
        tm += mean
        tmed += med
        cnt += 1
        print(f"{name}: mean {mean:.3f} median {med:.3f}")
    print(f"FINAL normal: mean {tm / max(cnt, 1):.3f} "
          f"median {tmed / max(cnt, 1):.3f} over {int(cnt)} images")
    return tm / max(cnt, 1)


def run_depth(opt):
    import cv2

    total = cnt = 0.0
    stem = "depthBS" if opt.useBS else "depth"
    for pred in sorted(glob.glob(
            osp.join(opt.predRoot, f"*_{stem}{opt.level}.npy"))):
        name = osp.basename(pred).replace(f"_{stem}{opt.level}.npy", "")
        gt_path = osp.join(opt.gtRoot, name + ".tiff")
        if not osp.isfile(gt_path):
            continue
        depth = np.load(pred)
        if depth.ndim == 3:
            depth = depth[:, :, 0]
        gt = cv2.imread(gt_path, -1).astype(np.float64)
        depth = cv2.resize(depth, (gt.shape[1], gt.shape[0]),
                           interpolation=cv2.INTER_LINEAR)
        err = si_log_depth_rmse(depth, gt)
        total += err
        cnt += 1
        print(f"{name}: si-log-rmse {err:.4f}  running {total / cnt:.4f}")
    print(f"FINAL depth si-log-RMSE: {total / max(cnt, 1):.4f} "
          f"over {int(cnt)} images")
    return total / max(cnt, 1)


def main(argv=None):
    opt = parse_args(argv)
    return {"whdr": run_whdr, "normal": run_normal,
            "depth": run_depth}[opt.metric](opt)


if __name__ == "__main__":
    main()
