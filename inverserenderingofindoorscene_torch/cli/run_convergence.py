"""From-scratch staged convergence runs on the procedural fixture.

The counterpart of the JAX package's ``scripts/run_convergence.py``.
Drives the port's training CLIs end to end, chained like the reference's
staged recipe (trainBRDF.py:145-396 -> trainLight.py:215-244 ->
trainBRDFBilateral.py:264-342): write the fixture (``data/fixture.py``),
train each stage from scratch at a reduced operating point, and compare
held-out TEST-split metrics against the UNTRAINED initialization (same
seed => the init checkpoint holds the run's exact step-0 nets).

Records, per stage: the train-loss curve (first/last rolling means and
their ratio), init-vs-trained test metrics and wall times, into
``<out>/summary.json`` (the schema and stage keys of the JAX package's
``docs/convergence_r5.json``) and a markdown table on stdout.  Beside the
JAX record's ``config``: ``device`` (the card's name and power limit as
``nvidia-smi`` gives them, or ``cpu``), ``torch`` (its version), and a
``not_run`` map of every stage of the full recipe this run did not
record, with the reason.  The cascade-1 legs read and write the
hand-off's ``.h5`` files through the port's own HDF5 codec
(``utils/h5.py``), so they run wherever the rest does.

Usage:
  python -m inverserenderingofindoorscene_torch.cli.run_convergence \\
      --out runs/conv [--imHeight 120 --imWidth 160 --envRow 60 \\
      --envCol 80] [--brdfEpochs 60] [--lightEpochs 20] [--bsEpochs 5] \\
      [--device cpu] [--gate]

``--gate`` holds the recorded legs to the JAX package's learning gate
(:func:`gate`).
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import os.path as osp
import re
import subprocess
import time
from types import SimpleNamespace

import numpy as np
import torch

# every stage of the full recipe, in the order the JAX record holds them
STAGES = ("brdf", "light", "bilateral", "brdf1", "light1", "light_b20",
          "bilateral_mid", "finetune_nyu", "finetune_iiw", "finetune_nyu1",
          "finetune_iiw1", "capstone")


def log(m):
    print(m, flush=True)


def curve_stats(exp, key="total"):
    """Loss history from the newest {key}Error_{epoch}.npy the CLI wrote."""
    files = glob.glob(osp.join(exp, f"{key}Error_*.npy"))
    if not files:
        return None
    newest = max(files, key=lambda f: int(f.rsplit("_", 1)[1][:-4]))
    h = np.load(newest).ravel()
    k = max(1, min(20, len(h) // 10))
    return {
        "steps": int(len(h)),
        "first": float(h[:k].mean()),
        "last": float(h[-k:].mean()),
        "ratio": float(h[:k].mean() / max(h[-k:].mean(), 1e-12)),
    }


def _improvement(init, trained):
    return {k: round(init[k] / max(trained[k], 1e-12), 2) for k in init}


def _brdf_forward_fn(opt, exp, exp_dir, stage, cascade):
    """im -> preds forward (NHWC numpy in, NHWC tensors out) of the
    checkpointed BRDF at either cascade, in float32 as the JAX harness
    evaluates.  At cascade 1 the TRAINED cascade-0 BRDF and light stacks
    (exp['brdf'], exp['light']) synthesize the ``*_pre`` inputs inline,
    the flow of the cascade-1 fine-tune CLIs
    (trainFineTuneIIW_cascade1.py:300-362)."""
    from inverserenderingofindoorscene_torch.cli import common as cli_common
    from inverserenderingofindoorscene_torch.pipeline.brdf import (
        BRDFNets,
        brdf_forward,
    )
    from inverserenderingofindoorscene_torch.pipeline.finetune import (
        synthesize_pre,
    )
    from inverserenderingofindoorscene_torch.utils import checkpoint as ckpt

    device = torch.device(opt.device)
    nets = BRDFNets(cascade_level=cascade)
    epoch = ckpt.latest_epoch(exp_dir, stage, cascade)
    if epoch is None:
        raise FileNotFoundError(f"no {stage} checkpoint at cascade "
                                f"{cascade} under {exp_dir}")
    ckpt.load_train_state(ckpt.restore_checkpoint(
        exp_dir, stage, cascade, epoch, map_location=device), nets)
    nets.to(device).eval()
    synth = None
    if cascade == 1:
        ns = SimpleNamespace(
            cascadeLevel=1, imHeight=opt.imHeight, imWidth=opt.imWidth,
            envRow=opt.envRow, envCol=opt.envCol, envHeight=8, envWidth=16,
            SGNum=12, seed=0, brdfExperiment=None, brdfEpoch=None,
            brdf0Experiment=exp["brdf"], brdf0Epoch=None,
            light0Experiment=exp["light"], light0Epoch=None,
        )
        bn0, ln0 = cli_common.load_frozen_cascade0(
            ns, torch.Generator().manual_seed(7), device)
        bn0.to(device).eval()
        ln0.to(device).eval()

        def synth(b):
            return synthesize_pre(bn0, ln0, b,
                                  use_kernels=device.type == "cuda")

    def fwd(batch):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        with torch.no_grad():
            if synth is not None:
                batch = synth(batch)
            return brdf_forward(nets, batch)

    return fwd


def _np(x):
    return x.detach().cpu().numpy().astype(np.float64)


def _finetune_c1_args(exp):
    return ["--cascadeLevel", "1", "--brdfExperiment", exp["brdf1"],
            "--brdf0Experiment", exp["brdf"],
            "--light0Experiment", exp["light"]]


def _finetune_nyu_leg(opt, args, exp, prior, summary, cascade=0):
    """Fine-tune on the NYU fixture from the cascade-``cascade`` BRDF and
    compare held-out geometry metrics before/after (trainFineTuneNYU.py /
    trainFineTuneNYU_cascade1.py:311-374 flows; eval = CompareNormal.py /
    CompareDepth.py metrics over the TEST list)."""
    from inverserenderingofindoorscene_torch.cli import train_finetune_nyu
    from inverserenderingofindoorscene_torch.data.fixture import (
        write_nyu_fixture,
    )
    from inverserenderingofindoorscene_torch.data.nyu import NYUDataset
    from inverserenderingofindoorscene_torch.eval.metrics import (
        normal_angle_error,
        si_log_depth_rmse,
    )

    leg = "finetune_nyu1" if cascade else "finetune_nyu"
    if leg in prior:
        log(f"[{leg}] already recorded; skipping (resume)")
        summary["stages"][leg] = prior[leg]
        return

    nyu_root = osp.join(opt.out, "nyu_fixture")
    # 4*(H, W) keeps the photos at the network aspect (the NYU-native
    # 480x640 at the 120x160 operating point)
    write_nyu_fixture(nyu_root,
                      frame_hw=(4 * opt.imHeight, 4 * opt.imWidth))
    nyu_args = [
        "--nyuImRoot", osp.join(nyu_root, "images"),
        "--nyuNormalRoot", osp.join(nyu_root, "normals"),
        "--nyuDepthRoot", osp.join(nyu_root, "depths"),
        "--nyuSegRoot", osp.join(nyu_root, "segs"),
        "--nyuList", osp.join(nyu_root, "NYUTrain.txt"),
    ]
    nyu_args += (_finetune_c1_args(exp) if cascade
                 else ["--brdfExperiment", exp["brdf"]])

    def eval_geometry(exp_dir, stage):
        fwd = _brdf_forward_fn(opt, exp, exp_dir, stage, cascade)
        ds = NYUDataset(
            osp.join(nyu_root, "images"), osp.join(nyu_root, "normals"),
            osp.join(nyu_root, "depths"), osp.join(nyu_root, "segs"),
            osp.join(nyu_root, "NYUTest.txt"),
            im_hw=(opt.imHeight, opt.imWidth), phase="TEST",
        )
        angs, rmses = [], []
        for i in range(len(ds)):
            item = ds[i]
            preds = fwd({"im": np.asarray(item["im"])[None]})
            mean_deg, _ = normal_angle_error(
                _np(preds["normal"][0]), item["normal"],
                item["seg_normal"][:, :, 0])
            angs.append(mean_deg)
            rmses.append(si_log_depth_rmse(_np(preds["depth"][0, :, :, 0]),
                                           item["depth"][:, :, 0]))
        return {"normal_mean_deg": float(np.mean(angs)),
                "si_log_depth_rmse": float(np.mean(rmses))}

    init_dir = exp["brdf1"] if cascade else exp["brdf"]
    rec = {"init_test": eval_geometry(init_dir, "brdf")}
    t1 = time.time()
    nyu_exp = osp.join(opt.out, f"{leg}_main")
    train_finetune_nyu.main(
        args(["--experiment", nyu_exp] + nyu_args, opt.nyuBatch,
             opt.nyuEpochs))
    rec["train_s"] = round(time.time() - t1, 1)
    rec["loss"] = curve_stats(nyu_exp, key="nyu_total")
    rec["trained_test"] = eval_geometry(nyu_exp, "nyu")
    rec["test_improvement"] = _improvement(rec["init_test"],
                                           rec["trained_test"])
    summary["stages"][leg] = rec
    log(f"[{leg}] loss {rec['loss']} | init {rec['init_test']} | "
        f"trained {rec['trained_test']} | x-better {rec['test_improvement']}"
        f" | {rec['train_s']}s")


def _eval_whdr(opt, exp, iiw_root, exp_dir, stage, cascade):
    """Held-out WHDR (CompareWHDR.py:8-66, delta=0.1) of the checkpointed
    BRDF over the IIW fixture TEST list; ``brdf_forward``'s albedo is
    already in [0, 1], the reflectance."""
    from PIL import Image

    from inverserenderingofindoorscene_torch.eval.metrics import compute_whdr

    fwd = _brdf_forward_fn(opt, exp, exp_dir, stage, cascade)
    with open(osp.join(iiw_root, "IIWTest.txt")) as f:
        names = [x.strip() for x in f if x.strip()]
    whdrs = []
    for name in names:
        im = Image.open(osp.join(iiw_root, name)).resize(
            [opt.imWidth, opt.imHeight], Image.LANCZOS)
        im = (np.asarray(im, np.float32) / 255.0) ** 2.2
        im = im / im.max()  # the loader's normalization (iiw.py)
        preds = fwd({"im": im[None]})
        with open(osp.join(iiw_root, name.replace(".png", ".json"))) as f:
            res = compute_whdr(_np(preds["albedo"][0]), json.load(f))
        whdrs.append(res[0])
    return {"whdr": float(np.mean(whdrs))}


def _finetune_iiw_leg(opt, args, exp, prior, summary, cascade=0):
    """Fine-tune on the IIW fixture from the cascade-``cascade`` BRDF
    (alternating synthetic / IIW ranking-loss batches,
    trainFineTuneIIW.py:147-263 / trainFineTuneIIW_cascade1.py:300-362)
    and compare held-out WHDR over the TEST list before/after."""
    from inverserenderingofindoorscene_torch.cli import train_finetune_iiw
    from inverserenderingofindoorscene_torch.data.fixture import (
        write_iiw_fixture,
    )

    leg = "finetune_iiw1" if cascade else "finetune_iiw"
    if leg in prior:
        log(f"[{leg}] already recorded; skipping (resume)")
        summary["stages"][leg] = prior[leg]
        return

    iiw_root = osp.join(opt.out, "iiw_fixture")
    # 4*(H, W) keeps the network's aspect: the loader's aspect-preserving
    # resize then needs no crop, so judgement coordinates survive exactly
    write_iiw_fixture(iiw_root, frame_hw=(4 * opt.imHeight, 4 * opt.imWidth))
    iiw_args = ["--iiwRoot", iiw_root,
                "--iiwList", osp.join(iiw_root, "IIWTrain.txt")]
    iiw_args += (_finetune_c1_args(exp) if cascade
                 else ["--brdfExperiment", exp["brdf"]])

    init_dir = exp["brdf1"] if cascade else exp["brdf"]
    rec = {"init_test": _eval_whdr(opt, exp, iiw_root, init_dir, "brdf",
                                   cascade)}
    t1 = time.time()
    iiw_exp = osp.join(opt.out, f"{leg}_main")
    train_finetune_iiw.main(
        args(["--experiment", iiw_exp] + iiw_args, opt.iiwBatch,
             opt.iiwEpochs))
    rec["train_s"] = round(time.time() - t1, 1)
    rec["loss"] = curve_stats(iiw_exp, key="iiw_total")
    rec["trained_test"] = _eval_whdr(opt, exp, iiw_root, iiw_exp, "iiw",
                                     cascade)
    rec["test_improvement"] = _improvement(rec["init_test"],
                                           rec["trained_test"])
    summary["stages"][leg] = rec
    log(f"[{leg}] loss {rec['loss']} | init {rec['init_test']} | "
        f"trained {rec['trained_test']} | x-better {rec['test_improvement']}"
        f" | {rec['train_s']}s")


def _capstone_leg(opt, exp, prior, summary):
    """The trained-weights product capstone: the TRAINED checkpoints
    through the whole serving chain, ``test_real`` over held-out fixture
    photos (both cascades where cascade 1 trained, lighting and the
    bilateral refinement; the runReal20.sh / testReal.py:356-540 flow),
    then the ``compare`` CLI on the written products
    (CompareWHDR.py:70-112, CompareNormal.py, CompareDepth.py), trained
    against the products of the same chain over the step-0 init
    checkpoints."""
    from inverserenderingofindoorscene_torch.cli import compare, test_real
    from inverserenderingofindoorscene_torch.data.fixture import (
        write_iiw_fixture,
        write_nyu_fixture,
    )

    if "capstone" in prior:
        log("[capstone] already recorded; skipping (resume)")
        summary["stages"]["capstone"] = prior["capstone"]
        return

    iiw_root = osp.join(opt.out, "iiw_fixture")
    write_iiw_fixture(iiw_root, frame_hw=(4 * opt.imHeight, 4 * opt.imWidth))
    nyu_root = osp.join(opt.out, "nyu_fixture")
    write_nyu_fixture(nyu_root,
                      frame_hw=(4 * opt.imHeight, 4 * opt.imWidth))

    level = 2 if "brdf1" in exp else 1
    lvl = level - 1  # products carry 0-based level suffixes

    # a missing stage checkpoint is an error: test_real's loaders would
    # take random frozen nets with a warning, and the capstone would
    # record an untrained stack's products
    need = ["brdf", "light", "bilateral"] + (
        ["brdf1", "light1"] if level == 2 else [])
    for s in need:
        for suffix in ("init", "main"):
            d = osp.join(opt.out, f"{s}_{suffix}")
            if not osp.isdir(d):
                raise FileNotFoundError(
                    f"capstone needs the {s} stage's {suffix} checkpoints; "
                    f"{d} missing: run the recipe with its stages enabled")

    # held-out photos: IIW TEST pngs (WHDR judgements) and NYU TEST
    # frames (normal / depth ground truth)
    paths = []
    with open(osp.join(iiw_root, "IIWTest.txt")) as f:
        paths += [osp.join(iiw_root, x.strip()) for x in f if x.strip()]
    with open(osp.join(nyu_root, "NYUTest.txt")) as f:
        paths += [osp.join(nyu_root, "images", x.strip())
                  for x in f if x.strip()]
    lst = osp.join(opt.out, "capstone_imlist.txt")
    with open(lst, "w") as f:
        f.write("\n".join(paths) + "\n")

    def serve(tag, suffix):
        outdir = osp.join(opt.out, f"capstone_{tag}")
        argv = [
            "--imList", lst, "--output", outdir,
            "--level", str(level), "--isLight", "--isBS",
            "--imHeight", str(opt.imHeight), "--imWidth", str(opt.imWidth),
            "--envRow", str(opt.envRow), "--envCol", str(opt.envCol),
            "--experimentBRDF0", osp.join(opt.out, f"brdf_{suffix}"),
            "--experimentLight0", osp.join(opt.out, f"light_{suffix}"),
            "--bsExperiment", osp.join(opt.out, f"bilateral_{suffix}"),
            "--device", opt.device,
        ] + _no_kernels(opt)
        if level == 2:
            argv += [
                "--experimentBRDF1", osp.join(opt.out, f"brdf1_{suffix}"),
                "--experimentLight1", osp.join(opt.out, f"light1_{suffix}"),
            ]
        test_real.main(argv)
        # the reference scores the refined albedo / depth products and the
        # raw normal (CompareWHDR.py:72, CompareDepth.py:10)
        return {
            "whdr": float(compare.main([
                "whdr", "--predRoot", outdir, "--gtRoot", iiw_root,
                "--level", str(lvl), "--useBS"])),
            "normal_mean_deg": float(compare.main([
                "normal", "--predRoot", outdir,
                "--gtRoot", osp.join(nyu_root, "normals"),
                "--level", str(lvl)])),
            "si_log_depth_rmse": float(compare.main([
                "depth", "--predRoot", outdir,
                "--gtRoot", osp.join(nyu_root, "depths"),
                "--level", str(lvl), "--useBS"])),
        }

    t1 = time.time()
    rec = {"level": level,
           "init_products": serve("init", "init"),
           "trained_products": serve("trained", "main")}
    rec["serve_s"] = round(time.time() - t1, 1)
    rec["product_improvement"] = _improvement(rec["init_products"],
                                              rec["trained_products"])
    summary["stages"]["capstone"] = rec
    log(f"[capstone] init {rec['init_products']} | trained "
        f"{rec['trained_products']} | x-better {rec['product_improvement']}"
        f" | {rec['serve_s']}s")


def _no_kernels(opt):
    """The CLIs that reach a kernel need ``--noKernels`` off the card."""
    return ["--noKernels"] if opt.device == "cpu" else []


def device_name(device: str) -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them, or ``cpu``."""
    if device == "cpu":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
        return out[torch.device(device).index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(torch.device(device))


def not_run(opt, summary):
    """{stage: reason} for each stage of the full recipe this run did not
    record."""
    asked = {
        "brdf": "brdf" in opt.stages, "light": "light" in opt.stages,
        "bilateral": "bilateral" in opt.stages,
        "brdf1": opt.cascade1, "light1": opt.cascade1,
        "light_b20": opt.lightB20, "bilateral_mid": opt.bsMid,
        "finetune_nyu": opt.finetuneNYU, "finetune_iiw": opt.finetuneIIW,
        "finetune_nyu1": opt.finetuneNYU1,
        "finetune_iiw1": opt.finetuneIIW1, "capstone": opt.capstone,
    }
    out = {}
    for name in STAGES:
        if name in summary["stages"]:
            continue
        if not asked[name]:
            out[name] = "not asked for"
        else:
            out[name] = "its prerequisite stage did not run"
    return out


def gate(stages: dict) -> list:
    """The learning gate of the JAX package's tests/test_convergence.py
    (:55-146) on the stages recorded, and the NYU legs' held-out
    improvement over init.  Returns the failed checks as strings (empty:
    every recorded leg learned)."""
    failed = []

    def check(ok, what, rec):
        if not ok:
            failed.append(f"{what}: {rec}")

    if "brdf" in stages:
        rec = stages["brdf"]
        check(rec["loss"]["steps"] >= 100, "brdf steps >= 100", rec["loss"])
        check(rec["loss"]["ratio"] >= 5.0, "brdf loss ratio >= 5",
              rec["loss"])
        for k in ("albedo", "normal"):
            check(rec["test_improvement"][k] >= 3.0,
                  f"brdf {k} improvement >= 3", rec["test_improvement"])
        for k in ("rough", "depth"):
            check(rec["trained_test"][k] <= rec["init_test"][k],
                  f"brdf {k} trained <= init", rec)
    if "light" in stages:
        rec = stages["light"]
        check(rec["loss"]["ratio"] >= 1.03, "light loss ratio >= 1.03",
              rec["loss"])
        check(rec["trained_test"]["render"] < rec["init_test"]["render"] * 0.8,
              "light render trained < 0.8 init", rec)
        check(rec["trained_test"]["reconst"] < rec["init_test"]["reconst"],
              "light reconst trained < init", rec)
    if "bilateral" in stages:
        rec = stages["bilateral"]
        for k in ("albedo_bs", "rough_bs", "depth_bs"):
            check(rec["trained_test"][k] <= rec["init_test"][k] * 1.02,
                  f"bilateral {k} trained <= 1.02 init", rec)
    if "bilateral_mid" in stages:
        rec = stages["bilateral_mid"]
        for k in ("albedo_bs", "rough_bs", "depth_bs"):
            check(rec["refined_vs_raw"][k] > 1.0,
                  f"bilateral_mid {k} refined beats raw", rec)
            check(rec["trained_test"][k] <= rec["init_test"][k] * 1.01,
                  f"bilateral_mid {k} trained <= 1.01 init", rec)
    if "finetune_iiw" in stages:
        rec = stages["finetune_iiw"]
        check(rec["loss"]["ratio"] >= 1.1, "finetune_iiw loss ratio >= 1.1",
              rec["loss"])
        check(rec["trained_test"]["whdr"] <= rec["init_test"]["whdr"] * 0.95,
              "finetune_iiw whdr trained <= 0.95 init", rec)
    for leg in ("finetune_nyu", "finetune_nyu1"):
        if leg in stages:
            rec = stages[leg]
            for k in ("normal_mean_deg", "si_log_depth_rmse"):
                check(rec["trained_test"][k] < rec["init_test"][k],
                      f"{leg} {k} trained < init", rec)
    if "capstone" in stages:
        rec = stages["capstone"]
        t, i = rec["trained_products"], rec["init_products"]
        for k in ("whdr", "normal_mean_deg", "si_log_depth_rmse"):
            check(t[k] < i[k], f"capstone {k} trained < init", rec)
    return failed


def stages_digest(stages: dict) -> str:
    """sha256 of the stages' JSON (keys sorted) without their wall times
    (the ``*_s`` keys): equal digests, a repeated run."""

    def strip(x):
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items() if not k.endswith("_s")}
        return x

    text = json.dumps(strip(stages), sort_keys=True)
    return hashlib.sha256(text.encode()).hexdigest()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="runs/conv")
    ap.add_argument("--imHeight", type=int, default=120)
    ap.add_argument("--imWidth", type=int, default=160)
    ap.add_argument("--envRow", type=int, default=60)
    ap.add_argument("--envCol", type=int, default=80)
    ap.add_argument("--scenes", type=int, default=5)
    ap.add_argument("--perScene", type=int, default=12)
    ap.add_argument("--brdfEpochs", type=int, default=60)
    ap.add_argument("--brdfBatch", type=int, default=8)
    ap.add_argument("--lightEpochs", type=int, default=20)
    ap.add_argument("--lightBatch", type=int, default=4)
    ap.add_argument("--bsEpochs", type=int, default=5)
    ap.add_argument("--bsBatch", type=int, default=2)
    ap.add_argument("--stages", nargs="+",
                    default=["brdf", "light", "bilateral"])
    ap.add_argument("--cascade1", action="store_true",
                    help="after the cascade-0 stages: export the "
                         "intermediates (output_brdf_light, both splits) "
                         "and run the cascade-1 BRDF + light legs")
    ap.add_argument("--brdf1Epochs", type=int, default=30)
    ap.add_argument("--light1Epochs", type=int, default=10)
    ap.add_argument("--finetuneNYU", action="store_true",
                    help="after the cascade-0 BRDF: fine-tune on the NYU "
                         "fixture (alternating synthetic / NYU batches) "
                         "and record held-out normal-angle / si-log-depth "
                         "improvement over the un-finetuned BRDF")
    ap.add_argument("--nyuEpochs", type=int, default=8)
    ap.add_argument("--nyuBatch", type=int, default=4)
    ap.add_argument("--finetuneIIW", action="store_true",
                    help="after the cascade-0 BRDF: fine-tune on the IIW "
                         "fixture (alternating synthetic / ranking-loss "
                         "batches) and record held-out WHDR improvement "
                         "over the un-finetuned BRDF")
    ap.add_argument("--iiwEpochs", type=int, default=8)
    ap.add_argument("--iiwBatch", type=int, default=4)
    ap.add_argument("--finetuneNYU1", action="store_true",
                    help="with --cascade1: the cascade-1 NYU fine-tune leg "
                         "(the *_pre maps synthesized inline from the "
                         "trained c0 stacks, init = the trained c1 BRDF)")
    ap.add_argument("--finetuneIIW1", action="store_true",
                    help="with --cascade1: the cascade-1 IIW fine-tune leg")
    ap.add_argument("--capstone", action="store_true",
                    help="after all stages: test_real (both cascades where "
                         "cascade 1 trained, light, bilateral) over "
                         "held-out fixture photos, then compare on the "
                         "written products, trained vs init")
    ap.add_argument("--lightB20", action="store_true",
                    help="the light stage at batch --b20Batch with the LR "
                         "scaled linearly, against the recipe's base batch")
    ap.add_argument("--b20Batch", type=int, default=20)
    ap.add_argument("--b20Epochs", type=int, default=None,
                    help="default: --lightEpochs (equal data passes)")
    ap.add_argument("--bsMidEpochs", type=int, default=None,
                    help="default: 3 * --bsEpochs (the mid leg is the "
                         "learning gate; give it enough steps)")
    ap.add_argument("--bsMid", action="store_true",
                    help="the bilateral leg against a MID-training BRDF "
                         "checkpoint, where the refinement has signal: "
                         "records refined against unrefined held-out "
                         "metrics")
    ap.add_argument("--computeDtype", default="bfloat16",
                    choices=["float32", "bfloat16"],
                    help="train_brdf / train_light's compute dtype")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every CLI (cpu: the kernels' "
                         "plain versions)")
    ap.add_argument("--gate", action="store_true",
                    help="exit non-zero unless every recorded leg passes "
                         "the learning gate (:func:`gate`)")
    return ap.parse_args(argv)


def main(argv=None):
    opt = parse_args(argv)
    os.makedirs(opt.out, exist_ok=True)

    from inverserenderingofindoorscene_torch.cli import (
        test_synthetic,
        train_bilateral,
        train_brdf,
        train_light,
    )
    from inverserenderingofindoorscene_torch.data.fixture import (
        write_openrooms_fixture,
    )

    root = osp.join(opt.out, "fixture")
    t0 = time.time()
    write_openrooms_fixture(
        root, n_scenes=opt.scenes, per_scene=opt.perScene,
        n_test_scenes=1, im_hw=(opt.imHeight, opt.imWidth),
        env_rc=(opt.envRow, opt.envCol),
    )
    log(f"fixture: {opt.scenes}x{opt.perScene} train + "
        f"1x{opt.perScene} test images in {time.time() - t0:.0f}s")

    def args(extra, bs, epochs, max_steps=None, kernels=True):
        a = [
            "--dataRoot", root, "--device", opt.device,
            "--imHeight", str(opt.imHeight), "--imWidth", str(opt.imWidth),
            "--envRow", str(opt.envRow), "--envCol", str(opt.envCol),
            "--batchSize", str(bs), "--nepoch", str(epochs),
            "--numWorkers", "2", "--loaderMode", "thread",
            "--itemCache", osp.join(opt.out, "cache"), "--saveEvery", "10",
        ]
        if max_steps is not None:
            a += ["--maxSteps", str(max_steps)]
        return a + (_no_kernels(opt) if kernels else []) + extra

    # resumable: a stage already recorded in <out>/summary.json is kept
    prior = {}
    sj = osp.join(opt.out, "summary.json")
    if osp.isfile(sj):
        with open(sj) as f:
            prior = json.load(f).get("stages", {})
    config = vars(opt).copy()
    config["device"] = device_name(opt.device)
    config["torch"] = torch.__version__
    summary = {"config": config, "stages": {}}
    exp = {}

    def dump_summary():
        # written after every stage, so a rerun resumes at stage
        # granularity; prior stages not yet re-reached are merged in
        merged = dict(prior)
        merged.update(summary["stages"])
        blob = json.dumps({**summary, "stages": merged,
                           "not_run": not_run(opt, {"stages": merged})},
                          indent=1)
        tmp = sj + ".tmp"
        with open(tmp, "w") as f:
            f.write(blob)
        os.replace(tmp, sj)

    def run_stage(name, train_main, bs, epochs, extra_train, eval_extra,
                  eval_keys, stage=None):
        stage = stage or name
        kernels = train_main is not train_brdf.main
        main_exp0 = osp.join(opt.out, f"{name}_main")
        if name in prior:
            log(f"[{name}] already recorded; skipping (resume)")
            summary["stages"][name] = prior[name]
            exp[name] = main_exp0
            return
        rec = {}
        # 1) init checkpoint (0 steps; same seed => the training run's
        #    exact init nets) and held-out eval of the UNTRAINED nets
        init_exp = osp.join(opt.out, f"{name}_init")
        train_main(args(["--experiment", init_exp] + extra_train,
                        bs, 1, max_steps=0, kernels=kernels))
        m0 = test_synthetic.main(args(
            ["--stage", stage,
             "--testRoot", osp.join(opt.out, f"test_{name}_init")]
            + eval_extra(init_exp), bs, 1))
        rec["init_test"] = {k: _scalar(m0[k]) for k in eval_keys}
        # 2) the real run
        t1 = time.time()
        main_exp = osp.join(opt.out, f"{name}_main")
        train_main(args(["--experiment", main_exp] + extra_train,
                        bs, epochs, kernels=kernels))
        rec["train_s"] = round(time.time() - t1, 1)
        rec["loss"] = curve_stats(main_exp)
        # 3) held-out eval of the trained nets
        m1 = test_synthetic.main(args(
            ["--stage", stage,
             "--testRoot", osp.join(opt.out, f"test_{name}_main")]
            + eval_extra(main_exp), bs, 1))
        rec["trained_test"] = {k: _scalar(m1[k]) for k in eval_keys}
        rec["test_improvement"] = _improvement(rec["init_test"],
                                               rec["trained_test"])
        exp[name] = main_exp
        summary["stages"][name] = rec
        dump_summary()
        log(f"[{name}] loss {rec['loss']} | init {rec['init_test']} | "
            f"trained {rec['trained_test']} | x-better "
            f"{rec['test_improvement']} | {rec['train_s']}s")

    def _scalar(v):
        a = np.asarray(v, np.float64).ravel()
        return float(a[-1] if a.size > 1 else a[0])  # bilateral: [raw, bs]

    dt = ["--computeDtype", opt.computeDtype]

    if "brdf" in opt.stages:
        run_stage("brdf", train_brdf.main, opt.brdfBatch, opt.brdfEpochs,
                  dt + ["--previewEvery", "0"],
                  lambda e: ["--brdfExperiment", e],
                  ["albedo", "normal", "rough", "depth"])
    if "light" in opt.stages:
        brdf_args = (["--brdfExperiment", exp["brdf"]]
                     if "brdf" in exp else [])
        run_stage("light", train_light.main, opt.lightBatch,
                  opt.lightEpochs, dt + brdf_args,
                  lambda e: ["--lightExperiment", e] + brdf_args,
                  ["reconst", "render"])
    if "bilateral" in opt.stages:
        brdf_args = (["--brdfExperiment", exp["brdf"]]
                     if "brdf" in exp else [])
        run_stage("bilateral", train_bilateral.main, opt.bsBatch,
                  opt.bsEpochs, brdf_args,
                  lambda e: ["--bsExperiment", e] + brdf_args,
                  ["albedo_bs", "rough_bs", "depth_bs"])

    if opt.cascade1 and "brdf" in exp and "light" in exp:
        from inverserenderingofindoorscene_torch.cli import output_brdf_light

        handoff = ["--brdfExperiment", exp["brdf"],
                   "--lightExperiment", exp["light"]]
        if "brdf1" not in prior:
            # the cascade hand-off: the *_0.h5 intermediates next to the
            # fixture files (skip-existing, outputBRDFLight.py:253-301)
            for mode in ("TRAIN", "TEST"):
                log(f"exporting cascade-0 intermediates ({mode}) ...")
                output_brdf_light.main(
                    args(["--mode", mode] + handoff, 2, 1))
        c1 = ["--cascadeLevel", "1"]
        run_stage("brdf1", train_brdf.main, opt.brdfBatch, opt.brdf1Epochs,
                  dt + c1 + ["--previewEvery", "0"],
                  lambda e: ["--brdfExperiment", e] + c1,
                  ["albedo", "normal", "rough", "depth"], stage="brdf")
        brdf1_args = ["--brdfExperiment", exp["brdf1"]]
        run_stage("light1", train_light.main, opt.lightBatch,
                  opt.light1Epochs, dt + c1 + brdf1_args,
                  lambda e: ["--lightExperiment", e] + brdf1_args + c1,
                  ["reconst", "render"], stage="light")

    if opt.lightB20 and "brdf" in exp:
        # the linear LR scaling rule (lr ~ batch) from the recipe's base
        # light batch; equal epochs => equal data passes, 1/K the steps
        lr20 = 1e-4 * opt.b20Batch / max(opt.lightBatch, 1)
        b20_extra = dt + ["--brdfExperiment", exp["brdf"],
                          "--lr", f"{lr20:.6g}"]
        name0 = "light_b20"
        if name0 in prior:
            log(f"[{name0}] already recorded; skipping (resume)")
            summary["stages"][name0] = prior[name0]
        else:
            t1 = time.time()
            b20_exp = osp.join(opt.out, f"{name0}_main")
            train_light.main(args(["--experiment", b20_exp] + b20_extra,
                                  opt.b20Batch,
                                  opt.b20Epochs or opt.lightEpochs))
            rec = {"train_s": round(time.time() - t1, 1),
                   "lr": lr20, "batch": opt.b20Batch,
                   "loss": curve_stats(b20_exp)}
            m1 = test_synthetic.main(args(
                ["--stage", "light",
                 "--testRoot", osp.join(opt.out, f"test_{name0}_main"),
                 "--lightExperiment", b20_exp,
                 "--brdfExperiment", exp["brdf"]],
                opt.lightBatch, 1))
            rec["trained_test"] = {k: _scalar(m1[k])
                                   for k in ("reconst", "render")}
            base = summary["stages"].get("light") or prior.get("light")
            rec["init_test"] = (base or {}).get("trained_test", {})
            rec["vs_base_batch"] = {
                k: round(rec["init_test"].get(k, float("nan"))
                         / max(rec["trained_test"][k], 1e-12), 3)
                for k in rec["trained_test"]
            }
            summary["stages"][name0] = rec
            log(f"[{name0}] loss {rec['loss']} | B{opt.b20Batch} "
                f"lr {lr20:.2g} trained {rec['trained_test']} | base-B "
                f"trained {rec['init_test']} | b20/base "
                f"{rec['vs_base_batch']} | {rec['train_s']}s")
        dump_summary()

    if opt.bsMid and "brdf" in exp:
        name0 = "bilateral_mid"
        if name0 in prior:
            log(f"[{name0}] already recorded; skipping (resume)")
            summary["stages"][name0] = prior[name0]
        else:
            # the mid-training BRDF checkpoint: the saved epoch nearest to
            # half the run, among the exact brdf0_<epoch> dirs (a step
            # checkpoint's brdf0_step_<e>_<j> is not an epoch)
            eps = sorted(
                int(m.group(1))
                for p in glob.glob(osp.join(exp["brdf"], "brdf0_*"))
                for m in [re.fullmatch(r"brdf0_(\d+)", osp.basename(p))]
                if m
            )
            if not eps:
                raise FileNotFoundError(f"no brdf epoch under {exp['brdf']}")
            mid = min(eps, key=lambda e: abs(e - max(eps) / 2))
            brdf_mid = ["--brdfExperiment", exp["brdf"],
                        "--brdfEpoch", str(mid)]
            rec = {"brdf_epoch": mid}
            init_exp = osp.join(opt.out, f"{name0}_init")
            train_bilateral.main(args(
                ["--experiment", init_exp] + brdf_mid, opt.bsBatch, 1,
                max_steps=0))
            m0 = test_synthetic.main(args(
                ["--stage", "bilateral",
                 "--testRoot", osp.join(opt.out, f"test_{name0}_init"),
                 "--bsExperiment", init_exp] + brdf_mid, opt.bsBatch, 1))
            keys = ("albedo_bs", "rough_bs", "depth_bs")
            rec["init_test"] = {k: _scalar(m0[k]) for k in keys}
            t1 = time.time()
            mid_exp = osp.join(opt.out, f"{name0}_main")
            train_bilateral.main(args(
                ["--experiment", mid_exp] + brdf_mid, opt.bsBatch,
                opt.bsMidEpochs or 3 * opt.bsEpochs))
            rec["train_s"] = round(time.time() - t1, 1)
            rec["loss"] = curve_stats(mid_exp)
            m1 = test_synthetic.main(args(
                ["--stage", "bilateral",
                 "--testRoot", osp.join(opt.out, f"test_{name0}_main"),
                 "--bsExperiment", mid_exp] + brdf_mid, opt.bsBatch, 1))
            rec["trained_test"] = {k: _scalar(m1[k]) for k in keys}
            # the bilateral stage reports [raw, refined] as {k}_raw /
            # {k}_bs: refined must BEAT the frozen mid-BRDF's raw maps
            rec["trained_raw"] = {
                k: _scalar(m1[k.replace("_bs", "_raw")]) for k in keys
            }
            rec["test_improvement"] = _improvement(rec["init_test"],
                                                   rec["trained_test"])
            rec["refined_vs_raw"] = {
                k: round(rec["trained_raw"][k]
                         / max(rec["trained_test"][k], 1e-12), 3)
                for k in keys
            }
            summary["stages"][name0] = rec
            log(f"[{name0}] brdf@{mid} loss {rec['loss']} | init "
                f"{rec['init_test']} | trained {rec['trained_test']} | "
                f"raw {rec['trained_raw']} | refined/raw "
                f"{rec['refined_vs_raw']} | {rec['train_s']}s")
        dump_summary()

    if opt.finetuneNYU and "brdf" in exp:
        _finetune_nyu_leg(opt, args, exp, prior, summary)
        dump_summary()
    if opt.finetuneIIW and "brdf" in exp:
        _finetune_iiw_leg(opt, args, exp, prior, summary)
        dump_summary()
    if opt.finetuneNYU1 and "brdf1" in exp:
        _finetune_nyu_leg(opt, args, exp, prior, summary, cascade=1)
        dump_summary()
    if opt.finetuneIIW1 and "brdf1" in exp:
        _finetune_iiw_leg(opt, args, exp, prior, summary, cascade=1)
        dump_summary()
    if opt.capstone and "brdf" in exp:
        _capstone_leg(opt, exp, prior, summary)
        dump_summary()

    dump_summary()
    log("\n| stage | steps | loss first->last (ratio) | test init -> trained |")
    log("|---|---|---|---|")
    for name, rec in summary["stages"].items():
        c = rec.get("loss") or {"steps": 0, "first": float("nan"),
                                "last": float("nan"), "ratio": float("nan")}
        ik = rec.get("init_test") or rec.get("init_products") or {}
        tk = rec.get("trained_test") or rec.get("trained_products") or {}
        tt = ", ".join(
            f"{k} {ik.get(k, float('nan')):.4g}->{tk[k]:.4g}"
            for k in tk)
        log(f"| {name} | {c['steps']} | {c['first']:.4g} -> {c['last']:.4g} "
            f"({c['ratio']:.1f}x) | {tt} |")
    summary["not_run"] = not_run(opt, summary)
    log(f"not run: {summary['not_run']}")
    log(f"summary: {sj}")
    if opt.gate:
        failed = gate(summary["stages"])
        for f in failed:
            log(f"[gate] FAILED {f}")
        if failed:
            raise SystemExit(1)
        log("[gate] every recorded leg learned")
    return summary


if __name__ == "__main__":
    main()
