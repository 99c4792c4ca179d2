#!/usr/bin/env python3
"""Repeat the serving walk's first launch and its main-path launch on the
card, and show which outputs a wrong launch leaves wrong.

    python3 probe_walk_coverage.py [--procs 6] [--iters 300]

``render_sg_env`` (``ops/csrc/sg_render_env.cu``, ``Walk::kServe``) is
launched at the serving shape (B=1, 120x160, K=12, D=128) on the inputs of
``chip_smoke.py`` phase 3, with its outputs filled with NaN before the
launch, and held against ``render_sg_env_plain`` at phase 3's tolerances:

  1. ``--procs`` fresh processes, each building nothing (the library is
     built first, here), whose first launch of the walk is that check,
     as in phase 3;
  2. one process, ``--iters`` launches on fresh inputs each.

For a wrong launch it prints how many pixels were left unwritten (NaN)
or written wrong, and the wrong pixels' warps (pixel p is warp p % W of
the grid's W warps).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from inverserenderingofindoorscene_torch.ops import build, sg_render

SHAPE = (1, 120, 160, 12)
ATOL = 2e-5  # chip_smoke.py ELEMENT_TOL["diffuse"]


def inputs(rng, b, h, w, k):
    """chip_smoke.py kernel_inputs."""
    albedo = rng.rand(b, h, w, 3)
    normal = rng.uniform(-1, 1, (b, h, w, 3))
    normal[..., 2] = np.abs(normal[..., 2]) + 0.3
    normal = 0.97 * normal / np.linalg.norm(normal, axis=-1, keepdims=True)
    rough = rng.uniform(-1, 1, (b, h, w, 1))
    ax = rng.uniform(-1, 1, (b, h, w, k, 3))
    ax = ax / np.linalg.norm(ax, axis=-1, keepdims=True)
    lamb = rng.uniform(0, 20, (b, h, w, k))
    wgt = rng.uniform(0, 2, (b, h, w, k, 3))
    return [torch.as_tensor(x.astype(np.float32), device="cuda")
            for x in (albedo, normal, rough, ax, lamb, wgt)]


def launch(args):
    """The wrapper's launch, with outputs filled with NaN first."""
    lib, (b, h, w, k, d), tables = sg_render._walk_inputs(
        "render_sg_env", *args, 57.0, 8, 16)
    n = b * h * w
    diffuse = torch.full((b, h, w, 3), float("nan"), device="cuda")
    specular = torch.full_like(diffuse, float("nan"))
    env = torch.full((b, h, w, d, 3), float("nan"), device="cuda")
    ptrs = [x.data_ptr() for x in (*args, *tables)]
    build.raise_on("sg_render_env", lib.sg_render_env_f32(
        *ptrs, diffuse.data_ptr(), specular.data_ptr(), env.data_ptr(), n,
        h * w, k, d, 0.05, build.stream(torch.device("cuda"))))
    return diffuse, specular, env


def n_warps():
    """The grid's warps at the serving shape: the launcher's rule."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n = SHAPE[0] * SHAPE[1] * SHAPE[2]
    return min((n + 7) // 8, 3 * sms) * 8


def check(seed):
    """One launch on seed's inputs -> a dict describing it."""
    args = inputs(np.random.RandomState(seed), *SHAPE)
    got = launch(args)
    want = sg_render.render_sg_env_plain(*args)
    torch.cuda.synchronize()
    d = got[0].reshape(-1, 3)
    unwritten = torch.isnan(d).any(-1)
    wrong = ((d - want[0].reshape(-1, 3)).abs() > ATOL).any(-1) & ~unwritten
    env_nan = int(torch.isnan(got[2]).any(-1).any(-1).sum())
    bad = (unwritten | wrong).nonzero().flatten().cpu().numpy()
    warps = sorted(set((bad % n_warps()).tolist()))
    return {"seed": seed, "unwritten": int(unwritten.sum()),
            "wrong": int(wrong.sum()), "env_pixels_nan": env_nan,
            "n_warps": n_warps(), "bad_warps": len(warps),
            "first_bad_warps": warps[:16],
            "max_abs_err": float(np.nan_to_num(
                (d - want[0].reshape(-1, 3)).abs().max().item(), nan=-1))}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--procs", type=int, default=6)
    parser.add_argument("--iters", type=int, default=300)
    parser.add_argument("--child", type=int, default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_walk_coverage: needs a CUDA card", file=sys.stderr)
        return 1
    if args.child is not None:  # a fresh process: its first launch
        print(json.dumps(check(args.child)))
        return 0
    build.build_all()
    print(torch.cuda.get_device_name(0), flush=True)
    firsts = []
    for i in range(args.procs):
        out = subprocess.run([sys.executable, __file__, "--child", str(i)],
                             capture_output=True, text=True, timeout=300)
        firsts.append(out.stdout.strip() or out.stderr[-2000:])
        print(f"first launch in process {i}: {firsts[-1]}", flush=True)
    bad = []
    for seed in range(args.iters):
        r = check(1000 + seed)
        if r["unwritten"] or r["wrong"]:
            bad.append(r)
            print(f"launch {seed}: {r}", flush=True)
    print(f"{len(bad)} of {args.iters} launches in one process wrong")
    return 0


if __name__ == "__main__":
    sys.exit(main())
