#!/usr/bin/env python3
"""The port's training steps under ``torch.use_deterministic_algorithms``
on one CUDA card: which ops have no deterministic CUDA path, what the
steps cost, and whether a step and the learning harness repeat bit for
bit (ROADMAP C17, C20).

    python3 probe_determinism.py [--root DIR] (--warn | --time N |
                                                --repeat | --harness)

``--root DIR`` imports the port (and ``chip_smoke.py``'s phase-12
configuration) from DIR, a checkout of another commit; the default is
this file's directory.

``--warn``: under ``use_deterministic_algorithms(True, warn_only=True)``
with cuDNN's autotuning off, one step each of the c0 BRDF step (B=16,
240x320, f32), the c0 light step (B=5, grid 120x160, light input
480x640, K=12, kernel route), the bilateral step (B=2, seeded confidence
nets) and the IIW step (B=16, 800 rows a kind); then the convergence
harness at ``chip_smoke.py``'s phase-12 configuration.  Each distinct
warning once, with the run that showed it and the call site torch names.

``--time N``: the c0 BRDF (B=16) and c0 light (B=5) steps in float32 and
bfloat16 from the same weights, as ``chip_smoke.py`` phase 11 takes them
(autotuning on, one untimed step, then N), and the same under
``use_deterministic_algorithms(True)`` with autotuning off; ms a step,
host clock to a synchronize, median of N.

``--repeat``: the c0 BRDF step's loss and backward twice from one state
and batch, in the default mode (autotuning on) and under deterministic
algorithms (off): which nets' gradients differ.

``--harness``: the harness at phase 12's configuration under
``use_deterministic_algorithms(True)`` (an op without a deterministic
path raises); the gate's failures, the IIW loss ratio and the digest of
the stages without their wall times.

Every result is a line ``PROBE {json}`` beside the card's name and power
limit.  Exits non-zero without a CUDA card.
"""

import os

# cuBLAS adds without atomics only with a fixed workspace, read when CUDA
# starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import argparse
import copy
import hashlib
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip()


def report(what, **fields):
    print("PROBE " + json.dumps({"what": what, **fields}), flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=os.path.dirname(
        os.path.abspath(__file__)))
    mode = parser.add_mutually_exclusive_group(required=True)
    mode.add_argument("--warn", action="store_true")
    mode.add_argument("--time", type=int, default=0)
    mode.add_argument("--repeat", action="store_true")
    mode.add_argument("--harness", action="store_true")
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)

    import torch

    if not torch.cuda.is_available():
        print("probe_determinism: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    probe = Probe(torch, root)
    if args.warn:
        probe.warn()
    elif args.time:
        probe.time(args.time)
    elif args.repeat:
        probe.repeat()
    else:
        probe.harness()
    return 0


class Probe:
    def __init__(self, torch, root):
        from inverserenderingofindoorscene_torch.data import synthetic
        from inverserenderingofindoorscene_torch.pipeline import (
            bilateral,
            brdf,
            light,
        )
        from inverserenderingofindoorscene_torch.train import steps

        self.torch, self.root = torch, root
        self.dev = torch.device("cuda")
        self.synthetic, self.steps = synthetic, steps
        self.BRDFNets, self.LightNets = brdf.BRDFNets, light.LightNets
        self.BilateralNets = bilateral.BilateralNets
        self.card = card()

    def gen(self, seed):
        return self.torch.Generator().manual_seed(seed)

    def batch(self, b, seed):
        return self.synthetic.synthetic_batch(
            batch=b, im_hw=(240, 320), env_rc=(120, 160), sg_num=12,
            seed=seed, device=self.dev)

    def brdf_step(self, nets=None):
        nets = nets or self.BRDFNets(0, generator=self.gen(11))
        return (self.steps.make_brdf_train_step(nets, device=self.dev,
                                                lr=1e-4),
                self.batch(16, 11))

    def light_step(self, light=None):
        gen = self.gen(12)
        brdf = self.BRDFNets(0, generator=gen)
        light = light or self.LightNets(sg_num=12, env_rows=120,
                                        env_cols=160, generator=gen)
        return (self.steps.make_light_train_step(brdf, light,
                                                 device=self.dev, lr=1e-4),
                self.batch(5, 12))

    def bilateral_step(self):
        gen = self.gen(13)
        return (self.steps.make_bilateral_train_step(
            self.BRDFNets(0, generator=gen), self.BilateralNets(gen),
            device=self.dev), self.batch(2, 13))

    def iiw_step(self):
        batch, _ = self.synthetic.synthetic_iiw_batch(
            batch=16, im_hw=(240, 320), max_num=800, seed=14,
            device=self.dev)
        return (self.steps.make_iiw_train_step(
            self.BRDFNets(0, generator=self.gen(14)), device=self.dev),
            batch)

    def sync(self):
        self.torch.cuda.synchronize()

    def harness_run(self):
        """The harness at phase 12's configuration in a temp dir; returns
        its summary."""
        import chip_smoke
        from inverserenderingofindoorscene_torch.cli import run_convergence

        out = tempfile.mkdtemp(prefix="irois_probe_")
        try:
            return run_convergence.main(["--out", out,
                                         *chip_smoke.LEARNING_ARGS])
        finally:
            shutil.rmtree(out, ignore_errors=True)

    def warn(self):
        torch = self.torch
        torch.backends.cudnn.benchmark = False
        torch.use_deterministic_algorithms(True, warn_only=True)
        runs = {"c0 brdf step": lambda: self.run_step(*self.brdf_step()),
                "c0 light step": lambda: self.run_step(*self.light_step()),
                "bilateral step": lambda: self.run_step(
                    *self.bilateral_step()),
                "iiw step": lambda: self.run_step(*self.iiw_step()),
                "phase 12 harness": self.harness_run}
        seen = {}
        for name, run in runs.items():
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                run()
                self.sync()
            for w in caught:
                text = str(w.message)
                if "deterministic" not in text:
                    continue
                key = text.split("\n")[0]
                if key not in seen:
                    seen[key] = {"run": name,
                                 "site": f"{w.filename}:{w.lineno}"}
            report("warn", run=name, s=time.perf_counter() - t0,
                   root=self.root, card=self.card)
        report("warnings", root=self.root, ops=seen, card=self.card)

    def run_step(self, step, batch):
        step(batch)

    def timed(self, step, batch, n):
        step(batch)  # cuDNN's autotuning where it is on, the allocator
        times = []
        for _ in range(n):
            self.sync()
            t0 = time.perf_counter()
            step(batch)
            self.sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def time(self, n):
        torch = self.torch
        brdf = self.BRDFNets(0, generator=self.gen(11))
        light = self.LightNets(sg_num=12, env_rows=120, env_cols=160,
                               generator=self.gen(12))
        for deterministic in (False, True):
            torch.backends.cudnn.benchmark = not deterministic
            torch.use_deterministic_algorithms(deterministic)
            ms = {}
            for dtype in ("float32", "bfloat16"):
                nets = copy.deepcopy(brdf)
                nets.compute_dtype = dtype
                ms[f"c0 brdf B=16 {dtype}"] = self.timed(
                    *self.brdf_step(nets), n)
                nets = copy.deepcopy(light)
                nets.compute_dtype = dtype
                ms[f"c0 light B=5 {dtype}"] = self.timed(
                    *self.light_step(nets), n)
            torch.use_deterministic_algorithms(False)
            report("time", root=self.root, deterministic=deterministic,
                   steps=n, ms=ms, card=self.card)

    def repeat(self):
        torch = self.torch
        step, batch = self.brdf_step()
        for deterministic in (False, True):
            torch.backends.cudnn.benchmark = not deterministic
            torch.use_deterministic_algorithms(deterministic)
            grads = []
            for _ in range(3):  # the first settles the algorithms
                step.brdf_nets.zero_grad(set_to_none=True)
                step.loss(batch)[0].backward()
                grads.append({n: p.grad.clone() for n, p in
                              step.brdf_nets.named_parameters()})
            torch.use_deterministic_algorithms(False)
            differ = sorted({n.split(".")[0] for n, g in grads[1].items()
                             if not torch.equal(g, grads[2][n])})
            report("repeat", root=self.root, deterministic=deterministic,
                   nets_that_differ=differ, card=self.card)

    def harness(self):
        from inverserenderingofindoorscene_torch.cli import run_convergence

        torch = self.torch
        torch.use_deterministic_algorithms(True)
        t0 = time.perf_counter()
        try:
            summary = self.harness_run()
        finally:
            torch.use_deterministic_algorithms(False)
        stages = summary["stages"]
        report("harness", root=self.root, s=time.perf_counter() - t0,
               gate_failed=run_convergence.gate(stages),
               iiw_loss=stages["finetune_iiw"]["loss"],
               iiw_whdr=stages["finetune_iiw"]["test_improvement"],
               digest=run_convergence.stages_digest(stages),
               stages_sha256_with_times=hashlib.sha256(json.dumps(
                   stages, sort_keys=True).encode()).hexdigest(),
               card=self.card)


if __name__ == "__main__":
    sys.exit(main())
