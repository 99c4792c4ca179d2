#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py [--seed N]

Phases, each fatal on failure:
  1. device: the card's name and power limit, CUDA version, TF32 off;
  2. build: compile every CUDA kernel from the sources in this checkout
     (``inverserenderingofindoorscene_torch/ops/csrc``), all at once;
  3. kernels: each kernel's wrapper against its plain PyTorch version on
     the card (a backward also against torch.autograd of the plain
     forward), at its main-path shape, a ragged 10x13 and K=4 (the render
     backward also at K=24, above 48 KB of shared memory, and a K past the
     card's limit must raise; ``render_sg_env`` also at D=60, K=64, B=8
     and a ragged K=5, and a K past the card's limit must raise;
     ``render_sg_fwd``, the same walk without the envmap, also at K=64 and
     B=8; ``sg_envmap_fwd``, the walk without the shading, also at D=60,
     D=200, K=64, B=8, a ragged K=5 and a ragged D=2048, and a K past the
     card's limit must raise; ``sg_envmap_bwd`` also at D=60, D=200, K=64
     and B=8; the ptxas registers and spills of the walk's entries and of
     the envmap backward are logged), with bounds and with
     times by device time (the profiler's kernel intervals) and by CUDA
     events around a run of launches; the bilateral blur bit for bit on
     the grid of a noisy 240x320 guide at C=3 and C=1 and on a ragged
     10x13 one, with the time of torch.sparse.mm beside it;
  4. serving: the two-cascade ``InverseRenderer`` (level 2, lighting on,
     bilateral refinement of both levels with seeded random confidence
     nets) at the reference operating point (image 240x320, lighting grid
     120x160, 12 SG lobes, 8x16 envmap) with seeded random weights; the
     launch counts show the requests went through ``render_sg_env`` and
     ``bilateral_blur``, each cascade's lighting and refinement agree with
     the plain route on the same inputs, and the plain route end to end
     gives the same cascade-0 maps;
  5. training: the cascade-0 lighting train step at full width (B=5, image
     240x320, grid 120x160, light input 480x640) from the same seeded
     weights on the kernel route and the plain route; step 1's losses
     and light gradients agree, then 20 steps on each route are timed,
     descend, and launch each training kernel once a step on the kernel
     route;
  6. bilateral training: the bilateral train step at full width (B=2,
     image 240x320, frozen cascade-0 BRDF nets), both routes from the
     same seeded weights; step 1's losses and confidence-net gradients
     agree, then 20 steps on each route are timed, descend, and launch
     ``bilateral_blur`` 103 times an image a step on the kernel route;
  7. cascade recipe: the staged training recipe across the cascade
     hand-off at full width, seeded weights: 20 cascade-0 BRDF steps
     (B=16, step 1's errors and per-net gradients against a float64 copy
     on a B=2 slice); the cascade-0 export of that batch on both routes
     (the BRDF products and the SG tensor bit-equal, diffuse and specular
     within the serving tolerances, one ``render_sg_fwd`` and one
     ``sg_envmap_fwd`` launch on the kernel route); the hand-off of the
     kernel route's products in memory through ``normalize_cascade_pre``
     into the cascade-1 ``*_pre`` and ``env_pre`` maps; then, as phase 5,
     the cascade-1 lighting step (B=5, 20 steps a route), as part 1 the
     cascade-1 BRDF step (B=16, the 17-channel encoder), and as phase 6
     the cascade-1 bilateral step (B=2, 10 steps a route);
  8. fine-tunes: the IIW and NYU fine-tunes at full width (B=16, IIW
     batches of 800 rows a kind in the loader's format, NYU ground truth
     at 240x320, both from the seed), seeded weights, 10 cycles each of
     the synthetic BRDF step (phase 7's batch) and the real-data step on
     one Adam, at cascade 0 (no kernel) and at cascade 1, where the
     frozen cascade-0 stack of phase 7 synthesizes the ``*_pre`` maps
     every cycle (one ``render_sg_fwd`` launch); step 1 of each real-data
     step against a float64 copy on a B=2 slice; the synthesis on both
     routes (the BRDF maps and ``env_pre`` bit-equal, diffuse and
     specular within the serving tolerances, the fit's scales logged);
     WHDR against the batch's judgements, normal angle and si-log depth
     RMSE against the NYU ground truth, before and after the cycles
     (random-weight numbers, held only to their ranges).
The second-to-last line of output is the kernels' JSON record, the last
``{"ok": true, "device": {...}}``.  Without a CUDA card it exits non-zero
before printing any result.
"""

from __future__ import annotations

import argparse
import copy
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from inverserenderingofindoorscene_torch.data.openrooms import (
    PRE_STEMS,
    normalize_cascade_pre,
)
from inverserenderingofindoorscene_torch.core import sg
from inverserenderingofindoorscene_torch.core.render_layer import pool_nhwc
from inverserenderingofindoorscene_torch.core.scale import mean_normalize
from inverserenderingofindoorscene_torch.data.synthetic import (
    synthetic_batch,
    synthetic_iiw_batch,
    synthetic_nyu_batch,
)
from inverserenderingofindoorscene_torch.eval.metrics import (
    compute_whdr,
    normal_angle_error,
    si_log_depth_rmse,
)
from inverserenderingofindoorscene_torch.ops import bilateral, build, sg_render
from inverserenderingofindoorscene_torch.pipeline.bilateral import (
    BS_MODES,
    BilateralNets,
    normalized_guide,
)
from inverserenderingofindoorscene_torch.pipeline.brdf import (
    BRDFNets,
    brdf_forward,
)
from inverserenderingofindoorscene_torch.pipeline.export import export_step
from inverserenderingofindoorscene_torch.pipeline.finetune import (
    PRE_KEYS,
    nyu_step,
    synthesize_pre,
)
from inverserenderingofindoorscene_torch.pipeline.inference import (
    InverseRenderer,
    predict_light,
    predict_light_core,
    refine_bs,
)
from inverserenderingofindoorscene_torch.pipeline.light import (
    LightNets,
    light_forward,
)
from inverserenderingofindoorscene_torch.train.steps import (
    make_bilateral_train_step,
    make_brdf_train_step,
    make_iiw_train_step,
    make_light_train_step,
    make_nyu_train_step,
)

IM_HW = (240, 320)
ENV_RC = (120, 160)
SG_NUM = 12
N_REQUESTS = 100
N_DIRS = 128  # the 8x16 envmap
TRAIN_B = 5  # the JAX light-training CLI's batch
TRAIN_LR = 1e-4  # the reference's Adam rate
N_TRAIN_STEPS = 20
BS_TRAIN_B = 2  # the JAX bilateral-training CLI's batch
BRDF_TRAIN_B = 16  # the JAX CLIs' default batch (cli/common.py:34)
IIW_MAX_NUM = 800  # the IIW loader's rows a kind (data/iiw.py:25)
N_FT_CYCLES = 10
N_BS_C1_STEPS = 10
BRDF_NETS = ("encoder", "albedo", "normal", "rough", "depth")
_CSRC = "inverserenderingofindoorscene_torch/ops/csrc/"
_TPU = "inverserenderingofindoorscene_tpu/ops/sg_render.py:"
# kernel -> (its source, the TPU kernel it replaces)
KERNELS = {
    "render_sg_env": (_CSRC + "sg_render_env.cu", _TPU + "397"),
    "sg_envmap_fwd": (_CSRC + "sg_render_env.cu", _TPU + "513"),
    "sg_envmap_bwd": (_CSRC + "sg_envmap.cu", _TPU + "520"),
    "render_sg_fwd": (_CSRC + "sg_render_env.cu", _TPU + "189"),
    "render_sg_bwd": (_CSRC + "sg_render.cu", _TPU + "197"),
    "bilateral_blur": (_CSRC + "bilateral_blur.cu",
                       "scripts/profile_blur_kernel.py:76"),
}
# kernel -> its wrapper, which counts its launches
WRAPPERS = {**{name: getattr(sg_render, name) for name in KERNELS
               if name != "bilateral_blur"},
            "bilateral_blur": bilateral.bilateral_blur}
# bilateral_blur launches, from the code: per image, a forward solve is a
# bistochastization (10 + 1 blurs) and 1 + cg_maxiter products with A, a
# gradient solve 1 + cg_maxiter more; the images of a batch are solved one
# by one.  Serving refines 3 modes at each of 2 levels: 68 a level.
_MAXITER = [bilateral.MODE_PARAMS[m].cg_maxiter for _, m in BS_MODES.values()]
BLURS_FWD = sum(11 + 1 + it for it in _MAXITER)  # 68 an image
BLURS_GRAD = sum(1 + it for it in _MAXITER)  # 35 an image

# data-sheet device-memory rate and f32 (non-tensor-core) peak, by card
# name; the SXM part's figures are the default
CARD_PEAKS = (
    ("PCIe", 2.0e12, 51e12),
    ("NVL", 3.9e12, 60e12),
    ("", 3.35e12, 67e12),
)

# kernel vs plain version: diffuse and env elementwise as (rtol, atol), the
# JAX kernel tests' tolerances (tests/test_sg_render_kernel.py:125-146);
# specular as a relative L1 distance of the whole map.  At full width the
# inputs reach low-roughness pixels where the GGX term is ill-conditioned in
# f32, and there single elements of the TPU kernel's own arithmetic leave
# any small elementwise tolerance against the plain version
# (tests/test_torch_sg_render.py::test_full_width_specular_tolerance).
ELEMENT_TOL = {"diffuse": (0.0, 2e-5), "env": (2e-5, 1e-5)}
SPECULAR_REL_L1 = 1e-3
# a cascade's lighting, kernel route vs plain route on the same inputs, as
# (rtol, atol) (tests/test_pipeline.py:266-277); specular is the kernel's
# specular times a fitted scalar and is held as above.  The host-side scale
# fit divides the 2x2 least-squares coefficients of diffuse and specular,
# and the specular coefficient amplifies the specular map's differences,
# so c_albedo / c_light are held to rtol 1e-2.
CHAIN_TOL = {"env_img": (1e-3, 1e-5), "diffuse": (1e-3, 1e-5)}
SCALE_RTOL = 1e-2
# a backward kernel vs the plain adjoint and vs torch.autograd of the plain
# forward: atol after dividing by max(max|g|, 1), the JAX kernel tests'
# rule (tests/test_sg_render_kernel.py:73-77)
GRAD_SCALED_ATOL = 2e-3
# render_sg's backward, whose normal and rough gradients run through the
# GGX term and the tangent frame, is held by the relative L2 distance of
# each whole gradient instead: in f32 the TPU kernel's GGX formula (which
# torch.autograd of the plain forward differentiates) cancels near ndh = 1,
# and single elements leave any small elementwise tolerance; the kernel's
# own adjoint takes a form that does not cancel and is ~1e-4 (normal) from
# its float64 value at 120x160 K=12 (tests/test_torch_sg_render.py::
# test_render_sg_bwd_f32_conditioning).
GRAD_REL_L2 = {"normal": 1e-2, "rough": 1e-2, "albedo": 1e-3, "axis": 1e-3,
               "lamb": 1e-3, "weight": 1e-3}
# training step 1, kernel route vs plain route on one batch: the light
# losses as relative differences, the light gradients as the worst
# parameter's relative L2 distance (measured on the H100: reconst 0,
# render 2.4e-6, grads 4.7e-6)
STEP1_TOL = {"reconst": 1e-5, "render": 5e-5, "grads": 1e-4}
# a level's refinement, kernel route vs plain blur on the same predictions:
# (rtol, atol), the JAX tests' tolerance for a reordered reduction of the
# same solve (tests/test_bilateral.py:233-237).  The blur is bit-equal and
# the splat sums in one order, so the routes agree bit for bit on the H100.
REFINE_TOL = (2e-4, 2e-5)
# bilateral training step 1, kernel route vs plain route: each loss as a
# relative difference, the confidence-net gradients as the worst
# parameter's relative L2 distance (measured on the H100: losses equal,
# gradients 9.0e-7, from cuDNN's and the upsample backward's reordered
# sums; the solves are bit-equal)
BS_STEP1_TOL = {"losses": 1e-5, "grads": 1e-4}
# BRDF training step 1, f32 against a float64 copy of the nets on a B=2
# slice of the batch: the four errors as relative differences, each net's
# gradient (all its parameters together) as a relative L2 distance.  The
# nets are gated in f32 (ReLU, the heads' clamp of 1.01 tanh): a pixel
# within rounding of a gate takes its gradient on either side
# (tests/test_torch_brdf_train.py docstring)
BRDF_F64_TOL = {"errors": 1e-4, "grads": 1e-3}
# the same check of a fine-tune step (phase 8).  At cascade 1 its inputs
# come from phase 7's c0 stack, whose f32 training differs in its last
# bits between runs (cuDNN's autotuned algorithms), so which pixels sit
# within rounding of a gate differs too: on the H100 the c1 encoder's
# gradient was 1.9e-6 to 1.0e-3 from float64 over six runs (IIW) and
# 1.1e-5 to 8.4e-4 over five (NYU), the cascade-0 ones (the same inputs
# every run) at most 2.4e-5.  Both precisions run the same code: this bounds f32
# conditioning; the CPU tests hold the math against the JAX package.
FINETUNE_F64_TOL = {"errors": 1e-4, "grads": 5e-3}


def log(*args):
    print(*args, flush=True)


def card_peaks(name):
    for key, bw, f32 in CARD_PEAKS:
        if key in name:
            return bw, f32
    raise AssertionError("unreachable")


def kernel_inputs(rng, b, h, w, k, device):
    """The JAX kernel tests' input distribution (|normal| = 0.97)."""
    albedo = rng.rand(b, h, w, 3)
    normal = rng.uniform(-1, 1, (b, h, w, 3))
    normal[..., 2] = np.abs(normal[..., 2]) + 0.3
    normal = 0.97 * normal / np.linalg.norm(normal, axis=-1, keepdims=True)
    rough = rng.uniform(-1, 1, (b, h, w, 1))
    ax = rng.uniform(-1, 1, (b, h, w, k, 3))
    ax = ax / np.linalg.norm(ax, axis=-1, keepdims=True)
    lamb = rng.uniform(0, 20, (b, h, w, k))
    wgt = rng.uniform(0, 2, (b, h, w, k, 3))
    return [torch.as_tensor(x.astype(np.float32), device=device)
            for x in (albedo, normal, rough, ax, lamb, wgt)]


def events_ms(fn, n=50, warmup=5):
    """Time of one call of fn: a pair of CUDA events around a run of n
    calls, over n.  Where the host issues a call more slowly than the
    device runs it, this reads the host's launch path."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def timings(fns):
    """(device ms, events ms) per call of each function: the device time
    goes into the record, both into the log."""
    return [device_ms(fn) for fn in fns], [events_ms(fn) for fn in fns]


def check_close(name, got, want, rtol, atol):
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    max_err = float(err.max())
    if not torch.isfinite(got).all() or bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements outside "
                             f"rtol={rtol} atol={atol}; max abs err {max_err}")
    return max_err


def check_rel_l1(name, got, want, tol):
    """sum|got - want| <= tol * sum|want|; returns the max abs error."""
    dist = float((got - want).abs().sum() / want.abs().sum())
    if not torch.isfinite(got).all() or not dist <= tol:
        raise AssertionError(f"{name}: relative L1 distance {dist} > {tol}")
    return float((got - want).abs().max())


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    log(f"TF32 before: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}; set both False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[device] image libraries for the data loaders (a probe, fails "
        "nothing): " + ", ".join(probe_import(m) for m in ("PIL", "cv2",
                                                             "h5py")))
    return smi


def probe_import(name):
    """Whether ``name`` imports, in a child interpreter: the libraries'
    native code stays out of the process that is measured."""
    out = subprocess.run(
        [sys.executable, "-c", f"import {name}; "
         f"print(getattr({name}, '__version__', '?'))"],
        capture_output=True, text=True, timeout=120)
    if out.returncode:
        return f"{name} does not import"
    return f"{name} {out.stdout.strip()} imports"


def phase_build():
    """Returns {source: nvcc output} of the sources built here."""
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"[build] {len(build.SOURCES)} kernel source(s), "
        f"{len(logs)} compiled in {time.perf_counter() - t0:.1f} s (set-up)")
    for name, out in logs.items():
        for line in out.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                log(f"[build] {name}: {line.strip()}")
    return logs


def ptxas_entries(out):
    """{kernel entry: {registers, stack, spill_stores, spill_loads}} from
    the output of nvcc -Xptxas -v."""
    entries, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = entries.setdefault(m.group(1), {})
        elif cur is not None:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores,"
                          r" (\d+) bytes spill loads", line)
            if m:
                cur.update(zip(("stack", "spill_stores", "spill_loads"),
                               map(int, m.groups())))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
    return entries


def log_ptxas(name, source, logs, entry_has=""):
    """One [kernels] line a kernel entry of ``source`` whose name holds
    ``entry_has``: ptxas's registers, stack and spills."""
    entries = ptxas_entries(logs.get(source, ""))
    entries = {e: info for e, info in entries.items() if entry_has in e}
    if not entries:
        log(f"[kernels] {name} ptxas: library not built in this run")
    for entry, info in entries.items():
        log(f"[kernels] {name} ptxas {entry}: "
            + ", ".join(f"{k} {v}" for k, v in info.items()))


def check_grad(name, got, want, tol=GRAD_SCALED_ATOL):
    """|got - want| / max(max|want|, 1) <= tol elementwise (the JAX kernel
    tests' rule); returns the max abs error."""
    scale = max(float(want.abs().max()), 1.0)
    err = float((got - want).abs().max())
    if not torch.isfinite(got).all() or not err / scale <= tol:
        raise AssertionError(f"{name}: max abs err {err} > {tol} x {scale}")
    return err


def rel_l2(got, want):
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def check_rel_l2(name, got, want, tol):
    """|got - want|_2 <= tol |want|_2 over the whole tensor; returns the
    max abs error."""
    dist = rel_l2(got, want)
    if not torch.isfinite(got).all() or not dist <= tol:
        raise AssertionError(f"{name}: relative L2 distance {dist} > {tol}")
    return float((got - want).abs().max())


def bound(n_bytes, flops, bw, f32_peak):
    """(bound_ms, bound_by): the larger of bytes / memory rate and
    operations / f32 rate."""
    t_bytes, t_ops = n_bytes / bw, flops / f32_peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def log_kernel(name, label, shape, errs, dev, events, bound_ms, bound_by,
               n_bytes, flops):
    b, h, w, k = shape
    log(f"[kernels] {name} {label} B={b} {h}x{w} K={k}: max abs err "
        + ", ".join(f"{nm} {e:.3e}" for nm, e in errs.items())
        + f"; device time per call: kernel {dev[0]:.5f} ms, plain "
        f"{dev[1]:.5f} ms; CUDA events over a run, per call: kernel "
        f"{events[0]:.5f} ms, plain {events[1]:.5f} ms; bound "
        f"{bound_ms:.5f} ms ({bound_by}: {n_bytes / 1e6:.1f} MB, "
        f"{flops / 1e6:.0f} MFLOP)")


def record_of(name, errs, ms, plain_ms, bound_ms, bound_by):
    source, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": max(errs.values()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def plain_grads(fn, inputs, cotangents):
    """torch.autograd of a plain forward: the vector-Jacobian product."""
    inputs = [x.detach().requires_grad_(True) for x in inputs]
    outs = fn(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return torch.autograd.grad(outs, inputs, cotangents)


def check_render_sg_env(args, shape, env_hw=(8, 16)):
    b, h, w, k = shape
    cfg = {"env_height": env_hw[0], "env_width": env_hw[1]}
    got = sg_render.render_sg_env(*args, **cfg)
    want = sg_render.render_sg_env_plain(*args, **cfg)
    torch.cuda.synchronize()
    errs = {
        "diffuse": check_close("diffuse", got[0], want[0],
                               *ELEMENT_TOL["diffuse"]),
        "specular": check_rel_l1("specular", got[1], want[1],
                                 SPECULAR_REL_L1),
        "env": check_close("env", got[2], want[2], *ELEMENT_TOL["env"]),
    }
    fns = (lambda: sg_render.render_sg_env(*args, **cfg),
           lambda: sg_render.render_sg_env_plain(*args, **cfg))
    n, d = b * h * w, env_hw[0] * env_hw[1]
    n_bytes = 4 * (n * (7 + 7 * k) + h * w * 3 + d * 4 + n * (6 + 3 * d))
    flops = n * (8 * k + 45) * d
    return errs, fns, n_bytes, flops


def check_walk_smem(name, dev):
    """The walk's shared memory a block for ``name`` (render_sg_env, which
    shades, or sg_envmap_fwd, which does not) at K=12 and K=64 (above 48
    KB the launch opts in), and the first K past the card's limit
    raises."""
    lib = sg_render._lib("sg_render_env")
    shade = int(name != "sg_envmap_fwd")
    log(f"[kernels] {name} shared memory a block: "
        + ", ".join(f"{lib.sg_walk_smem_bytes(k, shade)} B at K={k}"
                    for k in (SG_NUM, 64)))
    k = 1
    while lib.sg_walk_smem_bytes(k, shade) <= sg_render._SMEM_OPTIN_LIMIT:
        k += 1
    args = kernel_inputs(np.random.RandomState(0), 1, 2, 3, k, dev)
    try:
        getattr(sg_render, name)(*(args if shade else args[3:]))
    except ValueError as err:
        log(f"[kernels] {name} K={k} raises: {err}")
    else:
        raise AssertionError(f"{name} K={k}: no ValueError")


def check_render_sg_fwd(args, shape):
    b, h, w, k = shape
    got = sg_render.render_sg_fwd(*args)
    want = sg_render.render_sg_plain(*args)
    torch.cuda.synchronize()
    errs = {
        "diffuse": check_close("diffuse", got[0], want[0],
                               *ELEMENT_TOL["diffuse"]),
        "specular": check_rel_l1("specular", got[1], want[1],
                                 SPECULAR_REL_L1),
    }
    fns = (lambda: sg_render.render_sg_fwd(*args),
           lambda: sg_render.render_sg_plain(*args))
    n, d = b * h * w, N_DIRS
    n_bytes = 4 * (n * (7 + 7 * k) + h * w * 3 + d * 4 + n * 6)
    flops = n * (8 * k + 45) * d
    return errs, fns, n_bytes, flops


GRAD_NAMES = ("albedo", "normal", "rough", "axis", "lamb", "weight")


def check_render_sg_bwd(args, shape):
    b, h, w, k = shape
    rng = np.random.RandomState(b * h * w + k)
    cot = [torch.as_tensor(rng.randn(b, h, w, 3).astype(np.float32),
                           device=args[0].device) for _ in range(2)]
    got = sg_render.render_sg_bwd(*args, *cot)
    explicit = sg_render.render_sg_bwd_plain(*args, *cot)
    # torch.autograd of the plain forward in float64: in f32 its GGX term
    # cancels, and a pixel whose GGX denominator sits within f32 noise of
    # its clamp puts its gradient on the wrong side of the clamp's gate
    auto = plain_grads(sg_render.render_sg_plain,
                       [x.double() for x in args], [c.double() for c in cot])
    auto32 = plain_grads(sg_render.render_sg_plain, args, cot)
    torch.cuda.synchronize()
    log("[kernels] render_sg_bwd B={} {}x{} K={}: relative L2 vs plain "
        "adjoint / vs float64 autograd (f32 autograd vs float64 autograd): "
        .format(*shape)
        + ", ".join(f"{nm} {rel_l2(g, e):.2e} / {rel_l2(g, a):.2e} "
                    f"({rel_l2(a32.double(), a):.2e})"
                    for nm, g, e, a, a32 in zip(GRAD_NAMES, got, explicit,
                                                auto, auto32)))
    errs = {}
    for nm, g, e, a in zip(GRAD_NAMES, got, explicit, auto):
        tol = GRAD_REL_L2[nm]
        errs[nm] = check_rel_l2(f"d_{nm} vs plain adjoint", g, e, tol)
        errs[f"{nm} (autograd)"] = check_rel_l2(f"d_{nm} vs autograd", g, a,
                                                tol)
    del auto, auto32
    fns = (lambda: sg_render.render_sg_bwd(*args, *cot),
           lambda: sg_render.render_sg_bwd_plain(*args, *cot))
    n, d = b * h * w, N_DIRS
    n_bytes = 4 * (2 * n * (7 + 7 * k) + h * w * 3 + d * 4 + n * 6)
    flops = 3 * n * (8 * k + 45) * d
    return errs, fns, n_bytes, flops


def check_sg_envmap_fwd(args, shape, env_hw=(8, 16)):
    b, h, w, k = shape
    lobes = args[3:]
    cfg = {"env_height": env_hw[0], "env_width": env_hw[1]}
    got = sg_render.sg_envmap_fwd(*lobes, **cfg)
    want = sg_render.sg_envmap_plain(*lobes, **cfg)
    torch.cuda.synchronize()
    errs = {"env": check_close("env", got, want, *ELEMENT_TOL["env"])}
    fns = (lambda: sg_render.sg_envmap_fwd(*lobes, **cfg),
           lambda: sg_render.sg_envmap_plain(*lobes, **cfg))
    n, d = b * h * w, env_hw[0] * env_hw[1]
    n_bytes = 4 * (n * 7 * k + d * 4 + n * 3 * d)
    flops = n * k * 8 * d
    return errs, fns, n_bytes, flops


def check_sg_envmap_bwd(args, shape, env_hw=(8, 16)):
    b, h, w, k = shape
    lobes = args[3:]
    cfg = {"env_height": env_hw[0], "env_width": env_hw[1]}
    n, d = b * h * w, env_hw[0] * env_hw[1]
    rng = np.random.RandomState(n + k)
    g_env = torch.as_tensor(rng.randn(b, h, w, d, 3).astype(np.float32),
                            device=args[0].device)
    got = sg_render.sg_envmap_bwd(*lobes, g_env, **cfg)
    explicit = sg_render.sg_envmap_bwd_plain(*lobes, g_env, **cfg)
    auto = plain_grads(lambda *x: sg_render.sg_envmap_plain(*x, **cfg),
                       lobes, (g_env,))
    torch.cuda.synchronize()
    errs = {}
    for nm, g, e, a in zip(GRAD_NAMES[3:], got, explicit, auto):
        errs[nm] = check_grad(f"d_{nm} vs plain adjoint", g, e)
        errs[f"{nm} (autograd)"] = check_grad(f"d_{nm} vs autograd", g, a)
    fns = (lambda: sg_render.sg_envmap_bwd(*lobes, g_env, **cfg),
           lambda: sg_render.sg_envmap_bwd_plain(*lobes, g_env, **cfg))
    n_bytes = 4 * (2 * n * 7 * k + d * 4 + n * 3 * d)
    flops = 3 * n * k * 8 * d
    return errs, fns, n_bytes, flops


# kernel name -> (check, the shape its record is taken at: the main path's)
KERNEL_CHECKS = {
    "render_sg_env": (check_render_sg_env, (1, *ENV_RC, SG_NUM)),
    "sg_envmap_fwd": (check_sg_envmap_fwd, (TRAIN_B, *ENV_RC, SG_NUM)),
    "sg_envmap_bwd": (check_sg_envmap_bwd, (TRAIN_B, *ENV_RC, SG_NUM)),
    "render_sg_fwd": (check_render_sg_fwd, (TRAIN_B, *ENV_RC, SG_NUM)),
    "render_sg_bwd": (check_render_sg_bwd, (TRAIN_B, *ENV_RC, SG_NUM)),
}


def noisy_grid(rng, h, w, dev):
    """The mode-0 (albedo) grid of a noisy h x w guide: nearly one vertex
    per pixel, the most a full-width refinement meets."""
    guide = np.clip(0.5 + 0.3 * rng.randn(h, w, 3), 0.0, 1.0)
    p = bilateral.MODE_PARAMS[0]
    return bilateral.build_grid(
        torch.as_tensor(guide.astype(np.float32), device=dev) * 255.0,
        p.sigma_spatial, p.sigma_luma, p.sigma_chroma)


def blur_matrix(grid):
    """The blur as one CSR matrix, 10 I + adjacency, built once from the
    neighbour table: the library yardstick (torch.sparse.mm)."""
    v = grid.nvert
    nbr = grid.nbr.long()
    ids = torch.arange(v, device=nbr.device)
    hit = nbr >= 0
    rows = torch.cat([ids, ids[:, None].expand(v, bilateral.N_DIRS)[hit]])
    cols = torch.cat([ids, nbr[hit]])
    vals = torch.cat([torch.full((v,), 2.0 * bilateral.DIM, device=ids.device),
                      torch.ones(int(hit.sum()), device=ids.device)])
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, (v, v))
    return coo.coalesce().to_sparse_csr()


def check_bilateral_blur(grid, c, rng):
    """The blur kernel bit for bit against its plain version on one grid,
    and torch.sparse.mm of the same function beside it.  Returns the
    three device times per call and their CUDA-event times per call."""
    v = grid.nvert
    y = torch.as_tensor(rng.rand(v, c).astype(np.float32),
                        device=grid.nbr.device)
    got = bilateral.bilateral_blur(grid, y)
    want = bilateral.bilateral_blur_plain(grid, y)
    mat = blur_matrix(grid)
    lib = torch.sparse.mm(mat, y)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"bilateral_blur V={v} C={c}: not bit-equal, "
                             f"max abs err {float((got - want).abs().max())}")
    check_close("bilateral_blur torch.sparse.mm", lib, want, 1e-5, 0.0)
    fns = (lambda: bilateral.bilateral_blur(grid, y),
           lambda: bilateral.bilateral_blur_plain(grid, y),
           lambda: torch.sparse.mm(mat, y))
    return timings(fns)


def device_ms(fn, n=50, tries=10):
    """Device time of one call of fn: the union of its kernels' intervals
    in a torch.profiler trace of n calls, over n.  For a kernel of a few
    microseconds, CUDA events around one call time the host's launch
    path instead (the device idles between the two events).  A trace
    that holds no device interval at all (seen for the 1.4-2 us blur,
    three times in a row once) is logged and taken again; after `tries`
    such traces the measurement fails."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for i in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        busy = device_busy_ms(prof)
        if busy > 0.0:
            return busy / n
        log(f"[kernels] torch.profiler trace {i + 1} of {n} calls held no "
            "device interval; tracing again")
    raise AssertionError(f"torch.profiler traced no device time in {tries} "
                         "traces")


def phase_blur(seed, dev, bw, f32_peak):
    """bilateral_blur at its main-path shapes (C=1 for bistochastization,
    rough and depth, C=3 for albedo) and on a ragged 10x13 grid.  Returns
    its JSON record, taken at C=1 (55 of a level's 68 launches), with
    device times: the kernel, the plain version and torch.sparse.mm each
    take a few microseconds of device time a call, below the host's launch
    path that CUDA events around a run of calls read."""
    rng = np.random.RandomState(seed + 5)
    full, ragged = noisy_grid(rng, *IM_HW, dev), noisy_grid(rng, 10, 13, dev)
    record = None
    for label, grid, c in (("main", full, 1), ("main", full, 3),
                           ("ragged", ragged, 3), ("ragged", ragged, 1)):
        (ms, plain_ms, library_ms), events = check_bilateral_blur(grid, c,
                                                                  rng)
        v = grid.nvert
        n_bytes = 4 * 2 * v * c + 4 * bilateral.N_DIRS * v
        flops = (1 + bilateral.N_DIRS) * v * c
        bound_ms, bound_by = bound(n_bytes, flops, bw, f32_peak)
        log(f"[kernels] bilateral_blur {label} V={v} C={c}: bit-equal to "
            f"plain; device time per call: kernel {ms:.5f} ms, plain "
            f"{plain_ms:.5f} ms, torch.sparse.mm {library_ms:.5f} ms; "
            "CUDA events over a run, per call: "
            + ", ".join(f"{t:.4f}" for t in events)
            + f" ms; bound {bound_ms:.5f} ms ({bound_by}: "
            f"{n_bytes / 1e6:.2f} MB, {flops / 1e6:.2f} MFLOP)")
        if label == "main" and c == 1:
            record = record_of("bilateral_blur", {"out": 0.0}, ms, plain_ms,
                               bound_ms, bound_by)
            record["library_ms"] = library_ms
    return record


def check_render_sg_bwd_smem(dev):
    """The render backward's shared memory a block at K=12 and K=24, and
    a K past the card's per-block limit raises."""
    lib = sg_render._lib("sg_render")
    log("[kernels] render_sg_bwd shared memory a block (D=128): "
        + ", ".join(f"{lib.render_sg_bwd_smem_bytes(k, N_DIRS)} B at K={k}"
                    for k in (SG_NUM, 24)))
    k = 1
    while (lib.render_sg_bwd_smem_bytes(k, N_DIRS)
           <= sg_render._SMEM_OPTIN_LIMIT):
        k += 1
    args = kernel_inputs(np.random.RandomState(0), 1, 2, 3, k, dev)
    cot = [torch.zeros(1, 2, 3, 3, device=dev)] * 2
    try:
        sg_render.render_sg_bwd(*args, *cot)
    except ValueError as err:
        log(f"[kernels] render_sg_bwd K={k} raises: {err}")
    else:
        raise AssertionError(f"render_sg_bwd K={k}: no ValueError")


def phase_kernels(seed, dev, ptxas):
    """Every kernel vs its plain version (a backward also vs
    torch.autograd of the plain forward) at its main-path shape, a ragged
    10x13 and K=4 (the render backward also at K=24); the bilateral blur
    on grids.  Returns {name: JSON record at the main-path shape}."""
    rng = np.random.RandomState(seed)
    bw, f32_peak = card_peaks(torch.cuda.get_device_name(0))
    records = {}
    for name, (check, main_shape) in KERNEL_CHECKS.items():
        b = main_shape[0]
        # (label, shape[, the check's further arguments])
        shapes = [("main", main_shape), ("ragged", (1, 10, 13, SG_NUM)),
                  ("K=4", (b, *ENV_RC, 4))]
        if name == "render_sg_bwd":
            check_render_sg_bwd_smem(dev)
            shapes.append(("K=24", (1, 10, 13, 24)))
        if name == "render_sg_env":  # the walk's library: all three entries
            log_ptxas("the walk", "sg_render_env", ptxas)
            check_walk_smem(name, dev)
            # B=8: more than 32 pixels a warp, so every warp computes a
            # second batch of frames; K=5: inputs copied float by float
            shapes += [("D=60", (1, *ENV_RC, SG_NUM), (6, 10)),
                       ("K=64", (1, *ENV_RC, 64)),
                       ("B=8", (8, *ENV_RC, SG_NUM)),
                       ("K=5", (1, 10, 13, 5))]
        if name == "render_sg_fwd":
            shapes += [("K=64", (b, *ENV_RC, 64)),
                       ("B=8", (8, *ENV_RC, SG_NUM))]
        if name == "sg_envmap_fwd":
            # the mangled name of the instantiation Walk::kEnvmap
            log_ptxas(name, "sg_render_env", ptxas, entry_has="WalkE2E")
            check_walk_smem(name, dev)
            # D=60 and D=200: one short pass and two passes, the second
            # with a tail; K=5: inputs copied float by float; a ragged
            # D=2048 (16 passes), past the shading walk's 1,024
            shapes += [("D=60", main_shape, (6, 10)),
                       ("D=200", main_shape, (10, 20)),
                       ("K=64", (b, *ENV_RC, 64)),
                       ("B=8", (8, *ENV_RC, SG_NUM)),
                       ("K=5", (1, 10, 13, 5)),
                       ("D=2048", (1, 10, 13, SG_NUM), (32, 64))]
        if name == "sg_envmap_bwd":
            log_ptxas(name, "sg_envmap", ptxas)
            # D=60: one short chunk of directions; D=200: four, the last
            # of 8 (the warp-a-pixel design took D <= 128); K=64: 22
            # threads a pixel, the last with one lobe
            shapes += [("D=60", main_shape, (6, 10)),
                       ("D=200", main_shape, (10, 20)),
                       ("K=64", (b, *ENV_RC, 64)),
                       ("B=8", (8, *ENV_RC, SG_NUM))]
        for label, shape, *extra in shapes:
            args = kernel_inputs(rng, *shape, dev)
            errs, fns, n_bytes, flops = check(args, shape, *extra)
            dev_ms, ev_ms = timings(fns)
            bound_ms, bound_by = bound(n_bytes, flops, bw, f32_peak)
            log_kernel(name, label, shape, errs, dev_ms, ev_ms, bound_ms,
                       bound_by, n_bytes, flops)
            if label == "main":
                records[name] = record_of(name, errs, *dev_ms, bound_ms,
                                          bound_by)
            del args, fns
        torch.cuda.empty_cache()
    records["bilateral_blur"] = phase_blur(seed, dev, bw, f32_peak)
    return records


def timed_request(renderer, im, im_small):
    """One request, host clock around work that ends in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = renderer(im, im_small, 57.0)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def percentiles(times):
    """median and p90 (the highest percentile with >= 10 samples beyond
    it at 100 requests)."""
    return statistics.median(times), statistics.quantiles(times, n=10)[-1]


def check_shapes(out):
    h, w = IM_HW
    shapes = {"albedo": (1, h, w, 3), "normal": (1, h, w, 3),
              "rough": (1, h, w, 1), "depth": (1, h, w, 1)}
    assert len(out["refined"]) == 2
    for refined in out["refined"]:
        assert sorted(refined) == sorted(BS_MODES), sorted(refined)
        for k, v in refined.items():
            assert tuple(v.shape) == shapes[k], (k, v.shape)
            assert torch.isfinite(v).all(), k
    r, c = ENV_RC
    light_shapes = {"sg_flat": (1, r, c, 7 * SG_NUM),
                    "env_img": (1, r, c, 128, 3),
                    "diffuse": (1, r, c, 3), "specular": (1, r, c, 3)}
    assert len(out["preds"]) == 2 and len(out["lights"]) == 2
    for preds in out["preds"]:
        for k, shape in shapes.items():
            assert tuple(preds[k].shape) == shape, (k, preds[k].shape)
            assert torch.isfinite(preds[k]).all(), k
    for light in out["lights"]:
        for k, shape in light_shapes.items():
            assert tuple(light[k].shape) == shape, (k, light[k].shape)
            assert torch.isfinite(light[k]).all(), k
        for k in ("c_albedo", "c_light"):
            assert np.isfinite(light[k]), k


def check_lighting(stacks, im, im_small, out, worst):
    """Each cascade's lighting again through the plain route, on the same
    inputs the kernel route had.  (Cascade 1's end-to-end inputs differ
    between the routes, and the chain amplifies input differences, so
    the plain route end to end is held only on cascade 0.)"""
    dev = out["preds"][0]["albedo"].device
    im = torch.as_tensor(im, device=dev)
    im_small = torch.as_tensor(im_small, device=dev)
    for lvl, light in enumerate(out["lights"]):
        env_pre = out["lights"][0]["sg_flat"] if lvl else None
        with torch.inference_mode():
            ref = predict_light(predict_light_core(
                stacks[lvl][1], im, out["preds"][lvl], im_small, 57.0,
                env_pre, use_kernels=False), cascade=lvl)
        errs = {k: check_close(f"light{lvl}.{k}", light[k], ref[k], *tol)
                for k, tol in CHAIN_TOL.items()}
        errs["specular"] = check_rel_l1(f"light{lvl}.specular",
                                        light["specular"], ref["specular"],
                                        SPECULAR_REL_L1)
        for k, err in errs.items():
            key = f"light{lvl}.{k}"
            worst[key] = max(worst.get(key, 0.0), err)
        for k in ("c_albedo", "c_light"):
            rel = abs(light[k] - ref[k]) / abs(ref[k])
            if not rel <= SCALE_RTOL:
                raise AssertionError(f"light{lvl}.{k}: {light[k]} vs {ref[k]}")
            key = f"light{lvl}.{k} (relative)"
            worst[key] = max(worst.get(key, 0.0), rel)


def check_refinement(im, bs_nets, out, worst, nverts):
    """Each level's refinement again with the plain blur, on the kernel
    route's predictions; records each mode's vertex count."""
    dev = out["preds"][0]["albedo"].device
    im = torch.as_tensor(im, device=dev)
    for lvl, (preds, refined) in enumerate(zip(out["preds"],
                                               out["refined"])):
        with torch.inference_mode():
            ref = refine_bs(im, preds, bs_nets[lvl], use_kernels=False)
            guide = normalized_guide(preds["albedo"])[0] * 255.0
            for k, (_, mode) in BS_MODES.items():
                p = bilateral.MODE_PARAMS[mode]
                nverts.setdefault((lvl, k), []).append(bilateral.build_grid(
                    guide, p.sigma_spatial, p.sigma_luma,
                    p.sigma_chroma).nvert)
        for k, v in ref.items():
            err = check_close(f"refined{lvl}.{k}", refined[k], v, *REFINE_TOL)
            key = f"refined{lvl}.{k}"
            worst[key] = max(worst.get(key, 0.0), err)


def reset_launches():
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0


def read_launches():
    return {name: wrapper.launches for name, wrapper in WRAPPERS.items()}


def phase_serving(seed):
    """Returns {kernel: launches} of the serving path's run."""
    gen = torch.Generator().manual_seed(seed)
    t0 = time.perf_counter()
    stacks = [(BRDFNets(lvl, generator=gen),
               LightNets(cascade_level=lvl, sg_num=SG_NUM,
                         env_rows=ENV_RC[0], env_cols=ENV_RC[1],
                         generator=gen))
              for lvl in range(2)]
    bs_nets = [BilateralNets(gen) for _ in range(2)]
    fast = InverseRenderer(stacks, is_light=True, is_bs=True,
                           bs_nets=bs_nets, use_kernels=True)
    plain = InverseRenderer(stacks, is_light=True, is_bs=True,
                            bs_nets=bs_nets, use_kernels=False)
    log(f"[serving] two cascades and their refinement, seeded random "
        f"weights, on {fast.device}: {time.perf_counter() - t0:.1f} s "
        "(set-up)")
    rng = np.random.RandomState(seed + 1)
    requests = [(rng.rand(1, *IM_HW, 3).astype(np.float32) ** 2.2,
                 rng.rand(1, *ENV_RC, 3).astype(np.float32) ** 2.2)
                for _ in range(N_REQUESTS)]
    for renderer in (fast, plain):  # warm-up: cuDNN and the allocator
        timed_request(renderer, *requests[0])
    torch.cuda.reset_peak_memory_stats()
    timed_request(fast, *requests[0])
    peak_mib = torch.cuda.max_memory_allocated() / 2**20

    # the main path: the kernel route, counted and timed; the checks run
    # between requests, outside the timed region, and launch no kernel
    worst, times, preds0, nverts = {}, [], [], {}
    reset_launches()
    for im, im_small in requests:
        out, ms = timed_request(fast, im, im_small)
        times.append(ms)
        check_shapes(out)
        check_lighting(stacks, im, im_small, out, worst)
        check_refinement(im, bs_nets, out, worst, nverts)
        preds0.append(out["preds"][0])
    launches = read_launches()
    want = {**dict.fromkeys(KERNELS, 0), "render_sg_env": 2 * N_REQUESTS,
            "bilateral_blur": 2 * BLURS_FWD * N_REQUESTS}
    if launches != want:
        raise AssertionError(f"launches {launches} for {N_REQUESTS} requests, "
                             f"expected {want}")
    log("[serving] grid vertices (min / median / max over the requests): "
        + ", ".join(f"level {lvl} {k} {min(v)} / {statistics.median(v)} / "
                    f"{max(v)}" for (lvl, k), v in nverts.items()))

    plain_times = []
    for (im, im_small), p0 in zip(requests, preds0):
        ref, ms = timed_request(plain, im, im_small)
        plain_times.append(ms)
        check_shapes(ref)
        for k, v in p0.items():
            if not torch.equal(v, ref["preds"][0][k]):
                raise AssertionError(f"cascade-0 {k} differs between routes")
    log("[serving] lighting and refinement, kernel route vs plain route "
        "on the same inputs, max err: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    med, p90 = percentiles(times)
    pmed, pp90 = percentiles(plain_times)
    log(f"[serving] {N_REQUESTS} requests, {launches['render_sg_env']} "
        f"render_sg_env and {launches['bilateral_blur']} bilateral_blur "
        f"launches; ms/request kernel route median {med:.3f} p90 {p90:.3f}, "
        f"plain route median {pmed:.3f} p90 {pp90:.3f}; peak device memory "
        f"{peak_mib:.0f} MiB")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, ms = timed_request(fast, *requests[0])
    busy_ms = device_busy_ms(prof)
    log(f"[serving] torch.profiler, one request on the kernel route: "
        f"{ms:.3f} ms on the host clock, device busy {busy_ms:.3f} ms "
        f"(idle share {1.0 - busy_ms / ms:.3f}):")
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=20))
    return {k: launches[k] for k in ("render_sg_env", "bilateral_blur")}


def device_busy_ms(prof):
    """The union of the device's kernel and copy intervals in a profile,
    in ms (CUPTI's own buffer events left out)."""
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.name not in ("Activity Buffer Request", "Buffer Flush"))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / 1e3


def timed_step(step, batch):
    """One training step, host clock around work that ends in a
    synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = step(batch)
    torch.cuda.synchronize()
    return metrics, (time.perf_counter() - t0) * 1e3


def check_first_step(steps, batch, tag="[training]"):
    """Both routes' loss and gradients on one batch, before any update."""
    out = {}
    for route, step in steps.items():
        total, losses = step.loss(batch)
        total.backward()
        out[route] = (losses, {n: p.grad.clone() for n, p in
                               step.light_nets.named_parameters()})
        step.optimizer.zero_grad(set_to_none=True)
    (lk, gk), (lp, gp) = out["kernels"], out["plain"]
    for k in ("albedo", "normal", "rough", "depth"):
        if not torch.equal(lk[k], lp[k]):
            raise AssertionError(f"BRDF error {k} differs between routes")
    dist = {k: abs(lk[k].item() / lp[k].item() - 1.0)
            for k in ("reconst", "render")}
    dist["grads"] = max(float(torch.linalg.vector_norm(gk[n] - gp[n])
                              / torch.linalg.vector_norm(gp[n])) for n in gp)
    log(f"{tag} step 1, kernel route vs plain route: "
        + ", ".join(f"{k} {v.item():.6g}" for k, v in lk.items())
        + "; relative differences "
        + ", ".join(f"{k} {v:.3e}" for k, v in dist.items())
        + " (grads: the worst parameter's relative L2)")
    for k, tol in STEP1_TOL.items():
        if not dist[k] <= tol:
            raise AssertionError(f"step 1 {k}: {dist[k]} > {tol}")


def profile_step(tag, step, batch, row_limit):
    """One step under torch.profiler: host time, device busy time and
    idle share, and the top ``row_limit`` ops by device time (none at
    0)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, ms = timed_step(step, batch)
    busy_ms = device_busy_ms(prof)
    log(f"{tag} torch.profiler, one step on the kernel route: {ms:.3f} ms "
        f"on the host clock, device busy {busy_ms:.3f} ms (idle share "
        f"{1.0 - busy_ms / ms:.3f})" + (":" if row_limit else ""))
    if row_limit:
        log(prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=row_limit))


def train_light_routes(tag, steps, batch, n_steps, row_limit):
    """The lighting step on both routes from the same weights: step 1's
    checks, then ``n_steps`` timed steps a route that descend and launch
    each training kernel once a step on the kernel route, none on the
    plain route.  Returns {kernel: launches} of the kernel route's run."""
    check_first_step(steps, batch, tag)
    results = {}
    for route, step in steps.items():
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        totals, times = [], []
        for _ in range(n_steps):
            metrics, ms = timed_step(step, batch)
            times.append(ms)
            totals.append(float(metrics["total"]))
            bad = [k for k, v in metrics.items() if not torch.isfinite(v)]
            if bad:
                raise AssertionError(f"{route}: non-finite {bad}")
        launches = read_launches()
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        med, p90 = percentiles(times)
        log(f"{tag} {route} route, {n_steps} steps: ms/step "
            f"median {med:.3f} p90 {p90:.3f}; peak device memory "
            f"{peak_mib:.0f} MiB; total {totals[0]:.6g} -> {totals[-1]:.6g}; "
            f"launches {launches}")
        if not min(totals[1:]) < totals[0]:
            raise AssertionError(f"{route}: total did not fall: {totals}")
        results[route] = launches
    want = {"kernels": {**dict.fromkeys(KERNELS, n_steps),
                        "render_sg_env": 0, "bilateral_blur": 0},
            "plain": dict.fromkeys(KERNELS, 0)}
    if results != want:
        raise AssertionError(f"launches {results}, expected {want}")
    profile_step(tag, steps["kernels"], batch, row_limit)
    return {k: v for k, v in results["kernels"].items()
            if k not in ("render_sg_env", "bilateral_blur")}


def light_steps(brdf, light, dev):
    """The lighting step on each route, from copies of the same weights."""
    return {route: make_light_train_step(copy.deepcopy(brdf),
                                         copy.deepcopy(light),
                                         use_kernels=flag, device=dev,
                                         lr=TRAIN_LR)
            for route, flag in (("kernels", True), ("plain", False))}


def phase_training(seed, dev):
    """Cascade-0 lighting training at full width, both routes from the
    same weights.  Returns {kernel: launches} of the kernel route's run."""
    # cuDNN's heuristic picks, for a B=5 f32 convolution with TF32 off, an
    # FFT algorithm that launches ~10^5 small complex GEMMs a step (1.3 s
    # a step); autotuning picks the fastest algorithm once per shape
    # (during step 1, before the timed steps)
    torch.backends.cudnn.benchmark = True
    log("[training] cudnn.benchmark on (autotuned convolution algorithms)")
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(seed + 2)
    brdf = BRDFNets(0, generator=gen)
    light = LightNets(sg_num=SG_NUM, env_rows=ENV_RC[0], env_cols=ENV_RC[1],
                      generator=gen)
    steps = light_steps(brdf, light, dev)
    batch = synthetic_batch(batch=TRAIN_B, im_hw=IM_HW, env_rc=ENV_RC,
                            sg_num=SG_NUM, seed=seed, device=dev)
    h, w = steps["kernels"].light_nets.light_hw
    log(f"[training] B={TRAIN_B}, image {IM_HW[0]}x{IM_HW[1]}, grid "
        f"{ENV_RC[0]}x{ENV_RC[1]}, light input {h}x{w}, K={SG_NUM}, "
        f"lr {TRAIN_LR}: {time.perf_counter() - t0:.1f} s (set-up)")
    return train_light_routes("[training]", steps, batch, N_TRAIN_STEPS, 25)


def check_first_bs_step(steps, batch, tag="[bilateral training]"):
    """Both routes' bilateral losses and confidence-net gradients on one
    batch, before any update.  Returns the kernel route's vertex counts."""
    out = {}
    for route, step in steps.items():
        total, losses, stats = step.loss(batch)
        total.backward()
        out[route] = (losses, stats, {n: p.grad.clone() for n, p in
                                      step.bs_nets.named_parameters()})
        step.optimizer.zero_grad(set_to_none=True)
    (lk, sk, gk), (lp, sp, gp) = out["kernels"], out["plain"]
    nverts = {k: v["nvert"].tolist() for k, v in sk.items()}
    if nverts != {k: v["nvert"].tolist() for k, v in sp.items()}:
        raise AssertionError(f"grids differ between routes: {sk} vs {sp}")
    dist = {k: abs(lk[k].item() / lp[k].item() - 1.0) for k in lp}
    grads = {n: rel_l2(gk[n], gp[n]) for n in gp}
    worst = max(grads, key=grads.get)
    log(f"{tag} step 1, kernel route vs plain route: "
        + ", ".join(f"{k} {v.item():.6g}" for k, v in lk.items())
        + "; relative differences "
        + ", ".join(f"{k} {v:.3e}" for k, v in dist.items())
        + f"; worst gradient relative L2 {grads[worst]:.3e} ({worst})")
    if not max(dist.values()) <= BS_STEP1_TOL["losses"]:
        raise AssertionError(f"step 1 losses: {dist}")
    if not grads[worst] <= BS_STEP1_TOL["grads"]:
        raise AssertionError(f"step 1 gradient {worst}: {grads[worst]}")
    return nverts


def train_bs_routes(tag, brdf, bs_nets, batch, n_steps, row_limit, dev):
    """The bilateral step on both routes from the same weights: step 1's
    checks, then ``n_steps`` timed steps a route that descend and launch
    ``bilateral_blur`` 103 times an image a step on the kernel route.
    Returns {kernel: launches} of the kernel route's run."""
    steps = {route: make_bilateral_train_step(
                 copy.deepcopy(brdf), copy.deepcopy(bs_nets),
                 use_kernels=flag, device=dev, lr=TRAIN_LR)
             for route, flag in (("kernels", True), ("plain", False))}
    nverts = check_first_bs_step(steps, batch, tag)
    log(f"{tag} grid vertices per image: {nverts}")

    per_step = batch["im"].shape[0] * (BLURS_FWD + BLURS_GRAD)
    results = {}
    for route, step in steps.items():
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        totals, times = [], []
        for _ in range(n_steps):
            metrics, ms = timed_step(step, batch)
            times.append(ms)
            totals.append(float(metrics["total"]))
            bad = [k for k, v in metrics.items()
                   if not torch.isfinite(v.float())]
            if bad:
                raise AssertionError(f"{route}: non-finite {bad}")
        launches = read_launches()
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        med, p90 = percentiles(times)
        log(f"{tag} {route} route, {n_steps} steps: "
            f"ms/step median {med:.3f} p90 {p90:.3f}; peak device memory "
            f"{peak_mib:.0f} MiB; total {totals[0]:.6g} -> {totals[-1]:.6g} "
            f"(min {min(totals):.6g}); bilateral_blur launches "
            f"{launches['bilateral_blur']} ({per_step} a step expected)")
        if not min(totals[1:]) < totals[0]:
            raise AssertionError(f"{route}: total did not fall: {totals}")
        results[route] = launches
    want = {"kernels": {**dict.fromkeys(KERNELS, 0),
                        "bilateral_blur": per_step * n_steps},
            "plain": dict.fromkeys(KERNELS, 0)}
    if results != want:
        raise AssertionError(f"launches {results}, expected {want}")
    profile_step(tag, steps["kernels"], batch, row_limit)
    return {"bilateral_blur": results["kernels"]["bilateral_blur"]}


def phase_bilateral_training(seed, dev):
    """The bilateral train step at full width, both routes from the same
    weights.  Returns {kernel: launches} of the kernel route's run."""
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(seed + 3)
    brdf, bs_nets = BRDFNets(0, generator=gen), BilateralNets(gen)
    batch = synthetic_batch(batch=BS_TRAIN_B, im_hw=IM_HW, env_rc=ENV_RC,
                            sg_num=SG_NUM, seed=seed + 3, device=dev)
    log(f"[bilateral training] B={BS_TRAIN_B}, image {IM_HW[0]}x{IM_HW[1]}, "
        f"frozen cascade-0 BRDF nets, lr {TRAIN_LR}: "
        f"{time.perf_counter() - t0:.1f} s (set-up)")
    return train_bs_routes("[bilateral training]", brdf, bs_nets, batch,
                           N_TRAIN_STEPS, 25, dev)


def check_brdf_f64(tag, nets, batch, dev, make_step=make_brdf_train_step,
                   tol=BRDF_F64_TOL):
    """Step 1 of a BRDF-nets step (``make_step``: the BRDF step or a
    fine-tune step) on a B=2 slice of the batch, in f32 and in float64 (a
    ``.double()`` copy of the nets and of the slice's float tensors),
    before any update: the losses and each net's gradient (a net the loss
    does not reach has none in either)."""
    sl = {k: v[:2] for k, v in batch.items()}
    out = {}
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        step = make_step(copy.deepcopy(nets).to(dtype), device=dev)
        total, errors = step.loss({k: v.to(dtype) if v.is_floating_point()
                                   else v for k, v in sl.items()})
        total.backward()
        grads = {}
        for n in BRDF_NETS:
            gs = [p.grad for pn, p in step.brdf_nets.named_parameters()
                  if pn.startswith(n + ".") and p.grad is not None]
            if gs:
                grads[n] = torch.cat([g.double().flatten() for g in gs])
        out[name] = ({k: v.item() for k, v in errors.items()}, grads)
        del step
    (e32, g32), (e64, g64) = out["f32"], out["f64"]
    if sorted(g32) != sorted(g64):
        raise AssertionError(f"{tag} nets reached: {sorted(g32)} in f32, "
                             f"{sorted(g64)} in float64")
    dist = {k: abs(e32[k] / e64[k] - 1.0) for k in e64}
    grads = {n: rel_l2(g32[n], g64[n]) for n in g64}
    log(f"{tag} step 1 on a B=2 slice, f32 vs float64: errors "
        + ", ".join(f"{k} {v:.6g}" for k, v in e32.items())
        + "; relative differences "
        + ", ".join(f"{k} {v:.3e}" for k, v in dist.items())
        + "; gradient relative L2 "
        + ", ".join(f"{k} {v:.3e}" for k, v in grads.items()))
    if not max(dist.values()) <= tol["errors"]:
        raise AssertionError(f"{tag} step 1 errors vs float64: {dist}")
    if not max(grads.values()) <= tol["grads"]:
        raise AssertionError(f"{tag} step 1 gradients vs float64: {grads}")


def brdf_conv_flops(nets, batch):
    """The convolution FLOPs of one BRDF step on ``batch`` (forward and
    backward; torch.utils.flop_counter on a copy of the nets on the meta
    device)."""
    from torch.utils.flop_counter import FlopCounterMode

    meta = copy.deepcopy(nets).to("meta")
    b, h, w, _ = batch["im"].shape
    im = torch.zeros(b, 3, h, w, device="meta")
    inp = torch.zeros(b, meta.encoder.conv1.in_channels, h, w, device="meta")
    with FlopCounterMode(display=False) as counter:
        sum(v.sum() for v in meta(im, inp).values()).backward()
    return counter.get_total_flops()


def train_brdf(tag, nets, batch, dev, row_limit=None):
    """BRDF training at full width: step 1 against float64, then
    N_TRAIN_STEPS steps that descend and launch no kernel.  Step 1
    autotunes the convolutions and is timed apart; the median, p90 and
    peak memory are of the steps after it.  Returns the trained nets."""
    check_brdf_f64(tag, nets, batch, dev)
    step = make_brdf_train_step(nets, device=dev, lr=TRAIN_LR)
    reset_launches()
    metrics, first_ms = timed_step(step, batch)
    totals, times = [float(metrics["total"])], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(N_TRAIN_STEPS - 1):
        metrics, ms = timed_step(step, batch)
        times.append(ms)
        totals.append(float(metrics["total"]))
        bad = [k for k, v in metrics.items() if not torch.isfinite(v)]
        if bad:
            raise AssertionError(f"{tag}: non-finite {bad}")
    launches = read_launches()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    med, p90 = percentiles(times)
    flops = brdf_conv_flops(nets, batch)
    log(f"{tag} {N_TRAIN_STEPS} steps: step 1 (autotuning) {first_ms:.1f} "
        f"ms, then ms/step median {med:.3f} p90 {p90:.3f}; peak device "
        f"memory {peak_mib:.0f} MiB; total {totals[0]:.6g} -> "
        f"{totals[-1]:.6g}; launches {launches}; convolutions "
        f"{flops / 1e12:.3f} TFLOP a step, {flops / med / 1e9:.1f} TFLOP/s "
        "at the median")
    if not min(totals[1:]) < totals[0]:
        raise AssertionError(f"{tag}: total did not fall: {totals}")
    if launches != dict.fromkeys(KERNELS, 0):
        raise AssertionError(f"{tag}: launches {launches}, expected none")
    if row_limit:
        profile_step(tag, step, batch, row_limit)
    return step.brdf_nets


def check_export(products):
    """The two routes' products of one batch: the BRDF maps and the SG
    tensor bit-equal (no kernel runs before them), diffuse and specular
    within the serving tolerances."""
    (pk, lk), (pp, lp) = products["kernels"], products["plain"]
    for k in ("albedo", "normal", "rough", "depth", "env"):
        if not torch.equal(pk[k], pp[k]):
            raise AssertionError(f"export {k} differs between routes")
    errs = {"diffuse": check_close("export diffuse", pk["diffuse"],
                                   pp["diffuse"], *CHAIN_TOL["diffuse"]),
            "specular": check_rel_l1("export specular", pk["specular"],
                                     pp["specular"], SPECULAR_REL_L1)}
    for k, v in pk.items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"export {k}: non-finite")
    log("[cascade] export, kernel route vs plain route: BRDF maps and env "
        "bit-equal; max abs err "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + "; losses " + ", ".join(f"{k} {v.item():.6g}"
                                  for k, v in lk.items()))


def export_routes(brdf, light, batch):
    """export_step on each route; each compared call launches one
    render_sg_fwd and one sg_envmap_fwd on the kernel route, none on the
    plain route.  Returns ({route: (products, losses)}, {kernel:
    launches} of the kernel route's compared call)."""
    products, counted = {}, {}
    for route, flag in (("kernels", True), ("plain", False)):
        export_step(brdf, light, batch, use_kernels=flag)  # autotuning
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        products[route] = export_step(brdf, light, batch, use_kernels=flag)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = read_launches()
        want = dict.fromkeys(KERNELS, 0)
        if flag:
            want.update(render_sg_fwd=1, sg_envmap_fwd=1)
        if launches != want:
            raise AssertionError(f"export {route}: launches {launches}, "
                                 f"expected {want}")
        counted[route] = launches
        log(f"[cascade] export B={batch['im'].shape[0]}, {route} route: "
            f"{ms:.3f} ms; launches {launches}")
    check_export(products)
    return products, counted["kernels"]


def hand_off(products, batch):
    """The cascade-1 batch: ``batch`` with the previous cascade's maps
    from the exported products (``normalize_cascade_pre``, the reader's
    arithmetic, on the host) and ``env_pre``, the SG tensor."""
    b = batch["im"].shape[0]
    pre = [normalize_cascade_pre({
        key: products[key[:-len("_pre")]][n].permute(2, 0, 1).cpu().numpy()
        for key in PRE_STEMS}) for n in range(b)]
    dev = batch["im"].device
    c1 = dict(batch)
    for key in PRE_STEMS:
        c1[key] = torch.as_tensor(np.stack([p[key] for p in pre]),
                                  device=dev)
    c1["env_pre"] = products["env"].contiguous()
    for key in (*PRE_STEMS, "env_pre"):
        if not torch.isfinite(c1[key]).all():
            raise AssertionError(f"hand-off {key}: non-finite")
    means = {k: c1[k].reshape(b, -1).mean(dim=1)
             for k in ("albedo_pre", "depth_pre")}
    for k, m in means.items():
        check_close(f"hand-off {k} mean", m, torch.full_like(m, 1 / 3),
                    1e-4, 0.0)
    h5 = probe_import("h5py")
    log(f"[cascade] hand-off in memory: "
        + ", ".join(f"{k} {tuple(c1[k].shape)}" for k in (*PRE_STEMS,
                                                          "env_pre"))
        + "; per-image means of albedo_pre / depth_pre "
        + " / ".join(f"{float(m.min()):.7f}-{float(m.max()):.7f}"
                     for m in means.values())
        + f"; files are not written here ({h5})")
    return c1


def phase_cascade(seed, dev):
    """The staged recipe across the cascade hand-off at full width.
    Returns {kernel: launches} of the kernel routes' runs."""
    torch.backends.cudnn.benchmark = True
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(seed + 4)
    brdf0 = BRDFNets(0, generator=gen)
    light0 = LightNets(sg_num=SG_NUM, env_rows=ENV_RC[0], env_cols=ENV_RC[1],
                       generator=gen)
    brdf1 = BRDFNets(1, generator=gen)
    light1 = LightNets(sg_num=SG_NUM, cascade_level=1, env_rows=ENV_RC[0],
                       env_cols=ENV_RC[1], generator=gen)
    bs_nets = BilateralNets(gen)
    batch = synthetic_batch(batch=BRDF_TRAIN_B, im_hw=IM_HW, env_rc=ENV_RC,
                            sg_num=SG_NUM, seed=seed + 4, device=dev)
    log(f"[cascade] B={BRDF_TRAIN_B}, image {IM_HW[0]}x{IM_HW[1]}, grid "
        f"{ENV_RC[0]}x{ENV_RC[1]}, K={SG_NUM}, lr {TRAIN_LR}, "
        f"cudnn.benchmark on: {time.perf_counter() - t0:.1f} s (set-up)")

    brdf0 = train_brdf("[cascade c0 brdf]", brdf0, batch, dev, row_limit=12)
    products, launches = export_routes(brdf0, light0.to(dev), batch)
    c1 = hand_off(products["kernels"][0], batch)
    del products

    def head(n):
        return {k: v[:n] for k, v in c1.items()}

    runs = [train_light_routes("[cascade c1 light]",
                               light_steps(brdf1, light1, dev),
                               head(TRAIN_B), N_TRAIN_STEPS, 12)]
    train_brdf("[cascade c1 brdf]", copy.deepcopy(brdf1), c1, dev)
    runs.append(train_bs_routes("[cascade c1 bs]", brdf1, bs_nets,
                                head(BS_TRAIN_B), N_BS_C1_STEPS, 0, dev))
    for run in runs:
        for name, n in run.items():
            launches[name] += n
    return launches, (brdf0, light0, batch, c1)


# ---------------------------------------------------------------- phase 8


def fine_tune_batches(seed, dev):
    """The IIW batch (``IIW_MAX_NUM`` rows a kind, the loader's format)
    with its judgements, and the NYU batch (ground truth at image size,
    the loader's output size), B=BRDF_TRAIN_B, from ``seed``."""
    iiw, judgements = synthetic_iiw_batch(batch=BRDF_TRAIN_B, im_hw=IM_HW,
                                          max_num=IIW_MAX_NUM, seed=seed,
                                          device=dev)
    nyu = synthetic_nyu_batch(batch=BRDF_TRAIN_B, im_hw=IM_HW, seed=seed + 1,
                              device=dev)
    n = {k: iiw[f"{k}_num"].cpu().numpy() for k in ("eq", "darker")}
    log(f"[fine-tune] IIW B={BRDF_TRAIN_B}, {IIW_MAX_NUM} rows a kind, "
        "rows in use (dummy counted) eq "
        f"{n['eq'].min()}-{n['eq'].max()}, darker {n['darker'].min()}-"
        f"{n['darker'].max()}; NYU ground truth {tuple(nyu['depth'].shape)}, "
        f"seg_depth {float(nyu['seg_depth'].mean()):.4f}, seg_normal "
        f"{float(nyu['seg_normal'].mean()):.4f}")
    return {"iiw": iiw, "nyu": nyu}, judgements


def scores(nets, batches, judgements, synth=None):
    """The benchmark metrics of ``nets``' predictions on the fine-tune
    batches: WHDR (mean over the images) against the IIW judgements, and
    the masked normal angle (mean of the images' means) and si-log depth
    RMSE (mean) of ``nyu_step``'s full-size predictions against the NYU
    ground truth.  ``synth`` maps a dataset to its cascade-1 batch."""
    synth = synth or {}
    with torch.no_grad():
        albedo = brdf_forward(nets, synth.get("iiw", batches["iiw"]))[
            "albedo"].cpu().double().numpy()
        preds, _ = nyu_step(nets, synth.get("nyu", batches["nyu"]))
    nyu = {k: v.cpu().double().numpy() for k, v in batches["nyu"].items()}
    normal = preds["normal_full"].cpu().double().numpy()
    depth = preds["depth_full"].cpu().double().numpy()
    whdr = [w[0] for w in map(compute_whdr, albedo, judgements)
            if w is not None]  # None: an image without a judgement
    angle = [normal_angle_error(normal[i], nyu["normal"][i],
                                nyu["seg_normal"][i, ..., 0])[0]
             for i in range(len(normal))]
    silog = [si_log_depth_rmse(depth[i, ..., 0], nyu["depth"][i, ..., 0])
             for i in range(len(depth))]
    out = {"whdr": float(np.mean(whdr)), "angle_deg": float(np.mean(angle)),
           "si_log": float(np.mean(silog))}
    ok = (0.0 <= min(whdr) and max(whdr) <= 1.0 and 0.0 <= min(angle)
          and max(angle) <= 180.0 and all(np.isfinite(silog)))
    if not ok or not all(np.isfinite(list(out.values()))):
        raise AssertionError(f"metrics out of range: whdr {whdr}, angle "
                             f"{angle}, si-log {silog}")
    return out


def fit_scales(brdf0, light0, im, pre):
    """Per image, the scale the ``ls_regress_diff_spec`` fit gave the
    rendered diffuse and specular: the synthesized map over the plain
    render of the same predictions (its least-squares ratio)."""
    r, c = light0.env_rows, light0.env_cols
    with torch.no_grad():
        preds = dict(brdf_forward(brdf0, {"im": im}))
        for k in ("albedo", "depth"):
            preds[k] = mean_normalize(preds[k])
        sg_out = light_forward(light0, im, preds)
        raw = sg_render.render_sg_plain(
            *(pool_nhwc(preds[k], (r, c)) for k in ("albedo", "normal",
                                                     "rough")),
            sg_out["axis"], sg.unsquash(sg_out["lamb01"]),
            sg.unsquash(sg_out["weight01"]), env_height=light0.env_height,
            env_width=light0.env_width)
    b = im.shape[0]
    return {k: (torch.sum((pre[f"{k}_pre"] * x).reshape(b, -1), 1)
                / torch.sum((x * x).reshape(b, -1), 1))
            for k, x in zip(("diffuse", "specular"), raw)}


def synth_routes(tag, brdf0, light0, batch):
    """``synthesize_pre`` on each route: one ``render_sg_fwd`` launch on
    the kernel route, none on the plain route; the BRDF maps and
    ``env_pre`` bit-equal, diffuse and specular at the serving
    tolerances; the fit's scales logged.  Returns the kernel route's
    batch and its launches."""
    out, counted = {}, {}
    for route, flag in (("kernels", True), ("plain", False)):
        synthesize_pre(brdf0, light0, batch, use_kernels=flag)  # autotuning
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out[route] = synthesize_pre(brdf0, light0, batch, use_kernels=flag)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counted[route] = read_launches()
        want = {**dict.fromkeys(KERNELS, 0), "render_sg_fwd": int(flag)}
        if counted[route] != want:
            raise AssertionError(f"{tag} synthesis {route}: launches "
                                 f"{counted[route]}, expected {want}")
        log(f"{tag} synthesize_pre B={batch['im'].shape[0]}, {route} route: "
            f"{ms:.3f} ms; launches {counted[route]}")
    k, p = out["kernels"], out["plain"]
    for key in PRE_KEYS:
        if not torch.isfinite(k[key]).all() or k[key].requires_grad:
            raise AssertionError(f"{tag} {key}: non-finite or not detached")
    for key in ("albedo_pre", "normal_pre", "rough_pre", "depth_pre",
                "env_pre"):
        if not torch.equal(k[key], p[key]):
            raise AssertionError(f"{tag} {key} differs between routes")
    errs = {"diffuse": check_close(f"{tag} diffuse_pre", k["diffuse_pre"],
                                   p["diffuse_pre"], *CHAIN_TOL["diffuse"]),
            "specular": check_rel_l1(f"{tag} specular_pre", k["specular_pre"],
                                     p["specular_pre"], SPECULAR_REL_L1)}
    scales = {route: fit_scales(brdf0, light0, batch["im"], o)
              for route, o in out.items()}
    # an image's scale against the batch's largest: the fit clamps the
    # specular coefficient at 0, and near it an image's own relative
    # difference is ill-conditioned (logged beside)
    diff, own, zeros = {}, {}, {}
    for m, sk in scales["kernels"].items():
        sp = scales["plain"][m]
        zero = (sk == 0) & (sp == 0)  # the fit dropped specular
        zeros[m] = int(zero.sum())
        own[m] = float(torch.where(zero, 0.0, (sk / sp - 1.0).abs()).max())
        diff[m] = float((sk - sp).abs().max()
                        / torch.clamp(sp.abs().max(), min=1e-30))
    log(f"{tag} synthesis, kernel route vs plain route: BRDF maps and "
        "env_pre bit-equal; max abs err "
        + ", ".join(f"{m} {v:.3e}" for m, v in errs.items())
        + "; the fit's scales over the images (kernel route) "
        + ", ".join(f"{m} {float(v.min()):.5g}-{float(v.max()):.5g}"
                    for m, v in scales["kernels"].items())
        + "; largest difference of an image's scale between routes over "
        "the largest scale " + ", ".join(f"{m} {v:.3e}"
                                         for m, v in diff.items())
        + " (over its own scale " + ", ".join(f"{m} {v:.3e}"
                                              for m, v in own.items())
        + f"; {zeros['specular']} image(s) with specular scale 0 on both)")
    if not max(diff.values()) <= SCALE_RTOL:
        raise AssertionError(f"{tag} fit scales differ between routes: "
                             f"{diff}")
    return k, counted["kernels"]


def fine_tune_cycles(tag, real_cls, nets, syn_batch, real_batch, dev,
                     synth=None, pre=None):
    """``N_FT_CYCLES`` cycles of the fine-tune: the synthetic BRDF step,
    then the real-data step, on one Adam and schedule.  ``synth``: the
    cascade-1 synthesis of the real-data batch, timed apart, run every
    cycle as the fine-tune CLIs do; ``pre``: its result, on which step 1 of
    the real-data step is held against float64 first.  Cycle 1 (cuDNN
    autotuning) is timed apart.  Returns the trained nets and the
    launches of the run."""
    check_brdf_f64(tag, nets, real_batch if pre is None else pre, dev,
                   make_step=real_cls, tol=FINETUNE_F64_TOL)
    syn = make_brdf_train_step(nets, device=dev, lr=TRAIN_LR)
    step = real_cls(nets, device=dev, optimizer=syn.optimizer,
                    scheduler=syn.scheduler)
    times = {"synthetic": [], "real": [], "synthesis": [], "cycle": []}
    totals, real = [], real_batch
    peaks = {"cycle": 0, "real": 0, "resident": 0}
    reset_launches()
    for _ in range(N_FT_CYCLES):
        torch.cuda.reset_peak_memory_stats()
        _, syn_ms = timed_step(syn, syn_batch)
        synth_ms = 0.0
        if synth:
            real, synth_ms = timed_step(synth, real_batch)
        peaks["cycle"] = max(peaks["cycle"], torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        peaks["resident"] = max(peaks["resident"],
                                torch.cuda.memory_allocated())
        metrics, real_ms = timed_step(step, real)
        peaks["real"] = max(peaks["real"], torch.cuda.max_memory_allocated())
        peaks["cycle"] = max(peaks["cycle"], peaks["real"])
        bad = [k for k, v in metrics.items() if not torch.isfinite(v)]
        if bad:
            raise AssertionError(f"{tag}: non-finite {bad}")
        totals.append(float(metrics["total"]))
        for k, v in (("synthetic", syn_ms), ("real", real_ms),
                     ("synthesis", synth_ms),
                     ("cycle", syn_ms + synth_ms + real_ms)):
            times[k].append(v)
    launches = read_launches()
    want = {**dict.fromkeys(KERNELS, 0),
            "render_sg_fwd": N_FT_CYCLES if synth else 0}
    log(f"{tag} {N_FT_CYCLES} cycles: cycle 1 (autotuning) "
        f"{times['cycle'][0]:.1f} ms, then ms median / p90 "
        + ", ".join(f"{k} {percentiles(v[1:])[0]:.3f} / "
                    f"{percentiles(v[1:])[1]:.3f}" for k, v in times.items()
                    if any(v))
        + f"; peak device memory {peaks['cycle'] / 2**20:.0f} MiB (the "
        f"real-data step {peaks['real'] / 2**20:.0f}, "
        f"{peaks['resident'] / 2**20:.0f} of it resident before the step); "
        "real-data total "
        f"{totals[0]:.6g} -> {totals[-1]:.6g} (min {min(totals):.6g}); "
        f"launches {launches}")
    if not min(totals[1:]) < totals[0]:
        raise AssertionError(f"{tag}: real-data total did not fall: {totals}")
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches}, expected {want}")
    profile_step(tag, step, real, 0)
    return nets, launches


def phase_finetune(seed, dev, brdf0, light0, syn0, syn1):
    """The IIW and NYU fine-tunes at both cascades, full width.  ``brdf0``
    / ``light0``: phase 7's cascade-0 stack, frozen here; ``syn0`` /
    ``syn1``: phase 7's cascade-0 and cascade-1 synthetic batches.
    Returns {kernel: launches} of the run."""
    t0 = time.perf_counter()
    batches, judgements = fine_tune_batches(seed + 8, dev)
    gen = torch.Generator().manual_seed(seed + 8)
    init = {0: BRDFNets(0, generator=gen).to(dev),
            1: BRDFNets(1, generator=gen).to(dev)}
    brdf0.requires_grad_(False)
    light0.requires_grad_(False)
    log(f"[fine-tune] seeded c0 and c1 BRDF nets, phase 7's c0 stack "
        f"frozen: {time.perf_counter() - t0:.1f} s (set-up)")
    launches = dict.fromkeys(KERNELS, 0)
    pre = {}  # dataset -> its cascade-1 batch (the kernel route's)
    for name, batch in batches.items():
        pre[name], counted = synth_routes(f"[fine-tune c1 {name}]", brdf0,
                                          light0, batch)
        for k, n in counted.items():
            launches[k] += n
    before = {lvl: scores(init[lvl], batches, judgements,
                          pre if lvl else None) for lvl in (0, 1)}
    classes = {"iiw": make_iiw_train_step, "nyu": make_nyu_train_step}
    for lvl, syn_batch in ((0, syn0), (1, syn1)):
        trained = {}
        for name, cls in classes.items():
            trained[name], counted = fine_tune_cycles(
                f"[fine-tune c{lvl} {name}]", cls, copy.deepcopy(init[lvl]),
                syn_batch, batches[name], dev,
                synth=(lambda b: synthesize_pre(brdf0, light0, b)) if lvl
                else None, pre=pre[name] if lvl else None)
            for k, n in counted.items():
                launches[k] += n
        after = {m: scores(trained[m], batches, judgements,
                           pre if lvl else None)
                 for m in classes}
        log(f"[fine-tune c{lvl}] metrics (random-weight numbers, not "
            "quality): before "
            + ", ".join(f"{k} {v:.5g}" for k, v in before[lvl].items())
            + "; after the IIW cycles whdr "
            f"{after['iiw']['whdr']:.5g}; after the NYU cycles angle_deg "
            f"{after['nyu']['angle_deg']:.5g}, si_log "
            f"{after['nyu']['si_log']:.5g}")
    return launches


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = phase_device()
    ptxas = phase_build()
    records = phase_kernels(args.seed, dev, ptxas)
    launches = phase_serving(args.seed)
    launches.update(phase_training(args.seed, dev))
    # bilateral_blur's count: the serving run's and the bilateral training
    # runs' together
    launches["bilateral_blur"] += phase_bilateral_training(
        args.seed, dev)["bilateral_blur"]
    # the cascade recipe's launches: the export's, the cascade-1 light and
    # bilateral steps'
    cascade, stack = phase_cascade(args.seed, dev)
    for name, n in cascade.items():
        launches[name] += n
    # the fine-tunes' launches: the cascade-1 syntheses'
    for name, n in phase_finetune(args.seed, dev, *stack).items():
        launches[name] += n
    for name, record in records.items():
        record["launches"] = launches[name]
    log(smi)
    log(json.dumps({"kernels": list(records.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
