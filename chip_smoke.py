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
     the envmap backward are logged), with bounds and, at the main-path
     shape, with times by device time (the profiler's kernel intervals)
     and by CUDA events around a run of launches; the bilateral blur bit for bit on
     the grid of a noisy 240x320 guide at C=3 and C=1 and on a ragged
     10x13 one, with the time of torch.sparse.mm beside it;
  4. serving: the two-cascade ``InverseRenderer`` (level 2, lighting on,
     bilateral refinement of both levels with seeded random confidence
     nets) at the reference operating point (image 240x320, lighting grid
     120x160, 12 SG lobes, 8x16 envmap) with seeded random weights; the
     launch counts show the requests went through ``render_sg_env`` and
     ``bilateral_blur``, each cascade's lighting and refinement agree with
     the plain route on the same inputs, and the plain route end to end
     gives the same cascade-0 maps (on the first 10 requests);
 4b. fused serving, right after phase 4 (before phase 5 turns cuDNN's
     autotuning on): ``InverseRenderer(fused=True)`` (the scale fit
     traced per image) on phase 4's nets and operating point: 3 B=1
     requests against the staged mode (predictions atol 2e-5, scales
     rtol 1e-2, envmap and refinement at phase 4's tolerances), a B=4
     batch against its images alone (c_light rtol 1e-4, the scales not
     all equal, each refined map against the image's own refinement of
     the batch's maps atol 1e-5), the counted launches (2
     ``render_sg_env`` a call at B=1 and B=4, 2 * 68 blurs an image, and
     the kernels by name in a profiled B=1 call), the chain on both
     routes under ``torch.cuda.set_sync_debug_mode("error")``, fused and
     staged ms a request in turns, ms a batch and an image at B=4, the
     idle share, peak memory; and the chain
     exported with ``InverseRenderer.serialize`` at B=1 and served by
     ``deserialize_chain`` (c_light rtol 1e-5, albedo atol 1e-6);
  5. training: the cascade-0 lighting train step at full width (B=5, image
     240x320, grid 120x160, light input 480x640) from the same seeded
     weights on the kernel route and the plain route; step 1's losses
     and light gradients agree, then 5 steps on each route are timed,
     descend, and launch each training kernel once a step on the kernel
     route;
  6. bilateral training: the bilateral train step at full width (B=2,
     image 240x320, frozen cascade-0 BRDF nets), both routes from the
     same seeded weights; step 1's losses and confidence-net gradients
     agree, then 5 steps on each route are timed, descend, and launch
     ``bilateral_blur`` 103 times an image a step on the kernel route;
  7. cascade recipe: the staged training recipe across the cascade
     hand-off at full width, seeded weights: 10 cascade-0 BRDF steps
     (B=16, step 1's errors and per-net gradients against a float64 copy
     on a B=2 slice), then the step's loss and backward twice from the
     trained state under ``torch.use_deterministic_algorithms(True)``,
     every net's gradients bit-equal (ROADMAP C17); the cascade-0 export of that batch on both routes
     (the BRDF products and the SG tensor bit-equal, diffuse and specular
     within the serving tolerances, one ``render_sg_fwd`` and one
     ``sg_envmap_fwd`` launch on the kernel route); the hand-off of the
     kernel route's products in memory through ``normalize_cascade_pre``
     into the cascade-1 ``*_pre`` and ``env_pre`` maps; then, as phase 5,
     the cascade-1 lighting step (B=5, 5 steps a route), as part 1 the
     cascade-1 BRDF step (B=16, the 17-channel encoder), and as phase 6
     the cascade-1 bilateral step (B=2, 5 steps a route);
  8. fine-tunes: the IIW and NYU fine-tunes at full width (B=16, IIW
     batches of 800 rows a kind in the loader's format, NYU ground truth
     at 240x320, both from the seed), seeded weights, 5 cycles each of
     the synthetic BRDF step (phase 7's batch) and the real-data step on
     one Adam, at cascade 0 (no kernel) and at cascade 1, where the
     frozen cascade-0 stack of phase 7 synthesizes the ``*_pre`` maps
     every cycle (one ``render_sg_fwd`` launch); step 1 of each real-data
     step against a float64 copy on a B=2 slice; the synthesis on both
     routes (the BRDF maps and ``env_pre`` bit-equal, diffuse and
     specular within the serving tolerances, the fit's scales logged);
     WHDR against the batch's judgements, normal angle and si-log depth
     RMSE against the NYU ground truth, before and after the cycles
     (random-weight numbers, held only to their ranges);
  9. from disk: the port's fixture writers into a temp dir outside the
     checkout (OpenRooms at 240x320 with 1920x5120 envmaps, 16 TRAIN
     images; IIW and NYU of 16 frames), run by a process of their own
     while phases 3-8 use the card, the native envmap decoder bit-equal
     to cv2's (a cv2 fallback fails the run), the light loader's items a
     second, ``train_brdf`` (B=16, process workers, step
     checkpoints; then B=4 killed after a step checkpoint and resumed),
     ``train_light`` on its checkpoint on both routes, one IIW and one NYU loader batch through the fine-tune
     steps;
 10. the other CLIs from disk, on phase 9's fixtures and checkpoints:
     ``build_cache --light`` and ``train_light --itemCache`` (2 epochs;
     the first cached batch against the direct loader under the cache's
     contract); ``train_bilateral`` on both routes (step 1's losses
     within phase 6's tolerance, ``bilateral_blur`` 103 times an image a
     step); ``output_brdf_light`` at cascade 0 (one ``render_sg_fwd`` and
     one ``sg_envmap_fwd`` a batch), its files written and read by the
     port's HDF5 codec (``utils/h5.py``), the first batch's read back
     through ``load_cascade_pre`` / ``load_env_pre`` bit-equal to
     ``normalize_cascade_pre`` on the products computed in memory, and the
     codec's round trip and times on the host; cascade 1 from those files:
     ``train_brdf``, ``train_light`` and ``train_bilateral`` (2 steps
     each, the last two on the first's checkpoint) and ``test_synthetic
     --stage light``; ``train_finetune_iiw`` at cascade 0 and
     ``train_finetune_nyu`` at cascade 1 (its ``*_pre`` synthesis one
     ``render_sg_fwd`` a cycle); ``test_real --level 2
     --isLight --isBS`` on 2 photos (2 ``render_sg_env`` launches a
     photo; the first photo's lighting and refinement against the plain
     route at the serving tolerances); ``test_synthetic`` at its three
     stages; ``compare`` on test_real's outputs (WHDR in [0, 1], angles
     in [0, 180]).  Each cell's times beside the card's name and power
     limit;
 11. bf16, the JAX CLIs' default compute dtype, at full width: the c0
     BRDF step (B=16, 240x320) and the c0 light step (B=5, grid 120x160,
     light input 480x640, K=12, frozen f32 BRDF nets as in
     ``train_light``) from the same weights and batch in float32 and
     bfloat16: step 1's loss in bf16 within 2% (BRDF) and 5% (light) of
     float32's, each training kernel launched once a light step,
     float32 params, gradients and heads; step time, peak memory and
     the BRDF step's conv TFLOP/s of both dtypes; each kernel wrapper
     raises on a bf16 CUDA input; ``test_real --computeDtype bfloat16
     --level 2 --isLight --isBS`` on phase 10's first photo (finite
     outputs, phase 10's launches a photo; the products' host writes,
     phase 10's code, left out);
 12. the learning gate: ``cli/run_convergence.py`` at the JAX gate's
     configuration (tests/test_convergence.py:37-51: 64x64, 2 scenes of
     8, brdf 32 epochs at B=4, light 12 at B=2, bilateral 2 at B=2 with
     ``--bsMid``, IIW 2 at B=2, ``--capstone``) in bf16, in a temp dir,
     under ``torch.use_deterministic_algorithms(True)`` (an op without a
     deterministic path raises; the CLIs then keep cuDNN's autotuning
     off), so the run repeats bit for bit: the digest of its stages is
     logged; held to that test's assertions (``run_convergence.gate``);
 13. data-parallel training: ``parallel/dryrun.py`` as two ranks, each
     its own process, sharing the card over gloo (NCCL refuses two ranks
     on one device) with ``cudnn.benchmark`` off, one step of each of the
     eight train-step families of ``__graft_entry__.dryrun_multichip``
     (the cascade-0 light step at phase 5's operating point, the rest at
     that function's shapes; seeded confidence nets), global batch 4, two
     rows a rank: the ranks' metrics and updated parameters bit-equal,
     each family against the same step in one process on the whole
     batch (metrics rtol 2e-4, bilateral 5e-4; parameters within 3e-4),
     each training kernel once a light step and ``bilateral_blur`` 103
     times an image a bilateral step on each rank; ms a step of the two
     ranks' and of one process's c0 light step, the time in all_reduce,
     peak memory a rank (logged); then, in the same rank processes,
     data-parallel serving: the level-2 fused renderer with lighting and
     seeded confidence nets at both levels, at phase 4's operating
     point, serves each rank's 2 rows of a seeded batch of 4 through the
     group (``InverseRenderer(..., fused=True, group=g)``), against one
     process serving the 4 rows with ``group=None`` from the same
     weights: the ranks' weights equal, the scales within rtol 1e-4,
     maps, envmaps and diffuse at phase 4's tolerances, specular by
     relative L1 1e-3, each refined map bit-equal to the rank's own
     refinement of the group call's maps, the confidences (their maximum
     taken over the group) within rtol 1e-6, 2 ``render_sg_env`` and
     2 * 68 blurs an image on each rank; then a world of one on NCCL, in
     this process, takes the c0 light step and serves the batch of 4
     through its group, against the same with ``group=None``.
The second-to-last line of output is the kernels' JSON record, the last
``{"ok": true, "device": {...}}``.  Without a CUDA card it exits non-zero
before printing any result.
"""

from __future__ import annotations

import os

# cuBLAS adds without atomics only with a fixed workspace, which it reads
# when CUDA starts; phases 7 and 12 run under
# torch.use_deterministic_algorithms, which refuses cuBLAS without it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import argparse
import copy
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from inverserenderingofindoorscene_torch.cli import common as cli_common
from inverserenderingofindoorscene_torch.cli import (
    build_cache as cli_build_cache,
    run_convergence,
    compare as cli_compare,
    output_brdf_light as cli_output_brdf_light,
    test_real as cli_test_real,
    test_synthetic as cli_test_synthetic,
    train_bilateral as cli_train_bilateral,
    train_brdf as cli_train_brdf,
    train_finetune_iiw as cli_finetune_iiw,
    train_finetune_nyu as cli_finetune_nyu,
    train_light as cli_train_light,
)
from inverserenderingofindoorscene_torch.data.cache import (
    CachedOpenRoomsDataset,
)
from inverserenderingofindoorscene_torch.data import fixture
from inverserenderingofindoorscene_torch.data.iiw import IIWDataset
from inverserenderingofindoorscene_torch.data.nyu import NYUDataset
from inverserenderingofindoorscene_torch.data.openrooms import (
    PRE_STEMS,
    BatchIterator,
    OpenRoomsDataset,
    load_cascade_pre,
    load_env_pre,
    normalize_cascade_pre,
)
from inverserenderingofindoorscene_torch.native import hdr as native_hdr
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
from inverserenderingofindoorscene_torch.parallel import dryrun, multihost
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
    deserialize_chain,
    predict_light,
    predict_light_core,
    predict_light_traced,
    refine_bs,
)
from inverserenderingofindoorscene_torch.pipeline.light import (
    LightNets,
    light_forward,
    light_step,
)
from inverserenderingofindoorscene_torch.train.steps import (
    BilateralTrainStep,
    BRDFTrainStep,
    LightTrainStep,
    make_bilateral_train_step,
    make_brdf_train_step,
    make_iiw_train_step,
    make_light_train_step,
    make_nyu_train_step,
)
from inverserenderingofindoorscene_torch.utils import checkpoint as ckpt
from inverserenderingofindoorscene_torch.utils import h5
from inverserenderingofindoorscene_torch.utils.logging import MetricLogger

IM_HW = (240, 320)
ENV_RC = (120, 160)
SG_NUM = 12
# cut to fit the run: 100 before phase 10 was added, 50 before phases
# 11-12, 30 before phase 4b
N_REQUESTS = 20
# phase 4's plain route end to end: the first 5 requests (all of them
# before phase 4b was added, 10 before cli-export and cli-c1; cut to fit
# the run)
N_PLAIN_REQUESTS = 5
N_DIRS = 128  # the 8x16 envmap
# calls a phase-3 timing averages: a kernel's and the library call's 50,
# a plain version's 10 (the SG ones take milliseconds a call; 50 before
# phase 13 was added, cut to fit the run)
N_TIMED_CALLS = 50
N_TIMED_PLAIN_CALLS = 10
TRAIN_B = 5  # the JAX light-training CLI's batch
TRAIN_LR = 1e-4  # the reference's Adam rate
# phases 5 and 7 (20 before phase 4b was added, 10 before phase 13, cut
# to fit the run)
N_TRAIN_STEPS = 5
# phase 6 (20 before phase 10, 10 before phase 13, cut to fit the run)
BS_TRAIN_STEPS = 5
BS_TRAIN_B = 2  # the JAX bilateral-training CLI's batch
BRDF_TRAIN_B = 16  # the JAX CLIs' default batch (cli/common.py:34)
IIW_MAX_NUM = 800  # the IIW loader's rows a kind (data/iiw.py:25)
# cut to fit the run: 10 before phase 10 was added, 6 before phases 11-12
N_FT_CYCLES = 5
N_BS_C1_STEPS = 5  # 10 before phase 13, cut to fit the run
FIXTURE_IMAGES = 16  # phase 9: one TRAIN scene
CLI_WORKERS = 4  # the CLIs' default --numWorkers
CLI_RESUME_B = 4  # the kill-and-resume run: 4 steps an epoch
LIGHT_CLI_STEPS = 2
# train_brdf / train_light default to bfloat16, as the JAX CLIs do;
# phases 9-10 keep their float32 checks (the kill-and-resume's 1e-4, the
# routes' STEP1_TOL), and bf16 is phases 11-12's
F32 = ("--computeDtype", "float32")
# the killed-and-resumed train_brdf run's final weights against the
# uninterrupted run's, each net's relative L2 (cuDNN may pick another
# algorithm, or reduce in another order, between the runs)
RESUME_REL_L2 = 1e-4
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
    """(device ms, events ms) per call of each function (the kernel, its
    plain version and, for the blur, the library call): the device time
    goes into the record, both into the log."""
    calls = (N_TIMED_CALLS, N_TIMED_PLAIN_CALLS, N_TIMED_CALLS)
    return ([device_ms(fn, n) for fn, n in zip(fns, calls)],
            [events_ms(fn, n) for fn, n in zip(fns, calls)])


def check_close(name, got, want, rtol, atol):
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    max_err = float(err.max())
    if not torch.isfinite(got).all() or bool(bad.any()):
        idx = (bad | ~torch.isfinite(got)).flatten().nonzero().flatten()
        first = [(int(i), float(got.flatten()[i]), float(want.flatten()[i]))
                 for i in idx[:4]]
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside rtol={rtol} "
            f"atol={atol}; max abs err {max_err}; non-finite "
            f"{int((~torch.isfinite(got)).sum())}; the first (flat index, "
            f"got, want): {first}; want finite "
            f"{bool(torch.isfinite(want).all())}")
    return max_err


def check_rel_l1(name, got, want, tol):
    """sum|got - want| <= tol * sum|want|; returns the max abs error.  Two
    all-zero maps (a fit that dropped specular on both routes) are at
    distance 0."""
    diff, norm = float((got - want).abs().sum()), float(want.abs().sum())
    dist = 0.0 if diff == 0 else diff / norm if norm else float("inf")
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
        "nothing): " + ", ".join(probe_import(m) for m in ("PIL", "cv2")))
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
            if label != "main":
                # checked at every shape, timed at the main path's only
                # (every shape before phase 4b was added, cut to fit)
                log(f"[kernels] {name} {label} B={shape[0]} {shape[1]}x"
                    f"{shape[2]} K={shape[3]}: max abs err "
                    + ", ".join(f"{nm} {e:.3e}" for nm, e in errs.items()))
                del args, fns
                continue
            dev_ms, ev_ms = timings(fns)
            bound_ms, bound_by = bound(n_bytes, flops, bw, f32_peak)
            log_kernel(name, label, shape, errs, dev_ms, ev_ms, bound_ms,
                       bound_by, n_bytes, flops)
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
    """Returns {kernel: launches} of the serving path's run and the
    (stacks, bs_nets) it served with."""
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
    for (im, im_small), p0 in list(zip(requests, preds0))[:N_PLAIN_REQUESTS]:
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
        f"plain route ({N_PLAIN_REQUESTS} requests) median {pmed:.3f} p90 "
        f"{pp90:.3f}; peak device memory "
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
    return ({k: launches[k] for k in ("render_sg_env", "bilateral_blur")},
            (stacks, bs_nets))


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
                           BS_TRAIN_STEPS, 25, dev)


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


def check_brdf_repeats(tag, nets, batch, dev):
    """ROADMAP C17's probe, fatal: the BRDF step's loss and backward twice
    from one state and batch under ``torch.use_deterministic_algorithms
    (True)`` (an op without a deterministic CUDA path raises), every
    net's gradients bit-equal.  Autotuning is off for it, as in a
    deterministic CLI run (``setup_device``): it would time every
    deterministic algorithm of every shape first (~6.5 s)."""
    step = make_brdf_train_step(nets, device=dev, lr=TRAIN_LR)
    grads = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)
    try:
        for _ in range(2):
            step.brdf_nets.zero_grad(set_to_none=True)
            step.loss(batch)[0].backward()
            grads.append({n: p.grad.clone() for n, p in
                          step.brdf_nets.named_parameters()
                          if p.grad is not None})
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.benchmark = benchmark
    torch.cuda.synchronize()
    differ = sorted({n.split(".")[0] for n, g in grads[0].items()
                     if not torch.equal(g, grads[1][n])})
    log(f"{tag} the step's loss and backward twice from one state and "
        "batch under torch.use_deterministic_algorithms(True): "
        f"{time.perf_counter() - t0:.2f} s; nets whose gradients differ: "
        f"{differ or 'none'}")
    if differ or sorted(grads[0]) != sorted(
            n for n, _ in step.brdf_nets.named_parameters()):
        raise AssertionError(f"{tag} the step does not repeat: {differ}")


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
    log(f"[cascade] hand-off in memory: "
        + ", ".join(f"{k} {tuple(c1[k].shape)}" for k in (*PRE_STEMS,
                                                          "env_pre"))
        + "; per-image means of albedo_pre / depth_pre "
        + " / ".join(f"{float(m.min()):.7f}-{float(m.max()):.7f}"
                     for m in means.values())
        + "; the files: phase 10's cli-export and cli-c1")
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
    check_brdf_repeats("[cascade c0 brdf]", brdf0, batch, dev)
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
    Returns {kernel: launches} of the run and the cascade-0 nets trained
    by each fine-tune ({"iiw": ..., "nyu": ...})."""
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
    nets0 = None
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
        nets0 = nets0 or trained
        log(f"[fine-tune c{lvl}] metrics (random-weight numbers, not "
            "quality): before "
            + ", ".join(f"{k} {v:.5g}" for k, v in before[lvl].items())
            + "; after the IIW cycles whdr "
            f"{after['iiw']['whdr']:.5g}; after the NYU cycles angle_deg "
            f"{after['nyu']['angle_deg']:.5g}, si_log "
            f"{after['nyu']['si_log']:.5g}")
    return launches, nets0


# ---------------------------------------------------------------- phase 9


class CLITimer:
    """Instruments the CLIs while they run in this process: the host time
    of each loader wait, batch staging, train step and checkpoint save
    (each ending in a synchronize), each logged metric line at full
    precision, and a torch.profiler trace of step ``profile_at`` (1-based,
    of every step taken while active).  ``kill_at``: the log call at
    which a KeyboardInterrupt is raised (a simulated preemption)."""

    STEPS = (BRDFTrainStep, LightTrainStep, BilateralTrainStep)

    def __init__(self, profile_at=None, kill_at=None):
        self.profile_at, self.kill_at = profile_at, kill_at
        self.times = {"loader": [], "stage": [], "step": [], "save": []}
        self.lines, self.busy, self.prof = [], None, None
        self._saved = []

    def _patch(self, owner, name, wrap):
        orig = getattr(owner, name)
        self._saved.append((owner, name, orig))
        setattr(owner, name, wrap(orig))

    def _timed(self, key):
        def wrap(orig):
            def run(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = orig(*a, **kw)
                torch.cuda.synchronize()
                self.times[key].append((time.perf_counter() - t0) * 1e3)
                return out
            return run
        return wrap

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        timer = self

        def loader(orig):
            def it(self_):
                gen = orig(self_)
                try:
                    while True:
                        t0 = time.perf_counter()
                        try:
                            item = next(gen)
                        except StopIteration:
                            return
                        timer.times["loader"].append(
                            (time.perf_counter() - t0) * 1e3)
                        yield item
                finally:
                    gen.close()
            return it

        def step(orig):
            timed = self._timed("step")(orig)

            def run(self_, batch):
                if len(timer.times["step"]) + 1 != timer.profile_at:
                    return timed(self_, batch)
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    out = timed(self_, batch)
                timer.busy = (device_busy_ms(prof), timer.times["step"][-1])
                timer.prof = prof
                return out
            return run

        def logged(orig):
            def run(self_, epoch, j, metrics):
                orig(self_, epoch, j, metrics)
                timer.lines.append((epoch, j, dict(metrics)))
                if len(timer.lines) == timer.kill_at:
                    raise KeyboardInterrupt  # a simulated preemption
            return run

        self._patch(BatchIterator, "__iter__", loader)
        self._patch(cli_common, "stage_batch", self._timed("stage"))
        for cls in self.STEPS:
            self._patch(cls, "__call__", step)
        self._patch(ckpt, "save_step_checkpoint", self._timed("save"))
        self._patch(ckpt, "save_checkpoint", self._timed("save"))
        self._patch(MetricLogger, "log", logged)
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        return False

    def summary(self, skip=1):
        """ms medians of the loader wait, the staging and the step (after
        the first ``skip`` of each), of the saves, and the profiled step's
        idle share, alone and with its loader wait and staging."""
        med = {}
        for k, v in self.times.items():
            v = v if k == "save" else v[skip:]
            if v:
                med[k] = statistics.median(v)
        out = ", ".join(f"{k} {v:.3f}" for k, v in med.items())
        if self.busy:
            busy, ms = self.busy
            it = med["loader"] + med["stage"] + ms
            out += (f"; the profiled step {ms:.3f} ms, device busy "
                    f"{busy:.3f} ms (idle share {1.0 - busy / ms:.3f}; of "
                    f"loader wait + staging + step {1.0 - busy / it:.3f})")
        return out


def cli_args(root, exp, *extra):
    return ["--dataRoot", root, "--experiment", exp, "--device", "cuda",
            "--imHeight", str(IM_HW[0]), "--imWidth", str(IM_HW[1]),
            "--envRow", str(ENV_RC[0]), "--envCol", str(ENV_RC[1]),
            "--SGNum", str(SG_NUM), "--seed", "0", "--logFlushSteps", "1",
            *map(str, extra)]


# the fixture writer's process: each writer of data/fixture.py by name,
# with its keyword arguments as JSON (lists back to tuples: the writers
# keep their arguments' repr in a marker file); cv2 on one thread, so
# that the writer takes one of the host's cores from phases 3-8
FIXTURE_WRITER = """
import json, os, sys, time
import cv2
cv2.setNumThreads(1)
from inverserenderingofindoorscene_torch.data import fixture
out = {}
for name, write, kw in json.loads(sys.argv[2]):
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}
    t0 = time.perf_counter()
    root = getattr(fixture, write)(os.path.join(sys.argv[1], name), **kw)
    out[name] = [root, kw, time.perf_counter() - t0]
print("FIXTURES " + json.dumps(out), flush=True)
"""
FIXTURE_RUN_S = 900  # the writer's limit, from its start to phase 9


def start_fixtures(tmp, seed):
    """Start writing the OpenRooms fixture at full width (one TRAIN
    scene) and IIW and NYU fixtures of ``BRDF_TRAIN_B`` frames under
    ``tmp``, in a process of its own, so that the host's writing overlaps
    phases 3-8 on the card; returns (the process, its start)."""
    specs = [
        ("openrooms", "write_openrooms_fixture",
         dict(n_scenes=1, per_scene=FIXTURE_IMAGES, n_test_scenes=0,
              im_hw=IM_HW, env_rc=ENV_RC, seed=seed)),
        ("iiw", "write_iiw_fixture",
         dict(n_train=BRDF_TRAIN_B, n_test=0, seed=seed)),
        ("nyu", "write_nyu_fixture",
         dict(n_train=BRDF_TRAIN_B, n_test=0, seed=seed))]
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-c", FIXTURE_WRITER, tmp, json.dumps(specs)],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, time.monotonic()


def stop_fixtures(writer):
    """Kill the fixture writer if it still runs."""
    proc, _ = writer
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def write_fixtures(writer):
    """Wait for the fixture writer (:func:`start_fixtures`); returns
    {name: root}.  Fails if it failed or outlasts FIXTURE_RUN_S."""
    proc, start = writer
    t0 = time.perf_counter()
    try:
        out, err = proc.communicate(
            timeout=max(start + FIXTURE_RUN_S - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"[from disk] the fixture writer still runs "
                             f"{FIXTURE_RUN_S} s after its start")
    if proc.returncode:
        raise AssertionError(f"[from disk] the fixture writer exited "
                             f"{proc.returncode}:\n{err[-4000:]}")
    line = [x for x in out.splitlines() if x.startswith("FIXTURES ")]
    roots = {}
    for name, (root, kw, seconds) in json.loads(
            line[-1][len("FIXTURES "):]).items():
        roots[name] = root
        size = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(root) for f in fs)
        log(f"[from disk] {name} fixture {kw}: {seconds:.1f} s in the "
            f"writer's process, {size / 2**20:.1f} MiB")
    log(f"[from disk] the fixtures, written during phases 3-8: waited "
        f"{time.perf_counter() - t0:.1f} s for them")
    return roots


def check_loaders(root):
    """The native decoder is built and bit-equal to the cv2 route on a
    fixture envmap; the light loader's items a second in thread mode over
    2 epochs (the BRDF loader's process pool is timed by ``train_brdf``'s
    loader waits: its own first epoch, the pool's start, took ~11 s; cut
    to fit the run)."""
    if not native_hdr.native_available():
        raise AssertionError("the native RGBE decoder did not build")
    ds = OpenRoomsDataset(root, im_hw=IM_HW, env_rc=ENV_RC, is_light=True,
                          is_all_light=True, sg_num=SG_NUM)
    path = ds.im_list[0].replace("im_", "imenv_")
    t0 = time.perf_counter()
    native, _ = ds._load_envmap(path)
    t1 = time.perf_counter()
    plain, _ = ds._load_envmap_cv2(path)
    t2 = time.perf_counter()
    if not np.array_equal(native, plain):
        raise AssertionError("native and cv2 envmap decodes differ")
    log(f"[from disk] envmap {path.rsplit('/', 1)[-1]} "
        f"({ENV_RC[0] * 16}x{ENV_RC[1] * 32} RGBE): native decode + pool "
        f"{(t1 - t0) * 1e3:.1f} ms, cv2 + numpy {(t2 - t1) * 1e3:.1f} ms, "
        "bit-equal")
    rates = {}
    it = BatchIterator(OpenRoomsDataset(
        root, im_hw=IM_HW, env_rc=ENV_RC, is_light=True, is_all_light=True,
        sg_num=SG_NUM), TRAIN_B, num_workers=CLI_WORKERS, mode="thread")
    try:
        for epoch in range(2):
            t0 = time.perf_counter()
            n = sum(len(batch["name"]) for batch in it)
            rates[("thread", epoch)] = n / (time.perf_counter() - t0)
    finally:
        it.close()
    log(f"[from disk] loader items/s with {CLI_WORKERS} workers on "
        f"{os.cpu_count()} host cores: light items (22 MB env_gt), thread "
        f"mode, epoch 1 {rates[('thread', 0)]:.2f}, epoch 2 "
        f"{rates[('thread', 1)]:.2f}")
    return rates


def nets_rel_l2(a, b):
    """Each net's parameters (all together) in two BRDF checkpoints: the
    relative L2 distance."""
    out = {}
    for net in BRDF_NETS:
        ka = [k for k in a["nets"] if k.startswith(net + ".")]
        va = torch.cat([a["nets"][k].double().flatten() for k in ka])
        vb = torch.cat([b["nets"][k].double().flatten() for k in ka])
        out[net] = rel_l2(va, vb)
    return out


def train_brdf_cli(root, tmp):
    """``train_brdf`` at cascade 0: B=16 with process workers, 2 epochs of
    one step with a step checkpoint each; then the kill and resume at B=4.
    Returns the first run's experiment (its checkpoint is the frozen nets
    of ``train_light``)."""
    exp = os.path.join(tmp, "brdf16")
    with CLITimer(profile_at=2) as timer:
        cli_train_brdf.main(cli_args(
            root, exp, "--batchSize", BRDF_TRAIN_B, "--numWorkers",
            CLI_WORKERS, "--nepoch", 2, "--ckptEverySteps", 1, "--resume",
            "auto", "--previewEvery", 0, *F32))
    per_epoch = FIXTURE_IMAGES // BRDF_TRAIN_B
    if [(e, j) for e, j, _ in timer.lines] != [
            (e, j) for e in range(2) for j in range(per_epoch)]:
        raise AssertionError(f"train_brdf B=16 logged {timer.lines}")
    bad = [k for _, _, m in timer.lines for k, v in m.items()
           if not np.isfinite(v)]
    if bad or ckpt.latest_epoch(exp, "brdf", 0) != 1:
        raise AssertionError(f"train_brdf B=16: non-finite {bad} or no "
                             "epoch-1 checkpoint")
    log(f"[from disk] train_brdf c0 B={BRDF_TRAIN_B}, {CLI_WORKERS} process "
        f"workers, 2 epochs of {per_epoch} step(s), a step checkpoint a step "
        "and an epoch checkpoint an epoch, no previews: "
        f"step 1 (autotuning) {timer.times['step'][0]:.1f} ms; ms "
        + timer.summary() + f"; total {timer.lines[0][2]['total']:.6g} -> "
        f"{timer.lines[-1][2]['total']:.6g}"
        " (phase 7's in-memory train-c0-brdf step beside it)")

    runs = {}
    for name, kill in (("whole", None), ("killed", 2), ("resumed", None)):
        run_exp = os.path.join(tmp, "brdf4_" + ("whole" if name == "whole"
                                                else "killed"))
        with CLITimer(kill_at=kill) as timer:
            try:
                # thread workers: a spawned pool costs 9-15 s a run to
                # start (process workers before phase 4b, cut to fit)
                cli_train_brdf.main(cli_args(
                    root, run_exp, "--batchSize", CLI_RESUME_B, *THREADS,
                    "--nepoch", 1, "--ckptEverySteps", 1, "--resume",
                    "auto", "--previewEvery", 0, *F32))
            except KeyboardInterrupt:
                if kill is None:
                    raise
            else:
                if kill is not None:
                    raise AssertionError("the killed run was not killed")
        runs[name] = (run_exp, timer)
        if name == "killed" and (
                ckpt.list_step_checkpoints(run_exp, "brdf", 0)[-1] != (0, 0)
                or ckpt.latest_epoch(run_exp, "brdf", 0) is not None):
            raise AssertionError("the killed run's newest checkpoint is not "
                                 "step 1's")
    steps = {k: [(e, j) for e, j, _ in t.lines] for k, (_, t) in runs.items()}
    per_epoch = FIXTURE_IMAGES // CLI_RESUME_B
    want = {"whole": [(0, j) for j in range(per_epoch)],
            "killed": [(0, 0), (0, 1)],
            "resumed": [(0, j) for j in range(1, per_epoch)]}
    if steps != want:
        raise AssertionError(f"kill and resume logged {steps}, want {want}")
    a = ckpt.restore_checkpoint(runs["whole"][0], "brdf", 0, 0)
    b = ckpt.restore_checkpoint(runs["resumed"][0], "brdf", 0, 0)
    equal = all(torch.equal(a["nets"][k], b["nets"][k]) for k in a["nets"])
    dist = nets_rel_l2(b, a)
    same_loss = [runs["resumed"][1].lines[i][2] == runs["whole"][1]
                 .lines[i + 1][2] for i in range(per_epoch - 1)]
    log(f"[from disk] train_brdf c0 B={CLI_RESUME_B}, one epoch of "
        f"{per_epoch} steps: "
        "uninterrupted, then killed after step 1 (the log of step 2 raises; "
        "the newest step checkpoint is step 1's) and resumed with --resume "
        f"auto: final checkpoints {'bit-equal' if equal else 'differ'}; "
        "relative L2 of each net's parameters "
        + ", ".join(f"{k} {v:.3e}" for k, v in dist.items())
        + f"; resumed steps' losses equal to the uninterrupted run's: "
        f"{same_loss}; ms " + runs["whole"][1].summary())
    if not max(dist.values()) < RESUME_REL_L2:
        raise AssertionError(f"resumed run vs uninterrupted: {dist}")
    return exp


def train_light_cli(root, tmp, brdf_exp):
    """``train_light`` at cascade 0 on the frozen nets of ``brdf_exp``'s
    checkpoint: B=5, 2 steps with the kernels, then the same from the same
    start with ``--noKernels``; step 1's losses of the two routes within
    STEP1_TOL (a third run that timed the kernel route with process
    workers was cut to fit the run; ``train_brdf`` runs the process
    pool).  Returns ({kernel: launches} of the kernel
    routes' runs, the ``CLITimer`` of the kernel route with threads, whose
    experiment is ``light_kernels`` under ``tmp``)."""
    runs = {}
    for route, flag, mode in (("kernels", "--useKernels", "thread"),
                              ("plain", "--noKernels", "thread")):
        reset_launches()
        # the kernel route's step 2 is profiled (both routes' before
        # cli-export and cli-c1; cut to fit the run)
        with CLITimer(profile_at=2 if route == "kernels" else None) as timer:
            cli_train_light.main(cli_args(
                root, os.path.join(tmp, "light_" + route), "--batchSize",
                TRAIN_B, "--numWorkers", CLI_WORKERS, "--loaderMode", mode,
                "--nepoch", 1, "--maxSteps", LIGHT_CLI_STEPS,
                "--brdfExperiment", brdf_exp, flag, *F32))
        runs[route] = (timer, read_launches())
        log(f"[from disk] train_light c0 B={TRAIN_B}, {route.split('-')[0]} "
            f"route, {CLI_WORKERS} {mode} workers, {LIGHT_CLI_STEPS} steps on "
            "the frozen nets of train_brdf's epoch-1 checkpoint: ms "
            + timer.summary() + f"; launches {runs[route][1]} "
            "(phase 5's in-memory train-c0-light step beside it)"
            + ("; the profiled step's ops by host time:" if timer.prof
               else ""))
        if timer.prof:
            log(timer.prof.key_averages().table(
                sort_by="self_cpu_time_total", row_limit=8))
    (tk, lk), (tp, lp) = runs["kernels"], runs["plain"]
    steps = {**dict.fromkeys(KERNELS, LIGHT_CLI_STEPS), "render_sg_env": 0,
             "bilateral_blur": 0}
    want = {"kernels": steps, "plain": dict.fromkeys(KERNELS, 0)}
    got = {route: launches for route, (_, launches) in runs.items()}
    if got != want:
        raise AssertionError(f"train_light launches {got}, expected {want}")
    mk, mp = tk.lines[0][2], tp.lines[0][2]
    dist = {k: abs(mk[k] / mp[k] - 1.0) for k in ("reconst", "render")}
    log("[from disk] train_light step 1, kernel route vs plain route: "
        + ", ".join(f"{k} {v:.6g}" for k, v in mk.items())
        + "; relative differences "
        + ", ".join(f"{k} {v:.3e}" for k, v in dist.items())
        + "; BRDF errors equal: "
        + str(all(mk[k] == mp[k] for k in ("albedo", "normal", "rough",
                                            "depth"))))
    for k, v in dist.items():
        if not v <= STEP1_TOL[k]:
            raise AssertionError(f"train_light step 1 {k}: {v} > "
                                 f"{STEP1_TOL[k]}")
    bad = [k for t, _ in runs.values() for _, _, m in t.lines
           for k, v in m.items() if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"train_light: non-finite {bad}")
    return {k: lk[k] for k in lk
            if k not in ("render_sg_env", "bilateral_blur")}, tk


def real_data_steps(roots, nets, dev):
    """One B=16 batch of each real-data fixture through the port's
    loaders and ``stage_batch``, one IIW and one NYU step on phase 8's
    cascade-0 nets; the losses finite."""
    iiw_root, nyu_root = roots["iiw"], roots["nyu"]
    loaders = {
        "iiw": (IIWDataset(iiw_root, os.path.join(iiw_root, "IIWTrain.txt"),
                           im_hw=IM_HW, max_num=IIW_MAX_NUM),
                make_iiw_train_step),
        "nyu": (NYUDataset(*(os.path.join(nyu_root, s) for s in (
            "images", "normals", "depths", "segs", "NYUTrain.txt")),
            im_hw=IM_HW), make_nyu_train_step),
    }
    for name, (ds, make) in loaders.items():
        t0 = time.perf_counter()
        batch = next(iter(BatchIterator(ds, BRDF_TRAIN_B,
                                        num_workers=CLI_WORKERS)))
        staged = cli_common.stage_batch(batch, dev)
        load_ms = (time.perf_counter() - t0) * 1e3
        metrics, ms = timed_step(make(copy.deepcopy(nets[name]), device=dev),
                                 staged)
        bad = [k for k, v in metrics.items() if not torch.isfinite(v)]
        if bad:
            raise AssertionError(f"{name} step on the fixture: non-finite "
                                 f"{bad}")
        log(f"[from disk] {name} fixture batch B={BRDF_TRAIN_B} "
            f"({tuple(staged['im'].shape)}): loaded and staged in "
            f"{load_ms:.1f} ms; one step on phase 8's c0 nets {ms:.1f} ms: "
            + ", ".join(f"{k} {v.item():.6g}" for k, v in metrics.items()))


def phase_from_disk(dev, nets, tmp, fixtures):
    """The loaders and the first two training CLIs from files: the
    fixtures that ``fixtures`` (:func:`start_fixtures`) writes under
    ``tmp`` (outside the checkout; the caller removes it),
    the native decoder (no cv2 fallback: it raises here), ``train_brdf``
    with a kill and resume, ``train_light`` on its checkpoint with the
    kernels, and the real-data loaders into the fine-tune steps.
    ``nets``: phase 8's cascade-0 nets by fine-tune.  Returns ({kernel:
    launches} of the run, what phase 10 reuses: the fixture roots, the
    two CLIs' experiments, the loader rates and the light CLI's timer)."""
    t_phase = time.perf_counter()

    def no_cv2(*a, **kw):
        raise AssertionError("an envmap went through cv2, not the native "
                             "decoder")

    cv2_route = OpenRoomsDataset._load_envmap_cv2
    def cell(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        log(f"[time] cell {name}: {time.perf_counter() - t0:.1f} s")
        return out

    try:
        roots = cell("fixtures", write_fixtures, fixtures)
        rates = cell("loaders", check_loaders, roots["openrooms"])
        OpenRoomsDataset._load_envmap_cv2 = no_cv2
        brdf_exp = cell("cli-c0-brdf", train_brdf_cli, roots["openrooms"],
                        tmp)
        launches, light_timer = cell("cli-c0-light", train_light_cli,
                                     roots["openrooms"], tmp, brdf_exp)
        cell("real-data steps", real_data_steps, roots, nets, dev)
    finally:
        OpenRoomsDataset._load_envmap_cv2 = cv2_route
    log(f"[from disk] phase 9: {time.perf_counter() - t_phase:.1f} s")
    return launches, {"dev": dev, "tmp": tmp, "roots": roots,
                      "brdf_exp": brdf_exp,
                      "light_exp": os.path.join(tmp, "light_kernels"),
                      "rates": rates, "light_timer": light_timer}


# --------------------------------------------------------------- phase 10

# one photo of each kind (two of each before phases 11-12; cut to fit
# the run: a photo's host writes take ~13 s)
PHOTOS = {"iiw": ("iiw0000.png",), "nyu": ("images/frame0000.png",)}
CACHE_EPOCHS = 2
FT_STEPS = 2  # epochs of one cycle (16 images, B=16)
EVAL_B, EVAL_STEPS = 4, 2  # test_synthetic's default batch; batches a stage
BS_CLI_STEPS = 2
# phase 10's BRDF-stage loaders take 4 thread workers: a spawned pool
# costs 9-15 s a CLI to start (phase 9's train_brdf runs the process
# workers)
THREADS = ("--numWorkers", CLI_WORKERS, "--loaderMode", "thread")


def launch_delta(fn):
    """``fn()`` with the launch counts set to 0 just before and read just
    after.  Returns (its result, {kernel: launches})."""
    reset_launches()
    out = fn()
    return out, read_launches()


def expect_launches(tag, got, **want):
    want = {**dict.fromkeys(KERNELS, 0), **want}
    if got != want:
        raise AssertionError(f"{tag}: launches {got}, expected {want}")


def finite_lines(tag, timer, n):
    if len(timer.lines) != n:
        raise AssertionError(f"{tag}: {len(timer.lines)} steps logged, "
                             f"expected {n}")
    bad = sorted({k for _, _, m in timer.lines for k, v in m.items()
                  if not np.isfinite(v)})
    if bad:
        raise AssertionError(f"{tag}: non-finite {bad}")


def spread(times):
    return (f"median {statistics.median(times):.3f}, min {min(times):.3f}, "
            f"max {max(times):.3f} over {len(times)}")


def rounded(times):
    return [round(x, 3) for x in times]


def cell_cache(ctx, smi):
    """cli-cache: ``build_cache --light`` over the TRAIN images, cold;
    the cached loader's items a second, epochs 1 and 2; its first batch
    against the direct loader's under the cache's contract; then
    ``train_light --itemCache`` for 2 epochs, beside phase 9's run on the
    direct loader.  Returns {kernel: launches} of the train_light run."""
    root, tmp = ctx["roots"]["openrooms"], ctx["tmp"]
    cache = os.path.join(tmp, "cache")
    t0 = time.perf_counter()
    cli_build_cache.main(cli_args(
        root, os.path.join(tmp, "unused"), "--itemCache", cache, "--light",
        "--phases", "TRAIN", "--numWorkers", CLI_WORKERS))
    build_s = time.perf_counter() - t0

    def light_ds():
        return OpenRoomsDataset(root, im_hw=IM_HW, env_rc=ENV_RC,
                                is_light=True, is_all_light=True,
                                sg_num=SG_NUM)

    cached = CachedOpenRoomsDataset(light_ds(), cache, verbose=False)
    if not cached.reused:
        raise AssertionError("build_cache left no complete cache")
    it = BatchIterator(cached, TRAIN_B, num_workers=CLI_WORKERS)
    rates = []
    for _ in range(2):
        t0 = time.perf_counter()
        n = sum(len(batch["name"]) for batch in it)
        rates.append(n / (time.perf_counter() - t0))
    first = {}
    for name, ds in (("cached", cached), ("direct", light_ds())):
        batch = next(iter(BatchIterator(ds, TRAIN_B, num_workers=0)))
        first[name] = {k: (v if k == "name" else np.array(v))
                       for k, v in batch.items()}
    c, d = first["cached"], first["direct"]
    if set(c) != set(d) or c["name"] != d["name"]:
        raise AssertionError("the cached batch's keys or names differ")
    for k in d:
        if k == "name":
            continue
        if k == "env_gt":
            ok = np.allclose(c[k], d[k], rtol=3e-6, atol=1e-7)
        else:
            ok = np.array_equal(c[k], d[k])
        if not ok:
            raise AssertionError(f"cached batch {k} breaks the cache's "
                                 "contract against the direct loader")
    env_rel = float(np.max(np.abs(c["env_gt"] - d["env_gt"])
                           / np.maximum(np.abs(d["env_gt"]), 1e-30)))
    size = sum(os.path.getsize(os.path.join(cached.dir, f))
               for f in os.listdir(cached.dir))
    direct = ctx["rates"]
    log(f"[cli-cache] build_cache --light, {FIXTURE_IMAGES} TRAIN items at "
        f"{IM_HW[0]}x{IM_HW[1]} ({ENV_RC[0] * 16}x{ENV_RC[1] * 32} "
        f"envmaps), {CLI_WORKERS} threads, cold: {build_s:.2f} s, "
        f"{size / 2**20:.1f} MiB; cached loader items/s (B={TRAIN_B}, "
        f"{CLI_WORKERS} thread workers) epoch 1 {rates[0]:.2f}, epoch 2 "
        f"{rates[1]:.2f} (phase 9's direct light loader, same workers: "
        f"epoch 1 {direct[('thread', 0)]:.2f}, epoch 2 "
        f"{direct[('thread', 1)]:.2f}); first batch against the direct "
        f"loader: every field bit-equal but env_gt, within relative "
        f"{env_rel:.3e}; {smi}")

    steps = CACHE_EPOCHS * (FIXTURE_IMAGES // TRAIN_B)
    with CLITimer(profile_at=2) as timer:
        _, launches = launch_delta(lambda: cli_train_light.main(cli_args(
            root, os.path.join(tmp, "light_cached"), "--batchSize", TRAIN_B,
            "--numWorkers", CLI_WORKERS, "--nepoch", CACHE_EPOCHS,
            "--itemCache", cache, "--brdfExperiment", ctx["brdf_exp"],
            *F32)))
    finite_lines("train_light --itemCache", timer, steps)
    expect_launches("train_light --itemCache", launches,
                    **{k: steps for k in ("render_sg_fwd", "render_sg_bwd",
                                          "sg_envmap_fwd", "sg_envmap_bwd")})
    ref = ctx["light_timer"]
    log(f"[cli-cache] train_light c0 B={TRAIN_B}, --itemCache, "
        f"{CLI_WORKERS} thread workers, {CACHE_EPOCHS} epochs of "
        f"{steps // CACHE_EPOCHS} steps: step ms (after step 1) "
        f"{spread(timer.times['step'][1:])}, loader wait ms "
        f"{spread(timer.times['loader'][1:])}; ms " + timer.summary()
        + f"; phase 9's run on the direct loader: step ms "
        f"{rounded(ref.times['step'])}, loader wait ms "
        f"{rounded(ref.times['loader'])}; {smi}")
    return launches


def cell_bilateral(ctx, smi):
    """cli-c0-bs: ``train_bilateral`` at cascade 0, B=2, on phase 9's BRDF
    checkpoint, 2 steps on each route from the same seed: step 1's
    losses within phase 6's tolerance, ``bilateral_blur`` launched
    BLURS_FWD + BLURS_GRAD times an image a step.  Returns the kernel
    route's launches."""
    root, tmp = ctx["roots"]["openrooms"], ctx["tmp"]
    runs = {}
    for route, flag in (("kernels", "--useKernels"), ("plain", "--noKernels")):
        # the kernel route's step 2 is profiled (both routes' before
        # cli-export and cli-c1; cut to fit the run)
        with CLITimer(profile_at=2 if route == "kernels" else None) as timer:
            _, launches = launch_delta(lambda: cli_train_bilateral.main(
                cli_args(root, os.path.join(tmp, "bs_" + route),
                         "--batchSize", BS_TRAIN_B, *THREADS, "--maxSteps",
                         BS_CLI_STEPS, "--brdfExperiment", ctx["brdf_exp"],
                         flag)))
        finite_lines(f"train_bilateral {route}", timer, BS_CLI_STEPS)
        runs[route] = (timer, launches)
    blurs = BS_CLI_STEPS * BS_TRAIN_B * (BLURS_FWD + BLURS_GRAD)
    expect_launches("train_bilateral kernels", runs["kernels"][1],
                    bilateral_blur=blurs)
    expect_launches("train_bilateral plain", runs["plain"][1])
    mk, mp = runs["kernels"][0].lines[0][2], runs["plain"][0].lines[0][2]
    nvert = {k: v for k, v in mk.items() if k.startswith("nvert")}
    if nvert != {k: v for k, v in mp.items() if k.startswith("nvert")}:
        raise AssertionError(f"train_bilateral grids differ: {mk} vs {mp}")
    dist = {k: abs(mk[k] / mp[k] - 1.0) for k in mk if k not in nvert}
    log(f"[cli-c0-bs] train_bilateral c0 B={BS_TRAIN_B}, {BS_CLI_STEPS} "
        "steps a route on train_brdf's checkpoint: step 1, kernel route vs "
        "plain route, relative differences "
        + ", ".join(f"{k} {v:.3e}" for k, v in dist.items())
        + f"; grid vertices {nvert}; bilateral_blur launches "
        f"{runs['kernels'][1]['bilateral_blur']} ({BLURS_FWD + BLURS_GRAD} "
        "an image a step, phase 6's count); ms, kernel route "
        + runs["kernels"][0].summary() + "; plain route "
        + runs["plain"][0].summary() + f"; {smi}")
    if not max(dist.values()) <= BS_STEP1_TOL["losses"]:
        raise AssertionError(f"train_bilateral step 1 losses: {dist}")
    return runs["kernels"][1]


def finetune_args(ctx, kind, cascade, *extra):
    roots, tmp = ctx["roots"], ctx["tmp"]
    if kind == "iiw":
        data = ["--iiwRoot", roots["iiw"], "--iiwList",
                os.path.join(roots["iiw"], "IIWTrain.txt")]
    else:
        data = ["--nyuList", os.path.join(roots["nyu"], "NYUTrain.txt")]
        for sub, name in (("Im", "images"), ("Normal", "normals"),
                          ("Depth", "depths"), ("Seg", "segs")):
            data += [f"--nyu{sub}Root", os.path.join(roots["nyu"], name)]
    return cli_args(roots["openrooms"],
                    os.path.join(tmp, f"ft_{kind}{cascade}"), "--batchSize",
                    BRDF_TRAIN_B, *THREADS, "--nepoch", FT_STEPS,
                    "--maxSteps", 1, "--cascadeLevel", cascade, *data,
                    *extra)


def cell_finetune(ctx, smi):
    """cli-ft: ``train_finetune_iiw`` at cascade 0, 2 cycles at B=16 from
    phase 9's BRDF checkpoint; then ``train_finetune_nyu`` at cascade 1,
    whose synthetic batches read the ``*_pre`` files cli-export wrote and
    whose NYU batches get their ``*_pre`` maps from phase 9's cascade-0
    checkpoints through ``common.make_pre_synth`` (one ``render_sg_fwd``
    a cycle).  Returns the launches."""
    torch.cuda.reset_peak_memory_stats()
    with CLITimer() as timer:
        _, launches = launch_delta(lambda: cli_finetune_iiw.main(
            finetune_args(ctx, "iiw", 0, "--brdfExperiment",
                          ctx["brdf_exp"])))
    finite_lines("train_finetune_iiw", timer, FT_STEPS)
    expect_launches("train_finetune_iiw", launches)
    peak = torch.cuda.max_memory_allocated() / 2**20
    st = timer.times["step"]
    log(f"[cli-ft] train_finetune_iiw c0 B={BRDF_TRAIN_B}, {FT_STEPS} cycles "
        f"(the synthetic BRDF step, then the IIW step, one Adam): the "
        f"synthetic step ms {rounded(st[0::2])}, the IIW step ms "
        f"{rounded(st[1::2])}, loader waits ms "
        f"{rounded(timer.times['loader'])}, staging ms "
        f"{rounded(timer.times['stage'])}, saves ms "
        f"{rounded(timer.times['save'])}; peak device memory {peak:.0f} MiB; "
        + ", ".join(f"{k} {v:.6g}" for k, v in timer.lines[-1][2].items())
        + f"; {smi}")

    frozen = ["--brdf0Experiment", ctx["brdf_exp"], "--light0Experiment",
              ctx["light_exp"]]
    torch.cuda.reset_peak_memory_stats()
    with CLITimer() as timer:
        _, got = launch_delta(lambda: cli_finetune_nyu.main(
            finetune_args(ctx, "nyu", 1, *frozen)))
    finite_lines("train_finetune_nyu c1", timer, FT_STEPS)
    expect_launches("train_finetune_nyu c1", got, render_sg_fwd=FT_STEPS)
    st = timer.times["step"]
    log(f"[cli-ft] train_finetune_nyu c1 B={BRDF_TRAIN_B}, {FT_STEPS} "
        f"cycles, *_pre synthesized inline: the synthetic step ms "
        f"{rounded(st[0::2])}, the NYU step ms {rounded(st[1::2])}; "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; "
        f"launches {got}; {smi}")
    return {k: launches[k] + got[k] for k in KERNELS}


class PhotoTimer:
    """Times ``test_real``'s three parts a photo while it runs: the read
    and resize (``load_real_image``, on a reader thread), the chain
    (``InverseRenderer.__call__``, ending in a synchronize) and the
    writes; keeps the first chain call's arguments and output."""

    def __init__(self):
        self.times = {"read": [], "chain": [], "write": []}
        self.first = None
        self._saved = []

    def __enter__(self):
        timer = self

        def timed(key, orig, keep=False):
            def run(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = orig(*a, **kw)
                torch.cuda.synchronize()
                timer.times[key].append((time.perf_counter() - t0) * 1e3)
                if keep and timer.first is None:
                    timer.first = (a, out)
                return out
            return run

        for owner, name, key, keep in (
                (cli_test_real, "load_real_image", "read", False),
                (InverseRenderer, "__call__", "chain", True),
                (cli_test_real, "write_products", "write", False)):
            orig = getattr(owner, name)
            self._saved.append((owner, name, orig))
            setattr(owner, name, timed(key, orig, keep))
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        return False


def cell_test_real(ctx, smi):
    """cli-test-real: ``test_real --level 2 --isLight --isBS`` on 2 photos
    (an IIW and a NYU fixture frame of 480x640, written with cv2) at
    the default 240x320, phase 9's cascade-0 checkpoints at level 0 and
    seeded nets at level 1, unit confidence; the first photo's lighting
    and refinement held against the plain route on the same inputs at
    the serving tolerances (phase 4's checks).  Returns (launches, the
    output dir)."""
    import cv2

    tmp, roots = ctx["tmp"], ctx["roots"]
    photos = os.path.join(tmp, "photos")
    os.makedirs(photos)
    paths = []
    for kind, rels in PHOTOS.items():
        for rel in rels:
            im = cv2.imread(os.path.join(roots[kind], rel))
            if im is None or im.shape[:2] != (480, 640):
                raise AssertionError(f"fixture frame {rel} is not 480x640")
            paths.append(os.path.join(photos, os.path.basename(rel)))
            cv2.imwrite(paths[-1], im)
    im_list = os.path.join(photos, "list.txt")
    with open(im_list, "w") as f:
        f.write("\n".join(paths) + "\n")
    out = os.path.join(tmp, "real")
    argv = ["--imList", im_list, "--output", out, "--level", "2",
            "--isLight", "--isBS", "--device", "cuda",
            "--experimentBRDF0", ctx["brdf_exp"],
            "--experimentLight0", ctx["light_exp"]]
    with PhotoTimer() as timer:
        _, launches = launch_delta(lambda: cli_test_real.main(argv))
    n = len(paths)
    expect_launches("test_real", launches, render_sg_env=2 * n,
                    bilateral_blur=2 * BLURS_FWD * n)
    for path in paths:
        name = os.path.splitext(os.path.basename(path))[0]
        for lvl in range(2):
            for prod in ("albedo", "normal", "rough", "depth", "albedoBS",
                         "depthBS", "envmapSG", "cLight"):
                arr = np.load(os.path.join(out, f"{name}_{prod}{lvl}.npy"))
                if not np.isfinite(arr).all():
                    raise AssertionError(f"test_real {name} {prod}{lvl}")
    (renderer, im, im_small, fov), result = timer.first
    if fov != 57.0:
        raise AssertionError(f"a landscape photo's fov is {fov}")
    worst, nverts = {}, {}
    check_shapes(result)
    check_lighting(renderer._nets, im, im_small, result, worst)
    check_refinement(im, renderer._bs_nets, result, worst, nverts)
    t = timer.times
    log(f"[cli-test-real] test_real --level 2 --isLight --isBS, {n} photos "
        f"of 480x640 at {IM_HW[0]}x{IM_HW[1]}: ms a photo, read and resize "
        f"{rounded(t['read'])} (reader threads, ahead of the chain), chain "
        f"{rounded(t['chain'])} (photo 1: cuDNN's autotuning), writes "
        f"{rounded(t['write'])}; launches {launches}; the first photo "
        "against the plain route on the same inputs, max err "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()) + f"; {smi}")
    return launches, out


def cell_eval(ctx, smi, real_out):
    """cli-eval: ``test_synthetic`` at cascade 0 (brdf, light and bilateral
    stages) on the TEST split, then ``compare`` on cli-test-real's
    outputs: WHDR on the IIW photos, normal angle and si-log depth on the
    NYU ones.  Returns the launches."""
    root, tmp = ctx["roots"]["openrooms"], ctx["tmp"]
    # phase 9's fixture has one TRAIN scene and no TEST scene: the TEST
    # list names the TRAIN scene, as the JAX CLI tests' fixture does
    with open(os.path.join(root, "train.txt")) as f, \
            open(os.path.join(root, "test.txt"), "w") as g:
        g.write(f.read())
    launches = dict.fromkeys(KERNELS, 0)
    want = {"brdf": {},
            "light": {"render_sg_fwd": EVAL_STEPS,
                      "sg_envmap_fwd": EVAL_STEPS},
            "bilateral": {"bilateral_blur": EVAL_STEPS * EVAL_B * BLURS_FWD}}
    for stage, expected in want.items():
        t0 = time.perf_counter()
        means, got = launch_delta(lambda: cli_test_synthetic.main(cli_args(
            root, os.path.join(tmp, "unused"), "--stage", stage,
            "--testRoot", os.path.join(tmp, "test_" + stage),
            "--brdfExperiment", ctx["brdf_exp"], "--lightExperiment",
            ctx["light_exp"], "--batchSize", EVAL_B, "--maxSteps",
            EVAL_STEPS, *THREADS)))
        ms = (time.perf_counter() - t0) * 1e3
        expect_launches(f"test_synthetic {stage}", got, **expected)
        if not all(np.isfinite(v) for v in means.values()):
            raise AssertionError(f"test_synthetic {stage}: {means}")
        log(f"[cli-eval] test_synthetic --stage {stage} c0, {EVAL_STEPS} "
            f"batches of {EVAL_B}: {ms:.1f} ms (set-up included); "
            + ", ".join(f"{k} {v:.6g}" for k, v in means.items())
            + f"; launches {got}")
        launches = {k: launches[k] + got[k] for k in KERNELS}
    roots = ctx["roots"]
    gt = {"whdr": roots["iiw"],
          "normal": os.path.join(roots["nyu"], "normals"),
          "depth": os.path.join(roots["nyu"], "depths")}
    scores = {m: cli_compare.main([m, "--predRoot", real_out, "--gtRoot", g])
              for m, g in gt.items()}
    if not (all(np.isfinite(v) for v in scores.values())
            and 0.0 <= scores["whdr"] <= 1.0
            and 0.0 <= scores["normal"] <= 180.0):
        raise AssertionError(f"compare out of range: {scores}")
    log("[cli-eval] compare on test_real's level-1 outputs (random-weight "
        "numbers, held to their ranges): "
        + ", ".join(f"{k} {v:.6g}" for k, v in scores.items()) + f"; {smi}")
    return launches


# reads and writes a codec timing takes the least of, on the host
CODEC_REPEATS = 3
C1_STEPS = 2  # cli-c1's steps a CLI, at the batches phase 7 autotuned


def export_args(ctx):
    return cli_args(
        ctx["roots"]["openrooms"], os.path.join(ctx["tmp"], "unused"),
        "--brdfExperiment", ctx["brdf_exp"], "--lightExperiment",
        ctx["light_exp"], "--batchSize", 4, *THREADS)


def check_codec(smi):
    """The port's HDF5 codec on the card's host: one full-size map and one
    SG tensor written and read back bit-equal, each the least of
    CODEC_REPEATS times."""
    rows = h5.time_codec(CODEC_REPEATS)
    log("[cli-export] the HDF5 codec (utils/h5.py) on the card's host, "
        f"least of {CODEC_REPEATS}, round trips bit-equal: " + "; ".join(
            f"{name} {shape} ({size} bytes): write {w:.4f} s, read {r:.4f} s"
            for name, shape, size, w, r in rows) + f"; {smi}")


def check_handoff_files(ctx):
    """The first batch that ``output_brdf_light`` wrote, read back through
    the port's reader (``load_cascade_pre`` / ``load_env_pre``), against
    ``normalize_cascade_pre`` on the products ``export_step`` computes
    here on the same checkpoints and batch: bit-equal."""
    dev = ctx["dev"]
    opt = cli_output_brdf_light.parse_args(export_args(ctx))
    gen = cli_common.pin_seeds(opt.seed)
    brdf = cli_train_light.load_frozen_brdf(opt, gen, dev).to(dev)
    light = cli_output_brdf_light.load_frozen_light(opt, gen, dev).to(dev)
    loader = cli_common.make_loader(opt, "TRAIN", is_light=True,
                                    shuffle=False)
    try:
        np_batch = next(iter(loader))
    finally:
        loader.close()
    products, _ = export_step(brdf, light,
                              cli_common.stage_batch(np_batch, dev),
                              offset=opt.offset, use_kernels=opt.useKernels)
    checked, envs = 0, 0
    for n, name in enumerate(np_batch["name"]):
        want = normalize_cascade_pre({
            key: products[key[:-len("_pre")]][n].permute(2, 0, 1).cpu()
            .numpy() for key in PRE_STEMS})
        got = load_cascade_pre(name, 1)
        for key in PRE_STEMS:
            if not np.array_equal(got[key], want[key]):
                raise AssertionError(
                    f"hand-off file {key} of {name} differs from the "
                    "products in memory by up to "
                    f"{np.abs(got[key] - want[key]).max():.3g}")
            checked += 1
        env, ind = load_env_pre(name, 1, float(np_batch["env_ind"][n, 0]),
                                SG_NUM, ENV_RC)
        if ind:
            if not np.array_equal(env, products["env"][n].cpu().numpy()):
                raise AssertionError(f"hand-off env_pre of {name} differs")
            envs += 1
    if not envs:
        raise AssertionError("no env_pre file in the first batch")
    return checked, envs, len(np_batch["name"])


def cell_export(ctx, smi):
    """cli-export: ``output_brdf_light`` at cascade 0 over the TRAIN split
    on phase 9's checkpoints, seven files an image through the port's
    HDF5 codec; the first batch's files read back bit-equal to the
    products in memory; the codec's round trip and times on the host.
    Returns its launches."""
    t0 = time.perf_counter()
    _, got = launch_delta(lambda: cli_output_brdf_light.main(
        export_args(ctx)))
    seconds = time.perf_counter() - t0
    n = FIXTURE_IMAGES // 4
    expect_launches("output_brdf_light", got, render_sg_fwd=n,
                    sg_envmap_fwd=n)
    root = ctx["roots"]["openrooms"]
    files = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
             if f.endswith("_0.h5")]
    if len(files) < 6 * FIXTURE_IMAGES:
        raise AssertionError(f"output_brdf_light wrote {len(files)} files")
    size = sum(os.path.getsize(f) for f in files)
    log(f"[cli-export] output_brdf_light c0, {FIXTURE_IMAGES} images at B=4: "
        f"{seconds:.1f} s (set-up included); {len(files)} files, "
        f"{size / 2**20:.1f} MiB; launches {got}; {smi}")
    t0 = time.perf_counter()
    checked, envs, b = check_handoff_files(ctx)
    log(f"[cli-export] the first batch's files read back (load_cascade_pre "
        f"/ load_env_pre) against normalize_cascade_pre on export_step's "
        f"products in memory, same checkpoints and batch: {checked} maps "
        f"and {envs} SG tensors of {b} images bit-equal "
        f"({time.perf_counter() - t0:.1f} s)")
    check_codec(smi)
    return got


def cell_c1(ctx, smi):
    """cli-c1: cascade 1 from cli-export's files, each CLI a few steps:
    ``train_brdf`` (the 17-channel encoder reads the ``*_pre`` maps),
    ``train_light`` and ``train_bilateral`` on its checkpoint, and
    ``test_synthetic --stage light`` on both.  Returns the launches."""
    root, tmp = ctx["roots"]["openrooms"], ctx["tmp"]
    c1 = ("--cascadeLevel", 1)
    exp = {k: os.path.join(tmp, k + "_c1") for k in ("brdf", "light", "bs")}
    launches = dict.fromkeys(KERNELS, 0)
    blurs = BS_CLI_STEPS * BS_TRAIN_B * (BLURS_FWD + BLURS_GRAD)
    four = dict.fromkeys(TRAINING_KERNELS, C1_STEPS)
    runs = (
        # one step an epoch at B=16
        ("train_brdf", cli_train_brdf.main, C1_STEPS, {}, cli_args(
            root, exp["brdf"], *c1, "--batchSize", BRDF_TRAIN_B, *THREADS,
            "--nepoch", C1_STEPS, "--previewEvery", 0, *F32)),
        ("train_light", cli_train_light.main, C1_STEPS, four, cli_args(
            root, exp["light"], *c1, "--batchSize", TRAIN_B, *THREADS,
            "--nepoch", 1, "--maxSteps", C1_STEPS, "--brdfExperiment",
            exp["brdf"], "--useKernels", *F32)),
        ("train_bilateral", cli_train_bilateral.main, BS_CLI_STEPS,
         {"bilateral_blur": blurs}, cli_args(
             root, exp["bs"], *c1, "--batchSize", BS_TRAIN_B, *THREADS,
             "--maxSteps", BS_CLI_STEPS, "--brdfExperiment", exp["brdf"],
             "--useKernels")),
    )
    for name, main, steps, want, argv in runs:
        torch.cuda.reset_peak_memory_stats()
        with CLITimer() as timer:
            _, got = launch_delta(lambda: main(argv))
        finite_lines(f"{name} c1", timer, steps)
        expect_launches(f"{name} c1", got, **want)
        launches = {k: launches[k] + got[k] for k in KERNELS}
        log(f"[cli-c1] {name} --cascadeLevel 1 on cli-export's files, "
            f"{steps} steps: step ms {rounded(timer.times['step'])}, loader "
            f"waits ms {rounded(timer.times['loader'])}, saves ms "
            f"{rounded(timer.times['save'])}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; "
            + ", ".join(f"{k} {v:.6g}" for k, v in timer.lines[-1][2].items())
            + f"; launches {got}")
    # the TEST list names the TRAIN scene, whose files cli-export wrote
    with open(os.path.join(root, "train.txt")) as f, \
            open(os.path.join(root, "test.txt"), "w") as g:
        g.write(f.read())
    t0 = time.perf_counter()
    means, got = launch_delta(lambda: cli_test_synthetic.main(cli_args(
        root, os.path.join(tmp, "unused"), *c1, "--stage", "light",
        "--testRoot", os.path.join(tmp, "test_light_c1"),
        "--brdfExperiment", exp["brdf"], "--lightExperiment", exp["light"],
        "--batchSize", TRAIN_B, "--maxSteps", EVAL_STEPS, *THREADS)))
    expect_launches("test_synthetic light c1", got,
                    render_sg_fwd=EVAL_STEPS, sg_envmap_fwd=EVAL_STEPS)
    if not all(np.isfinite(v) for v in means.values()):
        raise AssertionError(f"test_synthetic light c1: {means}")
    launches = {k: launches[k] + got[k] for k in KERNELS}
    log(f"[cli-c1] test_synthetic --stage light --cascadeLevel 1, "
        f"{EVAL_STEPS} batches of {TRAIN_B}: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms (set-up included); "
        + ", ".join(f"{k} {v:.6g}" for k, v in means.items())
        + f"; launches {got}; {smi}")
    return launches


def phase_clis(ctx, smi):
    """Phase 10: the other CLIs from disk, on phase 9's fixtures and
    checkpoints, cascade 1 on the files cascade 0 exports.  Returns
    {kernel: launches} of the phase; each of the six kernels must have
    launched."""
    t_phase = time.perf_counter()
    launches = dict.fromkeys(KERNELS, 0)

    def add(got):
        for k in KERNELS:
            launches[k] += got[k]

    def cell(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        log(f"[time] cell {name}: {time.perf_counter() - t0:.1f} s")
        return out

    add(cell("cli-cache", cell_cache, ctx, smi))
    add(cell("cli-c0-bs", cell_bilateral, ctx, smi))
    add(cell("cli-export", cell_export, ctx, smi))
    add(cell("cli-c1", cell_c1, ctx, smi))
    add(cell("cli-ft", cell_finetune, ctx, smi))
    got, real_out = cell("cli-test-real", cell_test_real, ctx, smi)
    add(got)
    add(cell("cli-eval", cell_eval, ctx, smi, real_out))
    missing = [k for k in KERNELS if not launches[k]]
    if missing:
        raise AssertionError(f"phase 10 never launched {missing}")
    log(f"[cli] phase 10: {time.perf_counter() - t_phase:.1f} s; launches "
        f"{launches}; {smi}")
    return launches

# --------------------------------------------------------------- phase 11

# 6 before phase 13, 3 before data-parallel serving, cut to fit the run
BF16_STEPS = 2
# the JAX package's bf16-against-f32 tolerances on a step's loss
# (tests/test_pipeline.py:163-196)
BF16_TOL = {"brdf": 0.02, "light": 0.05}
TRAINING_KERNELS = ("render_sg_fwd", "render_sg_bwd", "sg_envmap_fwd",
                    "sg_envmap_bwd")


def check_f32(tag, nets, preds):
    """The params, their gradients and the heads are float32."""
    bad = [n for n, p in nets.named_parameters()
           if p.dtype != torch.float32 or p.grad is None
           or p.grad.dtype != torch.float32]
    bad += [f"head {k}" for k, v in preds.items() if v.dtype != torch.float32]
    if bad:
        raise AssertionError(f"{tag}: not float32: {bad[:5]}")


def dtype_runs(tag, make_step, nets, batch, heads):
    """For float32 and bfloat16, from copies of the same weights: step
    1's loss before any update, one step (cuDNN's autotuning), then
    BF16_STEPS timed steps, the launches of all 1 + BF16_STEPS steps
    read.  ``heads(step)``: the step's float heads on ``batch``.  Returns
    {dtype: {"loss", "med", "p90", "peak", "launches"}}."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        copied = copy.deepcopy(nets)
        copied.compute_dtype = dtype
        step = make_step(copied)
        with torch.no_grad():
            loss = float(step.loss(batch)[0])
        reset_launches()
        metrics = step(batch)
        torch.cuda.reset_peak_memory_stats()
        times, totals = [], [float(metrics["total"])]
        for _ in range(BF16_STEPS):
            metrics, ms = timed_step(step, batch)
            times.append(ms)
            totals.append(float(metrics["total"]))
        launches = read_launches()
        if not all(np.isfinite(totals)):
            raise AssertionError(f"{tag} {dtype}: totals {totals}")
        peak = torch.cuda.max_memory_allocated() / 2**20
        with torch.no_grad():
            check_f32(f"{tag} {dtype}", copied, heads(step))
        med, p90 = percentiles(times)
        out[dtype] = {"loss": loss, "med": med, "p90": p90, "peak": peak,
                      "launches": launches}
        log(f"{tag} {dtype}: step 1's loss {loss:.6g}; {BF16_STEPS} steps "
            f"after the autotuned one: ms/step median {med:.3f} p90 "
            f"{p90:.3f}; peak device memory {peak:.0f} MiB; total "
            f"{totals[0]:.6g} -> {totals[-1]:.6g}; launches of the "
            f"{1 + BF16_STEPS} steps {launches}")
        del step, copied
    return out


def bf16_brdf(seed, dev, smi):
    """The c0 BRDF step at B=16, 240x320, both dtypes on the same weights
    and batch: the loss within 2%, no kernel launched, the conv TFLOP/s."""
    gen = torch.Generator().manual_seed(seed + 11)
    nets = BRDFNets(0, generator=gen)
    batch = synthetic_batch(batch=BRDF_TRAIN_B, im_hw=IM_HW, env_rc=ENV_RC,
                            sg_num=SG_NUM, seed=seed + 11, device=dev)
    flops = brdf_conv_flops(nets, batch)
    tag = f"[bf16] c0 BRDF step B={BRDF_TRAIN_B} {IM_HW[0]}x{IM_HW[1]}"
    runs = dtype_runs(
        tag, lambda n: make_brdf_train_step(n, device=dev, lr=TRAIN_LR),
        nets, batch, lambda step: brdf_forward(step.brdf_nets, batch))
    for dtype, r in runs.items():
        expect_launches(f"{tag} {dtype}", r["launches"])
    rel = abs(runs["bfloat16"]["loss"] / runs["float32"]["loss"] - 1.0)
    log(f"{tag}: bf16 loss against f32 {rel:.3e} (tolerance "
        f"{BF16_TOL['brdf']}); convolutions {flops / 1e12:.3f} TFLOP a "
        "step, at the median " + ", ".join(
            f"{d} {flops / r['med'] / 1e9:.1f} TFLOP/s" for d, r in
            runs.items()) + f"; bf16 step {runs['float32']['med'] / runs['bfloat16']['med']:.2f}x "
        f"f32's; {smi}")
    if not rel <= BF16_TOL["brdf"]:
        raise AssertionError(f"{tag}: bf16 loss {rel} from f32's")


def bf16_light(seed, dev, smi):
    """The c0 light step at B=5 (grid 120x160, light input 480x640, K=12)
    on the kernel route, frozen f32 BRDF nets and the light nets in each
    dtype (train_light's arrangement): the loss within 5%, one launch of
    each training kernel a step, float32 heads and gradients."""
    gen = torch.Generator().manual_seed(seed + 12)
    brdf = BRDFNets(0, generator=gen)
    light = LightNets(sg_num=SG_NUM, env_rows=ENV_RC[0], env_cols=ENV_RC[1],
                      generator=gen)
    batch = synthetic_batch(batch=TRAIN_B, im_hw=IM_HW, env_rc=ENV_RC,
                            sg_num=SG_NUM, seed=seed + 12, device=dev)
    tag = f"[bf16] c0 light step B={TRAIN_B}"

    def heads(step):
        sg_out = light_step(step.brdf_nets, step.light_nets, batch)[1]["sg"]
        return {k: sg_out[k] for k in ("axis", "lamb01", "weight01")}

    runs = dtype_runs(
        tag, lambda n: make_light_train_step(copy.deepcopy(brdf), n,
                                             device=dev, lr=TRAIN_LR),
        light, batch, heads)
    for dtype, r in runs.items():
        expect_launches(f"{tag} {dtype}", r["launches"],
                        **dict.fromkeys(TRAINING_KERNELS, 1 + BF16_STEPS))
    rel = abs(runs["bfloat16"]["loss"] / runs["float32"]["loss"] - 1.0)
    log(f"{tag}: bf16 loss against f32 {rel:.3e} (tolerance "
        f"{BF16_TOL['light']}); each training kernel launched once a step "
        "in either dtype, on float32 inputs (the wrappers take nothing "
        f"else); bf16 step {runs['float32']['med'] / runs['bfloat16']['med']:.2f}x f32's; {smi}")
    if not rel <= BF16_TOL["light"]:
        raise AssertionError(f"{tag}: bf16 loss {rel} from f32's")
    return {k: sum(r["launches"][k] for r in runs.values()) for k in KERNELS}


def check_wrappers_refuse_bf16(dev):
    """Each kernel wrapper raises on a bfloat16 CUDA input and launches
    nothing (the heads stay float32 in bf16 mode; a bf16 tensor at a
    kernel would be a fault of the casts)."""
    b, h, w, k = 1, 2, 3, 4
    t = [torch.rand(shape, device=dev).to(torch.bfloat16) for shape in (
        (b, h, w, 3), (b, h, w, 3), (b, h, w, 1), (b, h, w, k, 3),
        (b, h, w, k), (b, h, w, k, 3))]
    grid = bilateral.build_grid(torch.rand((4, 5, 3), device=dev) * 255,
                                8.0, 4.0, 4.0)
    calls = {
        "render_sg_env": lambda: sg_render.render_sg_env(*t),
        "render_sg_fwd": lambda: sg_render.render_sg_fwd(*t),
        "render_sg_bwd": lambda: sg_render.render_sg_bwd(
            *t, t[0].contiguous(), t[0].contiguous()),
        "sg_envmap_fwd": lambda: sg_render.sg_envmap_fwd(*t[3:]),
        "sg_envmap_bwd": lambda: sg_render.sg_envmap_bwd(
            *t[3:], torch.zeros(t[4].shape + (N_DIRS, 3), device=dev,
                                dtype=torch.bfloat16)),
        "bilateral_blur": lambda: bilateral.bilateral_blur(
            grid, torch.ones((grid.nvert, 2), device=dev,
                             dtype=torch.bfloat16)),
    }
    for name, call in calls.items():
        try:
            _, got = launch_delta(call)
        except ValueError as e:
            if "float32" not in str(e):
                raise
        else:
            raise AssertionError(f"{name} took a bfloat16 input: {got}")
        expect_launches(f"{name} on bf16", read_launches())
    log("[bf16] each of the six kernel wrappers raises ValueError on a "
        "bfloat16 CUDA input and launches nothing")


def bf16_test_real(ctx, smi):
    """``test_real --computeDtype bfloat16 --level 2 --isLight --isBS`` on
    the first of phase 10's photos: the bf16 stacks served, finite
    outputs of every level, phase 10's launches a photo.  The products'
    host writes (~13 s, the same code as phase 10's f32 photos, which
    write and check them) are left out, cut to fit the run."""
    with open(os.path.join(ctx["tmp"], "photos", "list.txt")) as f:
        first = f.readline().strip()
    im_list = os.path.join(ctx["tmp"], "photos", "bf16.txt")
    with open(im_list, "w") as f:
        f.write(first + "\n")
    out = os.path.join(ctx["tmp"], "real_bf16")
    argv = ["--imList", im_list, "--output", out, "--level", "2",
            "--isLight", "--isBS", "--device", "cuda", "--computeDtype",
            "bfloat16", "--experimentBRDF0", ctx["brdf_exp"],
            "--experimentLight0", ctx["light_exp"]]
    write_products = cli_test_real.write_products
    cli_test_real.write_products = lambda *a, **kw: None
    try:
        with PhotoTimer() as timer:
            _, launches = launch_delta(lambda: cli_test_real.main(argv))
    finally:
        cli_test_real.write_products = write_products
    expect_launches("test_real bf16", launches, render_sg_env=2,
                    bilateral_blur=2 * BLURS_FWD)
    (renderer, *_), result = timer.first
    dtypes = {net.compute_dtype for pair in renderer._nets for net in pair}
    if dtypes != {"bfloat16"}:
        raise AssertionError(f"test_real bf16 served {dtypes}")
    check_shapes(result)
    log(f"[bf16] test_real --computeDtype bfloat16 --level 2 --isLight "
        f"--isBS on {os.path.basename(first)}: chain ms "
        f"{rounded(timer.times['chain'])} (cuDNN's autotuning of the bf16 "
        f"shapes included); finite outputs (the products' writes left "
        f"out); launches {launches}; {smi}")
    return launches


def phase_bf16(seed, dev, ctx, smi):
    """Phase 11: the bf16 compute dtype at full width.  Returns {kernel:
    launches} of its runs."""
    torch.backends.cudnn.benchmark = True
    bf16_brdf(seed, dev, smi)
    launches = bf16_light(seed, dev, smi)
    check_wrappers_refuse_bf16(dev)
    got = bf16_test_real(ctx, smi)
    return {k: launches[k] + got[k] for k in KERNELS}


# --------------------------------------------------------------- phase 12

# tests/test_convergence.py:37-51's configuration, in bf16, with the light
# leg at 24 epochs (192 steps) instead of 12: on the card the held-out
# render at 96 steps was still mid-transient (1.13-3.71x over init, under
# the gate's 1.25x in 2 of 6 runs), at 192 steps 1.54-2.32x in 6 of 6.
# The IIW leg stays at 2 epochs: more steps lowered its held-out WHDR
# gain (see PERF.md section 4).
LEARNING_ARGS = (
    "--imHeight", "64", "--imWidth", "64", "--envRow", "32", "--envCol",
    "32", "--scenes", "2", "--perScene", "8", "--brdfEpochs", "32",
    "--brdfBatch", "4", "--lightEpochs", "24", "--lightBatch", "2",
    "--bsEpochs", "2", "--bsBatch", "2", "--bsMid", "--finetuneIIW",
    "--iiwEpochs", "2", "--iiwBatch", "2", "--capstone",
    "--computeDtype", "bfloat16", "--device", "cuda")
LEARNING_STAGES = {"brdf", "light", "bilateral", "bilateral_mid",
                   "finetune_iiw", "capstone"}


def phase_learning(smi):
    """Phase 12: the convergence harness (``cli/run_convergence.py``) at
    the JAX gate's configuration, in a temp dir outside the checkout,
    under ``torch.use_deterministic_algorithms(True)`` in this process
    (``CUBLAS_WORKSPACE_CONFIG`` is set before CUDA starts; the CLIs'
    ``setup_device`` then keeps autotuning off), held to the JAX gate's
    assertions (``run_convergence.gate``).  Returns {kernel: launches} of
    the run."""
    out = tempfile.mkdtemp(prefix="irois_learning_")
    benchmark = torch.backends.cudnn.benchmark
    torch.use_deterministic_algorithms(True)
    try:
        summary, launches = launch_delta(lambda: run_convergence.main(
            ["--out", out, *LEARNING_ARGS]))
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.benchmark = benchmark
        shutil.rmtree(out, ignore_errors=True)
    stages = summary["stages"]
    for name, rec in stages.items():
        log(f"[learning] {name}: " + json.dumps(
            {k: v for k, v in rec.items() if k != "level"}))
    log("[learning] under torch.use_deterministic_algorithms(True), "
        "cudnn.benchmark off; sha256 of the stages without their wall "
        f"times: {run_convergence.stages_digest(stages)}")
    if set(stages) != LEARNING_STAGES:
        raise AssertionError(f"[learning] stages {sorted(stages)}")
    failed = run_convergence.gate(stages)
    if failed:
        raise AssertionError("[learning] the gate failed: "
                             + "; ".join(failed))
    missing = [k for k in KERNELS if not launches[k]]
    if missing:
        raise AssertionError(f"phase 12 never launched {missing}")
    log(f"[learning] every leg passes tests/test_convergence.py's "
        f"assertions; launches {launches}; {smi}")
    return launches


# --------------------------------------------------------------- phase 13

# the data-parallel run: the ranks of parallel/dryrun.py, each its own
# process on the one card, over gloo (NCCL refuses two ranks on one
# device); the cascade-0 light family at phase 5's operating point
DP_WORLD = 2
DP_LIGHT0 = f"{IM_HW[0]},{IM_HW[1]},{ENV_RC[0]},{ENV_RC[1]}"
DP_RUN_S = 400  # the two ranks' run, start-up included
DP_TIMED = 1  # timed c0 light steps, logged (2 before: cut to fit the run)
# a group step against the single-process step on the whole batch: JAX
# tests/test_parallel.py and tests/test_shard_map.py's tolerances (Adam's
# first update is lr g / (|g| + eps), so a gradient near zero may flip
# sign under another reduction order)
DP_METRIC_RTOL = {"bilateral": 5e-4}
DP_METRIC_RTOL_DEFAULT = 2e-4
DP_PARAM_ATOL = 3e-4
# data-parallel serving, a rank's rows against one process's call on the
# whole batch: the scales at phase 4b's batch-against-images rtol (a
# rank's B=2 convolutions may take other cuDNN algorithms than B=4's,
# autotuning off: C21), the maps and lighting at dryrun.SERVE_TOL (phase
# 4's), the confidences (divided by their maximum over the group) rtol
# 1e-6
DP_SERVE_SCALE_RTOL = 1e-4  # BATCH_RTOL
DP_SERVE_CONF_RTOL = 1e-6


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_ranks(*extra):
    """Run ``parallel/dryrun.py`` on the card as DP_WORLD ranks over gloo,
    meeting on a free local port; returns each rank's line ({"families":
    {family: record}, "serve": record}).  Every rank is killed if one
    fails or the run outlasts DP_RUN_S."""
    port = free_port()
    root = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "inverserenderingofindoorscene_torch."
         "parallel.dryrun", "--initMethod", f"tcp://127.0.0.1:{port}",
         "--world", str(DP_WORLD), "--rank", str(r), "--device", "cuda",
         "--light0", DP_LIGHT0, *extra],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(DP_WORLD)]
    deadline = time.monotonic() + DP_RUN_S
    records = []
    try:
        for r, proc in enumerate(procs):
            try:
                out, err = proc.communicate(
                    timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"[data parallel] rank {r} still "
                                     f"running after {DP_RUN_S} s")
            if proc.returncode:
                raise AssertionError(f"[data parallel] rank {r} exited "
                                     f"{proc.returncode}:\n{err[-4000:]}")
            line = [x for x in out.splitlines() if x.startswith("DRYRUN ")]
            records.append(json.loads(line[-1][len("DRYRUN "):]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return records


def nccl_world_of_one():
    """The c0 light family and the serving record through an NCCL group of
    this one process, with ``cudnn.benchmark`` off as in the ranks;
    returns their records."""
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    dev = torch.device("cuda")
    group = multihost.initialize("nccl", f"tcp://127.0.0.1:{free_port()}",
                                 1, 0)
    try:
        light = dryrun.run(group, dev, ("light0",), (IM_HW, ENV_RC))["light0"]
        serve = dryrun.serve(group, dev, *dryrun.serving_nets(ENV_RC),
                             *dryrun.serving_batch(IM_HW, ENV_RC))[0]
        return light, serve
    finally:
        torch.distributed.destroy_process_group()
        torch.backends.cudnn.benchmark = benchmark


def dp_launches(name, local_b):
    """The kernels a family's group step launches on a rank."""
    if name.startswith("light"):
        return {**dict.fromkeys(KERNELS, 1), "render_sg_env": 0,
                "bilateral_blur": 0}
    if name == "bilateral":
        return {**dict.fromkeys(KERNELS, 0),
                "bilateral_blur": (BLURS_FWD + BLURS_GRAD) * local_b}
    return dict.fromkeys(KERNELS, 0)


def check_against_single_process(tag, name, rec):
    """A family's group step against the single-process step that its
    rank took on the whole batch."""
    ref = rec["ref"]
    rtol = DP_METRIC_RTOL.get(name, DP_METRIC_RTOL_DEFAULT)
    rel = {k: abs(rec["metrics"][k] - v) / abs(v) if v else
           abs(rec["metrics"][k]) for k, v in ref["metrics"].items()}
    worst = max(rel, key=rel.get)
    log(f"{tag} {name}: metrics' worst relative difference {rel[worst]:.3e} "
        f"({worst}), parameters' max abs difference "
        f"{ref['max_param_diff']:.3e}, summed gradient's relative L2 "
        f"{ref['grad_rel_l2']:.3e} (logged), total "
        f"{rec['metrics']['total']:.6g}")
    if sorted(rel) != sorted(rec["metrics"]) or not rel[worst] <= rtol:
        raise AssertionError(f"{tag} {name}: metrics {rec['metrics']} "
                             f"against {ref['metrics']}, rtol {rtol}")
    if not ref["max_param_diff"] < DP_PARAM_ATOL:
        raise AssertionError(f"{tag} {name}: parameters "
                             f"{ref['max_param_diff']} apart")


def check_serving(tag, rec):
    """A rank's data-parallel serving record (``parallel/dryrun.serve``):
    its rows against one process's call on the whole batch, its
    confidences against one process's confidences of the group call's
    maps, its launches."""
    worst = {"scales (relative)": max(rec["scales"].values()),
             "maps and lighting (allclose ratio)": max(
                 rec["close"].values()),
             "specular (relative L1)": max(rec["specular_rel_l1"].values()),
             "refined vs its own refinement": rec["refined_max_abs"],
             "confidences (relative)": max(rec["conf_rel"].values())}
    log(f"{tag}: B={rec['local_b']} of {dryrun.GLOBAL_B}, {rec['ms']:.1f} "
        f"ms the batch (the renderer's first call), launches "
        f"{rec['launches']}; against one process: " + ", ".join(
            f"{k} {v:.3e}" for k, v in worst.items())
        + "; maps max abs " + ", ".join(
            f"{k} {v:.2e}" for k, v in rec["maps_max_abs"].items())
        + "; the confidences with this rank's own maximum (logged) "
        + ", ".join(f"{k} {v:.2e}" for k, v in
                    rec["conf_local_rel"].items())
        + "; against the one process's confidences of its own maps "
        "(logged, C21) " + ", ".join(f"{k} {v:.2e}" for k, v in
                                     rec["conf_call_rel"].items())
        + f"; {rec['seconds']:.1f} s, set-up included")
    limits = {"scales (relative)": DP_SERVE_SCALE_RTOL,
              "maps and lighting (allclose ratio)": 1.0,
              "specular (relative L1)": SPECULAR_REL_L1,
              "refined vs its own refinement": 0.0,
              "confidences (relative)": DP_SERVE_CONF_RTOL}
    over = {k: v for k, v in worst.items() if not v <= limits[k]}
    if over:
        raise AssertionError(f"{tag}: {over} against {limits}")
    expect_launches(tag, rec["launches"], render_sg_env=2,
                    bilateral_blur=2 * BLURS_FWD * rec["local_b"])


def phase_data_parallel(smi):
    """Phase 13: the data-parallel layer on the card.  Two ranks share it
    over gloo, take one step of each of the eight families and serve a
    batch through the group; then a world of one on NCCL takes the
    cascade-0 light step and serves the batch.  Returns {kernel:
    launches} of the group steps and group calls, the ranks' and the
    world of one's."""
    torch.cuda.empty_cache()
    families = dryrun.FAMILIES
    t0 = time.perf_counter()
    lines = dryrun_ranks("--timedSteps", str(DP_TIMED), "--serve", DP_LIGHT0)
    ranks = [line["families"] for line in lines]
    log(f"[data parallel] {DP_WORLD} ranks over gloo on one card, global "
        f"batch {dryrun.GLOBAL_B}, c0 light at {DP_LIGHT0} (image, grid), "
        f"the rest at dryrun's shapes: {time.perf_counter() - t0:.1f} s; "
        "s a family on each rank (set-up included): " + ", ".join(
            f"{name} " + "/".join(f"{r[name]['seconds']:.1f}" for r in ranks)
            for name in families))
    launches = dict.fromkeys(KERNELS, 0)
    for i, name in enumerate(families):
        recs = [r[name] for r in ranks]
        if len({r["digest"] for r in recs}) != 1 or any(
                r["metrics"] != recs[0]["metrics"] for r in recs):
            raise AssertionError(f"[data parallel] {name}: the ranks' "
                                 "metrics or parameters differ")
        for r, rec in enumerate(recs):
            expect_launches(f"[data parallel] {name} rank {r}",
                            rec["launches"],
                            **dp_launches(name, rec["local_b"]))
            for k, n in rec["launches"].items():
                launches[k] += n
        # rank i % DP_WORLD took its single-process step (FAMILIES[rank::
        # world], parallel/dryrun.py)
        check_against_single_process("[data parallel]", name,
                                     recs[i % DP_WORLD])
    log("[data parallel] the ranks bit-equal in every family; launches "
        f"{launches}")
    light = [r["light0"] for r in ranks]
    med = [statistics.median(r["ms"]) for r in light]
    ref_ms = statistics.median(light[0]["ref"]["ms"])
    log(f"[data parallel] c0 light, ms a step (median of {DP_TIMED}, "
        "after the checked step): "
        f"{DP_WORLD} ranks sharing the card "
        + ", ".join(f"{m:.1f}" for m in med)
        + f"; one process on the whole batch {ref_ms:.1f}; in all_reduce "
        "a step (each call synchronized): " + ", ".join(
            f"{r['all_reduce']['ms']:.1f} ms ({r['all_reduce']['n']} calls,"
            f" {r['all_reduce']['bytes']} B)" for r in light)
        + "; peak memory a rank " + ", ".join(
            f"{r['peak_mib']:.0f}" for r in light)
        + f" MiB; {smi}.  Two ranks time-slicing one card say nothing of "
        "scaling across cards")
    serve = [line["serve"] for line in lines]
    if len({rec["digest"] for rec in serve}) != 1:
        raise AssertionError("[data parallel] the ranks serve different "
                             "weights")
    for r, rec in enumerate(serve):
        check_serving(f"[data parallel] serving, rank {r}", rec)
        for k, n in rec["launches"].items():
            launches[k] += n
    log(f"[data parallel] serving: the ranks serve one set of weights; "
        f"{smi}")
    t0 = time.perf_counter()
    rec, served = nccl_world_of_one()
    expect_launches("[data parallel] NCCL world of one", rec["launches"],
                    **dp_launches("light0", rec["local_b"]))
    check_against_single_process("[data parallel] NCCL world of one",
                                 "light0", rec)
    check_serving("[data parallel] NCCL world of one, serving", served)
    for run in (rec, served):
        for k, n in run["launches"].items():
            launches[k] += n
    log(f"[data parallel] NCCL world of one: {time.perf_counter() - t0:.1f} "
        "s")
    return launches


# -------------------------------------------------------------- phase 4b


FUSED_CHECKED = 3  # B=1 requests held fused against staged
FUSED_B = 4  # the batch held against its images one by one
# B=1 requests a mode, fused and staged in turns (10 before phase 13, 5
# before data-parallel serving, cut to fit the run)
N_FUSED_TIMED = 3
N_FUSED_BATCHES = 1  # timed B=4 batches (2 before phase 13, cut to fit)
# a batch's c_light against each image's B=1 call: the JAX test's rtol
# (tests/test_pipeline.py:283-296); the same float32 chain, its
# convolutions summed in another order at another batch size
BATCH_RTOL = 1e-4
# fused against staged predictions (tests/test_pipeline.py:256-263); a
# batch's refinement against each image's refinement of its own maps
FUSED_PRED_ATOL = 2e-5
BATCH_REFINE_ATOL = 1e-5
# the exported chain against the fused call (tests/test_pipeline.py:
# 328-341)
EXPORT_TOL = {"c_light": 1e-5, "albedo": 1e-6}


def to_device(dev, *arrays):
    return [torch.as_tensor(a, device=dev) for a in arrays]


def max_err(a, b):
    return float((a.double() - b.double()).abs().max())


def check_fused_vs_staged(fused, staged, worst):
    """One B=1 request in both modes: each cascade's predictions and
    envmap, the scale fit (host float64 against traced float32, the
    card's scale tolerance C3), each level's refinement."""
    for lvl in range(2):
        for k, v in fused["preds"][lvl].items():
            err = max_err(v, staged["preds"][lvl][k])
            if not err <= FUSED_PRED_ATOL:
                raise AssertionError(f"[fused] level {lvl} {k}: fused vs "
                                     f"staged {err:.3e}")
            worst[f"preds{lvl}"] = max(worst.get(f"preds{lvl}", 0.0), err)
        fl, sl = fused["lights"][lvl], staged["lights"][lvl]
        key = f"light{lvl}.env_img"
        worst[key] = max(worst.get(key, 0.0), check_close(
            f"[fused] {key}", fl["env_img"], sl["env_img"],
            *CHAIN_TOL["env_img"]))
        for k in ("c_albedo", "c_light"):
            got = float(fl[k][0])
            rel = abs(got - sl[k]) / abs(sl[k])
            if not rel <= SCALE_RTOL:
                raise AssertionError(f"[fused] {k} level {lvl}: {got} vs "
                                     f"staged {sl[k]}")
            key = f"light{lvl}.{k} (relative)"
            worst[key] = max(worst.get(key, 0.0), rel)
        for k, v in fused["refined"][lvl].items():
            key = f"refined{lvl}.{k}"
            worst[key] = max(worst.get(key, 0.0), check_close(
                f"[fused] {key}", v, staged["refined"][lvl][k],
                *REFINE_TOL))


def check_batch(im4, out4, singles, worst):
    """The B=4 call against its images' B=1 calls: each c_light (rtol
    1e-4), the four scales not all equal; each refined map (unit
    confidence) against the image's refinement of the batch's own maps.
    The predictions and refined maps of the B=1 calls are logged beside:
    the convolutions of a batch sum in another order, cascade 1 takes
    cascade 0's fitted maps, and the solver's grid puts each guide pixel
    in a cell, so last-bit differences can move a pixel across a cell.  (With confidence nets a batch's refinement is not its images'
    own: the confidence is divided by its maximum over the whole batch
    tensor, BilateralLayer.py:269, in the JAX package too.)"""
    c4 = [float(x) for x in out4["light"]["c_light"]]
    for i, one in enumerate(singles):
        c1 = float(one["light"]["c_light"][0])
        rel = abs(c4[i] - c1) / abs(c1)
        if not rel <= BATCH_RTOL:
            raise AssertionError(f"[fused] image {i} of the batch: c_light "
                                 f"{c4[i]} vs {c1} alone")
        worst["batch c_light (relative)"] = max(
            worst.get("batch c_light (relative)", 0.0), rel)
        for lvl in range(2):
            for k, v in out4["preds"][lvl].items():
                key = f"batch preds{lvl} vs alone (logged)"
                worst[key] = max(worst.get(key, 0.0), max_err(
                    v[i], one["preds"][lvl][k][0]))
            for k, v in out4["refined"][lvl].items():
                key = f"batch refined{lvl} vs alone (logged)"
                worst[key] = max(worst.get(key, 0.0), max_err(
                    v[i], one["refined"][lvl][k][0]))
    if len(set(c4)) == 1:
        raise AssertionError(f"[fused] four images, one scale {c4}")
    with torch.inference_mode():
        for lvl, preds in enumerate(out4["preds"]):
            for i in range(len(singles)):
                own = refine_bs(im4[i:i + 1],
                                {k: v[i:i + 1] for k, v in preds.items()})
                for k, v in own.items():
                    err = max_err(out4["refined"][lvl][k][i], v[0])
                    if not err <= BATCH_REFINE_ATOL:
                        raise AssertionError(
                            f"[fused] image {i} level {lvl} refined {k}: "
                            f"batch vs its own {err:.3e}")
                    key = f"batch refined{lvl}"
                    worst[key] = max(worst.get(key, 0.0), err)


def check_no_sync(tag, renderer, im, im_small):
    """The chain with the traced fit under ``set_sync_debug_mode("error")``:
    any host sync inside it raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            out = renderer._run_chain(im, im_small, 57.0,
                                      predict_light_traced)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"[fused] {tag}: the chain ran under set_sync_debug_mode('error') "
        "without a host sync")
    return out


def kernel_events(prof, needle):
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and needle in e.name)


def profiled_request(renderer, im, im_small, tries=3):
    """One fused B=1 request in torch.profiler: the serving walk's and the
    blur's kernels by name (2 and 2 * BLURS_FWD; a trace that dropped
    events is taken again).  Returns the host ms, the device's busy ms
    and the trace."""
    from torch.profiler import ProfilerActivity, profile

    want = {"sg_render_walk_kernel": 2, "bilateral_blur_kernel":
            2 * BLURS_FWD}
    for i in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, ms = timed_request(renderer, im, im_small)
        got = {k: kernel_events(prof, k) for k in want}
        if got == want:
            return ms, device_busy_ms(prof), prof
        log(f"[fused] profiled request {i + 1}: kernels by name {got}, "
            f"expected {want}; tracing again")
    raise AssertionError(f"[fused] kernels by name {got}, expected {want}")


def check_served_export(fused, requests, outs, dev, smi):
    """The fused chain exported at B=1 on the card (kernel route), served
    from the bytes and the weights in this process, against the fused
    calls.  Returns {kernel: launches} of the served calls."""
    t0 = time.perf_counter()
    blob, params = fused.serialize(IM_HW, ENV_RC, fov=57.0, batch=1)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    served = deserialize_chain(blob)
    load_s = time.perf_counter() - t0
    errs = {}
    reset_launches()
    for (im, im_small), want in zip(requests, outs):
        got = served(params, *to_device(dev, im, im_small))
        c_got, c_want = got["light"]["c_light"], want["light"]["c_light"]
        rel = float(((c_got - c_want).abs() / c_want.abs()).max())
        err = max_err(got["preds"][-1]["albedo"], want["preds"][-1]["albedo"])
        if not (rel <= EXPORT_TOL["c_light"] and err <= EXPORT_TOL["albedo"]):
            raise AssertionError(f"[export] served vs fused: c_light {rel:.3e}"
                                 f", albedo {err:.3e}")
        errs["c_light"] = max(errs.get("c_light", 0.0), rel)
        errs["albedo"] = max(errs.get("albedo", 0.0), err)
    launches = read_launches()
    expect_launches("[export] served chain", launches,
                    render_sg_env=2 * len(requests))
    log(f"[export] serialize (torch.export, B=1, kernel route): "
        f"{export_s:.1f} s, {len(blob)} bytes beside "
        f"{sum(p.numel() for p in params.values())} weights; "
        f"deserialize_chain {load_s:.2f} s; {len(requests)} served requests "
        f"against the fused calls: c_light relative {errs['c_light']:.3e}, "
        f"final albedo {errs['albedo']:.3e}; launches {launches}; {smi}")
    return launches


def phase_fused(seed, dev, stacks, bs_nets, smi):
    """Phase 4b: the fused serving mode (``InverseRenderer(fused=True)``)
    on phase 4's nets, right after phase 4 and before phase 5 turns
    cuDNN's autotuning on: the algorithms it picks for a batch and for
    its images alone differ, and after phases 5-12 the scale fit put a
    B=4 batch's c_light 1.7e-4 from its image's alone.  Returns {kernel:
    launches} of its runs."""
    t_phase = time.perf_counter()
    kw = dict(is_light=True, is_bs=True, bs_nets=bs_nets)
    fused = InverseRenderer(stacks, fused=True, **kw)
    staged = InverseRenderer(stacks, **kw)
    # the batch held against its images: unit confidence (check_batch)
    unit = InverseRenderer(stacks, fused=True, is_light=True, is_bs=True)
    plain = InverseRenderer(stacks, fused=True, use_kernels=False)
    rng = np.random.RandomState(seed + 13)

    def photos(b):
        return (rng.rand(b, *IM_HW, 3).astype(np.float32) ** 2.2,
                rng.rand(b, *ENV_RC, 3).astype(np.float32) ** 2.2)

    requests = [photos(1) for _ in range(FUSED_CHECKED)]
    batch = photos(FUSED_B)
    singles = [(batch[0][i:i + 1], batch[1][i:i + 1])
               for i in range(FUSED_B)]
    for r in (fused, staged, unit, plain):  # warm-up: cuDNN, the allocator
        timed_request(r, *requests[0])

    # the main path: fused B=1 and B=4 requests, counted; staged beside
    worst = {}
    reset_launches()
    outs = []
    for im, im_small in requests:
        out, _ = timed_request(fused, im, im_small)
        ref, _ = timed_request(staged, im, im_small)
        check_fused_vs_staged(out, ref, worst)
        outs.append(out)
    out4, _ = timed_request(unit, *batch)
    ones = [timed_request(unit, *s)[0] for s in singles]
    launches = read_launches()
    n_im = 2 * FUSED_CHECKED + 2 * FUSED_B
    expect_launches("[fused] main path", launches,
                    render_sg_env=2 * (2 * FUSED_CHECKED + 1 + FUSED_B),
                    bilateral_blur=2 * BLURS_FWD * n_im)
    check_batch(torch.as_tensor(batch[0], device=dev), out4, ones, worst)
    log(f"[fused] {FUSED_CHECKED} B=1 requests fused against staged, a B="
        f"{FUSED_B} batch against its images alone; launches {launches}; "
        "max err: " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))

    log(f"[time] phase 4b checks: {time.perf_counter() - t_phase:.1f} s")
    # no host sync inside the chain, on both routes
    im_t, small_t = to_device(dev, *requests[0])
    check_no_sync("kernel route", fused, im_t, small_t)
    check_no_sync("plain route", plain, im_t, small_t)

    # one B=1 request (a B=4 trace holds cuDNN's ~200k FFT launches,
    # below, and takes a minute to read)
    ms, busy, prof = profiled_request(fused, *requests[0])
    log(f"[fused] torch.profiler, one B=1 request: {ms:.3f} ms on the host "
        f"clock, device busy {busy:.3f} ms (idle share "
        f"{1.0 - busy / ms:.3f}); the serving walk 2 launches and the blur "
        f"{2 * BLURS_FWD} by kernel name:")
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=12))

    log(f"[time] phase 4b to the timings: "
        f"{time.perf_counter() - t_phase:.1f} s")
    # times, in turns; written down, not claimed
    times = {"fused": [], "staged": []}
    chain_ms = {"fused": [], "staged": []}
    for i in range(N_FUSED_TIMED):
        im, im_small = requests[i % FUSED_CHECKED]
        for mode, r in (("fused", fused), ("staged", staged)):
            times[mode].append(timed_request(r, im, im_small)[1])
            im_t, small_t = to_device(dev, im, im_small)
            post = predict_light_traced if mode == "fused" else predict_light
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                r._run_chain(im_t, small_t, 57.0, post)
            torch.cuda.synchronize()
            chain_ms[mode].append((time.perf_counter() - t0) * 1e3)
    torch.cuda.reset_peak_memory_stats()
    batch_ms = [timed_request(fused, *batch)[1]
                for _ in range(N_FUSED_BATCHES)]
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    for mode in times:
        med, p90 = percentiles(times[mode])
        cmed, cp90 = percentiles(chain_ms[mode])
        log(f"[fused] {mode} B=1, {N_FUSED_TIMED} requests in turns with "
            f"the other mode: ms/request median {med:.3f} p90 {p90:.3f}; "
            f"the chain alone (no refinement, device tensors) median "
            f"{cmed:.3f} p90 {cp90:.3f}; {smi}")
    med = statistics.median(batch_ms)
    log(f"[fused] B={FUSED_B}, {N_FUSED_BATCHES} batches: ms/batch median "
        f"{med:.3f} (min {min(batch_ms):.3f}, max {max(batch_ms):.3f}), "
        f"ms/image {med / FUSED_B:.3f}; peak device memory "
        f"{peak_mib:.0f} MiB; {smi}")
    log(f"[time] phase 4b to the export: "
        f"{time.perf_counter() - t_phase:.1f} s")
    served = check_served_export(fused, requests, outs, dev, smi)
    for k in launches:
        launches[k] += served[k]
    log(f"[time] phase 4b cells: {time.perf_counter() - t_phase:.1f} s")
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
    clock = [time.perf_counter()] * 2  # start, last mark

    def mark(phase):
        now = time.perf_counter()
        log(f"[time] phase {phase}: {now - clock[1]:.1f} s "
            f"({now - clock[0]:.1f} s since the start)")
        clock[1] = now

    smi = phase_device()
    ptxas = phase_build()
    mark("1-2 device and build")
    # from disk (phases 9-11) in a temp dir outside the checkout, removed
    # at the end; phase 9's fixtures are written there by a process of
    # their own while phases 3-8 run on the card
    tmp = tempfile.mkdtemp(prefix="irois_from_disk_")
    fixtures = start_fixtures(tmp, args.seed)
    try:
        records = phase_kernels(args.seed, dev, ptxas)
        mark("3 kernels")
        launches, serving_nets = phase_serving(args.seed)
        mark("4 serving")
        fused = phase_fused(args.seed, dev, *serving_nets, smi)
        del serving_nets
        mark("4b fused serving")
        launches.update(phase_training(args.seed, dev))
        mark("5 training")
        # bilateral_blur's count: the serving run's and the bilateral
        # training runs' together
        launches["bilateral_blur"] += phase_bilateral_training(
            args.seed, dev)["bilateral_blur"]
        mark("6 bilateral training")
        # the cascade recipe's launches: the export's, the cascade-1 light
        # and bilateral steps'
        cascade, stack = phase_cascade(args.seed, dev)
        for name, n in cascade.items():
            launches[name] += n
        mark("7 cascade recipe")
        # the fine-tunes' launches: the cascade-1 syntheses'
        finetune, nets0 = phase_finetune(args.seed, dev, *stack)
        mark("8 fine-tunes")
        disk, ctx = phase_from_disk(dev, nets0, tmp, fixtures)
        mark("9 from disk")
        clis = phase_clis(ctx, smi)
        mark("10 the other CLIs")
        bf16 = phase_bf16(args.seed, dev, ctx, smi)
        mark("11 bf16")
    finally:
        stop_fixtures(fixtures)
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[from disk] the fixtures, checkpoints and outputs under {tmp} "
        "removed")
    learning = phase_learning(smi)
    mark("12 learning")
    data_parallel = phase_data_parallel(smi)
    mark("13 data parallel")
    for run in (fused, finetune, disk, clis, bf16, learning, data_parallel):
        for name, n in run.items():
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
