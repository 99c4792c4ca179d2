#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py [--seed N]

Phases, each fatal on failure:
  1. device: the card's name and power limit, CUDA version, TF32 off;
  2. build: compile every CUDA kernel of the serving path from the sources
     in this checkout (``inverserenderingofindoorscene_torch/ops/csrc``);
  3. kernels: each kernel's wrapper against its plain PyTorch version on
     the card, at the serving shape and two others, with times;
  4. serving: the two-cascade ``InverseRenderer`` (level 2, lighting on)
     at the reference operating point (image 240x320, lighting grid
     120x160, 12 SG lobes, 8x16 envmap) with seeded random weights; the
     launch counts show the requests went through the kernels, each
     cascade's lighting agrees with the plain route on the same inputs,
     and the plain route end to end gives the same cascade-0 maps.
The second-to-last line of output is the kernels' JSON record, the last
``{"ok": true, "device": {...}}``.  Without a CUDA card it exits non-zero
before printing any result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from inverserenderingofindoorscene_torch.ops import build, sg_render
from inverserenderingofindoorscene_torch.pipeline.brdf import BRDFNets
from inverserenderingofindoorscene_torch.pipeline.inference import (
    InverseRenderer,
    predict_light,
    predict_light_core,
)
from inverserenderingofindoorscene_torch.pipeline.light import LightNets

IM_HW = (240, 320)
ENV_RC = (120, 160)
SG_NUM = 12
N_REQUESTS = 100
KERNEL_SOURCE = "inverserenderingofindoorscene_torch/ops/csrc/sg_render_env.cu"
KERNEL_REPLACES = "inverserenderingofindoorscene_tpu/ops/sg_render.py:397"

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


def median_ms(fn, n=50, warmup=5):
    """Median of n launches, each timed with a pair of CUDA events."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


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
    return smi


def phase_build():
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"[build] {len(build.SOURCES)} kernel source(s), "
        f"{len(logs)} compiled in {time.perf_counter() - t0:.1f} s (set-up)")
    for name, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def phase_kernels(seed, dev):
    """render_sg_env vs its plain version; returns the JSON record."""
    rng = np.random.RandomState(seed)
    bw, f32_peak = card_peaks(torch.cuda.get_device_name(0))
    record = None
    for label, (b, h, w, k) in (("full", (1, *ENV_RC, SG_NUM)),
                                ("ragged", (1, 10, 13, SG_NUM)),
                                ("K=4", (1, *ENV_RC, 4))):
        args = kernel_inputs(rng, b, h, w, k, dev)
        got = sg_render.render_sg_env(*args)
        want = sg_render.render_sg_env_plain(*args)
        torch.cuda.synchronize()
        errs = {
            "diffuse": check_close("diffuse", got[0], want[0],
                                   *ELEMENT_TOL["diffuse"]),
            "specular": check_rel_l1("specular", got[1], want[1],
                                     SPECULAR_REL_L1),
            "env": check_close("env", got[2], want[2], *ELEMENT_TOL["env"]),
        }
        ms = median_ms(lambda: sg_render.render_sg_env(*args))
        plain_ms = median_ms(lambda: sg_render.render_sg_env_plain(*args))
        n, d = b * h * w, 128
        n_bytes = 4 * (n * (7 + 7 * k) + h * w * 3 + d * 4 + n * (6 + 3 * d))
        flops = n * (8 * k + 45) * d
        bound_ms = max(n_bytes / bw, flops / f32_peak) * 1e3
        bound_by = "bytes" if n_bytes / bw >= flops / f32_peak else "operations"
        log(f"[kernels] render_sg_env {label} B={b} {h}x{w} K={k}: max abs err "
            + ", ".join(f"{nm} {e:.3e}" for nm, e in errs.items())
            + f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {n_bytes / 1e6:.1f} MB, "
            f"{flops / 1e6:.0f} MFLOP)")
        if label == "full":
            record = {
                "name": "render_sg_env", "route": "cuda",
                "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
                "max_abs_err": max(errs.values()), "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None,
            }
    return record


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


def phase_serving(seed):
    """Returns the kernel launches of the main path's run."""
    gen = torch.Generator().manual_seed(seed)
    t0 = time.perf_counter()
    stacks = [(BRDFNets(lvl, generator=gen),
               LightNets(cascade_level=lvl, sg_num=SG_NUM,
                         env_rows=ENV_RC[0], env_cols=ENV_RC[1],
                         generator=gen))
              for lvl in range(2)]
    fast = InverseRenderer(stacks, is_light=True, use_kernels=True)
    plain = InverseRenderer(stacks, is_light=True, use_kernels=False)
    log(f"[serving] two cascades, seeded random weights, on "
        f"{fast.device}: {time.perf_counter() - t0:.1f} s (set-up)")
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
    worst, times, preds0 = {}, [], []
    sg_render.render_sg_env.launches = 0
    for im, im_small in requests:
        out, ms = timed_request(fast, im, im_small)
        times.append(ms)
        check_shapes(out)
        check_lighting(stacks, im, im_small, out, worst)
        preds0.append(out["preds"][0])
    launches = sg_render.render_sg_env.launches
    if launches != 2 * N_REQUESTS:
        raise AssertionError(f"render_sg_env launched {launches} times for "
                             f"{N_REQUESTS} requests, expected 2 each")

    plain_times = []
    for (im, im_small), p0 in zip(requests, preds0):
        ref, ms = timed_request(plain, im, im_small)
        plain_times.append(ms)
        check_shapes(ref)
        for k, v in p0.items():
            if not torch.equal(v, ref["preds"][0][k]):
                raise AssertionError(f"cascade-0 {k} differs between routes")
    log("[serving] lighting, kernel route vs plain route on the same "
        "inputs, max err: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    med, p90 = percentiles(times)
    pmed, pp90 = percentiles(plain_times)
    log(f"[serving] {N_REQUESTS} requests, {launches} render_sg_env "
        f"launches; ms/request kernel route median {med:.3f} p90 {p90:.3f}, "
        f"plain route median {pmed:.3f} p90 {pp90:.3f}; peak device memory "
        f"{peak_mib:.0f} MiB")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        timed_request(fast, *requests[0])
    log("[serving] torch.profiler, one request on the kernel route:")
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=20))
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
    phase_build()
    record = phase_kernels(args.seed, dev)
    record["launches"] = phase_serving(args.seed)
    log(smi)
    log(json.dumps({"kernels": [record]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
