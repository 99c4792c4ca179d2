#!/usr/bin/env python3
"""Time variants of the envmap walk (``sg_envmap_fwd``) side by side on
one CUDA card.

    python3 probe_sg_envmap_fwd.py [--seed N] [--rounds R]

The kernel's source (``inverserenderingofindoorscene_torch/ops/csrc``)
holds one design: the shading walk's lanes, each on directions lane,
lane + 32, lane + 64, lane + 96 of a pass, storing the envmap float by
float, with ``exp2f``, at a minimum of 4 blocks an SM.  Each other
variant is that source with a few lines replaced (``VARIANTS``): lanes on
four consecutive directions storing them as three float4, streaming
stores (``__stcs``, evict-first: the envmap is larger than the L2 and read
once, by the loss), ``expf`` in place of ``exp2f``, the exponential as
the bare ``ex2.approx.ftz`` (exp2f without its range check, which only
keeps results below 2^-126 from flushing to 0), and other minimum blocks
an SM in ``__launch_bounds__``.  A variant may change the other entries
of the walk's library too; only ``sg_envmap_fwd`` is timed.  Every variant
is built with the port's nvcc flags into ``build/probe_sg_envmap_fwd/``,
all at once, and its ptxas registers and spills are printed; then each is
checked against ``sg_envmap_plain`` at the envmap tolerance of
``chip_smoke.py`` and timed at the light step's shape (B=5, 120x160,
K=12, D=128) by device time (``chip_smoke.device_ms``) and CUDA events,
in turns (round r runs the variants forwards for even r, backwards for
odd).  A replaced text that is not in the source once fails the probe.
The last line is a JSON object of the times.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke
from inverserenderingofindoorscene_torch.ops import build, sg_render

OUT = build.BUILD_DIR.parent / "probe_sg_envmap_fwd"
CUH, CU, COMMON = "sg_render_env.cuh", "sg_render_env.cu", "sg_common.cuh"
_STORES = """\
#pragma unroll
  for (int j = 0; j < kDirsPerLane; ++j) {
    const int i = lane + kWarp * j;
"""


def _quads(store):
    """Lanes on four consecutive directions; where D is a multiple of 4 a
    lane's 12 floats leave as three float4 through ``store``."""
    quad = """\
      float4* out = reinterpret_cast<float4*>(env_pass) + 3 * lane;
      {s}(out, make_float4(env[0][0], env[0][1], env[0][2], env[1][0]));
      {s}(out + 1, make_float4(env[1][1], env[1][2], env[2][0], env[2][1]));
      {s}(out + 2, make_float4(env[2][2], env[3][0], env[3][1], env[3][2]));
""".format(s=store)
    return [
        (CUH, "    const int d = c0 + lane + kWarp * j;",
         "    const int d = c0 + kDirsPerLane * lane + j;"),
        (CUH, _STORES, """\
  if ((d_num & 3) == 0) {
    if (c0 + kDirsPerLane * lane < d_num) {  // then all four are
""" + quad + """\
    }
    return;
  }
""" + _STORES.replace("lane + kWarp * j", "kDirsPerLane * lane + j")),
        (CUH, "__host__ __device__ __forceinline__ void env_lane_mix(",
         "__device__ __forceinline__ void env_lane_mix("),
    ]


_PLAIN = """\
template <class T>
__device__ __forceinline__ void put(T* p, T v) { *p = v; }
"""
_STCS = [(CUH, "env_pass[3 * i + ch] = env[j][ch];",
          "__stcs(env_pass + 3 * i + ch, env[j][ch]);"),
         (CUH, "__host__ __device__ __forceinline__ void env_lane_mix(",
          "__device__ __forceinline__ void env_lane_mix(")]
_EX2 = [(COMMON, "  return exp2f(lamb2 * *cosm1);", """\
#ifdef __CUDA_ARCH__
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(lamb2 * *cosm1));
  return e;
#else
  return exp2f(lamb2 * *cosm1);
#endif""")]
_EXPF = [(CU, "constexpr bool kExp2 = kWalk != Walk::kServe;",
          "constexpr bool kExp2 = kWalk == Walk::kTrain;")]


def _blocks(n):
    return [(CU, "constexpr int kEnvBlocksPerSM = 4;",
             f"constexpr int kEnvBlocksPerSM = {n};")]


def _put(patches):
    """Declare put() (a plain store) before env_lane_mix."""
    return patches + [(CUH, "// One lane's share of a warp's pass",
                       _PLAIN + "\n// One lane's share of a warp's pass")]


# variant -> (file, old text, new text) replacements of the source
VARIANTS = {
    "interleaved scalar stores (the source)": [],
    "quads, float4 stores": _put(_quads("put")),
    "interleaved, __stcs": _STCS,
    "quads, float4 __stcs": _quads("__stcs"),
    "expf": _EXPF,
    "ex2.approx.ftz": _EX2,
    "minimum 1 block an SM": _blocks(1),
    "minimum 5 blocks an SM": _blocks(5),
    "minimum 6 blocks an SM": _blocks(6),
    "minimum 8 blocks an SM": _blocks(8),
}


def variant_source(name, patches):
    """A copy of csrc/ with the variant's replacements; returns its dir."""
    src = OUT / f"v{list(VARIANTS).index(name)}"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(build.CSRC, src)
    for fname, old, new in patches:
        path = src / fname
        text = path.read_text()
        if text.count(old) != 1:
            raise AssertionError(f"{name}: {old!r} is not once in {fname}")
        path.write_text(text.replace(old, new))
    return src


def build_variants():
    """Build every variant at once; returns {name: (library, ptxas of the
    envmap entry)}."""
    procs = {}
    for name, patches in VARIANTS.items():
        src = variant_source(name, patches)
        lib = src / "walk.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src / CU)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        entries = chip_smoke.ptxas_entries(text)
        info = [v for e, v in entries.items() if "WalkE2E" in e]
        out[name] = (lib, info[0] if info else {})
    return out


def launcher(lib_path, lobes, dirs, env, n, k, d, stream):
    fn = ctypes.CDLL(str(lib_path)).sg_envmap_fwd_f32
    fn.argtypes = sg_render._SIGNATURES["sg_render_env"]["sg_envmap_fwd_f32"]
    fn.restype = ctypes.c_int
    ptrs = [x.data_ptr() for x in (*lobes, dirs, env)]

    def run():
        build.raise_on("sg_envmap_fwd", fn(*ptrs, n, k, d, stream))
    return run


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--rounds", type=int, default=4)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_sg_envmap_fwd: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = chip_smoke.phase_device()
    libs = build_variants()
    shape = (chip_smoke.TRAIN_B, *chip_smoke.ENV_RC, chip_smoke.SG_NUM)
    lobes = chip_smoke.kernel_inputs(np.random.RandomState(args.seed),
                                     *shape, dev)[3:]
    dirs = sg_render._dir_consts(8, 16, dev)
    n, k, d = shape[0] * shape[1] * shape[2], shape[3], 128
    want = sg_render.sg_envmap_plain(*lobes)
    stream = build.stream(dev)
    runs, errs = {}, {}
    for name, (lib, info) in libs.items():
        env = torch.full_like(want, float("nan"))
        runs[name] = launcher(lib, lobes, dirs, env, n, k, d, stream)
        runs[name]()
        torch.cuda.synchronize()
        errs[name] = chip_smoke.check_close(
            name, env, want, *chip_smoke.ELEMENT_TOL["env"])
        print(f"[probe] {name}: ptxas "
              + ", ".join(f"{a} {b}" for a, b in info.items())
              + f"; max abs err vs plain {errs[name]:.3e}", flush=True)
    times = {name: {"device_ms": [], "events_ms": []} for name in runs}
    for r in range(args.rounds):
        order = list(runs) if r % 2 == 0 else list(reversed(runs))
        for name in order:
            times[name]["device_ms"].append(chip_smoke.device_ms(runs[name]))
            times[name]["events_ms"].append(chip_smoke.events_ms(runs[name]))
    base = list(runs)[0]
    med = {name: float(np.median(t["device_ms"])) for name, t in times.items()}
    for name, t in times.items():
        print(f"[probe] {name}: device ms "
              + " / ".join(f"{x:.5f}" for x in t["device_ms"])
              + ", events ms " + " / ".join(f"{x:.5f}" for x in t["events_ms"])
              + f"; median device ms {med[name]:.5f}, "
              f"{med[name] / med[base]:.3f} of the source's", flush=True)
    print(smi)
    print(json.dumps({"shape": shape, "variants": {
        name: {**times[name], "ptxas": libs[name][1],
               "max_abs_err": errs[name]} for name in runs}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
