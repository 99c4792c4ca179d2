"""The nets of a run, for the program and for the reference, from one seed.

Each bundle's weights are made once from the seed (``weights``) by the
reference's module and loaded into the program's module of the same name
and into a fresh reference module, so the two sides start from the same
tensors and the reference takes nothing the program made.  The program's
modules are built on the meta device (no draws of their own) and take
the weights as they are.
"""

from __future__ import annotations

import torch

from bench_port import weights
from bench_port.reference import nets as R

LABELS = ("brdf", "light", "bs")


def set_backends(cfg: dict) -> None:
    """The configuration's cuDNN autotuning and TF32 settings."""
    torch.backends.cudnn.benchmark = bool(cfg["cudnn_benchmark"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["cudnn_allow_tf32"])
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["matmul_allow_tf32"])


def reference_backends(benchmark: bool = False) -> None:
    """Float32 as written: no TF32 anywhere.  ``benchmark``: cuDNN picks
    each convolution's algorithm by timing it, and a shape it timed
    before in the process (in the program's run) keeps the algorithm it
    picked then, so a float32 reference convolution rounds as the
    program's of that shape does."""
    torch.backends.cudnn.benchmark = benchmark
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _ref_module(kind: str, level: int, cfg: dict, conv=R.CONV_F32):
    if kind == "brdf":
        return R.BRDFNets(level, conv=conv)
    if kind == "light":
        return R.LightNets(cfg["sg_num"], level, cfg["env_rows"],
                           cfg["env_cols"], cfg["env_height"],
                           cfg["env_width"], conv=conv)
    return R.BilateralNets(conv=conv)


def state(kind: str, level: int, cfg: dict, device, seed: int) -> dict:
    with torch.device("meta"):
        meta = _ref_module(kind, level, cfg)
    return weights.seeded_state(meta, device, seed, f"{kind}{level}")


def reference(kind: str, level: int, cfg: dict, device, seed: int,
              conv=R.CONV_F32):
    """The reference's bundle with the seed's weights, on ``device``."""
    with torch.device("meta"):
        module = _ref_module(kind, level, cfg, conv)
    return weights.load(module, state(kind, level, cfg, device, seed))


def port(kind: str, level: int, cfg: dict, device, seed: int,
         compute_dtype: str = "float32"):
    """The program's bundle with the seed's weights, on ``device``."""
    if kind == "brdf":
        from inverserenderingofindoorscene_torch.pipeline.brdf import (
            BRDFNets,
        )
        with torch.device("meta"):
            module = BRDFNets(level, compute_dtype=compute_dtype)
    elif kind == "light":
        from inverserenderingofindoorscene_torch.pipeline.light import (
            LightNets,
        )
        with torch.device("meta"):
            module = LightNets(sg_num=cfg["sg_num"], cascade_level=level,
                               env_rows=cfg["env_rows"],
                               env_cols=cfg["env_cols"],
                               env_height=cfg["env_height"],
                               env_width=cfg["env_width"],
                               compute_dtype=compute_dtype)
    else:
        from inverserenderingofindoorscene_torch.pipeline.bilateral import (
            BilateralNets,
        )
        with torch.device("meta"):
            module = BilateralNets()
    return weights.load(module, state(kind, level, cfg, device, seed))


def counters() -> dict:
    """The program's launch counters, by kernel wrapper."""
    from inverserenderingofindoorscene_torch.ops import bilateral, sg_render

    fns = {"bilateral_blur": bilateral.bilateral_blur}
    for name in ("render_sg_env", "render_sg_fwd", "render_sg_bwd",
                 "sg_envmap_fwd", "sg_envmap_bwd"):
        fns[name] = getattr(sg_render, name)
    return {name: fn.launches for name, fn in fns.items()}


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.clamp(torch.linalg.vector_norm(want), min=1e-30))
