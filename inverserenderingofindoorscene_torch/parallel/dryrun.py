"""One data-parallel step of each train-step family, on one rank.

The counterpart of ``__graft_entry__.dryrun_multichip``: the light step at
cascades 0 and 1, the BRDF, bilateral, IIW and NYU steps, and the IIW and
NYU steps at cascade 1, each from seeded weights on a seeded global
batch of 4, at that function's shapes (light 64x80 with a 32x40 grid, the
rest 32x32; the cascade-0 light step's shape is an argument, so a card
runs it at full width).  Every rank of a gloo group runs this module
(:func:`run` takes any group: a card's world of one on NCCL too); each
keeps its rows of the batch (``local_batch_slice``) and takes one step of
each family through the group.  For its share of the families
(``FAMILIES[rank::world]``) a rank then takes the same step in one
process on the whole batch, from the same weights, and reports how far
the two are apart.  The checks are the caller's: it holds the ranks'
metrics and parameter digests equal to each other and the distances to
its tolerances.

    python -m inverserenderingofindoorscene_torch.parallel.dryrun \\
        --initMethod file:///tmp/rendezvous --world 2 --rank 0 \\
        --device cpu --warm

prints one line ``DRYRUN {json}`` with, per family, the group step's
metrics, a sha256 of its updated parameters and metrics, the kernel
launches it made, and (for this rank's share) the single-process
metrics, the largest parameter difference and the gradients' relative L2
distance.  ``--timedSteps N`` also times the cascade-0 light step (host
clock to a synchronize on a CUDA device): N steps through the group,
with every all_reduce timed (a synchronize on each side), and on the
rank that runs its single-process step, N of those.  Each family's
record has its seconds, set-up included.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import hashlib
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from inverserenderingofindoorscene_torch.data.synthetic import synthetic_batch
from inverserenderingofindoorscene_torch.device import resolve_device
from inverserenderingofindoorscene_torch.ops import bilateral, sg_render
from inverserenderingofindoorscene_torch.parallel import multihost
from inverserenderingofindoorscene_torch.parallel.mesh import shard_batch
from inverserenderingofindoorscene_torch.pipeline.bilateral import (
    BilateralNets,
)
from inverserenderingofindoorscene_torch.pipeline.brdf import BRDFNets
from inverserenderingofindoorscene_torch.pipeline.light import LightNets
from inverserenderingofindoorscene_torch.train.steps import (
    make_bilateral_train_step,
    make_brdf_train_step,
    make_iiw_train_step,
    make_light_train_step,
    make_nyu_train_step,
)

FAMILIES = ("light0", "light1", "brdf", "bilateral", "iiw", "nyu", "iiw1",
            "nyu1")
GLOBAL_B = 4
LIGHT_HW, LIGHT_RC = (64, 80), (32, 40)
SMALL_HW, SMALL_RC = (32, 32), (16, 16)
NPAIR = 16
# kernel name -> its wrapper, which counts its launches
WRAPPERS = {
    "render_sg_fwd": sg_render.render_sg_fwd,
    "render_sg_bwd": sg_render.render_sg_bwd,
    "sg_envmap_fwd": sg_render.sg_envmap_fwd,
    "sg_envmap_bwd": sg_render.sg_envmap_bwd,
    "render_sg_env": sg_render.render_sg_env,
    "bilateral_blur": bilateral.bilateral_blur,
}


def real_batches(rng, b, hw):
    """The IIW, NYU and cascade-1 ``*_pre`` arrays of
    ``dryrun_multichip``, drawn from ``rng`` in its order (numpy)."""
    h, w = hw
    iiw = {
        "im": rng.rand(b, h, w, 3).astype(np.float32),
        "eq_point": rng.randint(0, h, (b, NPAIR, 4)).astype(np.int32),
        "eq_weight": rng.rand(b, NPAIR).astype(np.float32),
        "eq_num": np.full((b,), NPAIR, np.int32),
        "darker_point": rng.randint(0, h, (b, NPAIR, 4)).astype(np.int32),
        "darker_weight": rng.rand(b, NPAIR).astype(np.float32),
        "darker_num": np.full((b,), NPAIR, np.int32),
    }
    nrm = rng.randn(b, h, w, 3)
    nrm[..., 2] = np.abs(nrm[..., 2]) + 0.3
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nyu = {
        "im": rng.rand(b, h, w, 3).astype(np.float32),
        "normal": nrm.astype(np.float32),
        "depth": (1.0 + 6.0 * rng.rand(b, h, w, 1)).astype(np.float32),
        "seg_normal": np.ones((b, h, w, 1), np.float32),
        "seg_depth": np.ones((b, h, w, 1), np.float32),
    }
    er, ec = SMALL_RC
    pre = {
        "albedo_pre": rng.rand(b, er, ec, 3),
        "normal_pre": rng.rand(b, er, ec, 3),
        "rough_pre": rng.rand(b, er, ec, 1),
        "depth_pre": 0.5 + rng.rand(b, er, ec, 1),
        "diffuse_pre": rng.rand(b, er, ec, 3),
        "specular_pre": rng.rand(b, er, ec, 3),
    }
    pre = {k: v.astype(np.float32) for k, v in pre.items()}
    return iiw, nyu, pre


def family(name: str, device, light0=(LIGHT_HW, LIGHT_RC), nets=None):
    """(make, batch): ``make(group)`` builds the family's step on fresh
    copies of its seeded nets (one set of weights however often it is
    called); ``batch`` is the global batch on ``device``.  ``nets``, a
    dict kept across calls, holds the seeded BRDF nets that the BRDF, IIW
    and NYU families of one cascade share, so they are drawn once."""
    small = dict(batch=GLOBAL_B, im_hw=SMALL_HW, env_rc=SMALL_RC,
                 device=device)
    if name in ("light0", "light1"):
        level = int(name[-1])
        hw, rc = light0 if level == 0 else (LIGHT_HW, LIGHT_RC)
        gen = torch.Generator().manual_seed(10 + level)
        nets = (BRDFNets(level, generator=gen),
                LightNets(cascade_level=level, env_rows=rc[0],
                          env_cols=rc[1], generator=gen))
        batch = synthetic_batch(batch=GLOBAL_B, im_hw=hw, env_rc=rc,
                                cascade_level=level, seed=level,
                                device=device)

        def make(group):
            brdf, light = copy.deepcopy(nets)
            return make_light_train_step(brdf, light, device=device,
                                         group=group)
        return make, batch
    if name == "bilateral":
        gen = torch.Generator().manual_seed(3)
        nets = (BRDFNets(0, generator=gen), BilateralNets(generator=gen))

        def make(group):
            brdf, bs = copy.deepcopy(nets)
            return make_bilateral_train_step(brdf, bs, device=device,
                                             group=group)
        return make, synthetic_batch(seed=4, **small)
    level = 1 if name.endswith("1") else 0
    nets = {} if nets is None else nets
    if level not in nets:
        nets[level] = BRDFNets(
            level, generator=torch.Generator().manual_seed(5 + level))
    brdf = nets[level]
    maker = {"brdf": make_brdf_train_step, "iiw": make_iiw_train_step,
             "nyu": make_nyu_train_step}[name.rstrip("1")]
    if name == "brdf":
        batch = synthetic_batch(seed=3, **small)
    else:
        iiw, nyu, pre = real_batches(np.random.RandomState(7), GLOBAL_B,
                                     SMALL_HW)
        arrays = iiw if name.startswith("iiw") else nyu
        if level:
            arrays = {**arrays, **pre}
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in arrays.items()}

    def make(group):
        return maker(copy.deepcopy(brdf), device=device, group=group)
    return make, batch


def trained(step):
    """The nets a step trains."""
    for attr in ("light_nets", "bs_nets", "brdf_nets"):
        if hasattr(step, attr):
            return getattr(step, attr)
    raise TypeError(type(step))


def digest(step, metrics) -> str:
    """sha256 of the trained parameters' and the metrics' bytes."""
    h = hashlib.sha256()
    for p in trained(step).parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    for k in sorted(metrics):
        h.update(k.encode())
        h.update(metrics[k].detach().cpu().numpy().tobytes())
    return h.hexdigest()


@torch.no_grad()
def max_param_diff(a, b) -> float:
    return max(float(torch.max(torch.abs(p - q)))
               for p, q in zip(trained(a).parameters(),
                               trained(b).parameters()))


@torch.no_grad()
def grad_rel_l2(a, b) -> float:
    """The relative L2 distance of step ``a``'s last gradient, all its
    parameters together, from step ``b``'s.  Adam's first update hardly
    depends on the gradient's scale, so this is what tells a summed
    gradient from an averaged one."""
    num = den = 0.0
    for p, q in zip(trained(a).parameters(), trained(b).parameters()):
        num += float(torch.sum((p.grad - q.grad).double() ** 2))
        den += float(torch.sum(q.grad.double() ** 2))
    return (num / den) ** 0.5


def warm(step, batch) -> None:
    """One loss and backward, no update: every conv shape of the step is
    then on its second call, which the CPU's convolutions repeat bit for
    bit (ROADMAP C12)."""
    total = step.loss(batch)[0]
    total.backward()
    for p in trained(step).parameters():
        p.grad = None


def reset_launches() -> None:
    for w in WRAPPERS.values():
        w.launches = 0


def read_launches() -> dict:
    return {name: w.launches for name, w in WRAPPERS.items()}


def synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_steps(step, batch, n, device) -> list:
    """ms of each of ``n`` steps, host clock to a synchronize."""
    times = []
    for _ in range(n):
        synchronize(device)
        t0 = time.perf_counter()
        step(batch)
        synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


@contextlib.contextmanager
def all_reduce_timer(device, log: list):
    """Time every ``torch.distributed.all_reduce`` inside the block (a
    synchronize on each side), appending (ms, bytes) to ``log``."""
    plain = dist.all_reduce

    def timed(tensor, *args, **kwargs):
        synchronize(device)
        t0 = time.perf_counter()
        out = plain(tensor, *args, **kwargs)
        synchronize(device)
        log.append(((time.perf_counter() - t0) * 1e3,
                    tensor.numel() * tensor.element_size()))
        return out

    dist.all_reduce = timed
    try:
        yield
    finally:
        dist.all_reduce = plain


def scalars(metrics) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def run(group, device, families=FAMILIES, light0=(LIGHT_HW, LIGHT_RC),
        warm_first=False, timed=0) -> dict:
    """One step of each family through ``group`` (module docstring);
    returns {family: record}."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    own = set(FAMILIES[rank::world])
    out, nets = {}, {}
    for name in families:
        t0 = time.perf_counter()
        make, batch = family(name, device, light0, nets)
        local = multihost.global_batch_from_local(shard_batch(batch, group),
                                                  group, device)
        step = make(group)
        if warm_first:
            warm(step, local)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        reset_launches()
        metrics = step(local)
        synchronize(device)
        rec = {"metrics": scalars(metrics), "digest": digest(step, metrics),
               "launches": read_launches(), "local_b": len(local["im"])}
        if device.type == "cuda":
            rec["peak_mib"] = torch.cuda.max_memory_allocated(device) / 2**20
        if name in own:
            ref = make(None)
            if warm_first:
                warm(ref, batch)
            rec["ref"] = {"metrics": scalars(ref(batch)),
                          "max_param_diff": max_param_diff(step, ref),
                          "grad_rel_l2": grad_rel_l2(step, ref)}
        if timed and name == "light0":
            log = []
            with all_reduce_timer(device, log):
                rec["ms"] = timed_steps(step, local, timed, device)
            rec["all_reduce"] = {"n": len(log) // timed,
                                 "ms": sum(ms for ms, _ in log) / timed,
                                 "bytes": sum(n for _, n in log) // timed}
            if name in own:
                rec["ref"]["ms"] = timed_steps(ref, batch, timed, device)
        rec["seconds"] = time.perf_counter() - t0
        out[name] = rec
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--initMethod", required=True,
                        help="the group's rendezvous: file://... or "
                        "tcp://host:port")
    parser.add_argument("--world", type=int, required=True)
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--device", default=None,
                        help="cpu or cuda (the default)")
    parser.add_argument("--light0", default=None,
                        help="H,W,R,C of the cascade-0 light step (image "
                        "and grid; default 64,80,32,40)")
    parser.add_argument("--warm", action="store_true",
                        help="a loss and backward before each step")
    parser.add_argument("--timedSteps", type=int, default=0)
    parser.add_argument("--threads", type=int, default=None)
    args = parser.parse_args(argv)
    if args.threads:
        torch.set_num_threads(args.threads)
    device = resolve_device(args.device)
    if device.type == "cuda":
        # autotuning picks other algorithms for a batch and its halves
        # (ROADMAP C21)
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    light0 = (LIGHT_HW, LIGHT_RC)
    if args.light0:
        h, w, r, c = (int(v) for v in args.light0.split(","))
        light0 = ((h, w), (r, c))
    group = multihost.initialize("gloo", args.initMethod, args.world,
                                 args.rank)
    try:
        out = run(group, device, FAMILIES, light0, args.warm,
                  args.timedSteps)
    finally:
        dist.destroy_process_group()
    print("DRYRUN " + json.dumps({"rank": args.rank, "world": args.world,
                                  "families": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
