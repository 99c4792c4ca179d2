"""Rank processes for the port's data-parallel tests.

NOT a pytest module (no ``test_`` prefix).  :func:`run_ranks` starts one
process a rank, each with a timeout, kills them all if one fails or the
time runs out, and returns each rank's stdout.  Run as a script, this
file is one rank of the losses check in tests/test_torch_parallel.py: it
joins a gloo group through a ``file://`` rendezvous, keeps its rows of
the numpy arrays the test wrote (``local_batch_slice``), computes the
port's losses through the group with their gradients, and saves them.
With ``light`` first it is one rank of tests/test_torch_parallel_jax.py:
it loads the test's BRDF and light weights, takes one cascade-0 light
step through the group on its rows of ``synthetic_batch`` and saves the
metrics, the updated light parameters and their summed gradients.  It
imports the port and numpy, never JAX.

    python tests/torch_parallel_worker.py [light] INIT_METHOD WORLD RANK IN OUT
"""

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(argv_of_rank, world, timeout):
    """Start ``argv_of_rank(r)`` for each rank r in the repository's root,
    wait at most ``timeout`` seconds for all, and return their stdouts.
    Raises with every rank's output if one exits non-zero or the time
    runs out; no process outlives the call."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(argv_of_rank(r), cwd=ROOT, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    outs = [None] * world
    try:
        for r, p in enumerate(procs):
            left = max(deadline - time.monotonic(), 1.0)
            try:
                outs[r] = p.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"rank {r} still running after "
                                     f"{timeout} s") from None
            if p.returncode != 0:
                raise AssertionError(
                    f"rank {r} exited {p.returncode}:\n{outs[r][1][-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [o[0] for o in outs]


def light_rank(init_method, world, rank, src, dst):
    import torch

    from inverserenderingofindoorscene_torch.data.synthetic import (
        synthetic_batch,
    )
    from inverserenderingofindoorscene_torch.parallel import multihost
    from inverserenderingofindoorscene_torch.pipeline.brdf import BRDFNets
    from inverserenderingofindoorscene_torch.pipeline.light import LightNets
    from inverserenderingofindoorscene_torch.train.steps import (
        make_light_train_step,
    )

    cfg = torch.load(src)
    group = multihost.initialize_cpu_cluster(init_method, world, rank)
    rows, cols = cfg["env_rc"]
    with torch.device("meta"):
        brdf = BRDFNets(0)
        light = LightNets(env_rows=rows, env_cols=cols)
    brdf.load_state_dict(cfg["brdf"], assign=True)
    light.load_state_dict(cfg["light"], assign=True)
    batch = synthetic_batch(batch=cfg["batch"], im_hw=cfg["im_hw"],
                            env_rc=cfg["env_rc"], seed=cfg["seed"],
                            device="cpu")
    start, stop = multihost.local_batch_slice(rank, world, cfg["batch"])
    step = make_light_train_step(brdf, light, device="cpu", lr=cfg["lr"],
                                 group=group)
    metrics = step({k: v[start:stop] for k, v in batch.items()})
    torch.save({"metrics": {k: float(v) for k, v in metrics.items()},
                "params": light.state_dict(),
                "grads": {n: p.grad for n, p in light.named_parameters()}},
               dst)
    torch.distributed.destroy_process_group()


def main():
    light = sys.argv[1] == "light"
    init_method, world, rank, src, dst = sys.argv[2 if light else 1:]
    world, rank = int(world), int(rank)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    torch.set_num_threads(1)
    if light:
        return light_rank(init_method, world, rank, src, dst)
    from inverserenderingofindoorscene_torch.losses import masked
    from inverserenderingofindoorscene_torch.parallel import collectives
    from inverserenderingofindoorscene_torch.parallel import multihost
    from inverserenderingofindoorscene_torch.pipeline.finetune import (
        nyu_losses,
    )

    group = multihost.initialize_cpu_cluster(init_method, world, rank)
    arrays = dict(np.load(src))
    start, stop = multihost.local_batch_slice(rank, world,
                                              len(arrays["im"]))
    t = multihost.global_batch_from_local(
        {k: v[start:stop] for k, v in arrays.items()}, group, "cpu")
    preds = {k: t[k].clone().requires_grad_(True) for k in
             ("albedo_pred", "normal_pred", "rough_pred", "depth_pred",
              "env_pred", "diffuse", "specular", "nyu_normal_pred",
              "nyu_depth_pred", "amax_x")}
    values = {}
    values["masked_sq_sum"] = masked.masked_sq_sum(
        preds["albedo_pred"], t["albedo"], t["seg_brdf"], 3.0, group)
    errors, _ = masked.brdf_errors(
        preds["albedo_pred"], preds["normal_pred"], preds["rough_pred"],
        preds["depth_pred"], t, group)
    values.update({f"brdf_{k}": v for k, v in errors.items()})
    values["envmap_reconst_error"], _ = masked.envmap_reconst_error(
        preds["env_pred"], t["env_gt"], t["seg_env"], 1.0, group)
    values["render_error"], _ = masked.render_error(
        preds["diffuse"], preds["specular"], t["im_small"], t["seg_small"],
        group)
    losses, _, _ = nyu_losses(preds["nyu_normal_pred"],
                              preds["nyu_depth_pred"],
                              {k[4:]: t[k] for k in t if k.startswith("nyu_")},
                              group)
    values.update({f"nyu_{k}": v for k, v in losses.items()})
    # amax with the cotangent rank + 1 on each rank: the single-process
    # counterpart is (1 + 2 + ...) * torch.amax of the whole tensor
    values["amax"] = collectives.amax(preds["amax_x"], group)
    total = sum(v for k, v in values.items() if k != "nyu_angle_deg"
                and k != "amax") + (rank + 1) * values["amax"]
    total.backward()
    out = {f"value_{k}": v.detach().numpy() for k, v in values.items()}
    out.update({f"grad_{k}": v.grad.numpy() for k, v in preds.items()})
    out["psum"] = collectives.psum(torch.tensor([rank + 1.0]), group).numpy()
    out["pmean"] = collectives.pmean(torch.tensor([rank + 1.0]),
                                     group).numpy()
    out["pmax"] = collectives.pmax(torch.tensor([rank, -rank]),
                                   group).numpy()
    # a rank whose local batch has another shape: every rank raises
    bad = {"im": np.zeros((2 + rank, 4, 4, 3), np.float32)}
    try:
        multihost.global_batch_from_local(bad, group, "cpu")
    except ValueError:
        out["mismatch_raised"] = np.array(True)
    np.savez(dst, **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
