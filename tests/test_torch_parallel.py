"""The port's data-parallel layer (``parallel/``): its helpers, the
cross-rank losses against the JAX package's ``axis_name`` forms, and the
steps through a group of one.

  * ``local_batch_slice`` partitions a batch (JAX
    tests/test_shard_map.py:210-217) and raises on an uneven one;
    ``initialize`` does nothing when no world is named.
  * Two gloo ranks on the CPU (tests/torch_parallel_worker.py, meeting
    through a ``file://`` rendezvous in pytest's tmp dir) compute
    ``masked_sq_sum``, ``brdf_errors``, ``envmap_reconst_error``,
    ``render_error`` and the NYU sums (``nyu_losses``, the loss half of
    ``nyu_step``) on their halves of a numpy batch from a seed.  Their
    values are held against the JAX functions with ``axis_name`` under
    ``jax.shard_map`` over 2 of the conftest's virtual devices, on the
    whole batch, at rtol 1e-5 (f32 sums in another order); each rank's
    gradients against the rows of the port's single-process gradients on
    the whole batch, at rtol 1e-5 (the global count is the same sum in
    another order), which is the gradient rule: a rank's gradient is its
    share of the global loss's.  ``collectives.amax`` with three maxima
    tied across the ranks and another cotangent on each rank is held to
    ``torch.amax`` of the whole tensor, bit for bit.  A rank whose local
    batch has another shape makes every rank raise.
  * On one thread, each of the five step classes through a gloo group of
    one is bit-equal to the same step with ``group=None``: metrics and
    updated parameters.  Each step is warmed first (ROADMAP C12).
"""

import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
from jax.sharding import Mesh, PartitionSpec as P

from inverserenderingofindoorscene_tpu.losses import masked as jmasked
from inverserenderingofindoorscene_tpu.pipeline import finetune as jfinetune
from inverserenderingofindoorscene_torch.data.synthetic import synthetic_batch
from inverserenderingofindoorscene_torch.losses import masked
from inverserenderingofindoorscene_torch.parallel import dryrun, multihost
from inverserenderingofindoorscene_torch.pipeline.finetune import nyu_losses
from torch_parallel_worker import run_ranks

WORLD = 2
B = 4
VALUE_KEYS = ("masked_sq_sum", "brdf_albedo", "brdf_normal", "brdf_rough",
              "brdf_depth", "envmap_reconst_error", "render_error",
              "nyu_normal", "nyu_depth", "nyu_angle_deg")
GRAD_KEYS = ("albedo_pred", "normal_pred", "rough_pred", "depth_pred",
             "env_pred", "diffuse", "specular", "nyu_normal_pred",
             "nyu_depth_pred")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_local_batch_slice_partitions_batch():
    rows = [multihost.local_batch_slice(i, 4, 16) for i in range(4)]
    assert rows == [(0, 4), (4, 8), (8, 12), (12, 16)]
    seen = [r for s, e in rows for r in range(s, e)]
    assert seen == list(range(16))


@pytest.mark.parametrize("world,batch", [(2, 5), (4, 6), (3, 4)])
def test_local_batch_slice_uneven_raises(world, batch):
    with pytest.raises(ValueError, match="does not split"):
        multihost.local_batch_slice(0, world, batch)


def test_initialize_is_a_noop_without_a_world(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() is None
    assert not dist.is_initialized()


def unit(rng, shape):
    v = rng.randn(*shape)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def loss_arrays(seed=0):
    """The numpy batch of the losses check: ground truth from
    ``synthetic_batch``, predictions and masks from the seed."""
    rng = np.random.RandomState(seed)
    gt = synthetic_batch(batch=B, im_hw=(32, 32), env_rc=(8, 10),
                         env_hw=(4, 4), seed=seed, device="cpu")
    a = {k: v.numpy() for k, v in gt.items()}
    a.update({
        "albedo_pred": rng.uniform(0, 1, (B, 32, 32, 3)),
        "normal_pred": unit(rng, (B, 32, 32, 3)),
        "rough_pred": rng.uniform(-1, 1, (B, 32, 32, 1)),
        "depth_pred": rng.uniform(0.1, 5, (B, 32, 32, 1)),
        "env_pred": rng.uniform(0, 2, (B, 8, 10, 16, 3)),
        "seg_env": rng.uniform(0, 1, (B, 8, 10, 1)) > 0.3,
        "diffuse": rng.uniform(0, 1, (B, 8, 10, 3)),
        "specular": rng.uniform(0, 0.5, (B, 8, 10, 3)),
        "im_small": rng.uniform(0, 1, (B, 8, 10, 3)),
        "seg_small": rng.uniform(0, 1, (B, 8, 10, 1)),
        "nyu_normal_pred": unit(rng, (B, 16, 16, 3)),
        "nyu_depth_pred": rng.uniform(1, 6, (B, 16, 16, 1)),
        "nyu_normal": unit(rng, (B, 32, 32, 3)),
        "nyu_depth": rng.uniform(1, 6, (B, 32, 32, 1)),
        "nyu_seg_normal": rng.uniform(0, 1, (B, 32, 32, 1)) > 0.2,
        "nyu_seg_depth": rng.uniform(0, 1, (B, 32, 32, 1)) > 0.2,
        "amax_x": rng.randn(B, 5, 6),
    })
    # the maximum three times: twice in rank 0's rows, once in rank 1's
    for idx in ((0, 1, 2), (1, 0, 0), (3, 4, 5)):
        a["amax_x"][idx] = 10.0
    return {k: np.asarray(v, np.float32) for k, v in a.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{key: [rank 0's array, rank 1's]} of the two-rank losses run."""
    tmp = tmp_path_factory.mktemp("losses")
    arrays = loss_arrays()
    np.savez(tmp / "in.npz", **arrays)
    run_ranks(lambda r: [
        sys.executable, "tests/torch_parallel_worker.py",
        f"file://{tmp}/store", str(WORLD), str(r), str(tmp / "in.npz"),
        str(tmp / f"out{r}.npz")], WORLD, timeout=300)
    outs = [dict(np.load(tmp / f"out{r}.npz")) for r in range(WORLD)]
    return arrays, {k: [o.get(k) for o in outs] for k in outs[0]}


@pytest.fixture(scope="module")
def jax_values(ranks):
    """The JAX losses with ``axis_name`` under ``shard_map`` over two
    devices, on the whole batch (``nyu_step`` with its forward replaced
    by the predictions of the batch)."""
    arrays, _ = ranks

    def losses(b):
        out = {"masked_sq_sum": jmasked.masked_sq_sum(
            b["albedo_pred"], b["albedo"], b["seg_brdf"], 3.0, "data")}
        errors, _ = jmasked.brdf_errors(
            b["albedo_pred"], b["normal_pred"], b["rough_pred"],
            b["depth_pred"], b, axis_name="data")
        out.update({f"brdf_{k}": v for k, v in errors.items()})
        out["envmap_reconst_error"], _ = jmasked.envmap_reconst_error(
            b["env_pred"], b["env_gt"], b["seg_env"], 1.0, "data")
        out["render_error"], _ = jmasked.render_error(
            b["diffuse"], b["specular"], b["im_small"], b["seg_small"],
            "data")
        nyu = {"normal": b["nyu_normal"], "depth": b["nyu_depth"],
               "seg_normal": b["nyu_seg_normal"],
               "seg_depth": b["nyu_seg_depth"],
               "pred_normal": b["nyu_normal_pred"],
               "pred_depth": b["nyu_depth_pred"]}
        _, nyu_l = jfinetune.nyu_step(None, None, nyu, axis_name="data")
        out.update({f"nyu_{k}": v for k, v in nyu_l.items()})
        return out

    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), axis_names=("data",))
    fn = jax.jit(jax.shard_map(losses, mesh=mesh, in_specs=P("data"),
                               out_specs=P()))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfinetune, "brdf_forward",
                   lambda nets, params, batch: {
                       "normal": batch["pred_normal"],
                       "depth": batch["pred_depth"]})
        values = {k: float(v) for k, v in fn(arrays).items()}
    assert sorted(values) == sorted(VALUE_KEYS)
    return values


@pytest.mark.parametrize("key", VALUE_KEYS)
def test_losses_match_jax_axis_name(ranks, jax_values, key):
    _, got = ranks
    a, b = got[f"value_{key}"]
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(float(a), jax_values[key], rtol=1e-5)


def single_process_grads(arrays):
    """The port's losses on the whole batch with ``group=None``: {input:
    gradient} of the sum the ranks take (without ``amax``)."""
    t = {k: torch.as_tensor(v) for k, v in arrays.items()}
    preds = {k: t[k].clone().requires_grad_(True) for k in GRAD_KEYS}
    total = masked.masked_sq_sum(preds["albedo_pred"], t["albedo"],
                                 t["seg_brdf"], 3.0)
    errors, _ = masked.brdf_errors(preds["albedo_pred"], preds["normal_pred"],
                                   preds["rough_pred"], preds["depth_pred"],
                                   t)
    total = total + sum(errors.values())
    total = total + masked.envmap_reconst_error(
        preds["env_pred"], t["env_gt"], t["seg_env"], 1.0)[0]
    total = total + masked.render_error(preds["diffuse"], preds["specular"],
                                        t["im_small"], t["seg_small"])[0]
    losses, _, _ = nyu_losses(preds["nyu_normal_pred"],
                              preds["nyu_depth_pred"],
                              {k[4:]: t[k] for k in t if k.startswith("nyu_")})
    total = total + losses["normal"] + losses["depth"]
    total.backward()
    return {k: v.grad.numpy() for k, v in preds.items()}


@pytest.mark.parametrize("key", GRAD_KEYS)
def test_rank_gradients_are_rows_of_the_global_gradient(ranks, key):
    arrays, got = ranks
    want = single_process_grads(arrays)[key]
    rows = np.concatenate(got[f"grad_{key}"])
    scale = float(np.abs(want).max())
    assert scale > 0, key
    np.testing.assert_allclose(rows, want, rtol=1e-5, atol=1e-6 * scale,
                               err_msg=key)


def test_amax_over_ranks_is_torch_amax_of_the_whole(ranks):
    arrays, got = ranks
    x = torch.as_tensor(arrays["amax_x"]).requires_grad_(True)
    m = torch.amax(x)
    (sum(range(1, WORLD + 1)) * m).backward()
    for r in range(WORLD):
        assert float(got["value_amax"][r]) == m.item()
    rows = np.concatenate(got["grad_amax_x"])
    np.testing.assert_array_equal(rows, x.grad.numpy())
    # three tied maxima share the summed cotangent 1 + 2
    assert np.count_nonzero(rows) == 3
    np.testing.assert_allclose(rows.max(), 1.0, rtol=1e-7)


def test_collective_values_and_mismatched_batches(ranks):
    _, got = ranks
    for r in range(WORLD):
        assert got["psum"][r].tolist() == [3.0]
        assert got["pmean"][r].tolist() == [1.5]
        assert got["pmax"][r].tolist() == [1, 0]
        # rank 1's local batch has another shape: both raised
        assert got["mismatch_raised"][r] is not None, r


@pytest.fixture
def group_of_one(tmp_path):
    group = multihost.initialize_cpu_cluster(
        f"file://{tmp_path}/store", 1, 0)
    yield group
    dist.destroy_process_group()


@pytest.mark.parametrize("name", ["light0", "brdf", "bilateral", "iiw",
                                  "nyu"])
def test_group_of_one_is_bit_equal_to_no_group(group_of_one, name):
    make, batch = dryrun.family(name, torch.device("cpu"))
    out = {}
    for tag, group in (("none", None), ("one", group_of_one)):
        step = make(group)
        dryrun.warm(step, batch)
        metrics = step(batch)
        params = [p.detach().clone()
                  for p in dryrun.trained(step).parameters()]
        out[tag] = metrics, params
    (m0, p0), (m1, p1) = out["none"], out["one"]
    assert sorted(m0) == sorted(m1)
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)
