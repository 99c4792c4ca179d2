"""Data-parallel serving: ``InverseRenderer(..., fused=True, group=g)``
through two gloo ranks on the CPU, against JAX's fused renderer in one
device and against the port's own ``group=None`` call on the whole batch.

Sizes of JAX tests/test_parallel.py:208-251: image 64x80, lighting grid
32x40, a seeded global batch of 4 photos, two rows a rank; level 2 with
lighting on both cascades and the refinement of both levels with
confidence nets.  The weights are flax's init (BRDF, light and
confidence nets of both levels), carried into the port by
``utils/weights.py``.  The ranks are tests/torch_parallel_worker.py in
``serve`` mode, meeting through a ``file://`` rendezvous in pytest's tmp
dir, one torch thread each; each runs ``parallel/dryrun.serve`` (its
group call, then the single-process call on the whole batch and the
distances, every compared shape warmed first: ROADMAP C12), then the
batch's first rows on every rank.  The port takes the kernel route (CPU
tensors: the kernels' plain versions), JAX its plain route.

Held:
  * against JAX, each rank's rows: c_light rtol 5e-4 and the final
    albedo atol 2e-5 (JAX's own data-parallel tolerances,
    tests/test_parallel.py:242-251), the rest at tests/test_torch_fused.py's
    (predictions and the SG tensor atol 1e-4, envmap / diffuse /
    specular rtol 1e-3 atol 1e-5, c_albedo rtol 2e-4);
  * against the port's ``group=None`` call, and against one process's
    confidences of the group call's maps: each confidence within
    relative 1e-6 (the divisor is the maximum over both ranks' images);
    and, as a negative control, each confidence taken with its rank's
    own maximum differs from it by more than 1e-3 on some rank, which
    shows that the maximum over the group is what makes them agree;
  * each rank's refinement bit-equal to its own refinement of the group
    call's maps;
  * equal inputs on both ranks give bit-equal outputs, and both ranks
    serve the same weights;
  * staged mode and ``serialize`` on a group raise.
"""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from inverserenderingofindoorscene_tpu.pipeline.bilateral import (
    BilateralNets as JBilateral,
)
from inverserenderingofindoorscene_tpu.pipeline.brdf import BRDFNets as JBRDF
from inverserenderingofindoorscene_tpu.pipeline.inference import (
    InverseRenderer as JRenderer,
)
from inverserenderingofindoorscene_tpu.pipeline.light import (
    LightNets as JLight,
)
from inverserenderingofindoorscene_torch.parallel import dryrun
from inverserenderingofindoorscene_torch.utils import weights
from torch_parallel_worker import run_ranks

IM_HW, ENV_RC = (64, 80), (32, 40)
GLOBAL_B, WORLD = 4, 2
PRED_KEYS = ("albedo", "normal", "rough", "depth")
CONF_RTOL = 1e-6


def to_port(convert, tree):
    return {k: torch.as_tensor(np.array(v)) for k, v in
            convert(jax.tree.map(np.asarray, tree)).items()}


@pytest.fixture(scope="module")
def setup():
    """The flax init of both levels (JAX stacks) with their port state
    dicts, and the seeded global batch."""
    key = jax.random.PRNGKey(3)
    jax_stacks, port = [], {"brdf": [], "light": [], "bs": []}
    for lvl in range(2):
        k1, k2, k3, key = jax.random.split(key, 4)
        jb = JBRDF(cascade_level=lvl)
        jl = JLight(cascade_level=lvl, env_rows=ENV_RC[0], env_cols=ENV_RC[1])
        bp, lp = jb.init(k1, IM_HW), jl.init(k2)
        jax_stacks.append((jb, bp, jl, lp))
        port["brdf"].append(to_port(weights.brdf_state_dict, bp))
        port["light"].append(to_port(weights.light_state_dict, lp))
        port["bs"].append(to_port(weights.bilateral_state_dict,
                                  JBilateral().init(k3, IM_HW)))
    im, im_small = dryrun.serving_batch(IM_HW, ENV_RC, seed=5, b=GLOBAL_B)
    return jax_stacks, port, im, im_small


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    _, port, im, im_small = setup
    tmp = tmp_path_factory.mktemp("serve")
    torch.save({**port, "env_rc": ENV_RC, "im": torch.from_numpy(im),
                "im_small": torch.from_numpy(im_small)}, tmp / "in.pt")
    run_ranks(lambda r: [
        sys.executable, "tests/torch_parallel_worker.py", "serve",
        f"file://{tmp}/store", str(WORLD), str(r), str(tmp / "in.pt"),
        str(tmp / f"out{r}.pt")], WORLD, timeout=300)
    return [torch.load(tmp / f"out{r}.pt") for r in range(WORLD)]


@pytest.fixture(scope="module")
def jax_out(setup):
    jax_stacks, _, im, im_small = setup
    return JRenderer(jax_stacks, is_light=True, fused=True)(
        jnp.asarray(im), jnp.asarray(im_small), 57.0)


def rows(rank):
    per = GLOBAL_B // WORLD
    return slice(rank * per, (rank + 1) * per)


@pytest.mark.parametrize("lvl", [0, 1])
@pytest.mark.parametrize("rank", range(WORLD))
def test_rank_rows_match_jax(ranks, jax_out, rank, lvl):
    got = ranks[rank]["out"]
    want = jax.tree.map(lambda x: np.asarray(x)[rows(rank)], jax_out)
    for k in PRED_KEYS:
        atol = 2e-5 if (lvl, k) == (1, "albedo") else 1e-4
        np.testing.assert_allclose(got["preds"][lvl][k].numpy(),
                                   want["preds"][lvl][k], atol=atol,
                                   err_msg=f"{k} level {lvl}")
    g, w = got["lights"][lvl], want["lights"][lvl]
    np.testing.assert_allclose(g["sg_flat"].numpy(), w["sg_flat"], atol=1e-4)
    for k in ("env_img", "diffuse", "specular"):
        np.testing.assert_allclose(g[k].numpy(), w[k], rtol=1e-3, atol=1e-5,
                                   err_msg=f"{k} level {lvl}")
    np.testing.assert_allclose(g["c_light"].numpy(), w["c_light"], rtol=5e-4)
    np.testing.assert_allclose(g["c_albedo"].numpy(), w["c_albedo"],
                               rtol=2e-4)


@pytest.mark.parametrize("rank", range(WORLD))
def test_confidences_are_over_the_group(ranks, rank):
    """Each confidence against the single-process call's, and against one
    process's confidences of the group call's maps (every rank's,
    gathered); the refined maps against the rank's own refinement of the
    group call's maps."""
    rec = ranks[rank]["record"]
    for key in ("conf_rel", "conf_call_rel"):
        assert sorted(rec[key]) == sorted(
            f"{lvl}.{k}" for lvl in range(2)
            for k in ("albedo", "rough", "depth"))
        for k, v in rec[key].items():
            assert v <= CONF_RTOL, (key, k)
    assert rec["refined_max_abs"] == 0.0


def test_a_rank_alone_takes_another_maximum(ranks):
    """The negative control: with ``group=None`` inside the ranks, every
    confidence is off on the rank whose images do not hold the batch's
    maximum."""
    for k in ranks[0]["record"]["conf_local_rel"]:
        worst = max(r["record"]["conf_local_rel"][k] for r in ranks)
        assert worst > 1e3 * CONF_RTOL, k


@pytest.mark.parametrize("rank", range(WORLD))
def test_rank_rows_match_the_single_process_call(ranks, rank):
    """The record's own distances (this rank's rows against the port's
    ``group=None`` call on the whole batch, at dryrun.SERVE_TOL; on the
    CPU a batch's rows are its halves' bit for bit)."""
    rec = ranks[rank]["record"]
    assert rec["local_b"] == GLOBAL_B // WORLD
    assert max(rec["close"].values()) <= 1.0, rec["close"]
    assert max(rec["specular_rel_l1"].values()) <= 1e-3
    assert max(rec["scales"].values()) <= 1e-4, rec["scales"]
    assert set(rec["launches"].values()) == {0}  # CPU: plain versions


def test_equal_inputs_give_bit_equal_outputs(ranks):
    a, b = (r["same"] for r in ranks)
    assert ranks[0]["record"]["digest"] == ranks[1]["record"]["digest"]
    for lvl in range(2):
        for part in ("preds", "lights", "refined"):
            for k, v in a[part][lvl].items():
                assert torch.equal(v, b[part][lvl][k]), (part, lvl, k)


def test_staged_mode_and_serialize_on_a_group_raise(ranks):
    for r in ranks:
        assert "fused=True" in r["staged_error"]
        assert "without a group" in r["serialize_error"]
