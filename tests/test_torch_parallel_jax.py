"""The slice against the JAX package: the port's cascade-0 light step
through two gloo ranks on the CPU against JAX's light step in one device
on the global batch.

Sizes of JAX tests/test_multiprocess.py: image 64x80, lighting grid
32x40, global batch 4 (synthetic, seed 7), two rows a rank.  The weights
are flax's init (PRNGKey 0 and 1, as that test draws them), carried into
the port's modules by ``utils/weights.py``.  The ranks are
tests/torch_parallel_worker.py in ``light`` mode, meeting through a
``file://`` rendezvous in pytest's tmp dir, one torch thread each; the
port takes the kernel route (CPU tensors: the kernels' plain versions),
JAX its plain route.

Held:
  * the metrics within rtol 2e-4 of JAX's, the tolerance of
    test_multiprocess.py:144-150, and the two ranks' bit-equal;
  * the updated light parameters at tests/test_torch_train.py's
    tolerance for one Adam update: within 2 lr of JAX's, and where the
    summed gradient is above 1e-3 of its largest the update itself within
    lr / 100 (Adam's first update is lr g / (|g| + eps), so a gradient
    near zero may flip sign between two f32 programs); the two ranks'
    bit-equal.
"""

import sys

import numpy as np
import pytest
import torch

import jax

from inverserenderingofindoorscene_tpu.data.synthetic import (
    synthetic_batch as jsynthetic_batch,
)
from inverserenderingofindoorscene_tpu.pipeline.brdf import BRDFNets as JBRDF
from inverserenderingofindoorscene_tpu.pipeline.light import (
    LightNets as JLight,
)
from inverserenderingofindoorscene_tpu.train.steps import (
    create_train_state,
    make_light_train_step as jmake_light_train_step,
    reference_adam as jreference_adam,
)
from inverserenderingofindoorscene_torch.utils import weights
from torch_parallel_worker import run_ranks

IM_HW, ENV_RC = (64, 80), (32, 40)
GLOBAL_B, WORLD, SEED, LR = 4, 2, 7, 1e-4


@pytest.fixture(scope="module")
def jax_step():
    """(light params before, after, metrics) of JAX's step and the port
    state dicts of its weights."""
    jbrdf = JBRDF(cascade_level=0)
    jlight = JLight(cascade_level=0, env_rows=ENV_RC[0], env_cols=ENV_RC[1])
    bp = jbrdf.init(jax.random.PRNGKey(0), IM_HW)
    lp = jlight.init(jax.random.PRNGKey(1))
    batch = jsynthetic_batch(batch=GLOBAL_B, im_hw=IM_HW, env_rc=ENV_RC,
                             seed=SEED)
    state = create_train_state(lp, jreference_adam(LR))
    state, metrics = jax.jit(jmake_light_train_step(jbrdf, jlight, bp))(
        state, batch)

    def to_port(convert, tree):
        return {k: torch.as_tensor(np.array(v)) for k, v in
                convert(jax.tree.map(np.asarray, tree)).items()}

    return {"brdf": to_port(weights.brdf_state_dict, bp),
            "before": to_port(weights.light_state_dict, lp),
            "after": to_port(weights.light_state_dict, state.params),
            "metrics": {k: float(v) for k, v in metrics.items()}}


@pytest.fixture(scope="module")
def ranks(jax_step, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("light")
    torch.save({"brdf": jax_step["brdf"], "light": jax_step["before"],
                "im_hw": IM_HW, "env_rc": ENV_RC, "batch": GLOBAL_B,
                "seed": SEED, "lr": LR}, tmp / "in.pt")
    run_ranks(lambda r: [
        sys.executable, "tests/torch_parallel_worker.py", "light",
        f"file://{tmp}/store", str(WORLD), str(r), str(tmp / "in.pt"),
        str(tmp / f"out{r}.pt")], WORLD, timeout=300)
    return [torch.load(tmp / f"out{r}.pt") for r in range(WORLD)]


def test_ranks_are_bit_equal(ranks):
    a, b = ranks
    assert a["metrics"] == b["metrics"]
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
        assert torch.equal(a["grads"][k], b["grads"][k]), k


def test_metrics_match_jax(ranks, jax_step):
    got, want = ranks[0]["metrics"], jax_step["metrics"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=2e-4, err_msg=k)


def test_update_matches_jax(ranks, jax_step):
    got, grads = ranks[0]["params"], ranks[0]["grads"]
    assert sorted(got) == sorted(jax_step["after"])
    for k, w in jax_step["after"].items():
        g, w, p0 = got[k].numpy(), w.numpy(), jax_step["before"][k].numpy()
        np.testing.assert_allclose(g, w, atol=2 * LR, rtol=0, err_msg=k)
        big = np.abs(grads[k].numpy())
        big = big > 1e-3 * big.max()
        np.testing.assert_allclose((g - p0)[big], (w - p0)[big],
                                   atol=LR / 100, err_msg=k)
