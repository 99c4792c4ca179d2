"""The port's BRDF train step (trainBRDF) vs the JAX package's
``make_brdf_train_step``, at cascades 0 and 1.

Shared weights: the port's seeded ``BRDFNets``, carried into flax by the
JAX package's own converter (``utils/torch_import.py``); gradients and
optax moments come back through ``utils/weights.brdf_state_dict``.  Sizes
are those of tests/test_torch_train.py: image 64x64, lighting grid 32x32
(the cascade-1 ``*_pre`` maps of ``synthetic_batch``), B=2.  JAX runs on
the CPU; one jit of its train step and one of its gradient a cascade.
The JAX step's optimizer halves the rate every step
(``reference_adam(LR, epoch_decay_steps=1)``): its first update runs at
LR, its second at LR / 2.

Tolerances, each measured here and stated with its test:
  * the four errors and the total: rtol 1e-5 (3e-7 measured: f32 conv
    stacks and sums in another order);
  * the gradients: relative L2 of each net's gradient (encoder and the
    four decoders, all their parameters together) 2e-3 (2.95e-4 measured,
    the cascade-0 encoder; most nets 1e-6).  The nets are gated in f32:
    every ReLU, and the heads' clamp(1.01 tanh(x), -1, 1), whose
    derivative jumps from ~0.02 to 0 at |x| = 2.65.  A pixel within f32
    rounding of a gate takes its gradient on either side, in either
    package: over six seeded draws, with one thread, each package's f32
    gradient was up to 3.2e-4 (the port's cascade-0 depth net) from the
    float64 port, while the other package was ~1e-6 from it.  With
    several threads torch's oneDNN convolutions on the CPU sometimes give
    another result on the first call at a shape in a process (~5e-5 in a
    decoder's output; ROADMAP C12): 8.4e-4 in one draw's cascade-0 rough
    net, 1.5e-6 with one thread.  So each cascade's fixture runs one
    port loss and backward before the compared one, which the tests
    share;
  * one Adam update: params atol 2 lr, and where |g| > 1e-3 max|g| the
    update itself within lr / 100, as test_torch_train.py holds the light
    step;
  * a carried optax state: the second update relative L2 5e-3 and the
    first moments 1e-3, as test_torch_train.py's
    test_adam_state_carries_across.
"""

import copy

import numpy as np
import pytest
import torch

import jax

from inverserenderingofindoorscene_tpu.data.synthetic import (
    synthetic_batch as jsynthetic_batch,
)
from inverserenderingofindoorscene_tpu.pipeline.brdf import BRDFNets as JBRDF
from inverserenderingofindoorscene_tpu.pipeline.brdf import (
    brdf_step as jbrdf_step,
    brdf_total_error as jbrdf_total_error,
)
from inverserenderingofindoorscene_tpu.train.steps import (
    create_train_state,
    make_brdf_train_step as jmake_brdf_train_step,
    reference_adam as jreference_adam,
)
from inverserenderingofindoorscene_tpu.utils import torch_import
from inverserenderingofindoorscene_torch.data.synthetic import synthetic_batch
from inverserenderingofindoorscene_torch.pipeline.brdf import BRDFNets
from inverserenderingofindoorscene_torch.train.steps import (
    make_brdf_train_step,
)
from inverserenderingofindoorscene_torch.utils import weights
from test_torch_train import _check_adam_update, rel_l2

IM_HW = (64, 64)
ENV_RC = (32, 32)
LR = 1e-4
NETS = ("encoder", "albedo", "normal", "rough", "depth")
ERROR_KEYS = ("albedo", "normal", "rough", "depth")


def batches(cascade_level):
    kw = dict(batch=2, im_hw=IM_HW, env_rc=ENV_RC, seed=4,
              cascade_level=cascade_level)
    return synthetic_batch(device="cpu", **kw), jsynthetic_batch(**kw)


def flax_params(nets):
    return torch_import.brdf_params_from_torch(*(
        {k: v.detach().numpy() for k, v in getattr(nets, n).state_dict()
         .items()} for n in NETS))


def port_tree(tree):
    return weights.brdf_state_dict(jax.tree.map(np.asarray, tree))


def _jax_loss(jnets, params, batch):
    _, errors = jbrdf_step(jnets, params, batch)
    return jbrdf_total_error(errors), errors


JAX_GRAD = jax.jit(jax.value_and_grad(_jax_loss, argnums=1, has_aux=True),
                   static_argnums=0)


@pytest.fixture(scope="module", params=[0, 1], ids=["c0", "c1"])
def setup(request):
    """The cascade's port nets, JAX params, both batches, JAX's loss and
    gradient, the states after one and two steps of JAX's train step
    (jitted) with their metrics, and the port's loss and gradient."""
    level = request.param
    nets = BRDFNets(level, generator=torch.Generator().manual_seed(20 + level))
    params = flax_params(nets)
    tbatch, jbatch = batches(level)
    jnets = JBRDF(cascade_level=level)
    (jtotal, jerrors), jgrads = JAX_GRAD(jnets, params, jbatch)
    state = create_train_state(params, jreference_adam(LR,
                                                       epoch_decay_steps=1))
    jstep = jax.jit(jmake_brdf_train_step(jnets))
    state1, jmetrics = jstep(state, jbatch)
    state2, _ = jstep(state1, jbatch)
    port_loss(nets, tbatch)  # oneDNN's first call at these shapes
    return {"level": level, "nets": nets, "params": params, "tbatch": tbatch,
            "jtotal": jtotal, "jerrors": jerrors, "jgrads": jgrads,
            "state1": state1, "jmetrics": jmetrics, "state2": state2,
            "port": port_loss(nets, tbatch)}


def port_loss(nets, batch):
    """(total, errors, {name: grad}) of one port loss + backward on a copy
    of the nets; no update."""
    nets = copy.deepcopy(nets)
    step = make_brdf_train_step(nets, device="cpu", lr=LR)
    total, errors = step.loss(batch)
    total.backward()
    return total, errors, {n: p.grad for n, p in nets.named_parameters()}


def test_losses_match_jax(setup):
    total, errors, _ = setup["port"]
    assert sorted(errors) == sorted(ERROR_KEYS)
    for k in ERROR_KEYS:
        np.testing.assert_allclose(errors[k].detach().numpy(),
                                   float(setup["jerrors"][k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(total.detach().numpy(), float(setup["jtotal"]),
                               rtol=1e-5)


@pytest.mark.parametrize("net", NETS)
def test_grads_match_jax(setup, net):
    """Each net's gradient, all its parameters together, relative L2
    2e-3 (see the module docstring)."""
    _, _, grads = setup["port"]
    want = port_tree(setup["jgrads"])
    assert sorted(want) == sorted(grads)
    keys = [k for k in want if k.startswith(net + ".")]
    got = np.concatenate([grads[k].numpy().ravel() for k in keys])
    ref = np.concatenate([want[k].numpy().ravel() for k in keys])
    assert rel_l2(got, ref) < 2e-3


def test_one_adam_step_matches_jax(setup):
    """One step of each package's train step from the same weights: the
    metrics and the params after the update."""
    state, jmetrics = setup["state1"], setup["jmetrics"]
    nets = copy.deepcopy(setup["nets"])
    before = {k: v.clone() for k, v in nets.state_dict().items()}
    step = make_brdf_train_step(nets, device="cpu", lr=LR)
    metrics = step(setup["tbatch"])
    assert sorted(metrics) == sorted(ERROR_KEYS + ("total",))
    for k, v in metrics.items():
        assert not v.requires_grad, k
        np.testing.assert_allclose(v.numpy(), float(jmetrics[k]), rtol=1e-5,
                                   err_msg=k)
    grads = {n: p.grad for n, p in nets.named_parameters()}
    _check_adam_update(before, nets.state_dict(), port_tree(state.params),
                       grads, LR)


def test_carried_optax_state(setup):
    """Two JAX steps == one JAX step, its TrainState converted
    (``brdf_state_dict``, ``load_optax_state``), one port step.  The JAX
    schedule halves the rate at count 1, so the positioned port step runs
    at LR / 2."""
    state1, state2 = setup["state1"], setup["state2"]
    nets = copy.deepcopy(setup["nets"])
    nets.load_state_dict(port_tree(state1.params))
    before = {k: v.clone() for k, v in nets.state_dict().items()}
    step = make_brdf_train_step(nets, device="cpu", lr=LR,
                                epoch_decay_steps=1)
    adam = state1.opt_state[0]
    step.load_optax_state(jax.tree.map(np.asarray, adam.mu),
                          jax.tree.map(np.asarray, adam.nu), int(adam.count))
    assert step.optimizer.param_groups[0]["lr"] == LR / 2
    step(setup["tbatch"])
    want, after = port_tree(state2.params), nets.state_dict()
    for k, w in want.items():
        np.testing.assert_allclose(after[k].numpy(), w.numpy(), atol=2 * LR,
                                   rtol=0, err_msg=k)
        assert rel_l2(after[k] - before[k], w - before[k]) < 5e-3, k
    mu2 = port_tree(state2.opt_state[0].mu)
    for n, p in nets.named_parameters():
        st = step.optimizer.state[p]
        assert int(st["step"]) == 2
        assert rel_l2(st["exp_avg"].numpy(), mu2[n].numpy()) < 1e-3, n


def test_train_step_descends(setup):
    """Several steps on one batch: the total falls below the first
    step's."""
    step = make_brdf_train_step(copy.deepcopy(setup["nets"]), device="cpu",
                                lr=3e-4)
    totals = [float(step(setup["tbatch"])["total"]) for _ in range(5)]
    assert all(np.isfinite(totals)), totals
    assert min(totals[1:]) < totals[0], totals


def test_entry_point_defaults_to_cuda():
    """No quiet move to the CPU: device=None means CUDA."""
    if torch.cuda.is_available():
        assert make_brdf_train_step(BRDFNets(0)).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_brdf_train_step(BRDFNets(0))
