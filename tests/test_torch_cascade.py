"""The port's cascade 1 vs the JAX package's: the 17-channel encoder input,
the BRDF step, the lighting step and the bilateral step at cascade 1.

Shared weights: the port's seeded modules, carried into flax by the JAX
package's own converter (``utils/torch_import.py``).  Sizes are those of
tests/test_torch_train.py (image 64x64, lighting grid 32x32, B=2) and, for
the bilateral step, of tests/test_torch_bilateral.py (32x32, grid 16x16).
The batches are ``synthetic_batch(cascade_level=1)``: its ``*_pre`` maps
at the grid's size, and ``env_pre``.  Two light routes as in
test_torch_train.py: the port's kernels (plain versions and explicit
adjoints on CPU tensors) against JAX's Pallas kernels in interpret mode,
and the plain routes against each other.

Tolerances, each measured here and stated with its test:
  * ``prepare_cascade_input``: atol 1e-5 on maps of order 1 (4.8e-7
    measured with the ``*_pre`` maps at grid size, 3.6e-7 with the BRDF
    maps at image size; the diffuse/specular fit's ``frac / numel`` is
    37.1 and 37.3 on the two images, far from its 1e-2 gate);
  * ``brdf_step``: predictions atol 1e-4, errors rtol 1e-4, as at
    cascade 0 (test_torch_train.py::test_brdf_step_matches_jax);
  * the light step: losses rtol 5e-5, light gradients relative L2 2e-4
    each parameter, as at cascade 0;
  * the bilateral step: losses rtol 1e-4 and each confidence net's
    gradient relative L2 5e-2, as at cascade 0 (ROADMAP C9).

torch's oneDNN convolutions on the CPU (torch 2.13, several threads)
sometimes give another result on the first call at a shape in a process
(~5e-5 in a decoder's output, bit-equal from the second call on; ROADMAP
C12), so each comparison of a network's output runs the port once before
the compared call (``warm``).
"""

import copy

import numpy as np
import pytest
import torch

import jax

from inverserenderingofindoorscene_tpu.data.synthetic import (
    synthetic_batch as jsynthetic_batch,
)
from inverserenderingofindoorscene_tpu.pipeline import bilateral as jpb
from inverserenderingofindoorscene_tpu.pipeline.brdf import BRDFNets as JBRDF
from inverserenderingofindoorscene_tpu.pipeline.brdf import (
    brdf_step as jbrdf_step,
    prepare_cascade_input as jprepare_cascade_input,
)
from inverserenderingofindoorscene_tpu.pipeline.light import LightNets as JLight
from inverserenderingofindoorscene_tpu.pipeline.light import (
    light_step as jlight_step,
)
from inverserenderingofindoorscene_tpu.utils import torch_import
from inverserenderingofindoorscene_torch.data.synthetic import synthetic_batch
from inverserenderingofindoorscene_torch.pipeline.bilateral import BilateralNets
from inverserenderingofindoorscene_torch.pipeline.brdf import (
    BRDFNets,
    brdf_step,
    prepare_cascade_input,
)
from inverserenderingofindoorscene_torch.pipeline.light import LightNets
from inverserenderingofindoorscene_torch.train.steps import (
    make_bilateral_train_step,
    make_light_train_step,
)
from inverserenderingofindoorscene_torch.utils import weights
from test_torch_bilateral import converted_bs_params
from test_torch_train import rel_l2

IM_HW = (64, 64)
ENV_RC = (32, 32)
BS_HW, BS_RC = (32, 32), (16, 16)
LR = 1e-4
ROUTES = {"kernels": True, "plain": False}  # use_kernels == use_pallas
LOSS_KEYS = ("albedo", "normal", "rough", "depth", "reconst", "render")


def sub_state(module, name):
    return {k: v.numpy() for k, v in getattr(module, name).state_dict().items()}


def brdf_params(nets):
    return torch_import.brdf_params_from_torch(*(
        sub_state(nets, n)
        for n in ("encoder", "albedo", "normal", "rough", "depth")))


def warm(fn, *args):
    """Run fn once with its outputs' gradients, for oneDNN's first call at
    these shapes (module docstring)."""
    out = fn(*args)
    total = out[0] if isinstance(out, tuple) else out
    if total.requires_grad:
        total.backward()


def c1_batches(im_hw=IM_HW, env_rc=ENV_RC, seed=0):
    kw = dict(batch=2, im_hw=im_hw, env_rc=env_rc, seed=seed,
              cascade_level=1)
    return synthetic_batch(device="cpu", **kw), jsynthetic_batch(**kw)


def image_size_pre(tbatch, jbatch):
    """The batches with the four BRDF ``*_pre`` maps at image size, as the
    export writes them (diffuse and specular stay at the grid's size)."""
    rng = np.random.RandomState(9)
    b, h, w, _ = tbatch["im"].shape
    normal = rng.uniform(-1, 1, (b, h, w, 3))
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    maps = {"albedo_pre": rng.uniform(0, 1, (b, h, w, 3)),
            "normal_pre": 0.5 * (normal + 1.0),
            "rough_pre": rng.uniform(0, 1, (b, h, w, 1)),
            "depth_pre": rng.uniform(0.01, 1, (b, h, w, 1))}
    maps = {k: v.astype(np.float32) for k, v in maps.items()}
    return ({**tbatch, **{k: torch.from_numpy(v) for k, v in maps.items()}},
            {**jbatch, **maps})


@pytest.mark.parametrize("pre_size", ["grid", "image"])
def test_prepare_cascade_input_matches_jax(pre_size):
    tbatch, jbatch = c1_batches()
    if pre_size == "image":
        tbatch, jbatch = image_size_pre(tbatch, jbatch)
    got = prepare_cascade_input(tbatch, IM_HW)
    want = np.asarray(jax.jit(lambda b: jprepare_cascade_input(b, IM_HW))(
        jbatch))
    assert tuple(got.shape) == (2, *IM_HW, 17)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # albedo (channels 3-5) and depth (channel 10) have mean 1/3 an image
    for ch in (slice(3, 6), slice(10, 11)):
        np.testing.assert_allclose(got[..., ch].mean(dim=(1, 2, 3)).numpy(),
                                   1 / 3, rtol=1e-5)


def test_brdf_step_matches_jax():
    """brdf_forward at cascade 1 (the encoder on the 17 channels, the
    decoders on im) and its errors."""
    nets = BRDFNets(1, generator=torch.Generator().manual_seed(8))
    tbatch, jbatch = c1_batches()
    with torch.no_grad():
        warm(lambda b: brdf_step(nets, b)[1]["albedo"], tbatch)
        preds, errors = brdf_step(nets, tbatch)
    jpreds, jerrors = jax.jit(lambda p, b: jbrdf_step(JBRDF(cascade_level=1),
                                                      p, b))(
        brdf_params(nets), jbatch)
    for k, w in jpreds.items():
        np.testing.assert_allclose(preds[k].numpy(), np.asarray(w), atol=1e-4,
                                   err_msg=k)
    for k, w in jerrors.items():
        np.testing.assert_allclose(errors[k].numpy(), float(w), rtol=1e-4,
                                   err_msg=k)


@pytest.fixture(scope="module")
def light_nets():
    """(port BRDFNets(1), port LightNets(cascade 1), JAX brdf params, JAX
    light params)."""
    gen = torch.Generator().manual_seed(17)
    brdf = BRDFNets(1, generator=gen)
    light = LightNets(cascade_level=1, env_rows=ENV_RC[0],
                      env_cols=ENV_RC[1], generator=gen)
    lp = torch_import.light_params_from_torch(
        *(sub_state(light, n) for n in ("encoder", "axis", "lamb", "weight")))
    return brdf, light, brdf_params(brdf), lp


JNETS = (JBRDF(cascade_level=1),
         JLight(cascade_level=1, env_rows=ENV_RC[0], env_cols=ENV_RC[1]))


def _jax_light_loss(lp, bp, batch, use_pallas):
    losses, _ = jlight_step(*JNETS, bp, lp, batch, use_pallas=use_pallas)
    return 10.0 * losses["reconst"] + losses["render"], losses


JAX_LIGHT_GRAD = jax.jit(jax.value_and_grad(_jax_light_loss, has_aux=True),
                         static_argnums=3)


@pytest.fixture(scope="module")
def light_results(light_nets):
    """{route: (JAX ((total, losses), grads), port (total, losses,
    grads))} of one loss + backward, no update."""
    brdf, light, bp, lp = light_nets
    tbatch, jbatch = c1_batches()
    warm(make_light_train_step(copy.deepcopy(brdf), copy.deepcopy(light),
                               device="cpu").loss, tbatch)
    out = {}
    for route, flag in ROUTES.items():
        module = copy.deepcopy(light)
        step = make_light_train_step(copy.deepcopy(brdf), module,
                                     use_kernels=flag, device="cpu", lr=LR)
        total, losses = step.loss(tbatch)
        total.backward()
        grads = {n: p.grad.clone() for n, p in module.named_parameters()}
        out[route] = (JAX_LIGHT_GRAD(lp, bp, jbatch, flag),
                      (total, losses, grads))
    return out


@pytest.mark.parametrize("route", list(ROUTES))
def test_light_step_losses_match_jax(light_results, route):
    ((jtotal, jlosses), _), (total, losses, _) = light_results[route]
    for k in LOSS_KEYS:
        np.testing.assert_allclose(losses[k].detach().numpy(),
                                   float(jlosses[k]), rtol=5e-5, err_msg=k)
    np.testing.assert_allclose(total.detach().numpy(), float(jtotal),
                               rtol=5e-5)


@pytest.mark.parametrize("route", list(ROUTES))
def test_light_grads_match_jax(light_results, route):
    """Every light parameter's gradient, the cascade-1 encoder's wider
    ``conv1`` (it takes ``env_pre``) included, relative L2 2e-4."""
    (_, jgrads), (_, _, grads) = light_results[route]
    want = weights.light_state_dict(jax.tree.map(np.asarray, jgrads))
    assert sorted(want) == sorted(grads)
    assert grads["encoder.conv1.weight"].shape[1] > 64  # env_pre's channels
    worst = max(rel_l2(grads[k].numpy(), want[k].numpy()) for k in want)
    assert worst < 2e-4, worst


def test_light_step_reads_env_pre(light_nets):
    """The cascade-1 light step's SG output moves with ``env_pre``."""
    brdf, light, _, _ = light_nets
    tbatch, _ = c1_batches()
    step = make_light_train_step(copy.deepcopy(brdf), copy.deepcopy(light),
                                 device="cpu")
    with torch.no_grad():
        a = step.loss(tbatch)[1]["reconst"]
        b = step.loss({**tbatch, "env_pre": tbatch["env_pre"] * 0.5})[1][
            "reconst"]
    assert torch.isfinite(a) and torch.isfinite(b) and a != b


@pytest.fixture(scope="module")
def bs_results():
    """JAX ((total, losses), grads) and the port's (total, losses, grads)
    of the cascade-1 bilateral step, no update."""
    gen = torch.Generator().manual_seed(31)
    brdf, bs_nets = BRDFNets(1, generator=gen), BilateralNets(gen)
    sp = converted_bs_params(bs_nets)
    tbatch, jbatch = c1_batches(BS_HW, BS_RC)

    def loss(sp, bp, batch):
        losses, _ = jpb.bilateral_step(JBRDF(cascade_level=1),
                                       jpb.BilateralNets(), bp, sp, batch)
        return jpb.bilateral_total_error(losses), losses

    jres = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        sp, brdf_params(brdf), jbatch)
    nets = copy.deepcopy(bs_nets)
    step = make_bilateral_train_step(brdf, nets, device="cpu", lr=LR)
    warm(step.loss, tbatch)
    step.optimizer.zero_grad(set_to_none=True)
    total, losses, _ = step.loss(tbatch)
    total.backward()
    return jres, (total, losses,
                  {n: p.grad.clone() for n, p in nets.named_parameters()})


def test_bilateral_step_losses_match_jax(bs_results):
    ((jtotal, jlosses), _), (total, losses, _) = bs_results
    assert sorted(losses) == sorted(jlosses)
    for k, w in jlosses.items():
        np.testing.assert_allclose(losses[k].detach().numpy(), float(w),
                                   rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(total.detach().numpy(), float(jtotal),
                               rtol=1e-4)


@pytest.mark.parametrize("net", ["albedo", "rough", "depth"])
def test_bilateral_step_grads_match_jax(bs_results, net):
    """Each confidence net's gradient, all its parameters together,
    relative L2 5e-2 (ROADMAP C9)."""
    (_, jgrads), (_, _, grads) = bs_results
    want = weights.bilateral_state_dict(jax.tree.map(np.asarray, jgrads))
    keys = [k for k in want if k.startswith(net + ".")]
    got = np.concatenate([grads[k].numpy().ravel() for k in keys])
    ref = np.concatenate([want[k].numpy().ravel() for k in keys])
    assert rel_l2(got, ref) < 5e-2
