"""The port's serving chain vs the JAX package's, end to end.

A level-2 staged ``InverseRenderer`` with lighting on both cascades runs
in both packages on shared weights (the port's seeded weights, carried
into flax by the JAX package's ``utils/torch_import.py``) and the same
numpy image, at the sizes of
tests/test_pipeline.py: image 64x64, lighting grid 32x32, light input
128x128.  Two routes: the port's kernel route (``use_kernels=True``; on
CPU tensors the wrapper runs the kernel's plain version) against the JAX
Pallas route (``use_pallas=True``, interpret mode), and the plain routes
against each other.

Tolerances.  Predictions and the SG tensor atol 1e-4: f32 conv stacks
summed in different orders (a few 1e-6 per stage).  Envmaps, diffuse and
specular rtol 1e-3 / atol 1e-5, as in tests/test_pipeline.py: at random
init the axis head normalizes near-zero lobe vectors and unsquash (tan
near pi/2) turns lamb01 ~ 0.99 into lamb ~ 64, so the SG tensor's f32
differences move sharp lobes by ~1e-4.  The host-side scale fit divides
the 2x2 least-squares coefficients of diffuse and specular, which
amplifies those differences again: c_albedo / c_light rtol 2e-4.
"""

import numpy as np
import pytest
import torch

import jax

from inverserenderingofindoorscene_tpu.pipeline.brdf import BRDFNets as JBRDF
from inverserenderingofindoorscene_tpu.pipeline.inference import (
    InverseRenderer as JRenderer,
)
from inverserenderingofindoorscene_tpu.pipeline.light import LightNets as JLight
from inverserenderingofindoorscene_tpu.utils import torch_import
from inverserenderingofindoorscene_torch.device import resolve_device
from inverserenderingofindoorscene_torch.ops import sg_render
from inverserenderingofindoorscene_torch.pipeline.brdf import BRDFNets
from inverserenderingofindoorscene_torch.pipeline.inference import (
    InverseRenderer,
)
from inverserenderingofindoorscene_torch.pipeline.light import LightNets
from inverserenderingofindoorscene_torch.utils import weights

IM_HW = (64, 64)
ENV_RC = (32, 32)
LIGHT_HW = (128, 128)
ROUTES = {"kernels": True, "plain": False}  # use_kernels == use_pallas


def sub_state(module, name):
    """numpy state dict of one submodule, in the reference's names."""
    return {k: v.numpy() for k, v in getattr(module, name).state_dict().items()}


@pytest.fixture(scope="module")
def stacks():
    """Port modules with seeded weights, carried into the JAX package's
    param trees by its own converter for reference checkpoints."""
    jax_stacks, port_stacks = [], []
    for lvl in range(2):
        gen = torch.Generator().manual_seed(10 + lvl)
        brdf = BRDFNets(lvl, generator=gen)
        light = LightNets(cascade_level=lvl, env_rows=ENV_RC[0],
                          env_cols=ENV_RC[1], generator=gen)
        bp = torch_import.brdf_params_from_torch(
            *(sub_state(brdf, n) for n in
              ("encoder", "albedo", "normal", "rough", "depth")))
        lp = torch_import.light_params_from_torch(
            *(sub_state(light, n) for n in
              ("encoder", "axis", "lamb", "weight")))
        jax_stacks.append((
            JBRDF(cascade_level=lvl), bp,
            JLight(cascade_level=lvl, env_rows=ENV_RC[0], env_cols=ENV_RC[1]),
            lp,
        ))
        port_stacks.append((brdf, light))
    return jax_stacks, port_stacks


@pytest.fixture(scope="module")
def request_arrays():
    rng = np.random.RandomState(3)
    im = rng.rand(1, *IM_HW, 3).astype(np.float32) ** 2.2
    im_small = rng.rand(1, *ENV_RC, 3).astype(np.float32) ** 2.2
    return im, im_small


@pytest.fixture(scope="module")
def outputs(stacks, request_arrays):
    """{route: (JAX output, port output, port kernel launches)}."""
    jax_stacks, port_stacks = stacks
    out = {}
    for route, flag in ROUTES.items():
        want = JRenderer(jax_stacks, is_light=True, use_pallas=flag)(
            *request_arrays, 57.0
        )
        before = sg_render.render_sg_env.launches
        got = InverseRenderer(port_stacks, is_light=True, use_kernels=flag,
                              device="cpu")(*request_arrays, 57.0)
        out[route] = (want, got, sg_render.render_sg_env.launches - before)
    return out


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("route", list(ROUTES))
def test_preds_match_jax(outputs, route, level):
    want, got, _ = outputs[route]
    assert len(got["preds"]) == 2
    for k in ("albedo", "normal", "rough", "depth"):
        g, w = got["preds"][level][k], np.asarray(want["preds"][level][k])
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("route", list(ROUTES))
def test_lighting_matches_jax(outputs, route, level):
    want, got, _ = outputs[route]
    assert len(got["lights"]) == 2 and got["light"] is got["lights"][-1]
    g, w = got["lights"][level], want["lights"][level]
    np.testing.assert_allclose(g["sg_flat"].numpy(), np.asarray(w["sg_flat"]),
                               atol=1e-4, err_msg="sg_flat")
    for k in ("env_img", "diffuse", "specular"):
        assert tuple(g[k].shape) == np.shape(w[k]), k
        np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                   rtol=1e-3, atol=1e-5, err_msg=k)
    for k in ("c_albedo", "c_light"):
        np.testing.assert_allclose(g[k], float(w[k]), rtol=2e-4, err_msg=k)


@pytest.mark.parametrize("route", list(ROUTES))
def test_cpu_route_launches_no_kernel(outputs, route):
    """On CPU tensors the kernel route runs the plain version."""
    assert outputs[route][2] == 0


@pytest.mark.parametrize("level", [0, 1])
def test_converter_round_trip(stacks, level):
    """utils.weights turns the JAX bundles' params back into the port's
    state dicts bit for bit, every flax leaf to one key."""
    jax_stacks, port_stacks = stacks
    _, bp, _, lp = jax_stacks[level]
    for params, module, convert in zip(
        (bp, lp), port_stacks[level],
        (weights.brdf_state_dict, weights.light_state_dict),
    ):
        sd = convert(jax.tree.map(np.asarray, params))
        ref = module.state_dict()
        assert len(sd) == len(jax.tree.leaves(params)) == len(ref)
        assert all(torch.equal(sd[k], ref[k].cpu()) for k in ref)


def test_level1_brdf_only_batched_matches_jax(stacks):
    """Level 1 without lighting is the BRDF-only path, and it takes
    batches."""
    jax_stacks, port_stacks = stacks
    rng = np.random.RandomState(4)
    im = rng.rand(2, *IM_HW, 3).astype(np.float32) ** 2.2
    small = rng.rand(2, *ENV_RC, 3).astype(np.float32) ** 2.2
    want = JRenderer(jax_stacks[:1], is_light=False)(im, small, 57.0)
    got = InverseRenderer(port_stacks[:1], is_light=False, device="cpu")(
        im, small, 57.0)
    assert got["lights"] == [] and got["light"] is None
    for k, w in want["preds"][0].items():
        np.testing.assert_allclose(got["preds"][0][k].numpy(), np.asarray(w),
                                   atol=1e-4, err_msg=k)


def test_staged_mode_contract(stacks, request_arrays):
    _, port_stacks = stacks
    im, im_small = request_arrays
    im2, small2 = np.concatenate([im, im]), np.concatenate([im_small,
                                                            im_small])
    r = InverseRenderer(port_stacks, is_light=True, device="cpu")
    with pytest.raises(ValueError, match="strictly-B1.*fused=True"):
        r(im2, small2)
    # the fused mode takes the batch, with a scale an image
    out = InverseRenderer(port_stacks, is_light=True, device="cpu",
                          fused=True)(im2, small2)
    assert tuple(out["light"]["c_light"].shape) == (2,)
    # bilateral refinement: one BilateralNets (or None) per level
    with pytest.raises(ValueError, match="bs_nets"):
        InverseRenderer(port_stacks, device="cpu", is_bs=True,
                        bs_nets=[None])


def test_device_none_means_cuda(stacks):
    """No quiet move to the CPU: without CUDA, device=None raises."""
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InverseRenderer(stacks[1][:1])
