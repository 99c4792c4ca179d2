"""The port's bfloat16 compute dtype against the JAX package's.

``BRDFNets`` / ``LightNets`` with ``compute_dtype="bfloat16"`` in both
packages, on the same JAX-initialised params carried to the port through
``utils/weights.py``, on bit-equal synthetic batches (image 32x32 with an
8x8 grid for the BRDF nets, at cascades 0 and 1; image 64x64 with a 32x32
grid for the light nets: the light encoder's five stride-2 convs need a
32-wide grid, so that is the smallest light forward either package runs).
JAX runs on the CPU, its light step through the plain SG decode and
shading (``use_pallas=False``, the Pallas kernels' reference); the port's
kernel wrappers take their plain versions on CPU tensors.  Each compared
shape runs once in the port before the compared call (ROADMAP C12).

Tolerances, each measured here and stated with its test.  bf16 keeps 8
bits of mantissa, so the two packages' different summation orders and
rounding points (flax adds a conv's bias in bf16 after rounding the
product; oneDNN adds it before one rounding) move a net's output by a few
bf16 ulps, and the gated nets (ReLUs, the heads' clamps) pass that on.
Measured, largest over the cases:
  * the four BRDF heads: relative L2 of each head 9.2e-3 (c1 rough):
    tolerance 3e-2;
  * the SG heads (axis, lambda, weight): relative L2 1.3e-2 (axis):
    tolerance 5e-2;
  * the losses: relative 1.5e-4 (BRDF errors): tolerance 2e-3; 3.5e-3
    (light reconst): tolerance 2e-2;
  * the gradients: relative L2 of each net's whole gradient 7.8e-2 (the
    light encoder; 5.1e-2 the c1 BRDF encoder): tolerance 0.15.
And each package's bf16 losses within 2% (BRDF) and 5% (light) of its
own float32 losses: the JAX package's tolerances
(tests/test_pipeline.py:163-196).
"""

import copy
import shutil

import numpy as np
import pytest
import torch

import jax

from inverserenderingofindoorscene_tpu.data.synthetic import (
    synthetic_batch as jsynthetic_batch,
)
from inverserenderingofindoorscene_tpu.pipeline.brdf import BRDFNets as JBRDF
from inverserenderingofindoorscene_tpu.pipeline.brdf import (
    brdf_forward as jbrdf_forward,
    brdf_step as jbrdf_step,
    brdf_total_error as jbrdf_total_error,
)
from inverserenderingofindoorscene_tpu.pipeline.light import LightNets as JLight
from inverserenderingofindoorscene_tpu.pipeline.light import (
    light_step as jlight_step,
)
from inverserenderingofindoorscene_torch.data.synthetic import synthetic_batch
from inverserenderingofindoorscene_torch.ops import bilateral, build
from inverserenderingofindoorscene_torch.ops import sg_render
from inverserenderingofindoorscene_torch.pipeline.brdf import (
    BRDFNets,
    brdf_forward,
    brdf_step,
    brdf_total_error,
)
from inverserenderingofindoorscene_torch.pipeline.light import (
    LightNets,
    light_step,
)
from inverserenderingofindoorscene_torch.train.steps import (
    make_brdf_train_step,
    make_light_train_step,
)
from inverserenderingofindoorscene_torch.utils import checkpoint as ckpt
from inverserenderingofindoorscene_torch.utils import weights

BRDF_HW, BRDF_RC = (32, 32), (8, 8)
LIGHT_HW, LIGHT_RC = (64, 64), (32, 32)
BF16 = "bfloat16"
HEAD_TOL = 3e-2
SG_TOL = 5e-2
BRDF_LOSS_TOL = 2e-3
LIGHT_LOSS_TOL = 2e-2
GRAD_TOL = 0.15
ERROR_KEYS = ("albedo", "normal", "rough", "depth")
BRDF_NETS = ("encoder", "albedo", "normal", "rough", "depth")
LIGHT_NETS = ("encoder", "axis", "lamb", "weight")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread, as the CLI test files: under the six-worker
    run its convolutions slowed several times over with the default
    threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_l2(got, want):
    want = np.asarray(want, np.float64)
    return (np.linalg.norm(np.asarray(got, np.float64) - want)
            / np.linalg.norm(want))


def host(tree):
    return jax.tree.map(np.asarray, tree)


def net_rel_l2(port_grads, jax_grads, net):
    """Relative L2 of one net's whole gradient (all its parameters)."""
    keys = sorted(k for k in jax_grads if k.startswith(net + "."))
    got = np.concatenate([port_grads[k].numpy().ravel() for k in keys])
    want = np.concatenate([jax_grads[k].numpy().ravel() for k in keys])
    return rel_l2(got, want)


def _jax_brdf(jnets, params, batch):
    _, errors = jbrdf_step(jnets, params, batch)
    return jbrdf_total_error(errors), (errors,
                                       jbrdf_forward(jnets, params, batch))


JAX_BRDF = jax.jit(jax.value_and_grad(_jax_brdf, argnums=1, has_aux=True),
                   static_argnums=0)


def _jax_light(jnets, lp, bp, batch):
    losses, aux = jlight_step(*jnets, bp, lp, batch, use_pallas=False)
    sg = {k: aux["sg"][k] for k in ("axis", "lamb01", "weight01")}
    return 10.0 * losses["reconst"] + losses["render"], (losses, sg)


JAX_LIGHT = jax.jit(jax.value_and_grad(_jax_light, argnums=1, has_aux=True),
                    static_argnums=0)


def port_brdf(level, params, dtype=BF16):
    nets = BRDFNets(level, compute_dtype=dtype)
    nets.load_state_dict(weights.brdf_state_dict(host(params)))
    return nets


def port_light(params, dtype=BF16):
    nets = LightNets(env_rows=LIGHT_RC[0], env_cols=LIGHT_RC[1],
                     compute_dtype=dtype)
    nets.load_state_dict(weights.light_state_dict(host(params)))
    return nets


def port_brdf_grad(nets, batch):
    """(total, errors, preds, {name: grad}) of one port loss + backward."""
    nets.zero_grad(set_to_none=True)
    preds, errors = brdf_step(nets, batch)
    total = brdf_total_error(errors)
    total.backward()
    return total, errors, preds, {n: p.grad.clone()
                                  for n, p in nets.named_parameters()}


@pytest.fixture(scope="module", params=[0, 1], ids=["c0", "c1"])
def brdf(request):
    level = request.param
    kw = dict(batch=2, im_hw=BRDF_HW, env_rc=BRDF_RC, seed=3,
              cascade_level=level)
    tbatch, jbatch = synthetic_batch(device="cpu", **kw), jsynthetic_batch(
        **kw)
    jnets = JBRDF(cascade_level=level, compute_dtype=BF16)
    params = jnets.init(jax.random.PRNGKey(11 + level), BRDF_HW)
    (jtotal, (jerrors, jpreds)), jgrads = JAX_BRDF(jnets, params, jbatch)
    nets = port_brdf(level, params)
    port_brdf_grad(nets, tbatch)  # oneDNN's first call at these shapes
    total, errors, preds, grads = port_brdf_grad(nets, tbatch)
    return {"level": level, "params": params, "tbatch": tbatch,
            "jbatch": jbatch, "nets": nets, "jtotal": float(jtotal),
            "jerrors": host(jerrors), "jpreds": host(jpreds),
            "jgrads": weights.brdf_state_dict(host(jgrads)),
            "total": float(total.detach()), "errors": errors,
            "preds": preds,
            "grads": grads}


@pytest.fixture(scope="module")
def light():
    kw = dict(batch=2, im_hw=LIGHT_HW, env_rc=LIGHT_RC, seed=5)
    tbatch, jbatch = synthetic_batch(device="cpu", **kw), jsynthetic_batch(
        **kw)
    jnets = (JBRDF(cascade_level=0, compute_dtype=BF16),
             JLight(cascade_level=0, env_rows=LIGHT_RC[0],
                    env_cols=LIGHT_RC[1], compute_dtype=BF16))
    bp = jnets[0].init(jax.random.PRNGKey(21), LIGHT_HW)
    lp = jnets[1].init(jax.random.PRNGKey(22))
    (jtotal, (jlosses, jsg)), jgrads = JAX_LIGHT(jnets, lp, bp, jbatch)
    brdf_nets, light_nets = port_brdf(0, bp), port_light(lp)

    def port():
        light_nets.zero_grad(set_to_none=True)
        losses, aux = light_step(brdf_nets, light_nets, tbatch)
        total = 10.0 * losses["reconst"] + losses["render"]
        total.backward()
        return total, losses, aux["sg"], {
            n: p.grad.clone() for n, p in light_nets.named_parameters()}

    port()  # oneDNN's first call at these shapes
    total, losses, sg, grads = port()
    return {"bp": bp, "lp": lp, "tbatch": tbatch, "jbatch": jbatch,
            "brdf_nets": brdf_nets, "light_nets": light_nets,
            "jtotal": float(jtotal), "jlosses": host(jlosses),
            "jsg": host(jsg), "jgrads": weights.light_state_dict(
                host(jgrads)),
            "total": float(total.detach()), "losses": losses, "sg": sg,
            "grads": grads}


def test_brdf_forward_matches_jax_bf16(brdf):
    for head in ERROR_KEYS:
        got = brdf["preds"][head]
        assert got.dtype == torch.float32, head
        err = rel_l2(got.detach().numpy(), brdf["jpreds"][head])
        assert err < HEAD_TOL, (head, err)


def test_brdf_step_matches_jax_bf16(brdf):
    for k in ERROR_KEYS:
        np.testing.assert_allclose(float(brdf["errors"][k].detach()),
                                   float(brdf["jerrors"][k]),
                                   rtol=BRDF_LOSS_TOL, err_msg=k)
    np.testing.assert_allclose(brdf["total"], brdf["jtotal"],
                               rtol=BRDF_LOSS_TOL)
    for net in BRDF_NETS:
        err = net_rel_l2(brdf["grads"], brdf["jgrads"], net)
        assert err < GRAD_TOL, (net, err)
    assert all(g.dtype == torch.float32 for g in brdf["grads"].values())


def test_light_forward_matches_jax_bf16(light):
    for port_key, jax_key in (("axis", "axis"), ("lamb01", "lamb01"),
                              ("weight01", "weight01")):
        got = light["sg"][port_key]
        assert got.dtype == torch.float32, port_key
        err = rel_l2(got.detach().numpy(), light["jsg"][jax_key])
        assert err < SG_TOL, (port_key, err)


def test_light_step_matches_jax_bf16(light):
    for k in ("reconst", "render"):
        np.testing.assert_allclose(float(light["losses"][k]),
                                   float(light["jlosses"][k]),
                                   rtol=LIGHT_LOSS_TOL, err_msg=k)
    np.testing.assert_allclose(light["total"], light["jtotal"],
                               rtol=LIGHT_LOSS_TOL)
    for net in LIGHT_NETS:
        err = net_rel_l2(light["grads"], light["jgrads"], net)
        assert err < GRAD_TOL, (net, err)


def test_bf16_brdf_loss_near_f32_in_each_package(brdf):
    """The JAX package's gate (tests/test_pipeline.py:163-173), held by
    both packages on the same params."""
    jnets = JBRDF(cascade_level=brdf["level"])
    _, jerrors = jax.jit(lambda p, b: jbrdf_step(jnets, p, b))(
        brdf["params"], brdf["jbatch"])
    jf32 = float(jbrdf_total_error(jerrors))
    nets = port_brdf(brdf["level"], brdf["params"], "float32")
    with torch.no_grad():
        brdf_step(nets, brdf["tbatch"])
        f32 = float(brdf_total_error(brdf_step(nets, brdf["tbatch"])[1]))
    assert abs(brdf["jtotal"] - jf32) / jf32 < 0.02, (brdf["jtotal"], jf32)
    assert abs(brdf["total"] - f32) / f32 < 0.02, (brdf["total"], f32)


def test_bf16_light_loss_near_f32_in_each_package(light):
    """The JAX package's gate (tests/test_pipeline.py:176-196)."""
    jnets = (JBRDF(cascade_level=0),
             JLight(cascade_level=0, env_rows=LIGHT_RC[0],
                    env_cols=LIGHT_RC[1]))
    jlosses, _ = jax.jit(lambda bp, lp, b: jlight_step(
        *jnets, bp, lp, b, use_pallas=False))(light["bp"], light["lp"],
                                              light["jbatch"])
    jf32 = float(10.0 * jlosses["reconst"] + jlosses["render"])
    brdf_nets = port_brdf(0, light["bp"], "float32")
    light_nets = port_light(light["lp"], "float32")
    with torch.no_grad():
        light_step(brdf_nets, light_nets, light["tbatch"])
        losses, _ = light_step(brdf_nets, light_nets, light["tbatch"])
    f32 = float(10.0 * losses["reconst"] + losses["render"])
    assert abs(light["jtotal"] - jf32) / abs(jf32) < 0.05, (
        light["jtotal"], jf32)
    assert abs(light["total"] - f32) / abs(f32) < 0.05, (light["total"], f32)


def test_params_stay_f32_through_steps(brdf, light):
    """A bf16 train step updates float32 params with float32 gradients
    and Adam moments; the heads are float32."""
    step = make_brdf_train_step(copy.deepcopy(brdf["nets"]), device="cpu")
    metrics = step(brdf["tbatch"])
    assert all(v.dtype == torch.float32 for v in metrics.values())
    lstep = make_light_train_step(copy.deepcopy(light["brdf_nets"]),
                                  copy.deepcopy(light["light_nets"]),
                                  device="cpu")
    lstep(light["tbatch"])
    for s, nets in ((step, step.brdf_nets), (lstep, lstep.light_nets)):
        assert nets.compute_dtype == BF16
        for name, p in nets.named_parameters():
            assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
            st = s.optimizer.state[p]
            assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == (
                torch.float32), name
    with torch.no_grad():
        preds = brdf_forward(step.brdf_nets, brdf["tbatch"])
    assert all(v.dtype == torch.float32 for v in preds.values())


def test_state_dict_is_dtype_free(brdf, light):
    """The compute dtype is no part of the state: the bf16 nets' state
    dicts have the f32 nets' keys and dtypes."""
    for bf16, f32 in ((brdf["nets"], BRDFNets(brdf["level"])),
                      (light["light_nets"],
                       LightNets(env_rows=LIGHT_RC[0],
                                 env_cols=LIGHT_RC[1]))):
        a, b = bf16.state_dict(), f32.state_dict()
        assert list(a) == list(b)
        assert all(a[k].dtype == b[k].dtype == torch.float32 for k in a)


@pytest.fixture
def work(tmp_path):
    """tmp_path, emptied after the test: a BRDF checkpoint with its Adam
    moments is ~540 MB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_checkpoint_crosses_dtypes(brdf, work):
    """A checkpoint written by a bf16 step loads into f32 nets and back,
    its tensors unchanged, each net keeping its own compute dtype."""
    tmp_path = work
    step = make_brdf_train_step(copy.deepcopy(brdf["nets"]), device="cpu")
    step(brdf["tbatch"])
    ckpt.save_checkpoint(str(tmp_path), "brdf", brdf["level"], 0,
                         ckpt.train_state(step.brdf_nets, step.optimizer))
    f32 = make_brdf_train_step(BRDFNets(brdf["level"]), device="cpu")
    ckpt.load_train_state(ckpt.restore_checkpoint(
        str(tmp_path), "brdf", brdf["level"], 0), f32.brdf_nets,
        f32.optimizer)
    assert f32.brdf_nets.compute_dtype == "float32"
    for k, v in step.brdf_nets.state_dict().items():
        assert torch.equal(f32.brdf_nets.state_dict()[k], v), k
    ckpt.save_checkpoint(str(tmp_path), "brdf", brdf["level"], 1,
                         ckpt.train_state(f32.brdf_nets, f32.optimizer))
    back = BRDFNets(brdf["level"], compute_dtype=BF16)
    ckpt.load_train_state(ckpt.restore_checkpoint(
        str(tmp_path), "brdf", brdf["level"], 1), back)
    assert back.compute_dtype == BF16
    for k, v in step.brdf_nets.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


def test_float32_mode_casts_nothing(brdf, light):
    """In float32 mode the nets cast nothing: a float64 copy (the card's
    float64 checks of ``chip_smoke.py``) computes in float64 end to end."""
    nets = BRDFNets(brdf["level"]).double()
    batch = {k: v.double() if v.is_floating_point() else v
             for k, v in brdf["tbatch"].items()}
    with torch.no_grad():
        preds = brdf_forward(nets, batch)
        sg_out = light_step(BRDFNets(0).double(), LightNets(
            env_rows=LIGHT_RC[0], env_cols=LIGHT_RC[1]).double(),
            {k: v.double() if v.is_floating_point() else v
             for k, v in light["tbatch"].items()},
            use_kernels=False)[1]["sg"]
    assert all(v.dtype == torch.float64 for v in preds.values())
    assert all(v.dtype == torch.float64 for v in sg_out.values())


def test_compute_dtype_is_checked():
    with pytest.raises(ValueError, match="float16"):
        BRDFNets(0, compute_dtype="float16")
    with pytest.raises(ValueError, match="float16"):
        LightNets(compute_dtype="float16")


def _shading(dtype, b=1, h=2, w=3, k=4):
    g = torch.Generator().manual_seed(0)
    t = [torch.rand(s, generator=g).to(dtype) for s in (
        (b, h, w, 3), (b, h, w, 3), (b, h, w, 1), (b, h, w, k, 3),
        (b, h, w, k), (b, h, w, k, 3))]
    return t


def _grid():
    im = torch.rand((4, 5, 3), generator=torch.Generator().manual_seed(1))
    return bilateral.build_grid(im, 8.0, 4.0, 4.0)


KERNEL_CALLS = {
    "render_sg_env": lambda t: sg_render.render_sg_env(*t),
    "render_sg_fwd": lambda t: sg_render.render_sg_fwd(*t),
    "render_sg_bwd": lambda t: sg_render.render_sg_bwd(
        *t, t[0].contiguous(), t[0].contiguous()),
    "sg_envmap_fwd": lambda t: sg_render.sg_envmap_fwd(*t[3:]),
    "sg_envmap_bwd": lambda t: sg_render.sg_envmap_bwd(
        *t[3:], torch.zeros(t[4].shape + (128, 3), dtype=t[4].dtype)),
    "bilateral_blur": lambda t: bilateral.bilateral_blur(
        _grid(), torch.ones((_grid().nvert, 2), dtype=t[0].dtype)),
}


@pytest.mark.parametrize("kernel", list(KERNEL_CALLS))
def test_kernel_wrappers_raise_on_bf16(kernel, monkeypatch):
    """On the card route a wrapper checks its inputs before it builds or
    launches anything, and a bfloat16 input raises: the heads the kernels
    read stay float32 in bf16 mode, so a bf16 tensor there is a fault of
    the casts, never something to cast quietly.  ``build.on_card`` is made
    to say "card" for these CPU tensors (``chip_smoke.py`` phase 11 makes
    the same calls on the card)."""
    monkeypatch.setattr(build, "on_card", lambda fn, x: True)
    with pytest.raises(ValueError, match="float32"):
        KERNEL_CALLS[kernel](_shading(torch.bfloat16))
