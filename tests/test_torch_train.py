"""The port's cascade-0 lighting training vs the JAX package's.

Shared weights: the port's seeded modules, carried into flax by the JAX
package's own converter (``utils/torch_import.py``).  Sizes are those of
tests/test_pipeline.py: image 64x64, lighting grid 32x32, light input
128x128, B=2.  Two routes: the port's kernel route (``use_kernels=True``;
on CPU tensors each kernel wrapper runs its plain version, the backwards
their explicit adjoints) against the JAX Pallas route (``use_pallas=True``,
interpret mode), and the plain routes against each other.

Tolerances, each measured here and stated with its test:
  * the synthetic batch is bit-equal (the same float64 draws, rounded once);
  * the masked losses on shared inputs: rtol 1e-5 (f32 sums in another
    order);
  * the step's losses: rtol 5e-5 (7.4e-6 measured: f32 conv stacks and
    sums in another order);
  * the light gradients: relative L2 of each parameter's gradient 2e-4
    (2.8e-5 measured);
  * one Adam update: params atol 2 lr, and where |g| > 1e-3 max|g| the
    update itself within lr / 100 (Adam's first update is lr g/(|g|+eps),
    so a gradient near zero may flip sign between two f32 programs).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from inverserenderingofindoorscene_tpu.data.synthetic import (
    synthetic_batch as jsynthetic_batch,
)
from inverserenderingofindoorscene_tpu.losses import masked as jmasked
from inverserenderingofindoorscene_tpu.pipeline.brdf import BRDFNets as JBRDF
from inverserenderingofindoorscene_tpu.pipeline.brdf import (
    brdf_step as jbrdf_step,
    brdf_total_error as jbrdf_total_error,
)
from inverserenderingofindoorscene_tpu.pipeline.light import LightNets as JLight
from inverserenderingofindoorscene_tpu.pipeline.light import (
    light_step as jlight_step,
)
from inverserenderingofindoorscene_tpu.train.steps import (
    create_train_state,
    reference_adam as jreference_adam,
)
from inverserenderingofindoorscene_tpu.utils import torch_import
from inverserenderingofindoorscene_torch.data.synthetic import synthetic_batch
from inverserenderingofindoorscene_torch.losses import masked
from inverserenderingofindoorscene_torch.ops import sg_render
from inverserenderingofindoorscene_torch.pipeline.brdf import (
    BRDFNets,
    brdf_step,
    brdf_total_error,
)
from inverserenderingofindoorscene_torch.pipeline.light import LightNets
from inverserenderingofindoorscene_torch.pipeline.bilateral import BilateralNets
from inverserenderingofindoorscene_torch.train.steps import (
    make_bilateral_train_step,
    make_light_train_step,
    position_schedule,
    reference_adam,
)
from inverserenderingofindoorscene_torch.utils import weights

IM_HW = (64, 64)
ENV_RC = (32, 32)
LR = 1e-4
ROUTES = {"kernels": True, "plain": False}  # use_kernels == use_pallas
LOSS_KEYS = ("albedo", "normal", "rough", "depth", "reconst", "render")


def sub_state(module, name):
    return {k: v.numpy() for k, v in getattr(module, name).state_dict().items()}


def port_batch(seed=0, cascade_level=0):
    return synthetic_batch(batch=2, im_hw=IM_HW, env_rc=ENV_RC, seed=seed,
                           cascade_level=cascade_level, device="cpu")


def jax_batch(seed=0, cascade_level=0):
    return jsynthetic_batch(batch=2, im_hw=IM_HW, env_rc=ENV_RC, seed=seed,
                            cascade_level=cascade_level)


@pytest.fixture(scope="module")
def nets():
    """(port BRDFNets, port LightNets, JAX brdf params, JAX light params)."""
    gen = torch.Generator().manual_seed(7)
    brdf = BRDFNets(0, generator=gen)
    light = LightNets(env_rows=ENV_RC[0], env_cols=ENV_RC[1], generator=gen)
    bp = torch_import.brdf_params_from_torch(
        *(sub_state(brdf, n) for n in
          ("encoder", "albedo", "normal", "rough", "depth")))
    lp = torch_import.light_params_from_torch(
        *(sub_state(light, n) for n in ("encoder", "axis", "lamb", "weight")))
    return brdf, light, bp, lp


JNETS = (JBRDF(cascade_level=0),
         JLight(cascade_level=0, env_rows=ENV_RC[0], env_cols=ENV_RC[1]))


def _jax_loss(lp, bp, batch, use_pallas):
    losses, _ = jlight_step(*JNETS, bp, lp, batch, use_pallas=use_pallas)
    return 10.0 * losses["reconst"] + losses["render"], losses


JAX_GRAD = jax.jit(jax.value_and_grad(_jax_loss, has_aux=True),
                   static_argnums=3)


@pytest.fixture(scope="module")
def jax_results(nets):
    """{route: ((total, losses), grads)} of the JAX light step."""
    _, _, bp, lp = nets
    batch = jax_batch()
    return {route: JAX_GRAD(lp, bp, batch, flag)
            for route, flag in ROUTES.items()}


def port_grads(nets, use_kernels, batch=None):
    """(total, losses, {name: grad}, step) of one port loss + backward,
    on copies of the modules; the step is not taken."""
    brdf, light = copy.deepcopy(nets[0]), copy.deepcopy(nets[1])
    step = make_light_train_step(brdf, light, use_kernels=use_kernels,
                                 device="cpu", lr=LR)
    total, losses = step.loss(port_batch() if batch is None else batch)
    total.backward()
    grads = {n: p.grad.clone() for n, p in light.named_parameters()}
    return total, losses, grads, step


@pytest.fixture(scope="module")
def port_results(nets):
    return {route: port_grads(nets, flag) for route, flag in ROUTES.items()}


def rel_l2(got, want):
    want = np.asarray(want, np.float64)
    return (np.linalg.norm(np.asarray(got, np.float64) - want)
            / np.linalg.norm(want))


@pytest.mark.parametrize("cascade_level", [0, 1])
def test_synthetic_batch_bit_equal(cascade_level):
    got = synthetic_batch(batch=2, im_hw=(12, 16), env_rc=(6, 8),
                          cascade_level=cascade_level, seed=3, device="cpu")
    want = jsynthetic_batch(batch=2, im_hw=(12, 16), env_rc=(6, 8),
                            cascade_level=cascade_level, seed=3)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(w),
                                      err_msg=k)


def _loss_inputs():
    rng = np.random.RandomState(11)
    b, (h, w), (r, c) = 2, IM_HW, ENV_RC
    preds = {
        "albedo": rng.rand(b, h, w, 3),
        "normal": rng.uniform(-1, 1, (b, h, w, 3)),
        "rough": rng.uniform(-1, 1, (b, h, w, 1)),
        "depth": rng.uniform(0.1, 3.0, (b, h, w, 1)),
        "env_pred": rng.uniform(0, 3, (b, r, c, 128, 3)),
        "seg_env": (rng.rand(b, r, c, 1) > 0.3),
        "diffuse": rng.rand(b, r, c, 3),
        "specular": 0.3 * rng.rand(b, r, c, 3),
        "im_small": rng.rand(b, r, c, 3),
        "seg_small": rng.rand(b, r, c, 1),
    }
    return {k: v.astype(np.float32) for k, v in preds.items()}


@pytest.mark.parametrize("loss", ["brdf_errors", "envmap_reconst_error",
                                  "render_error", "masked_sq_sum"])
def test_masked_losses_match_jax(loss):
    x = _loss_inputs()
    jb = jax_batch()
    tb = port_batch()
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    j = {k: jnp.asarray(v) for k, v in x.items()}
    if loss == "brdf_errors":
        got, got_s = masked.brdf_errors(t["albedo"], t["normal"], t["rough"],
                                        t["depth"], tb)
        want, want_s = jmasked.brdf_errors(j["albedo"], j["normal"],
                                           j["rough"], j["depth"], jb)
        pairs = [(got[k], want[k]) for k in want]
        pairs += [(got_s[k], want_s[k]) for k in want_s]
    elif loss == "envmap_reconst_error":
        pairs = list(zip(
            masked.envmap_reconst_error(t["env_pred"], tb["env_gt"],
                                        t["seg_env"], 1.0),
            jmasked.envmap_reconst_error(j["env_pred"], jb["env_gt"],
                                         j["seg_env"], 1.0)))
    elif loss == "render_error":
        pairs = list(zip(
            masked.render_error(t["diffuse"], t["specular"], t["im_small"],
                                t["seg_small"]),
            jmasked.render_error(j["diffuse"], j["specular"], j["im_small"],
                                 j["seg_small"])))
    else:
        pairs = [(masked.masked_sq_sum(t["diffuse"], t["im_small"],
                                       t["seg_small"], 3.0),
                  jmasked.masked_sq_sum(j["diffuse"], j["im_small"],
                                        j["seg_small"], 3.0))]
    for g, w in pairs:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-7)


def test_brdf_step_matches_jax(nets):
    """brdf_forward at cascade 0 (raw heads, 0.5(x+1) for albedo and
    depth) and its errors, atol 1e-4 / rtol 1e-4 (f32 conv stacks)."""
    brdf, _, bp, _ = nets
    with torch.no_grad():
        preds, errors = brdf_step(brdf, port_batch())
    jpreds, jerrors = jbrdf_step(JNETS[0], bp, jax_batch())
    for k, w in jpreds.items():
        np.testing.assert_allclose(preds[k].numpy(), np.asarray(w), atol=1e-4,
                                   err_msg=k)
    for k, w in jerrors.items():
        np.testing.assert_allclose(errors[k].numpy(), np.asarray(w),
                                   rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(brdf_total_error(errors).numpy(),
                               float(jbrdf_total_error(jerrors)), rtol=1e-4)


@pytest.mark.parametrize("route", list(ROUTES))
def test_light_step_losses_match_jax(jax_results, port_results, route):
    (jtotal, jlosses), _ = jax_results[route]
    total, losses, _, _ = port_results[route]
    for k in LOSS_KEYS:
        np.testing.assert_allclose(losses[k].detach().numpy(),
                                   float(jlosses[k]), rtol=5e-5, err_msg=k)
    np.testing.assert_allclose(total.detach().numpy(), float(jtotal),
                               rtol=5e-5)


@pytest.mark.parametrize("route", list(ROUTES))
def test_light_grads_match_jax(jax_results, port_results, route):
    """Every light parameter's gradient, relative L2 2e-4."""
    _, jgrads = jax_results[route]
    want = weights.light_state_dict(jax.tree.map(np.asarray, jgrads))
    _, _, grads, _ = port_results[route]
    assert sorted(want) == sorted(grads)
    worst = max(rel_l2(grads[k].numpy(), want[k].numpy()) for k in want)
    assert worst < 2e-4, worst


def test_kernel_and_plain_routes_agree(port_results):
    """The port's two routes on one batch: BRDF errors bit-equal, the
    light losses rtol 1e-6, gradients relative L2 1e-5 (on the CPU the
    kernel route's forwards are the plain ops; the explicit adjoints sum
    in another order: 7.8e-7 measured)."""
    _, lk, gk, _ = port_results["kernels"]
    _, lp, gp, _ = port_results["plain"]
    for k in ("albedo", "normal", "rough", "depth"):
        assert torch.equal(lk[k], lp[k]), k
    for k in ("reconst", "render"):
        np.testing.assert_allclose(lk[k].detach().numpy(),
                                   lp[k].detach().numpy(), rtol=1e-6)
    assert max(rel_l2(gk[k].numpy(), gp[k].numpy()) for k in gk) < 1e-5


def _check_adam_update(before, after, want_after, grads, lr):
    """params after one update within 2 lr of JAX's; the update itself
    within lr/100 where |g| > 1e-3 max|g| (no sign flip possible)."""
    for k, w in want_after.items():
        got, w, p0 = after[k].numpy(), w.numpy(), before[k].numpy()
        np.testing.assert_allclose(got, w, atol=2 * lr, rtol=0, err_msg=k)
        g = np.abs(grads[k].numpy())
        big = g > 1e-3 * g.max()
        np.testing.assert_allclose((got - p0)[big], (w - p0)[big],
                                   atol=lr / 100, err_msg=k)


@pytest.mark.parametrize("route", list(ROUTES))
def test_one_adam_step_matches_jax(nets, jax_results, route):
    _, jgrads = jax_results[route]
    lp = nets[3]
    tx = jreference_adam(LR)
    updates, _ = tx.update(jgrads, tx.init(lp), lp)
    want = weights.light_state_dict(jax.tree.map(
        np.asarray, jax.tree.map(lambda p, u: p + u, lp, updates)))
    brdf, light = copy.deepcopy(nets[0]), copy.deepcopy(nets[1])
    before = {k: v.clone() for k, v in light.state_dict().items()}
    step = make_light_train_step(brdf, light, use_kernels=ROUTES[route],
                                 device="cpu", lr=LR)
    launches = (sg_render.sg_envmap_fwd.launches,
                sg_render.render_sg_bwd.launches)
    metrics = step(port_batch())
    assert sorted(metrics) == sorted(LOSS_KEYS + ("total",))
    grads = {n: p.grad for n, p in light.named_parameters()}
    _check_adam_update(before, light.state_dict(), want, grads, LR)
    # a CPU step runs the plain versions and launches nothing
    assert (sg_render.sg_envmap_fwd.launches,
            sg_render.render_sg_bwd.launches) == launches


def test_adam_state_carries_across(nets):
    """Two JAX steps == one JAX step, its TrainState converted, one port
    step: the params within 2 lr, the first moments relative L2 1e-3 and
    the second update, which is no longer +-lr, relative L2 5e-3 (1.6e-3
    measured: where g is near -mu the update's ratio is sensitive)."""
    brdf, light, bp, lp = nets
    tx = jreference_adam(LR)
    state = create_train_state(lp, tx)
    batch = jax_batch()
    for _ in range(2):
        _, g = JAX_GRAD(state.params, bp, batch, False)
        if int(state.step) == 1:
            state1 = state
        state = state.apply_gradients(g)
    light = copy.deepcopy(light)
    light.load_state_dict(weights.light_state_dict(
        jax.tree.map(np.asarray, state1.params)))
    before = {k: v.clone() for k, v in light.state_dict().items()}
    step = make_light_train_step(copy.deepcopy(brdf), light,
                                 use_kernels=False, device="cpu", lr=LR)
    adam = state1.opt_state[0]
    step.load_optax_state(jax.tree.map(np.asarray, adam.mu),
                          jax.tree.map(np.asarray, adam.nu), int(adam.count))
    step(port_batch())
    want = weights.light_state_dict(jax.tree.map(np.asarray, state.params))
    after = light.state_dict()
    for k, w in want.items():
        np.testing.assert_allclose(after[k].numpy(), w.numpy(), atol=2 * LR,
                                   rtol=0, err_msg=k)
        assert rel_l2(after[k] - before[k], w - before[k]) < 5e-3, k
    mu2 = weights.light_state_dict(jax.tree.map(np.asarray,
                                                state.opt_state[0].mu))
    for n, p in light.named_parameters():
        st = step.optimizer.state[p]
        assert int(st["step"]) == 2
        assert rel_l2(st["exp_avg"].numpy(), mu2[n].numpy()) < 1e-3, n


def test_carried_state_continues_the_schedule(nets, jax_results):
    """A carried optax state at count 2d + 1 continues the halving: the
    moments of one real JAX step with reference_adam(LR, d), the count
    set to 2d + 1, and one more update on each side.  The port's step,
    loaded with ``load_optax_state``, runs at LR / 4 and its update
    matches JAX's at the tolerances of test_adam_state_carries_across;
    the same step with the moments and count alone (the schedule left
    at 0) would run at LR and update 4x too far."""
    brdf, light, bp, lp = nets
    d = 3
    count = 2 * d + 1
    _, g = jax_results["plain"]
    tx = jreference_adam(LR, epoch_decay_steps=d)
    _, state = tx.update(g, tx.init(lp), lp)
    state = tuple(s._replace(count=jnp.asarray(count, jnp.int32))
                  if hasattr(s, "count") else s for s in state)
    updates, _ = tx.update(g, state, lp)
    want = weights.light_state_dict(jax.tree.map(
        np.asarray, jax.tree.map(lambda p, u: p + u, lp, updates)))
    moments = [jax.tree.map(np.asarray, m) for m in (state[0].mu,
                                                     state[0].nu)]
    before = {k: v.clone() for k, v in light.state_dict().items()}
    rate, after = {}, {}
    for positioned in (True, False):
        module = copy.deepcopy(light)
        step = make_light_train_step(copy.deepcopy(brdf), module,
                                     use_kernels=False, device="cpu", lr=LR,
                                     epoch_decay_steps=d)
        if positioned:
            step.load_optax_state(*moments, count)
        else:
            step.optimizer.load_state_dict(weights.light_adam_state_dict(
                step.optimizer, module, *moments, count))
        rate[positioned] = step.optimizer.param_groups[0]["lr"]
        step(port_batch())
        after[positioned] = module.state_dict()
    assert rate == {True: LR * 0.25, False: LR}
    for k, w in want.items():
        np.testing.assert_allclose(after[True][k].numpy(), w.numpy(),
                                   atol=2 * LR, rtol=0, err_msg=k)
        assert rel_l2(after[True][k] - before[k], w - before[k]) < 5e-3, k
        assert rel_l2(after[False][k] - before[k],
                      4.0 * (w - before[k])) < 5e-3, k


@pytest.mark.parametrize("stage", ["light", "bilateral"])
def test_position_schedule_matches_optax(nets, stage):
    """Each step's scheduler, put at a count, runs at the rate optax's
    reference_adam schedule gives there (lr 0.5^(count // d), JAX
    train/steps.py:71), and keeps to it over the steps that follow."""
    lr, d = 1e-3, 2
    if stage == "light":
        step = make_light_train_step(copy.deepcopy(nets[0]),
                                     copy.deepcopy(nets[1]), device="cpu",
                                     lr=lr, epoch_decay_steps=d)
    else:
        step = make_bilateral_train_step(copy.deepcopy(nets[0]),
                                         BilateralNets(), device="cpu",
                                         lr=lr, epoch_decay_steps=d)
    for count in (0, 1, 2, 5, 2 * d + 1, 10):
        position_schedule(step.scheduler, count)
        rates = []
        for _ in range(3):
            rates.append(step.optimizer.param_groups[0]["lr"])
            step.optimizer.step()  # no gradients: a no-op update
            step.scheduler.step()
        want = [lr * 0.5 ** ((count + i) // d) for i in range(3)]
        np.testing.assert_allclose(rates, want, rtol=1e-12, err_msg=count)
        np.testing.assert_allclose(step.scheduler.get_last_lr(),
                                   [lr * 0.5 ** ((count + 3) // d)],
                                   rtol=1e-12)


def test_light_train_step_descends(nets):
    """Several steps on one batch, kernel route (plain versions on the
    CPU): the total falls below the first step's, as in
    tests/test_pipeline.py::test_light_train_step_descends."""
    brdf, light = copy.deepcopy(nets[0]), copy.deepcopy(nets[1])
    step = make_light_train_step(brdf, light, device="cpu", lr=3e-4)
    batch = port_batch()
    totals = [float(step(batch)["total"]) for _ in range(5)]
    assert all(np.isfinite(totals)), totals
    assert min(totals[1:]) < totals[0], totals


def test_reference_adam_halves_the_rate():
    p = torch.nn.Parameter(torch.zeros(3))
    opt, sched = reference_adam([p], lr=1e-3, epoch_decay_steps=2)
    assert opt.defaults["betas"] == (0.5, 0.999) and opt.defaults["eps"] == 1e-8
    rates = []
    for _ in range(5):
        rates.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    np.testing.assert_allclose(rates, [1e-3, 1e-3, 5e-4, 5e-4, 2.5e-4])
    assert reference_adam([p])[1] is None


def test_entry_points_default_to_cuda(nets):
    """No quiet move to the CPU: device=None means CUDA."""
    if torch.cuda.is_available():
        assert make_light_train_step(*nets[:2]).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_light_train_step(*nets[:2])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        synthetic_batch(batch=1, im_hw=(4, 4), env_rc=(2, 2))
