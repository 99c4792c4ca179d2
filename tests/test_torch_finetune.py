"""The port's IIW fine-tune vs the JAX package's: the ranking loss, the
inline synthesis of the cascade-1 ``*_pre`` maps, ``iiw_step`` at
cascades 0 and 1, one alternating cycle on a shared Adam, and the
steps' default device.  The NYU half is tests/test_torch_finetune_nyu.py.

Shared weights: the port's seeded modules, carried into flax by the JAX
package's own converter (``utils/torch_import.py``); gradients and optax
moments come back through ``utils/weights.brdf_state_dict``.  Sizes are
those of tests/test_torch_cascade.py: image 64x64, lighting grid 32x32,
B=2.  The IIW batches are ``synthetic_iiw_batch`` (the IIW loader's
format: a leading dummy row, counts below the padding, points from a
pool of 64 an image so that indices repeat); the cascade-1 batches carry
the ``*_pre`` maps that the port's plain route synthesizes from a seeded
cascade-0 stack, the same arrays for both packages.

Tolerances, each measured here and stated with its test:
  * the ranking losses: rtol 1e-6 (2.6e-7 measured: f32 sums of up to
    40 terms in another order), and the albedo gradient through the
    gather, repeated indices accumulated, atol 1e-7 on values up to 0.23
    (2.2e-8 measured);
  * ``iiw_step``: eq, darker and the total rtol 1e-5 (3.9e-7 measured),
    each net's gradient relative L2 2e-3, the BRDF step's tolerance and
    reason (tests/test_torch_brdf_train.py docstring; 3.2e-6 measured);
  * ``synthesize_pre``: the BRDF maps and ``env_pre`` atol 1e-4, the
    export's (tests/test_torch_export.py; 2.7e-5 measured, env_pre),
    diffuse and specular rtol 1e-3 / atol 1e-5, the serving chain's
    (specular 5.5e-5 absolute, 1.2e-4 relative, measured); between the
    port's routes the BRDF maps and ``env_pre`` bit-equal (no kernel runs
    before them);
  * one cycle (the synthetic BRDF step, then the real-data step, on one
    Adam whose rate halves every step), against JAX's cycle: each step's
    metrics rtol 1e-5 (6e-7 measured), and step 1's update as
    test_torch_brdf_train.py::test_one_adam_step_matches_jax holds one
    step: params within 2 lr, the update within lr / 100 where |g| >
    1e-3 max|g| (0.61 lr and 7e-5 lr measured; 1.95 lr and 2.4e-3 lr in
    an NYU cycle).  Not the update of the whole cycle at C6's relative L2
    (5e-3): in an NYU cycle (seed 61) the depth decoder's is 1.9e-2 from
    JAX's, while the port's f32 cycle is
    3.4e-5 from the port's float64 one.  A fifth of that decoder's step-1
    gradient is below 1e-7 (many elements exactly 0), where Adam's
    g / (|g| + eps) turns f32 noise into updates of up to lr, and JAX's
    nets compute in f32 even on float64 input.  The optimizer itself is
    held exactly: optax's Adam fed the port's own gradients of the two
    steps gives the port's params (rtol 1e-6 / atol 1e-9; 0.21 of it
    measured) and moments (atol 1e-6 of each tensor's largest; 0.13 of
    it), both at count 2.

torch's oneDNN convolutions on the CPU sometimes give another result on
the first call at a shape in a process (ROADMAP C12), so every compared
port call follows one uncompared call at its shapes.
"""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from inverserenderingofindoorscene_tpu.data.synthetic import (
    synthetic_batch as jsynthetic_batch,
)
from inverserenderingofindoorscene_tpu.losses import ranking as jranking
from inverserenderingofindoorscene_tpu.pipeline import finetune as jfinetune
from inverserenderingofindoorscene_tpu.pipeline.brdf import BRDFNets as JBRDF
from inverserenderingofindoorscene_tpu.pipeline.light import LightNets as JLight
from inverserenderingofindoorscene_tpu.train.steps import (
    create_train_state,
    make_brdf_train_step as jmake_brdf_train_step,
    make_iiw_train_step as jmake_iiw_train_step,
    reference_adam as jreference_adam,
)
from inverserenderingofindoorscene_tpu.utils import torch_import
from inverserenderingofindoorscene_torch.data.synthetic import (
    synthetic_batch,
    synthetic_iiw_batch,
)
from inverserenderingofindoorscene_torch.losses.ranking import (
    batch_ranking_loss,
    batched_ranking_loss,
)
from inverserenderingofindoorscene_torch.pipeline.brdf import BRDFNets
from inverserenderingofindoorscene_torch.pipeline.finetune import (
    PRE_KEYS,
    synthesize_pre,
)
from inverserenderingofindoorscene_torch.pipeline.light import LightNets
from inverserenderingofindoorscene_torch.train.steps import (
    make_brdf_train_step,
    make_iiw_train_step,
)
from inverserenderingofindoorscene_torch.utils import weights
from test_torch_train import _check_adam_update, rel_l2

IM_HW = (64, 64)
ENV_RC = (32, 32)
LR = 1e-4
N_PAIRS = 40
NETS = ("encoder", "albedo", "normal", "rough", "depth")
ROUTES = {"kernels": True, "plain": False}
RANK_KEYS = ("eq", "darker")
RANK_ARGS = ("eq_point", "eq_weight", "darker_point", "darker_weight",
             "eq_num", "darker_num")


def flax_tree(named):
    """{port BRDFNets name: tensor} (weights, gradients) -> a flax tree of
    the JAX ``BRDFNets``, through the JAX package's converter.  Copies:
    JAX on the CPU may alias a numpy buffer, which the port's optimizer
    then updates in place."""
    return torch_import.brdf_params_from_torch(*(
        {k[len(n) + 1:]: v.detach().numpy().copy() for k, v in named.items()
         if k.startswith(n + ".")} for n in NETS))


def flax_brdf(nets):
    return flax_tree(nets.state_dict())


def flax_light(nets):
    return torch_import.light_params_from_torch(*(
        {k: v.detach().numpy().copy()
         for k, v in getattr(nets, n).state_dict().items()}
        for n in ("encoder", "axis", "lamb", "weight")))


def port_tree(tree):
    return weights.brdf_state_dict(jax.tree.map(np.asarray, tree))


def to_jax(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def c0_stack():
    """A seeded cascade-0 BRDF + light stack (port modules)."""
    gen = torch.Generator().manual_seed(50)
    return (BRDFNets(0, generator=gen),
            LightNets(env_rows=ENV_RC[0], env_cols=ENV_RC[1], generator=gen))


def with_pre(batch):
    """``batch`` with the ``*_pre`` maps the port's plain route
    synthesizes from :func:`c0_stack`: a cascade-1 real-data batch."""
    synthesize_pre(*c0_stack(), batch, use_kernels=False)  # C12
    return synthesize_pre(*c0_stack(), batch, use_kernels=False)


def iiw_batch(seed=0):
    return synthetic_iiw_batch(batch=2, im_hw=IM_HW, max_num=N_PAIRS,
                               seed=seed, device="cpu")[0]


def grads_match(grads, jgrads, tol=2e-3):
    """Each net's gradient, all its parameters together, relative L2.  A
    net the loss does not reach (the IIW loss reads albedo only) has no
    port gradient and an all-zero JAX one."""
    want = port_tree(jgrads)
    assert sorted(want) == sorted(grads)
    for net in NETS:
        keys = [k for k in want if k.startswith(net + ".")]
        ref = np.concatenate([want[k].numpy().ravel() for k in keys])
        if all(grads[k] is None for k in keys):
            assert not ref.any(), net
            continue
        got = np.concatenate([grads[k].numpy().ravel() for k in keys])
        assert rel_l2(got, ref) < tol, net


# ----------------------------------------------------------------- ranking


def ranking_inputs(seed=3):
    batch = iiw_batch(seed)
    rng = np.random.RandomState(seed)
    albedo = torch.as_tensor(
        rng.uniform(0, 1, (2, *IM_HW, 3)).astype(np.float32))
    return albedo, batch


def test_ranking_batch_has_the_loader_format():
    _, batch = ranking_inputs()
    for kind in RANK_KEYS:
        points, wts = batch[f"{kind}_point"], batch[f"{kind}_weight"]
        num = batch[f"{kind}_num"]
        assert points.dtype == torch.int32 and tuple(points.shape) == (
            2, N_PAIRS, 4)
        assert torch.all(points[:, 0] == 0) and torch.all(wts[:, 0] == 0)
        assert torch.all((num >= 1) & (num <= N_PAIRS))
        for n in range(2):
            assert torch.all(wts[n, num[n]:] == 0)
            assert torch.all(wts[n, 1:num[n]] > 0)
    flat = batch["eq_point"][:, 1:, :2].reshape(2, -1, 2)
    assert len(torch.unique(flat[0], dim=0)) < flat.shape[1]  # repeats


@pytest.mark.parametrize("counts", ["num", "padded"])
def test_ranking_loss_per_image_matches_jax(counts):
    """The JAX signature, one image at a time; with the counts, or their
    default, the padded length."""
    albedo, batch = ranking_inputs()
    for n in range(2):
        args = [batch[k][n] for k in RANK_ARGS]
        if counts == "padded":
            args = args[:4]
        got = batch_ranking_loss(albedo[n], *args)
        want = jranking.batch_ranking_loss(
            jnp.asarray(albedo[n].numpy()),
            *(jnp.asarray(a.numpy()) for a in args))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_batched_ranking_loss_and_grad_match_jax():
    """The batched form against jax.vmap of the JAX function, and the
    albedo gradient of eq + darker, repeated indices accumulated."""
    albedo, batch = ranking_inputs()
    args = [batch[k] for k in RANK_ARGS]
    leaf = albedo.clone().requires_grad_(True)
    eq, dk = batched_ranking_loss(leaf, *args)
    (eq.sum() + dk.sum()).backward()

    def jloss(a, *rest):
        e, d = jax.vmap(jranking.batch_ranking_loss)(a, *rest)
        return jnp.sum(e) + jnp.sum(d), (e, d)

    jargs = [jnp.asarray(a.numpy()) for a in args]
    (_, (jeq, jdk)), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(albedo.numpy()), *jargs)
    np.testing.assert_allclose(eq.detach().numpy(), np.asarray(jeq),
                               rtol=1e-6)
    np.testing.assert_allclose(dk.detach().numpy(), np.asarray(jdk),
                               rtol=1e-6)
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jgrad),
                               atol=1e-7, rtol=0)
    assert float(leaf.grad.abs().max()) > 0


# -------------------------------------------------------------- synthesis


@pytest.fixture(scope="module")
def synthesized():
    """The port's synthesis on each route and JAX's, on one IIW batch."""
    brdf0, light0 = c0_stack()
    batch = iiw_batch(seed=5)
    jnets = (JBRDF(cascade_level=0),
             JLight(cascade_level=0, env_rows=ENV_RC[0], env_cols=ENV_RC[1]))
    want = jax.jit(lambda bp, lp, b: jfinetune.synthesize_pre(
        *jnets, bp, lp, b))(flax_brdf(brdf0), flax_light(light0),
                            to_jax(batch))
    synthesize_pre(brdf0, light0, batch)  # C12
    got = {route: synthesize_pre(brdf0, light0, batch, use_kernels=flag)
           for route, flag in ROUTES.items()}
    return batch, got, jax.tree.map(np.asarray, want)


@pytest.mark.parametrize("route", list(ROUTES))
def test_synthesize_pre_matches_jax(synthesized, route):
    batch, got, want = synthesized
    out = got[route]
    assert sorted(out) == sorted(set(batch) | set(PRE_KEYS))
    r, c = ENV_RC
    assert tuple(out["env_pre"].shape) == (2, r, c, 84)
    for k in ("diffuse_pre", "specular_pre"):
        assert tuple(out[k].shape) == (2, r, c, 3), k
    for k in PRE_KEYS:
        assert not out[k].requires_grad, k
        assert torch.isfinite(out[k]).all(), k
    for k in batch:
        assert out[k] is batch[k], k
    for k in ("albedo_pre", "normal_pre", "rough_pre", "depth_pre",
              "env_pre"):
        np.testing.assert_allclose(out[k].numpy(), want[k], atol=1e-4,
                                   err_msg=k)
    for k in ("diffuse_pre", "specular_pre"):
        np.testing.assert_allclose(out[k].numpy(), want[k], rtol=1e-3,
                                   atol=1e-5, err_msg=k)
    for k in ("albedo_pre", "depth_pre"):  # mean 1/3 an image
        np.testing.assert_allclose(out[k].mean(dim=(1, 2, 3)).numpy(), 1 / 3,
                                   rtol=1e-5, err_msg=k)
    assert float(out["normal_pre"].min()) >= 0.0
    assert float(out["rough_pre"].max()) <= 1.0


def test_synthesize_pre_routes_agree(synthesized):
    _, got, _ = synthesized
    for k in ("albedo_pre", "normal_pre", "rough_pre", "depth_pre",
              "env_pre"):
        assert torch.equal(got["kernels"][k], got["plain"][k]), k
    for k in ("diffuse_pre", "specular_pre"):
        np.testing.assert_allclose(got["kernels"][k].numpy(),
                                   got["plain"][k].numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=k)


# ---------------------------------------------------------------- iiw_step


def _jax_iiw_loss(jnets, params, batch):
    _, eq_l, dk_l = jfinetune.iiw_step(jnets, params, batch)
    return 2.0 * (eq_l + dk_l), {"eq": eq_l, "darker": dk_l}


JAX_IIW_GRAD = jax.jit(
    jax.value_and_grad(_jax_iiw_loss, argnums=1, has_aux=True),
    static_argnums=0)


def port_loss(step_cls, nets, batch, **kw):
    """(total, losses, {name: grad}) of one port loss + backward on a copy
    of the nets, after one uncompared call (C12); no update."""
    for _ in range(2):
        net_copy = copy.deepcopy(nets)
        step = step_cls(net_copy, device="cpu", lr=LR, **kw)
        total, losses = step.loss(batch)
        total.backward()
    return total, losses, {n: p.grad for n, p in net_copy.named_parameters()}


@pytest.fixture(scope="module", params=[0, 1], ids=["c0", "c1"])
def iiw_setup(request):
    level = request.param
    nets = BRDFNets(level, generator=torch.Generator().manual_seed(30 + level))
    batch = iiw_batch(seed=7)
    if level:
        batch = with_pre(batch)
    (jtotal, jlosses), jgrads = JAX_IIW_GRAD(JBRDF(cascade_level=level),
                                             flax_brdf(nets), to_jax(batch))
    return {"port": port_loss(make_iiw_train_step, nets, batch),
            "jax": (jtotal, jlosses, jgrads)}


def test_iiw_losses_match_jax(iiw_setup):
    total, losses, _ = iiw_setup["port"]
    jtotal, jlosses, _ = iiw_setup["jax"]
    assert sorted(losses) == sorted(RANK_KEYS)
    for k in RANK_KEYS:
        np.testing.assert_allclose(losses[k].detach().numpy(),
                                   float(jlosses[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(total.detach().numpy(), float(jtotal),
                               rtol=1e-5)


def test_iiw_grads_match_jax(iiw_setup):
    grads_match(iiw_setup["port"][2], iiw_setup["jax"][2])


# ------------------------------------------------------------------ cycle


def check_cycle(nets, port_steps, batches, state, jsteps):
    """One fine-tune cycle (the synthetic step, then the real-data step)
    in each package from the same weights and one fresh optimizer state.

    Against JAX's cycle: each step's metrics, and after step 1 the params
    within 2 lr and the update within lr / 100 where |g| > 1e-3 max|g|
    (test_torch_brdf_train.py::test_one_adam_step_matches_jax).  The
    shared optimizer itself: optax's Adam fed the port's own gradients of
    the two steps gives the port's params and moments (see the module
    docstring for why not JAX's gradients)."""
    replay = state
    for i, (step, jstep, batch) in enumerate(zip(port_steps, jsteps,
                                                 batches)):
        before = {k: v.clone() for k, v in nets.state_dict().items()}
        metrics = step(batch)
        grads = {n: p.grad for n, p in nets.named_parameters()}
        state, jmetrics = jstep(state, to_jax(batch))
        replay = replay.apply_gradients(flax_tree(grads))
        assert sorted(metrics) == sorted(jmetrics), sorted(jmetrics)
        for k, v in metrics.items():
            assert not v.requires_grad, k
            np.testing.assert_allclose(v.numpy(), float(jmetrics[k]),
                                       rtol=1e-5, err_msg=k)
        if i == 0:
            _check_adam_update(before, nets.state_dict(),
                               port_tree(state.params), grads, LR)
    after, want = nets.state_dict(), port_tree(replay.params)
    adam = replay.opt_state[0]
    mu, nu = port_tree(adam.mu), port_tree(adam.nu)
    assert int(adam.count) == int(state.opt_state[0].count) == 2
    for n, p in nets.named_parameters():
        np.testing.assert_allclose(after[n].numpy(), want[n].numpy(),
                                   atol=1e-9, rtol=1e-6, err_msg=n)
        st = port_steps[-1].optimizer.state[p]
        assert int(st["step"]) == 2
        for key, ref in (("exp_avg", mu[n]), ("exp_avg_sq", nu[n])):
            ref = ref.numpy()  # f32 rounding of a different order
            np.testing.assert_allclose(st[key].numpy(), ref, rtol=0,
                                       atol=1e-6 * np.abs(ref).max(),
                                       err_msg=f"{n} {key}")


@functools.lru_cache(maxsize=None)
def jax_brdf_train_step():
    return jax.jit(jmake_brdf_train_step(JBRDF(cascade_level=0)))


def cycle_setup(seed):
    """Seeded c0 nets, their fresh JAX TrainState (the rate halves every
    step) and the synthetic batch of the cycle's first half."""
    nets = BRDFNets(0, generator=torch.Generator().manual_seed(seed))
    state = create_train_state(flax_brdf(nets),
                               jreference_adam(LR, epoch_decay_steps=1))
    kw = dict(batch=2, im_hw=IM_HW, env_rc=ENV_RC, seed=seed)
    syn = synthetic_batch(device="cpu", **kw)
    for k, v in jsynthetic_batch(**kw).items():  # the same draws
        np.testing.assert_array_equal(syn[k].numpy(), np.asarray(v))
    return nets, state, syn


def run_cycle(step_cls, jstep, batch, seed):
    """The port's cycle on a shared Adam and scheduler against the JAX
    fine-tune CLI's two steps on one TrainState."""
    nets, state, syn = cycle_setup(seed)
    port_loss(step_cls, nets, batch)  # C12 at the real-data shapes
    port_loss(make_brdf_train_step, nets, syn)
    first = make_brdf_train_step(nets, device="cpu", lr=LR,
                                 epoch_decay_steps=1)
    second = step_cls(nets, device="cpu", optimizer=first.optimizer,
                      scheduler=first.scheduler)
    assert second.optimizer is first.optimizer
    check_cycle(nets, (first, second), (syn, batch), state,
                (jax_brdf_train_step(), jstep))
    assert first.optimizer.param_groups[0]["lr"] == LR / 4


def test_iiw_cycle_on_shared_adam_matches_jax():
    run_cycle(make_iiw_train_step,
              jax.jit(jmake_iiw_train_step(JBRDF(cascade_level=0))),
              iiw_batch(seed=9), seed=60)


def test_iiw_step_defaults_to_cuda():
    """No quiet move to the CPU: device=None means CUDA."""
    if torch.cuda.is_available():
        assert make_iiw_train_step(BRDFNets(0)).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_iiw_train_step(BRDFNets(0))
