"""The port's bilateral stage vs the JAX package's.

Inputs are numpy draws from fixed seeds; JAX runs on the CPU in dense
mode with one vertex of capacity per pixel (``v_max = H*W``, or
``v_max="full"`` in the serving chain), the port on CPU tensors (the blur
wrapper runs its plain version there).  Nets share weights: the port's
seeded modules, carried into flax by the JAX package's own converter
(``utils/torch_import.py``).

Tolerances, each with the value measured here:
  * the grid (vertex count, pixel -> vertex map, neighbour table):
    exact;
  * the blur: bit-equal (both add the ten terms in one order);
  * bistochastization: rtol 1e-5 on n and m (max 4.7e-8 relative on n);
  * a forward solve vs JAX: relative L2 1e-4 and atol 1e-3 on [0, 1]
    targets (2.4e-5 and 2.2e-4 measured: the per-channel CG sums run in
    another order, and CG amplifies that at single pixels); vs the
    float64 scipy oracle rtol/atol 5e-3, as tests/test_bilateral.py
    holds JAX (2.8e-5 measured);
  * the solve's gradients: to the target relative L2 5e-4 (5.9e-5
    measured), to the confidence 5e-3 (7.5e-4 measured: that gradient is
    a difference of two slices, slice(yg) target - slice(yg yhat), which
    cancels at pixels that hold a vertex alone);
  * the confidence nets against flax: atol 1e-5 (f32 convolutions);
  * refinement on the same inputs against JAX: relative L2 1e-4; the
    serving chain's refined maps 1e-3 (2.4e-4 measured, rough at level
    0: the chain's predictions, which are the refinement's inputs,
    already differ by up to 1e-4, and rough maps around 0).  Maps are
    compared by relative L2: a 1e-6 difference in the guide may move a
    pixel across a grid-cell border, so an elementwise tolerance would
    fail for that alone;
  * the train step: losses rtol 1e-4 (5.5e-6 measured).  The
    confidence-net gradients are held by the relative L2 of each net's
    gradient, all its parameters together: 5e-2 (albedo 2.5e-2, depth
    9.8e-3, rough 4.5e-3 measured).  They are ill-conditioned in f32: on
    this batch's noisy guide (about one vertex per pixel) the 10-12
    unconverged CG iterations amplify reduction-order differences (the
    solve's own gradient to the confidence differs by 1.6e-3 between the
    packages, and both f32 versions are 4.6e-2 from a float64 run), and
    the normalization by the batch maximum cancels most of each net's
    gradient.  JAX's own dense and edge-list blurs, which differ only in
    summation order, give per-net gradients 3.4e-3 apart.  One Adam
    update: the port's equals optax's on the port's gradients (lr/100),
    and JAX's step within lr/100 wherever |g| > 3e-2 max|g| of its
    tensor (no sign flips there; 2 of 25,369 elements flip above 1e-2).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import oracle_bilateral as ob
from inverserenderingofindoorscene_tpu.data.synthetic import (
    synthetic_batch as jsynthetic_batch,
)
from inverserenderingofindoorscene_tpu.models.bilateral_net import (
    ConfidenceNet as JConfidenceNet,
)
from inverserenderingofindoorscene_tpu.ops import bilateral as jbl
from inverserenderingofindoorscene_tpu.pipeline import bilateral as jpb
from inverserenderingofindoorscene_tpu.pipeline.brdf import BRDFNets as JBRDF
from inverserenderingofindoorscene_tpu.pipeline.inference import (
    InverseRenderer as JRenderer,
    refine_bs as jrefine_bs,
)
from inverserenderingofindoorscene_tpu.pipeline.light import LightNets as JLight
from inverserenderingofindoorscene_tpu.train.steps import (
    reference_adam as jreference_adam,
)
from inverserenderingofindoorscene_tpu.utils import torch_import
from inverserenderingofindoorscene_torch.data.synthetic import synthetic_batch
from inverserenderingofindoorscene_torch.models.bilateral_net import (
    ConfidenceNet,
)
from inverserenderingofindoorscene_torch.models.mgnet import init_weights
from inverserenderingofindoorscene_torch.ops import bilateral as tbl
from inverserenderingofindoorscene_torch.pipeline.bilateral import (
    BilateralNets,
)
from inverserenderingofindoorscene_torch.pipeline.brdf import BRDFNets
from inverserenderingofindoorscene_torch.pipeline.inference import (
    InverseRenderer,
    refine_bs,
)
from inverserenderingofindoorscene_torch.pipeline.light import LightNets
from inverserenderingofindoorscene_torch.train.steps import (
    make_bilateral_train_step,
)
from inverserenderingofindoorscene_torch.utils import weights

H, W = 24, 32
MODES = (0, 2, 4)
LR = 1e-4


def rel_l2(got, want):
    want = np.asarray(want, np.float64)
    return (np.linalg.norm(np.asarray(got, np.float64) - want)
            / np.linalg.norm(want))


def make_guide(kind, seed=0, h=H, w=W):
    """[h, w, 3] float32 guide in 0..1."""
    rng = np.random.RandomState(seed)
    if kind == "random":
        g = rng.rand(h, w, 3)
    elif kind == "smooth":
        # a ramp with a little noise: the grid has real neighbour links
        yy, xx = np.mgrid[0:h, 0:w]
        g = np.stack([xx / w, yy / h, 0.5 + 0.3 * np.sin(xx / 4.0)], -1)
        g = np.clip(g + rng.randn(h, w, 3) * 0.02, 0.0, 1.0)
    elif kind == "quantized":
        g = np.round(rng.rand(h, w, 3) * 4) / 4.0
    else:  # two-level, gray: u and v sit on a cell border
        g = np.where(rng.rand(h, w, 1) > 0.5, 0.8, 0.2) * np.ones((1, 1, 3))
    return g.astype(np.float32)


def jax_grid(guide, params):
    h, w = guide.shape[:2]
    return jax.jit(lambda x: jbl.build_grid(
        x * 255.0, params.sigma_spatial, params.sigma_luma,
        params.sigma_chroma, h * w))(jnp.asarray(guide))


def port_grid(guide, params):
    return tbl.build_grid(torch.from_numpy(guide) * 255.0,
                          params.sigma_spatial, params.sigma_luma,
                          params.sigma_chroma)


def assert_grids_equal(jg, tg):
    nv = int(jg.valid.sum())
    assert tg.nvert == nv
    assert tg.nbr.dtype == torch.int32 and tuple(tg.nbr.shape) == (nv, 10)
    np.testing.assert_array_equal(tg.vert_of_pixel.numpy(),
                                  np.asarray(jg.vert_of_pixel))
    np.testing.assert_array_equal(tg.nbr.numpy(),
                                  np.asarray(jg.nbr)[:, :nv].T)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["random", "smooth", "quantized",
                                  "two_level"])
def test_build_grid_equals_jax(kind, mode):
    guide = make_guide(kind, seed=mode)
    params = tbl.MODE_PARAMS[mode]
    assert_grids_equal(jax_grid(guide, params), port_grid(guide, params))


def test_build_grid_full_width_equals_jax():
    """A noisy 240x320 guide: nearly one vertex per pixel."""
    rng = np.random.RandomState(5)
    guide = np.clip(0.5 + 0.3 * rng.randn(240, 320, 3), 0, 1).astype(
        np.float32)
    params = tbl.MODE_PARAMS[0]
    tg = port_grid(guide, params)
    assert tg.nvert > 0.9 * 240 * 320
    assert_grids_equal(jax_grid(guide, params), tg)


@pytest.fixture(scope="module")
def grid_pair():
    """(guide, JAX grid, port grid) of a smooth guide at mode 0."""
    guide = make_guide("smooth", seed=1)
    params = tbl.MODE_PARAMS[0]
    return guide, jax_grid(guide, params), port_grid(guide, params)


@pytest.mark.parametrize("c", [1, 3])
def test_blur_plain_equals_jax(grid_pair, c):
    _, jg, tg = grid_pair
    nv = tg.nvert
    y = np.random.RandomState(c).rand(nv, c).astype(np.float32)
    ypad = np.zeros((H * W, c), np.float32)
    ypad[:nv] = y
    want = np.asarray(jbl.blur(jg, jnp.asarray(ypad)))[:nv]
    got = tbl.bilateral_blur_plain(tg, torch.from_numpy(y))
    np.testing.assert_array_equal(got.numpy(), want)
    # on CPU tensors the wrapper is the plain version and launches nothing
    before = tbl.bilateral_blur.launches
    assert torch.equal(tbl.bilateral_blur(tg, torch.from_numpy(y)), got)
    assert tbl.bilateral_blur.launches == before


def test_blur_wrapper_raises_off_cpu_and_cuda(grid_pair):
    _, _, tg = grid_pair
    y = torch.zeros((tg.nvert, 1), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tbl.bilateral_blur(tg, y)


def test_bistochastize_matches_jax(grid_pair):
    _, jg, tg = grid_pair
    nv = tg.nvert
    jn, jm = jax.jit(jbl.bistochastize)(jg)
    tn, tm = tbl.bistochastize(tg)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn)[:nv], rtol=1e-5)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm)[:nv], rtol=1e-5)


def solve_inputs(seed, c, guide):
    rng = np.random.RandomState(seed)
    target = rng.rand(1, H, W, c).astype(np.float32)
    conf = (rng.rand(1, H, W, 1) * 0.9 + 0.1).astype(np.float32)
    return guide[None], target, conf


@pytest.mark.parametrize("mode", MODES)
def test_solve_matches_jax(grid_pair, mode):
    params = tbl.MODE_PARAMS[mode]
    c = 3 if mode == 0 else 1
    f, t, cf = solve_inputs(mode, c, grid_pair[0])
    want, jstats = jax.jit(
        lambda *a: jbl.bilateral_solve_stats(*a, params, H * W))(
        jnp.asarray(f), jnp.asarray(t), jnp.asarray(cf))
    got, stats = tbl.bilateral_solve_stats(
        torch.from_numpy(f), torch.from_numpy(t), torch.from_numpy(cf),
        params)
    assert tuple(got.shape) == (1, H, W, c)
    assert rel_l2(got.numpy(), want) < 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
    assert stats["nvert"].tolist() == np.asarray(jstats["nvert"]).tolist()


def test_solve_matches_oracle():
    """The float64 scipy oracle of tests/test_bilateral.py, same guide and
    parameters."""
    guide = make_guide("quantized", seed=0).astype(np.float64)
    oracle = ob.GridOracle(guide * 255.0, 6.0, 8.0, 8.0)
    rng = np.random.RandomState(2)
    target = rng.rand(H * W, 3)
    conf = rng.rand(H * W, 1) * 0.9 + 0.1
    want, _ = ob.solve_oracle(oracle, target, conf, lam=50.0, cg_maxiter=30)
    params = tbl.BSParams(8.0, 8.0, 6.0, 50.0, cg_maxiter=30)

    def t(x, c):
        return torch.from_numpy(x.reshape(1, H, W, c).astype(np.float32))

    got = tbl.bilateral_solve(t(guide, 3), t(target, 3), t(conf, 1), params)
    np.testing.assert_allclose(got.numpy().reshape(-1, 3), want, rtol=5e-3,
                               atol=5e-3)


def test_solve_grads_match_jax(grid_pair):
    """The autograd Function's backward (the gradient CG solve) against
    jax.vjp of bilateral_solve, to target and confidence; the guide's
    gradient is zero."""
    params = tbl.MODE_PARAMS[0]
    f, t, cf = solve_inputs(7, 3, grid_pair[0])
    gw = np.random.RandomState(8).randn(1, H, W, 3).astype(np.float32)
    want_t, want_c = jax.jit(jax.grad(
        lambda tt, cc: jnp.sum(jbl.bilateral_solve(
            jnp.asarray(f), tt, cc, params, H * W) * gw), argnums=(0, 1)))(
        jnp.asarray(t), jnp.asarray(cf))
    ft, tt, ct = (torch.from_numpy(x).requires_grad_() for x in (f, t, cf))
    out = tbl.bilateral_solve(ft, tt, ct, params)
    (out * torch.from_numpy(gw)).sum().backward()
    assert rel_l2(tt.grad.numpy(), want_t) < 5e-4
    assert rel_l2(ct.grad.numpy(), want_c) < 5e-3
    assert not ft.grad.any()


def flax_tree(state):
    """A port BilateralNets state dict (or a tree shaped like it, such as
    its gradients) -> the JAX BilateralNets.init tree."""
    return {
        mode: torch_import.confidence_params(
            {k[len(mode) + 1:]: v.detach().numpy() for k, v in state.items()
             if k.startswith(mode + ".")})
        for mode in ("albedo", "rough", "depth")
    }


def converted_bs_params(nets):
    """Port BilateralNets -> the JAX BilateralNets.init tree."""
    return flax_tree(nets.state_dict())


@pytest.mark.parametrize("in_channels", [6, 4])
def test_confidence_net_matches_flax(in_channels):
    """ConfidenceNet through bilateral_state_dict against flax at 32x48
    (flax's own init, converted into the port)."""
    rng = np.random.RandomState(in_channels)
    b, h, w = 2, 32, 48
    im = (2.0 * rng.rand(b, h, w, 3)).astype(np.float32)  # max above 1
    pred = rng.rand(b, h, w, in_channels - 3).astype(np.float32)
    jnet = JConfidenceNet(in_channels)
    jparams = jax.jit(jnet.init)(jax.random.PRNGKey(in_channels),
                                 jnp.asarray(im), jnp.asarray(pred))
    want = np.asarray(jax.jit(jnet.apply)(jparams, jnp.asarray(im),
                                          jnp.asarray(pred)))
    tree = {"albedo": jparams, "rough": jparams, "depth": jparams}
    sd = weights.bilateral_state_dict(jax.tree.map(np.asarray, tree))
    net = ConfidenceNet(in_channels)
    prefix = "albedo."
    net.load_state_dict({k[len(prefix):]: v for k, v in sd.items()
                         if k.startswith(prefix)})
    got = net(torch.from_numpy(im).permute(0, 3, 1, 2),
              torch.from_numpy(pred).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               want, atol=1e-5)


def test_bilateral_state_dict_round_trip():
    """Port weights -> the JAX converter -> bilateral_state_dict: bit for
    bit, every flax leaf to one key, strict load."""
    nets = BilateralNets(torch.Generator().manual_seed(3))
    tree = jax.tree.map(np.asarray, converted_bs_params(nets))
    sd = weights.bilateral_state_dict(tree)
    ref = nets.state_dict()
    assert len(sd) == len(jax.tree.leaves(tree)) == len(ref)
    assert all(torch.equal(sd[k], ref[k]) for k in ref)
    BilateralNets().load_state_dict(sd, strict=True)


def serving_preds(seed, h, w):
    """BRDF-like predictions in the ranges the chain gives refine_bs."""
    rng = np.random.RandomState(seed)
    normal = rng.randn(1, h, w, 3)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    preds = {
        "albedo": np.clip(0.5 + 0.2 * rng.randn(1, h, w, 3), 0, 1),
        "normal": normal,
        "rough": rng.uniform(-1, 1, (1, h, w, 1)),
        "depth": rng.uniform(0.2, 1.5, (1, h, w, 1)),
    }
    return {k: v.astype(np.float32) for k, v in preds.items()}


@pytest.mark.parametrize("with_nets", [True, False])
def test_refine_bs_matches_jax(with_nets):
    im = np.random.RandomState(9).rand(1, H, W, 3).astype(np.float32)
    preds = serving_preds(10, H, W)
    nets = BilateralNets(torch.Generator().manual_seed(4))
    jparams = converted_bs_params(nets) if with_nets else None
    want = jax.jit(jrefine_bs)(jnp.asarray(im),
                               {k: jnp.asarray(v) for k, v in preds.items()},
                               jparams)
    with torch.no_grad():
        got = refine_bs(torch.from_numpy(im),
                        {k: torch.from_numpy(v) for k, v in preds.items()},
                        nets if with_nets else None, use_kernels=True)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == np.shape(w), k
        assert rel_l2(got[k].numpy(), w) < 1e-4, k


# the serving chain at a small size: image 32x32, lighting grid 32x32
# (light input 128x128; a smaller grid leaves a zero-size feature map)
SERVE_HW, SERVE_RC = (32, 32), (32, 32)


def test_inverse_renderer_is_bs_matches_jax():
    """Level 2, lighting on, a BilateralNets per level: every level's
    refined maps against JAX's (v_max="full")."""
    jstacks, pstacks, bs_nets = [], [], []
    for lvl in range(2):
        gen = torch.Generator().manual_seed(20 + lvl)
        brdf = BRDFNets(lvl, generator=gen)
        light = LightNets(cascade_level=lvl, env_rows=SERVE_RC[0],
                          env_cols=SERVE_RC[1], generator=gen)
        bs_nets.append(BilateralNets(gen))

        def sub(module, name):
            return {k: v.numpy()
                    for k, v in getattr(module, name).state_dict().items()}

        jstacks.append((
            JBRDF(cascade_level=lvl),
            torch_import.brdf_params_from_torch(
                *(sub(brdf, n) for n in
                  ("encoder", "albedo", "normal", "rough", "depth"))),
            JLight(cascade_level=lvl, env_rows=SERVE_RC[0],
                   env_cols=SERVE_RC[1]),
            torch_import.light_params_from_torch(
                *(sub(light, n) for n in ("encoder", "axis", "lamb",
                                          "weight"))),
        ))
        pstacks.append((brdf, light))
    rng = np.random.RandomState(12)
    im = rng.rand(1, *SERVE_HW, 3).astype(np.float32) ** 2.2
    im_small = rng.rand(1, *SERVE_RC, 3).astype(np.float32) ** 2.2
    want = JRenderer(jstacks, is_light=True, is_bs=True,
                     bs_params=[converted_bs_params(n) for n in bs_nets],
                     v_max="full")(im, im_small, 57.0)
    got = InverseRenderer(pstacks, is_light=True, is_bs=True,
                          bs_nets=bs_nets, device="cpu")(im, im_small, 57.0)
    assert len(got["refined"]) == len(want["refined"]) == 2
    for lvl in range(2):
        for k, w in want["refined"][lvl].items():
            g = got["refined"][lvl][k]
            assert tuple(g.shape) == np.shape(w), (lvl, k)
            assert rel_l2(g.numpy(), w) < 1e-3, (lvl, k)


# the bilateral train step at the size of tests/test_bilateral.py
TRAIN_HW = (32, 32)


@pytest.fixture(scope="module")
def train_setup():
    """(port BRDFNets, port BilateralNets, JAX brdf params, JAX bs
    params, the batch at both sides)."""
    gen = torch.Generator().manual_seed(30)
    brdf = BRDFNets(0, generator=gen)
    bs_nets = BilateralNets(gen)

    def sub(name):
        return {k: v.numpy()
                for k, v in getattr(brdf, name).state_dict().items()}

    bp = torch_import.brdf_params_from_torch(
        *(sub(n) for n in ("encoder", "albedo", "normal", "rough", "depth")))
    sp = converted_bs_params(bs_nets)
    kw = dict(batch=2, im_hw=TRAIN_HW, env_rc=(16, 16), seed=0)
    return (brdf, bs_nets, bp, sp, jsynthetic_batch(**kw),
            synthetic_batch(device="cpu", **kw))


JBRDF0 = JBRDF(cascade_level=0)


def _jax_loss(sp, bp, batch):
    losses, _ = jpb.bilateral_step(JBRDF0, jpb.BilateralNets(), bp, sp,
                                   batch)
    return jpb.bilateral_total_error(losses), losses


JAX_BS_GRAD = jax.jit(jax.value_and_grad(_jax_loss, has_aux=True))


@pytest.fixture(scope="module")
def train_results(train_setup):
    """JAX ((total, losses), grads) and the port's (total, losses,
    stats, grads) of one loss + backward, no update."""
    brdf, bs_nets, bp, sp, jbatch, tbatch = train_setup
    jres = JAX_BS_GRAD(sp, bp, jbatch)
    nets = copy.deepcopy(bs_nets)
    step = make_bilateral_train_step(copy.deepcopy(brdf), nets, device="cpu",
                                     lr=LR)
    total, losses, stats = step.loss(tbatch)
    total.backward()
    grads = {n: p.grad.clone() for n, p in nets.named_parameters()}
    return jres, (total, losses, stats, grads)


def test_bilateral_step_losses_match_jax(train_results):
    (jtotal, jlosses), _ = train_results[0]
    total, losses, stats, _ = train_results[1]
    assert sorted(losses) == sorted(jlosses)
    for k, w in jlosses.items():
        np.testing.assert_allclose(losses[k].detach().numpy(), float(w),
                                   rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(total.detach().numpy(), float(jtotal),
                               rtol=1e-4)
    for mode, st in stats.items():
        assert 0 < int(st["nvert"].max()) <= TRAIN_HW[0] * TRAIN_HW[1], mode


@pytest.mark.parametrize("net", ["albedo", "rough", "depth"])
def test_bilateral_step_grads_match_jax(train_results, net):
    """Each confidence net's gradient, all parameters together, relative
    L2 5e-2 (see the module docstring)."""
    _, jgrads = train_results[0]
    want = weights.bilateral_state_dict(jax.tree.map(np.asarray, jgrads))
    grads = train_results[1][3]
    assert sorted(want) == sorted(grads)
    keys = [k for k in want if k.startswith(net + ".")]
    got = np.concatenate([grads[k].numpy().ravel() for k in keys])
    ref = np.concatenate([want[k].numpy().ravel() for k in keys])
    assert rel_l2(got, ref) < 5e-2


def adam_after(params, grads):
    """flax params after one optax reference Adam step on grads, as a
    port state dict."""
    tx = jreference_adam(LR)
    updates, _ = tx.update(grads, tx.init(params), params)
    return weights.bilateral_state_dict(jax.tree.map(
        np.asarray, jax.tree.map(lambda p, u: p + u, params, updates)))


def test_bilateral_adam_step_matches_jax(train_setup, train_results):
    """One step: the metrics; the params after the port's Adam equal
    optax's update from the port's own gradients within lr/100; and
    against JAX's step within 2 lr, the update within lr/100 wherever
    |g| > 3e-2 max|g| of its tensor."""
    brdf, bs_nets, _, sp, _, tbatch = train_setup
    want = adam_after(sp, train_results[0][1])
    nets = copy.deepcopy(bs_nets)
    before = {k: v.clone() for k, v in nets.state_dict().items()}
    step = make_bilateral_train_step(copy.deepcopy(brdf), nets, device="cpu",
                                     lr=LR)
    launches = tbl.bilateral_blur.launches
    metrics = step(tbatch)
    assert tbl.bilateral_blur.launches == launches  # CPU: plain versions
    assert {"total", "nvert_max", "nvert_albedo", "albedo_bs",
            "normal_raw"} <= set(metrics)
    assert all(torch.isfinite(v) for v in metrics.values())
    grads = {n: p.grad for n, p in nets.named_parameters()}
    after = nets.state_dict()
    own = adam_after(flax_tree(before), flax_tree(grads))
    jgrads = weights.bilateral_state_dict(jax.tree.map(
        np.asarray, train_results[0][1]))
    for k, w in want.items():
        got, w, p0 = after[k].numpy(), w.numpy(), before[k].numpy()
        np.testing.assert_allclose(got - p0, own[k].numpy() - p0,
                                   atol=LR / 100, err_msg=k)
        np.testing.assert_allclose(got, w, atol=2 * LR, rtol=0, err_msg=k)
        g = np.abs(jgrads[k].numpy())
        big = g > 3e-2 * g.max()
        np.testing.assert_allclose((got - p0)[big], (w - p0)[big],
                                   atol=LR / 100, err_msg=k)


def test_bilateral_step_routes_agree(train_setup):
    """use_kernels=False (the plain blur) gives the kernel route's
    losses bit for bit on the CPU, where both run the plain version."""
    brdf, bs_nets, _, _, _, tbatch = train_setup
    out = []
    for flag in (True, False):
        step = make_bilateral_train_step(copy.deepcopy(brdf),
                                         copy.deepcopy(bs_nets),
                                         use_kernels=flag, device="cpu")
        with torch.no_grad():
            out.append(step.loss(tbatch)[1])
    for k in out[0]:
        assert torch.equal(out[0][k], out[1][k]), k


def test_entry_points_default_to_cuda():
    """No quiet move to the CPU: device=None means CUDA."""
    nets = (BRDFNets(0), BilateralNets())
    if torch.cuda.is_available():
        assert make_bilateral_train_step(*nets).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_bilateral_train_step(*nets)


def test_init_is_seeded():
    a = BilateralNets(torch.Generator().manual_seed(1)).state_dict()
    b = BilateralNets(torch.Generator().manual_seed(1)).state_dict()
    c = init_weights(BilateralNets(), torch.Generator().manual_seed(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["albedo.conv1.weight"],
                           c.state_dict()["albedo.conv1.weight"])
