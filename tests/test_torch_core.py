"""Port core numerics vs the JAX package on the same numpy inputs.

Every comparison feeds float32 arrays made from a seed to both packages.
``jax.image.resize`` antialiases where it shrinks; the port's
``resize_bilinear`` does so exactly there and takes the plain bilinear
kernel for upscales (the serving and training paths only enlarge), so
both kinds are held against the JAX function.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from inverserenderingofindoorscene_tpu.core import brdf as jbrdf
from inverserenderingofindoorscene_tpu.core import camera as jcamera
from inverserenderingofindoorscene_tpu.core import imageops as jimageops
from inverserenderingofindoorscene_tpu.core import scale as jscale
from inverserenderingofindoorscene_tpu.core import sg as jsg
from inverserenderingofindoorscene_tpu.core import sphere as jsphere
from inverserenderingofindoorscene_torch.core import brdf, camera, imageops
from inverserenderingofindoorscene_torch.core import scale, sg, sphere, tables

import oracle_np
from test_torch_sg_render import assert_close_naming_side

ATOL = 1e-5


def sg_inputs(rng, lead=(1, 10, 13), k=12):
    ax = rng.uniform(-1, 1, lead + (k, 3))
    ax = (ax / np.linalg.norm(ax, axis=-1, keepdims=True)).astype(np.float32)
    lamb = rng.uniform(0, 20, lead + (k,)).astype(np.float32)
    wgt = rng.uniform(0, 2, lead + (k, 3)).astype(np.float32)
    return ax, lamb, wgt


@pytest.mark.parametrize("hw,fov", [((120, 160), 57.0), ((10, 13), 42.75)])
def test_view_dirs_bit_equal(hw, fov):
    np.testing.assert_array_equal(camera.view_dirs(*hw, fov),
                                  jcamera.view_dirs(*hw, fov))


@pytest.mark.parametrize("eh,ew", [(8, 16), (4, 8)])
def test_hemisphere_bit_equal(eh, ew):
    np.testing.assert_array_equal(sphere.hemisphere_dirs(eh, ew),
                                  jsphere.hemisphere_dirs(eh, ew))
    np.testing.assert_array_equal(sphere.hemisphere_weights(eh, ew),
                                  jsphere.hemisphere_weights(eh, ew))


def diagnose_sg_to_envmap(got, oracle, inputs):
    """What a failure of the comparison below saw (ROADMAP C22, a port
    result 4e-4 off once in a six-worker run): the directions and pixels
    that moved, the port's envmap recomputed in the same process, the cached hemisphere table against a
    fresh float32 cast of the numpy grid, the inputs against a fresh draw,
    and the process's torch threads and CPU capability."""
    again = sg.sg_to_envmap(*map(torch.from_numpy, inputs)).numpy()
    table = tables.hemisphere(8, 16, torch.float32, torch.device("cpu"))
    grid = torch.as_tensor(sphere.hemisphere_dirs(8, 16),
                           dtype=torch.float32)
    fresh = sg_inputs(np.random.RandomState(0))
    far = np.abs(np.float64(got) - oracle) > ATOL
    return "\n".join([
        f"directions with an element beyond atol: "
        f"{np.unique(np.nonzero(far)[-2]).tolist()}; pixels: "
        f"{len({tuple(p) for p in np.argwhere(far)[:, :-2]})}",
        f"recomputed here: max |again - float64| "
        f"{np.abs(np.float64(again) - oracle).max():.3g}, max |again - got| "
        f"{np.abs(again - got).max():.3g}",
        f"cached hemisphere table: max |table - fresh cast| "
        f"{(table - grid).abs().max().item():.3g}; numpy grid against the "
        f"oracle's: {np.abs(sphere.hemisphere_dirs(8, 16) - oracle_np.hemisphere_dirs_np()).max():.3g}",
        "inputs against a fresh draw: " + ", ".join(
            f"{n} {np.abs(a - b).max():.3g}"
            for n, a, b in zip(("axis", "lamb", "weight"), inputs, fresh)),
        f"torch {torch.__version__}: threads {torch.get_num_threads()}, "
        f"inter-op {torch.get_num_interop_threads()}, CPU capability "
        f"{torch.backends.cpu.get_cpu_capability()}, float32 matmul "
        f"precision {torch.get_float32_matmul_precision()}",
    ])


def test_sg_to_envmap_matches_jax():
    ax, lamb, wgt = sg_inputs(np.random.RandomState(0))
    want = np.asarray(jsg.sg_to_envmap(jnp.asarray(ax), jnp.asarray(lamb),
                                       jnp.asarray(wgt)))
    got = sg.sg_to_envmap(torch.from_numpy(ax), torch.from_numpy(lamb),
                          torch.from_numpy(wgt)).numpy()
    oracle = oracle_np.sg_to_envmap_np(*(np.float64(x) for x in (ax, lamb,
                                                                  wgt)))
    try:
        assert_close_naming_side(
            lambda g, w: np.testing.assert_allclose(g[0], w[0], atol=ATOL),
            [got], [want], [oracle], ["envmap"])
    except AssertionError as e:
        raise AssertionError(f"{e}\n" + diagnose_sg_to_envmap(
            got, oracle, (ax, lamb, wgt))) from None


def test_unsquash_and_flat_split_match_jax():
    rng = np.random.RandomState(1)
    x = rng.uniform(0, 1, (2, 4, 5, 84)).astype(np.float32)
    want = np.asarray(jsg.unsquash(jnp.asarray(x)))
    got = sg.unsquash(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for a, b in zip(sg.sg_params_from_flat(torch.from_numpy(x)),
                    jsg.sg_params_from_flat(jnp.asarray(x))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_render_envmap_matches_jax():
    rng = np.random.RandomState(2)
    lead = (1, 10, 13)
    albedo = rng.rand(*lead, 3).astype(np.float32)
    normal = rng.uniform(-1, 1, lead + (3,))
    normal[..., 2] = np.abs(normal[..., 2]) + 0.3
    normal = (0.97 * normal / np.linalg.norm(normal, axis=-1, keepdims=True)
              ).astype(np.float32)
    rough = rng.uniform(-1, 1, lead + (1,)).astype(np.float32)
    env = np.array(jsg.sg_to_envmap(*map(jnp.asarray, sg_inputs(rng, lead))))
    args = (albedo, normal, rough, env)
    for fov in (57.0, 42.75):
        want = jbrdf.render_envmap(*map(jnp.asarray, args), fov_deg=fov)
        got = brdf.render_envmap(*map(torch.from_numpy, args), fov_deg=fov)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("singular", [False, True])
def test_ls_regress_diff_spec_matches_jax(singular):
    rng = np.random.RandomState(3)
    diff = rng.rand(2, 8, 9, 3).astype(np.float32)
    spec = 0.1 * rng.rand(2, 8, 9, 3).astype(np.float32)
    if singular:  # specular parallel to diffuse: the diffuse-only fallback
        spec = 0.5 * diff
    im = rng.rand(2, 8, 9, 3).astype(np.float32)
    want = jscale.ls_regress_diff_spec(*map(jnp.asarray,
                                            (diff, spec, im, diff, spec)))
    got = scale.ls_regress_diff_spec(*map(torch.from_numpy,
                                          (diff, spec, im, diff, spec)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    want = jscale.ls_regress(*map(jnp.asarray, (diff, im, spec)))
    got = scale.ls_regress(*map(torch.from_numpy, (diff, im, spec)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# (input hw, output hw): 2x decoder upsample, the two enlarging
# _match_hw fix-ups at 240x320, the 4x light-input upsample at test size
@pytest.mark.parametrize("src,dst", [
    ((8, 10), (16, 20)),
    ((14, 20), (15, 20)),
    ((6, 10), (7, 10)),
    ((32, 32), (128, 128)),
])
def test_resize_bilinear_matches_jax(src, dst):
    x = np.random.RandomState(4).rand(2, *src, 5).astype(np.float32)
    want = np.asarray(jimageops.resize_bilinear(jnp.asarray(x), dst))
    got = imageops.resize_bilinear(
        torch.from_numpy(x).permute(0, 3, 1, 2), dst
    ).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


# downscales of a 16x16 input, and a mixed resize (height up, width
# down): antialiased on the shrinking side, as jax.image.resize
@pytest.mark.parametrize("src,dst", [
    ((16, 16), (15, 15)),
    ((16, 16), (8, 8)),
    ((16, 16), (12, 10)),
    ((24, 32), (32, 24)),
])
def test_resize_bilinear_downscale_matches_jax(src, dst):
    x = np.random.RandomState(8).rand(2, *src, 3).astype(np.float32)
    want = np.asarray(jimageops.resize_bilinear(jnp.asarray(x), dst))
    got = imageops.resize_bilinear(
        torch.from_numpy(x).permute(0, 3, 1, 2), dst
    ).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("src,dst", [((16, 16), (12, 10)),
                                     ((24, 32), (32, 24))])
def test_resize_bilinear_downscale_grad_matches_jax(src, dst):
    rng = np.random.RandomState(9)
    x = rng.rand(2, *src, 3).astype(np.float32)
    g = rng.rand(2, *dst, 3).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jimageops.resize_bilinear(a, dst),
                     jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    imageops.resize_bilinear(xt, dst).backward(
        torch.from_numpy(g).permute(0, 3, 1, 2))
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5)


@pytest.mark.parametrize("src,dst", [((8, 10), (16, 20)), ((14, 20), (15, 20)),
                                     ((6, 10), (6, 10))])
def test_resize_bilinear_upscale_is_the_plain_kernel(src, dst):
    """An upscale or identity takes F.interpolate without antialiasing,
    bit for bit, as every caller did before the antialiased downscale."""
    x = torch.from_numpy(np.random.RandomState(10).rand(2, 5, *src)
                         .astype(np.float32))
    want = torch.nn.functional.interpolate(
        x, size=dst, mode="bilinear", align_corners=False, antialias=False)
    assert torch.equal(imageops.resize_bilinear(x, dst), want)


@pytest.mark.parametrize("src,dst", [
    ((64, 64), (32, 32)),
    ((240, 320), (120, 160)),
    ((15, 20), (7, 10)),
])
def test_adaptive_avg_pool_matches_jax(src, dst):
    x = np.random.RandomState(5).rand(1, *src, 3).astype(np.float32)
    want = np.asarray(jimageops.adaptive_avg_pool(jnp.asarray(x), dst))
    got = imageops.adaptive_avg_pool(
        torch.from_numpy(x).permute(0, 3, 1, 2), dst
    ).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_replication_pad_matches_jax():
    x = np.random.RandomState(6).rand(1, 5, 7, 4).astype(np.float32)
    want = np.asarray(jimageops.replication_pad(jnp.asarray(x), 1))
    got = imageops.replication_pad(
        torch.from_numpy(x).permute(0, 3, 1, 2), 1
    ).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.fixture
def medium_matmul_precision():
    """torch's float32 matmuls in bf16 passes (``medium``), as a worker
    may be left with; the setting is restored after."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    yield
    torch.set_float32_matmul_precision(before)


def sg_envmap_vjp_np(axis, lamb, weight, g_env):
    """The adjoint of ``oracle_np.sg_to_envmap_np``, float64 numpy."""
    ls = oracle_np.hemisphere_dirs_np()
    cosm1 = np.einsum("...kc,dc->...kd", axis, ls) - 1.0
    e = np.exp(lamb[..., None] * cosm1)
    gee = np.einsum("...dc,...kc->...kd", g_env, weight) * e
    return (lamb[..., None] * np.einsum("...kd,dc->...kc", gee, ls),
            np.sum(gee * cosm1, axis=-1),
            np.einsum("...dc,...kd->...kc", g_env, e))


@pytest.mark.parametrize("fn", ["sg_to_envmap", "sg_envmap_bwd_plain",
                                "render_sg_bwd_plain"])
def test_plain_sg_contractions_ignore_matmul_precision(
        fn, medium_matmul_precision):
    """ROADMAP C18: the port's plain SG contractions were einsums, whose
    CPU matmul rounds by the matmul precision and by the path a process
    is on (``medium`` put sg_to_envmap 0.13 off).  Written as broadcast
    products and sums they give the same bits under ``medium`` as under
    ``highest``, and stay at the float64 oracle's atol 1e-5."""
    from inverserenderingofindoorscene_torch.ops import sg_render

    rng = np.random.RandomState(0)
    ax, lamb, wgt = sg_inputs(rng)
    if fn == "render_sg_bwd_plain":
        lead = lamb.shape[:-1]
        normal = rng.uniform(-1, 1, lead + (3,))
        normal[..., 2] = np.abs(normal[..., 2]) + 0.3
        normal = 0.97 * normal / np.linalg.norm(normal, axis=-1,
                                                keepdims=True)
        args = [rng.rand(*lead, 3), normal, rng.uniform(-1, 1, lead + (1,)),
                ax, lamb, wgt, rng.randn(*lead, 3), rng.randn(*lead, 3)]
        run = sg_render.render_sg_bwd_plain
    elif fn == "sg_envmap_bwd_plain":
        # the gradients O(1), where atol 1e-5 is what float32 can hold
        g_env = rng.randn(*lamb.shape[:-1], 128, 3) * 0.01
        args = [ax, lamb, wgt, g_env]
        run = sg_render.sg_envmap_bwd_plain
        oracle = sg_envmap_vjp_np(*(np.float64(x) for x in args))
    else:
        args = [ax, lamb, wgt]
        run = sg.sg_to_envmap
        oracle = [oracle_np.sg_to_envmap_np(*(np.float64(x) for x in args))]
    ts = [torch.from_numpy(np.float32(x)) for x in args]
    got = run(*ts)
    got = got if isinstance(got, tuple) else (got,)
    torch.set_float32_matmul_precision("highest")
    exact = run(*ts)
    exact = exact if isinstance(exact, tuple) else (exact,)
    for g, x in zip(got, exact):
        assert torch.equal(g, x)
    if fn != "render_sg_bwd_plain":
        for g, o in zip(got, oracle):
            np.testing.assert_allclose(g.numpy(), o, atol=ATOL)
