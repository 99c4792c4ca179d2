"""Port ``ops.sg_render.render_sg_env`` vs the JAX ``render_sg_env``
(Pallas kernel in interpret mode) on the same numpy inputs.

On CPU tensors the port's wrapper runs its plain PyTorch version; the
CUDA kernel itself is held against that plain version on the card by
``chip_smoke.py``.  Tolerances are those of the JAX kernel tests
(tests/test_sg_render_kernel.py): the kernel's algebraic shortcuts and
the plain version's unreduced form differ in rounding, most in specular.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from inverserenderingofindoorscene_tpu.core.camera import view_dirs
from inverserenderingofindoorscene_tpu.ops import sg_render as jsg_render
from inverserenderingofindoorscene_torch.ops import sg_render

import oracle_np


def make_inputs(b=1, h=10, w=13, k=12, seed=0, normal_scale=0.97):
    """The JAX kernel tests' input distribution, as float32 numpy."""
    rng = np.random.RandomState(seed)
    albedo = rng.rand(b, h, w, 3)
    normal = rng.uniform(-1, 1, (b, h, w, 3))
    normal[..., 2] = np.abs(normal[..., 2]) + 0.3
    normal = normal_scale * normal / np.linalg.norm(normal, axis=-1,
                                                    keepdims=True)
    rough = rng.uniform(-1, 1, (b, h, w, 1))
    ax = rng.uniform(-1, 1, (b, h, w, k, 3))
    ax = ax / np.linalg.norm(ax, axis=-1, keepdims=True)
    lamb = rng.uniform(0, 20, (b, h, w, k))
    wgt = rng.uniform(0, 2, (b, h, w, k, 3))
    return [x.astype(np.float32)
            for x in (albedo, normal, rough, ax, lamb, wgt)]


def assert_outputs_close(got, want):
    d, s, e = (np.asarray(x) for x in got)
    d0, s0, e0 = (np.asarray(x) for x in want)
    np.testing.assert_allclose(d, d0, atol=2e-5, err_msg="diffuse")
    np.testing.assert_allclose(s, s0, atol=5e-4, err_msg="specular")
    np.testing.assert_allclose(e, e0, rtol=2e-5, atol=1e-5, err_msg="env")


def oracle_outputs(args, fov=57.0, f0=0.05, env_height=8, env_width=16):
    """diffuse, specular, env of ``render_sg_env``'s inputs in float64,
    from tests/oracle_np.py."""
    albedo, normal, rough, ax, lamb, wgt = (np.float64(x) for x in args)
    env = oracle_np.sg_to_envmap_np(ax, lamb, wgt, env_height, env_width)
    d, s = oracle_np.render_envmap_np(albedo, normal, rough, env, fov, f0,
                                      env_height, env_width)
    return d, s, env


def assert_close_naming_side(check, got, want, oracle, names):
    """``check(got, want)``; where it fails, the message also gives each
    side's largest distance from the float64 ``oracle``, output by output
    (``names``), so a failure says which side moved (ROADMAP C18)."""
    try:
        check(got, want)
    except AssertionError as e:
        lines = [f"{n}: max |got - float64| "
                 f"{np.abs(np.float64(g) - o).max():.3g}, max |want - "
                 f"float64| {np.abs(np.float64(w) - o).max():.3g}"
                 for n, g, w, o in zip(names, got, want, oracle)]
        raise AssertionError(f"{e}\n" + "\n".join(lines)) from None


@pytest.mark.parametrize("k", [4, 12])
@pytest.mark.parametrize("fov", [57.0, 42.75])
def test_render_sg_env_matches_jax(k, fov):
    """10x13 = 130 pixels: ragged against the TPU kernel's 128-pixel tile."""
    args = make_inputs(k=k)
    want = jsg_render.render_sg_env(*map(jnp.asarray, args), fov_deg=fov,
                                    interpret=True)
    before = sg_render.render_sg_env.launches
    got = sg_render.render_sg_env(*map(torch.from_numpy, args), fov_deg=fov)
    assert got[2].shape == (1, 10, 13, 128, 3)
    assert_close_naming_side(assert_outputs_close, [x.numpy() for x in got],
                             [np.asarray(x) for x in want],
                             oracle_outputs(args, fov),
                             ("diffuse", "specular", "env"))
    # a CPU call runs the plain version and launches nothing
    assert sg_render.render_sg_env.launches == before


def test_render_sg_env_batch_and_env_grid():
    """B=2 (view vectors shared across the batch) on a 4x8 envmap grid."""
    args = make_inputs(b=2, h=6, w=7, k=3, seed=1)
    want = jsg_render.render_sg_env(*map(jnp.asarray, args), env_height=4,
                                    env_width=8, interpret=True)
    got = sg_render.render_sg_env(*map(torch.from_numpy, args),
                                  env_height=4, env_width=8)
    assert_outputs_close([x.numpy() for x in got], want)


def test_full_width_specular_tolerance():
    """At full width (120x160, K=12) the inputs reach low-roughness pixels
    where the GGX term is ill-conditioned in f32, and single specular
    elements of the TPU kernel's own arithmetic (``_shade_tile_math``, the
    Pallas kernel body, here under jit) leave the JAX tests' atol 5e-4
    against the plain version.  chip_smoke.py therefore holds the CUDA
    kernel's specular by the relative L1 distance of the whole map, 1e-3;
    the TPU kernel's math meets that bound with room."""
    args = make_inputs(h=120, w=160, seed=5)
    n = 120 * 160
    view = view_dirs(120, 160, 57.0).astype(np.float32).reshape(n, 3)
    consts = jnp.asarray(jsg_render.pack_dir_consts(8, 16))
    tile = jax.jit(lambda *a: jsg_render._shade_tile_math(*a, consts, 0.05))
    d_k, s_k = tile(*[jnp.asarray(x.reshape(n, -1).T) for x in args + [view]])
    d, s, _ = sg_render.render_sg_env_plain(*map(torch.from_numpy, args))
    s, s_k = s.numpy().reshape(n, 3), np.asarray(s_k).T
    np.testing.assert_allclose(np.asarray(d_k).T, d.numpy().reshape(n, 3),
                               atol=2e-5)
    assert np.abs(s_k - s).sum() / np.abs(s).sum() < 1e-4
    assert np.abs(s_k - s).max() > 5e-4  # why the elementwise test is not used


def test_render_sg_env_rejects_other_devices():
    """No quiet route: a tensor that is neither CPU nor CUDA raises."""
    args = [torch.from_numpy(x).to("meta") for x in make_inputs(h=2, w=3)]
    with pytest.raises(ValueError, match="unsupported device"):
        sg_render.render_sg_env(*args)


# ---------------------------------------------------------------------------
# The training pair: render_sg and sg_envmap, forward and backward.  On CPU
# tensors their autograd Functions run the plain forwards and the explicit
# plain adjoints (render_sg_bwd_plain, sg_envmap_bwd_plain).  Gradients are
# held by the JAX kernel tests' rule: atol 2e-3 after dividing by
# max(max|g|, 1) (tests/test_sg_render_kernel.py:73-77).
# ---------------------------------------------------------------------------

GRAD_NAMES = ("albedo", "normal", "rough", "axis", "lamb", "weight")
SHADING_GRADS = ("normal", "rough")
CASES = {  # (b, h, w, k, zero weight)
    "K=4": (1, 16, 24, 4, False),
    "K=12": (1, 16, 24, 12, False),
    "ragged 10x13": (1, 10, 13, 12, False),
    "zero weight": (2, 10, 13, 12, True),
}


def case_inputs(case):
    b, h, w, k, zero = CASES[case]
    args = make_inputs(b=b, h=h, w=w, k=k, seed=2)
    if zero:
        args[5] = np.zeros_like(args[5])
    return args


def assert_grads_close(got, want, names):
    """The kernel tests' rule; the normal and rough gradients, which run
    through the GGX term's f32 conditioning (see
    test_render_sg_bwd_f32_conditioning), by relative L2 5e-3 instead
    (two f32 programs, the port's explicit adjoint and jax.vjp in the
    Pallas backward: up to 1.3e-3 measured on the normal)."""
    for nm, g, w in zip(names, got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        if nm in SHADING_GRADS:
            dist = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
            assert dist < 5e-3, (nm, dist)
            continue
        scale = max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(g / scale, w / scale, atol=2e-3,
                                   err_msg=nm)


def port_vjp(fn, args, cotangents):
    """torch.autograd through one of the port's Functions."""
    ts = [torch.from_numpy(x).requires_grad_(True) for x in args]
    outs = fn(*ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return [g.numpy() for g in torch.autograd.grad(
        outs, ts, [torch.from_numpy(c) for c in cotangents])]


@pytest.mark.parametrize("case", list(CASES))
def test_render_sg_matches_jax(case):
    args = case_inputs(case)
    d0, s0 = jsg_render.render_sg(*map(jnp.asarray, args), interpret=True)
    before = (sg_render.render_sg_fwd.launches,
              sg_render.render_sg_bwd.launches)
    d, s = sg_render.render_sg(*map(torch.from_numpy, args))
    np.testing.assert_allclose(d.numpy(), np.asarray(d0), atol=2e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(s0), atol=5e-4)
    if CASES[case][4]:
        assert not d.abs().max() and not s.abs().max()
    rng = np.random.RandomState(3)
    cot = [rng.randn(*d.shape).astype(np.float32) for _ in range(2)]
    _, vjp = jax.vjp(lambda *a: jsg_render.render_sg(*a, interpret=True),
                     *map(jnp.asarray, args))
    want = vjp(tuple(map(jnp.asarray, cot)))
    got = port_vjp(sg_render.render_sg, args, cot)
    assert_grads_close(got, want, GRAD_NAMES)
    assert (sg_render.render_sg_fwd.launches,
            sg_render.render_sg_bwd.launches) == before


@pytest.mark.parametrize("case", list(CASES))
def test_sg_envmap_matches_jax(case):
    lobes = case_inputs(case)[3:]
    e0 = jsg_render.sg_envmap(*map(jnp.asarray, lobes), interpret=True)
    before = (sg_render.sg_envmap_fwd.launches,
              sg_render.sg_envmap_bwd.launches)
    e = sg_render.sg_envmap(*map(torch.from_numpy, lobes))
    assert e.shape == lobes[0].shape[:3] + (128, 3)
    np.testing.assert_allclose(e.numpy(), np.asarray(e0), rtol=2e-5,
                               atol=1e-5)
    cot = [np.random.RandomState(4).randn(*e.shape).astype(np.float32)]
    _, vjp = jax.vjp(lambda *a: jsg_render.sg_envmap(*a, interpret=True),
                     *map(jnp.asarray, lobes))
    want = vjp(jnp.asarray(cot[0]))
    got = port_vjp(sg_render.sg_envmap, lobes, cot)
    assert_grads_close(got, want, GRAD_NAMES[3:])
    assert (sg_render.sg_envmap_fwd.launches,
            sg_render.sg_envmap_bwd.launches) == before


@pytest.mark.parametrize("op", ["render_sg", "sg_envmap"])
def test_plain_adjoints_match_autograd_and_jax_vjp(op):
    """The explicit adjoints are the derivation the CUDA backwards run.
    In float64 they equal torch.autograd of the plain forward to 1e-9
    relative (at |normal| = 0.97, off every clamp tie); in float32 they
    agree with jax.vjp of the TPU kernel's own tile math (its Pallas
    backward, interpret mode) by the kernel tests' rule."""
    args = make_inputs(b=2, h=6, w=7, k=5, seed=6)
    rng = np.random.RandomState(7)
    if op == "render_sg":
        n_out, names, plain, bwd = 2, GRAD_NAMES, sg_render.render_sg_plain, \
            sg_render.render_sg_bwd_plain
        jfn = jsg_render.render_sg
        cot = [rng.randn(2, 6, 7, 3) for _ in range(n_out)]
    else:
        args = args[3:]
        names, plain, bwd = GRAD_NAMES[3:], sg_render.sg_envmap_plain, \
            sg_render.sg_envmap_bwd_plain
        jfn = jsg_render.sg_envmap
        cot = [rng.randn(2, 6, 7, 128, 3)]
    x64 = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
           for x in args]
    outs = plain(*x64)
    outs = outs if isinstance(outs, tuple) else (outs,)
    c64 = [torch.tensor(c) for c in cot]
    auto = torch.autograd.grad(outs, x64, c64)
    explicit = bwd(*[x.detach() for x in x64], *c64)
    for nm, g, a in zip(names, explicit, auto):
        assert float((g - a).abs().max()) <= 1e-9 * float(a.abs().max()), nm
    cot32 = [c.astype(np.float32) for c in cot]
    _, vjp = jax.vjp(lambda *a: jfn(*a, interpret=True),
                     *map(jnp.asarray, args))
    want = vjp(tuple(map(jnp.asarray, cot32)) if op == "render_sg"
               else jnp.asarray(cot32[0]))
    got = bwd(*map(torch.from_numpy, args), *map(torch.from_numpy, cot32))
    assert_grads_close([g.numpy() for g in got], want, names)


def test_render_sg_bwd_f32_conditioning():
    """The f32 explicit adjoint of render_sg's backward at full width
    (120x160, K=12) against its float64 value.  With the TPU kernels'
    nom0 = ndh^2 (a2 - 1) + 1 it was ~3e-3 (normal) and ~1e-3 (rough)
    relative L2 away, with single elements past the kernel tests'
    elementwise rule: the formula cancels near ndh = 1, and where the GGX
    denominator sits at its clamp f32 flips the gradient's gate.  With
    nom0 = a2 ndh^2 + |n x h|^2 (csrc/sg_common.cuh `shade<true>`) it is
    ~1e-4 and ~6e-6, every element within that rule.  chip_smoke.py holds
    the kernel by the relative L2 distance of each gradient (GRAD_REL_L2),
    as its other reference, torch.autograd of the f32 plain forward, has
    the cancelling formula."""
    args = make_inputs(h=120, w=160, seed=5)
    rng = np.random.RandomState(8)
    cot = [rng.randn(1, 120, 160, 3) for _ in range(2)]
    g32 = sg_render.render_sg_bwd_plain(
        *map(torch.from_numpy, args),
        *(torch.from_numpy(c.astype(np.float32)) for c in cot))
    g64 = sg_render.render_sg_bwd_plain(
        *(torch.tensor(x, dtype=torch.float64) for x in args),
        *map(torch.tensor, cot))
    del args
    dist = {}
    for nm, a, b in zip(GRAD_NAMES, g32, g64):
        dist[nm] = float(torch.linalg.vector_norm(a.double() - b)
                         / torch.linalg.vector_norm(b))
    assert dist["normal"] < 5e-4 and dist["rough"] < 5e-4, dist
    assert max(dist[k] for k in ("albedo", "axis", "lamb", "weight")) < 5e-4
    n32, n64 = g32[1].double(), g64[1]
    assert float((n32 - n64).abs().max() / n64.abs().max()) < 2e-3


@pytest.mark.parametrize("fn", ["render_sg_fwd", "render_sg_bwd",
                                "sg_envmap_fwd", "sg_envmap_bwd"])
def test_training_wrappers_reject_other_devices(fn):
    """No quiet route for the training kernels either."""
    args = [torch.from_numpy(x).to("meta") for x in make_inputs(h=2, w=3)]
    if fn.startswith("sg_envmap"):
        args = args[3:]
    if fn == "render_sg_bwd":
        args += [torch.zeros(1, 2, 3, 3, device="meta")] * 2
    if fn == "sg_envmap_bwd":
        args += [torch.zeros(1, 2, 3, 128, 3, device="meta")]
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(sg_render, fn)(*args)


def test_library_name_hashes_the_shared_header(tmp_path, monkeypatch):
    """A changed csrc/*.cuh header renames (so rebuilds) every library."""
    from inverserenderingofindoorscene_torch.ops import build

    for src in build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    assert all((tmp_path / f"{n}.cu").exists() for n in build.SOURCES)
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {n: build.library_path(n) for n in build.SOURCES}
    header = tmp_path / "sg_common.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: build.library_path(n) for n in build.SOURCES}
    assert all(before[n] != after[n] for n in build.SOURCES)
