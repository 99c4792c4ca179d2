"""The render backward kernel's per-pixel arithmetic on the CPU.

``render_sg_bwd_kernel`` (csrc/sg_render.cu) runs ``render_sg_bwd_pixel``
(csrc/sg_render_bwd.cuh) on one thread per pixel; everything but its
shared-memory staging and its stores is that function.  Here g++ builds
the same header, with the CUDA qualifiers mapped to plain C++, into a small
library that loops it over pixels with the kernel's lobe layout, bound with
ctypes as ``ops/build.py`` binds the kernels (no torch headers, a few
seconds to build).  It is held against the plain adjoint
``render_sg_bwd_plain`` and against jax.vjp of the Pallas ``render_sg``
(interpret mode) on the same numpy inputs, at the tolerances of
tests/test_torch_sg_render.py: relative L2 5e-3 for the normal and rough
gradients, the JAX kernel tests' scaled rule for the rest.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from inverserenderingofindoorscene_tpu.ops import sg_render as jsg_render
from inverserenderingofindoorscene_torch.ops import build, sg_render
from test_torch_sg_render import GRAD_NAMES, assert_grads_close, make_inputs

# the per-pixel function over pixels: the kernel's staging (lobe rows
# [field][k], fields axis x, y, z | lamb | weight r, g, b) and stores, one
# pixel at a time, with the kernel's C signature less the stream
HOST_LOOP = r"""
#include <vector>

#include "sg_render_bwd.cuh"

using namespace sgk;

extern "C" int render_sg_bwd_host(
    const float* albedo, const float* normal, const float* rough,
    const float* axis, const float* lamb, const float* weight,
    const float* view, const float* dirs, const float* grad_diffuse,
    const float* grad_specular, float* d_albedo, float* d_normal,
    float* d_rough, float* d_axis, float* d_lamb, float* d_weight,
    long long n_pix, int hw, int k_num, int d_num, float f0) {
  std::vector<float> lobe_rows(7 * k_num), grad_rows(7 * k_num);
  const LobeRows lobes{lobe_rows.data(), k_num, 1};
  const LobeRows grads{grad_rows.data(), k_num, 1};
  const float4* d4 = reinterpret_cast<const float4*>(dirs);
  for (long long p = 0; p < n_pix; ++p) {
    for (int k = 0; k < k_num; ++k) {
      for (int i = 0; i < 3; ++i) {
        lobes.at(i, k) = axis[(p * k_num + k) * 3 + i];
        lobes.at(4 + i, k) = weight[(p * k_num + k) * 3 + i];
      }
      lobes.at(3, k) = lamb[p * k_num + k];
    }
    const long long q = 3 * (p % hw);
    PixelIn in;
    for (int ch = 0; ch < 3; ++ch) {
      in.normal[ch] = normal[3 * p + ch];
      in.view[ch] = view[q + ch];
      in.albedo[ch] = albedo[3 * p + ch];
      in.gd[ch] = grad_diffuse[3 * p + ch];
      in.gs[ch] = grad_specular[3 * p + ch];
    }
    in.rough = rough[p];
    const PixelGrad g = render_sg_bwd_pixel(in, d4, d_num, f0, lobes, grads);
    for (int ch = 0; ch < 3; ++ch) {
      d_albedo[3 * p + ch] = g.albedo[ch];
      d_normal[3 * p + ch] = g.normal[ch];
    }
    d_rough[p] = g.rough;
    for (int k = 0; k < k_num; ++k) {
      for (int i = 0; i < 3; ++i) {
        d_axis[(p * k_num + k) * 3 + i] = grads.at(i, k);
        d_weight[(p * k_num + k) * 3 + i] = grads.at(4 + i, k);
      }
      d_lamb[p * k_num + k] = grads.at(3, k);
    }
  }
  return 0;
}
"""

CASES = {  # (b, h, w, k): ragged against any block size, K != 12, K = 12
    "1x10x13 K=4": (1, 10, 13, 4),
    "2x6x7 K=5": (2, 6, 7, 5),
    "1x16x24 K=12": (1, 16, 24, 12),
}
ENV_HW = (8, 16)  # D = 128
FOV, F0 = 57.0, 0.05


def build_host(tmp_path_factory, name, code, argtypes):
    """Compile ``code`` (which includes csrc headers) with g++ into a
    shared library and return its C function ``name`` with ``argtypes``;
    skip without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp(name)
    src, lib = out / f"{name}.cpp", out / f"{name}.so"
    src.write_text(code)
    done = subprocess.run(
        [gxx, "-O2", "-shared", "-fPIC", "-std=c++17", "-I", str(build.CSRC),
         "-o", str(lib), str(src)],
        capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    fn = getattr(ctypes.CDLL(str(lib)), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


@pytest.fixture(scope="module")
def render_sg_bwd_host(tmp_path_factory):
    """The per-pixel backward built with g++, as a ctypes function."""
    p, i = ctypes.c_void_p, ctypes.c_int
    return build_host(tmp_path_factory, "render_sg_bwd_host", HOST_LOOP,
                      [p] * 16 + [ctypes.c_longlong, i, i, i, ctypes.c_float])


def host_grads(fn, args, cot):
    """The six gradients from the g++ build, on the kernel's constants."""
    b, h, w = args[0].shape[:3]
    k = args[4].shape[-1]
    view = sg_render._view(h, w, FOV, torch.device("cpu")).numpy()
    dirs = sg_render._dir_consts(*ENV_HW, torch.device("cpu")).numpy()
    ins = [np.ascontiguousarray(x) for x in (*args[:6], view, dirs, *cot)]
    grads = [np.empty_like(x) for x in args[:6]]
    err = fn(*(x.ctypes.data for x in ins), *(g.ctypes.data for g in grads),
             b * h * w, h * w, k, ENV_HW[0] * ENV_HW[1], F0)
    assert err == 0
    return grads


@pytest.mark.parametrize("reference", ["plain adjoint", "pallas vjp"])
@pytest.mark.parametrize("case", list(CASES))
def test_render_sg_bwd_pixel_matches(render_sg_bwd_host, case, reference):
    b, h, w, k = CASES[case]
    args = make_inputs(b=b, h=h, w=w, k=k, seed=9)
    rng = np.random.RandomState(10)
    cot = [rng.randn(b, h, w, 3).astype(np.float32) for _ in range(2)]
    got = host_grads(render_sg_bwd_host, args, cot)
    for g in got:
        assert np.isfinite(g).all()
    if reference == "plain adjoint":
        want = [x.numpy() for x in sg_render.render_sg_bwd_plain(
            *map(torch.from_numpy, args), *map(torch.from_numpy, cot),
            fov_deg=FOV, f0=F0, env_height=ENV_HW[0], env_width=ENV_HW[1])]
    else:
        _, vjp = jax.vjp(
            lambda *a: jsg_render.render_sg(*a, fov_deg=FOV, f0=F0,
                                            interpret=True),
            *map(jnp.asarray, args))
        want = vjp(tuple(map(jnp.asarray, cot)))
    assert_grads_close(got, want, GRAD_NAMES)
