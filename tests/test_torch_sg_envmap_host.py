"""The envmap backward kernel's thread arithmetic on the CPU.

``sg_envmap_bwd_kernel`` (csrc/sg_envmap.cu) runs one thread a few lobes
of one pixel (``bwd_pixel_threads(K)`` threads a pixel): each block walks
its groups of ``bwd_group_pixels(K)`` pixels and each group's chunks of up
to ``kBwdChunk`` directions as a sequence of stages, staged with cp.async
into padded per-pixel slots; every thread adds its lobes' seven sums over
a stage's directions (``lobe_chunk``) and stores its own gradients
(``store_lobe_grads``).  All of that but the
copies and the barriers is csrc/sg_envmap_bwd.cuh.  Here g++ builds the
header into a small library that runs the kernel's walk block by block,
stage by stage and thread by thread on a few blocks, with every staged
float the kernel does not write set to NaN, bound with ctypes.  It is held
against the plain adjoint ``sg_envmap_bwd_plain`` and jax.vjp of the
Pallas ``sg_envmap`` (interpret mode) on the same numpy inputs, at the
tolerance of tests/test_torch_sg_render.py::test_sg_envmap_matches_jax:
atol 2e-3 after dividing by max(max|g|, 1).
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inverserenderingofindoorscene_tpu.ops import sg_render as jsg_render
from inverserenderingofindoorscene_torch.ops import sg_render
from test_torch_sg_render import GRAD_NAMES, assert_grads_close, make_inputs
from test_torch_sg_render_host import build_host

# the kernel's blocks, stages and threads one after another, with the
# kernel's C signature less the stream, plus the number of blocks
HOST_LOOP = r"""
#include <algorithm>
#include <cmath>
#include <vector>

#include "sg_envmap_bwd.cuh"

using namespace sgk;

extern "C" int sg_envmap_bwd_host(
    const float* axis, const float* lamb, const float* weight,
    const float* dirs, const float* g_env, float* d_axis, float* d_lamb,
    float* d_weight, long long n_pix_ll, int k_num, int d_num, int n_blocks) {
  const int n_pix = (int)n_pix_ll;
  const int group = bwd_group_pixels(k_num);
  const int per_px = bwd_pixel_threads(k_num), threads = group * per_px;
  const int chunk = std::min(kBwdChunk, round4(d_num));
  const int n_chunks = (d_num + kBwdChunk - 1) / kBwdChunk;
  const int n_groups = (n_pix + group - 1) / group;
  // one stage, 16-byte aligned as the kernel's shared memory
  std::vector<float4> stage4(BwdStage::floats(chunk, group) / 4);
  float* stage = reinterpret_cast<float*>(stage4.data());
  std::vector<ThreadLobes> lobes(threads);
  for (int b = 0; b < n_blocks; ++b) {
    for (int grp = b; grp < n_groups; grp += n_blocks) {
      const int n_px = std::min(group, n_pix - grp * group);
      for (int t = 0; t < threads; ++t) {  // pixel t / S, its thread t % S
        lobes[t] = t / per_px < n_px
                       ? load_lobes(axis, lamb, weight,
                                    grp * group + t / per_px, t % per_px,
                                    k_num)
                       : ThreadLobes{};
      }
      for (int ch = 0; ch < n_chunks; ++ch) {
        const int c0 = ch * kBwdChunk, n = std::min(kBwdChunk, d_num - c0);
        // the copies; what they do not write is NaN
        std::fill(stage, stage + BwdStage::floats(chunk, group), NAN);
        std::copy(dirs + 4 * c0, dirs + 4 * (c0 + n), stage);
        for (int px = 0; px < n_px; ++px) {
          const float* src = g_env + ((long long)(grp * group + px) * d_num
                                      + c0) * 3;
          std::copy(src, src + 3 * n, stage + BwdStage::slot(chunk, px));
        }
        for (int t = 0; t < threads; ++t) {
          stage_tail(stage, chunk, n, n_px, t, threads);
        }
        for (int t = 0; t < threads; ++t) {
          if (t / per_px < n_px) {
            lobe_chunk(lobes[t], reinterpret_cast<const float4*>(stage),
                       stage + BwdStage::slot(chunk, t / per_px),
                       round4(n) / 4);
          }
        }
      }
      for (int t = 0; t < threads; ++t) {
        if (t / per_px < n_px) {
          store_lobe_grads(lobes[t], grp * group + t / per_px, t % per_px,
                           k_num, d_axis, d_lamb, d_weight);
        }
      }
    }
  }
  return 0;
}
"""

# (b, h, w, k, env_height, env_width, blocks): 130 pixels are 8 groups of
# 16 and a partial one of 2 at K=12, K=5 (whose last thread a pixel has a
# lobe past K), K=4 and K=3 (one thread a pixel); D=200 takes three chunks
# of 64 and one of 8; D=35 ends in a partial quad of directions; K=64 makes
# smaller groups
CASES = {
    "10x13 K=3 D=128": (1, 10, 13, 3, 8, 16, 3),
    "10x13 K=4 D=128": (1, 10, 13, 4, 8, 16, 2),
    "2x6x7 K=12 D=35": (2, 6, 7, 12, 5, 7, 4),
    "1x5x7 K=64 D=200": (1, 5, 7, 64, 10, 20, 2),
    "10x13 K=12 D=128": (1, 10, 13, 12, 8, 16, 3),
    "10x13 K=5 D=128": (1, 10, 13, 5, 8, 16, 3),
    "10x13 K=12 D=60": (1, 10, 13, 12, 6, 10, 2),
    "10x13 K=5 D=60": (1, 10, 13, 5, 6, 10, 4),
    "10x13 K=12 D=200": (1, 10, 13, 12, 10, 20, 3),
    "2x6x7 K=5 D=200": (2, 6, 7, 5, 10, 20, 2),
    "10x13 K=12 D=35": (1, 10, 13, 12, 5, 7, 3),
    "1x5x7 K=64 D=128": (1, 5, 7, 64, 8, 16, 3),
}


@pytest.fixture(scope="module")
def sg_envmap_bwd_host(tmp_path_factory):
    """The kernel's thread arithmetic built with g++, as a ctypes
    function."""
    p, i = ctypes.c_void_p, ctypes.c_int
    return build_host(tmp_path_factory, "sg_envmap_bwd_host", HOST_LOOP,
                      [p] * 8 + [ctypes.c_longlong, i, i, i])


def host_grads(fn, lobes, g_env, env_hw, n_blocks):
    """d_axis, d_lamb, d_weight from the g++ build, on the kernel's
    direction table."""
    b, h, w, k = lobes[1].shape
    dirs = sg_render._dir_consts(*env_hw, torch.device("cpu")).numpy()
    ins = [np.ascontiguousarray(x) for x in (*lobes, dirs, g_env)]
    grads = [np.full_like(x, np.nan) for x in lobes]
    err = fn(*(x.ctypes.data for x in ins), *(g.ctypes.data for g in grads),
             b * h * w, k, env_hw[0] * env_hw[1], n_blocks)
    assert err == 0
    return grads


@pytest.mark.parametrize("reference", ["plain adjoint", "pallas vjp"])
@pytest.mark.parametrize("case", list(CASES))
def test_sg_envmap_bwd_threads_match(sg_envmap_bwd_host, case, reference):
    b, h, w, k, eh, ew, n_blocks = CASES[case]
    lobes = make_inputs(b=b, h=h, w=w, k=k, seed=13)[3:]
    g_env = np.random.RandomState(14).randn(b, h, w, eh * ew, 3).astype(
        np.float32)
    got = host_grads(sg_envmap_bwd_host, lobes, g_env, (eh, ew), n_blocks)
    for g in got:  # every gradient written, none NaN
        assert np.isfinite(g).all()
    if reference == "plain adjoint":
        want = [x.numpy() for x in sg_render.sg_envmap_bwd_plain(
            *map(torch.from_numpy, lobes), torch.from_numpy(g_env),
            env_height=eh, env_width=ew)]
    else:
        _, vjp = jax.vjp(
            lambda *a: jsg_render.sg_envmap(*a, env_height=eh, env_width=ew,
                                            interpret=True),
            *map(jnp.asarray, lobes))
        want = vjp(jnp.asarray(g_env))
    assert_grads_close(got, want, GRAD_NAMES[3:])
