"""The shading walk's lane arithmetic on the CPU.

``sg_render_walk_kernel`` (csrc/sg_render_env.cu) runs one warp per pixel,
each warp walking its own pixels (``warp_pixel``): every 32 pixels lane
l computes the frame of the warp's l-th next pixel (``frame_slot``), the
lanes turn a pixel's arrived inputs into 8-float lobe records
(``build_records``), then each lane walks the lobes over its four
directions of a 128-direction pass (``env_lane_mix``) and shades them
(``env_lane_shade``), and a shuffle reduction sums the lanes.  All of that
but the copies, the shuffles and the stores is csrc/sg_render_env.cuh.
The serving kernel ``render_sg_env`` is the walk that stores the envmap
with ``expf``; the training forward ``render_sg_fwd`` is the walk without
the stores, with ``exp2f`` (``lobe_exp2``); the envmap forward
``sg_envmap_fwd`` is the walk without the shading, with ``exp2f``.
Here g++ builds the header into a small library that runs the same
functions warp by warp and lane by lane, on a few warps so that the frame
batches roll over, with the butterfly written out in the same order,
bound with ctypes.  It is held
against the plain version ``render_sg_env_plain`` and the Pallas
``render_sg_env`` (interpret mode) on the same numpy inputs, at the
tolerances of tests/test_torch_sg_render.py::test_render_sg_env_matches_jax:
diffuse atol 2e-5, specular atol 5e-4, envmap rtol 2e-5 / atol 1e-5.  The
walk without the stores is held against ``render_sg_plain`` and the Pallas
``render_sg`` (the TPU kernel it replaces) at the same diffuse and
specular tolerances, gives the diffuse and specular of the storing walk
with the same exponential bit for bit (that walk is built here only for
the comparison), and leaves the envmap buffer untouched.  The walk
without the shading is held against ``sg_envmap_plain`` and the Pallas
``sg_envmap`` (the TPU kernel it replaces) at the envmap tolerance, and
gives the storing walk's envmap with the same exponential bit for bit.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inverserenderingofindoorscene_tpu.ops import sg_render as jsg_render
from inverserenderingofindoorscene_torch.ops import sg_render
from test_torch_sg_render import (
    assert_close_naming_side,
    assert_outputs_close,
    make_inputs,
    oracle_outputs,
)
from test_torch_sg_render_host import build_host

# the kernel's warps and lanes one after another, with the kernel's C
# signature less the stream, plus the number of warps and two flags (the
# card builds the storing walk with expf and the other with exp2f; the
# storing walk with exp2f is built here only, for the comparisons); then
# the walk without the shading (sg_envmap_fwd, exp2f)
HOST_LOOP = r"""
#include <algorithm>
#include <vector>

#include "sg_render_env.cuh"

using namespace sgk;

template <bool kStoreEnv, bool kExp2>
void walk(
    const float* albedo, const float* normal, const float* rough,
    const float* axis, const float* lamb, const float* weight,
    const float* view, const float* dirs, float* diffuse, float* specular,
    float* env, long long n_pix, int hw, int k_num, int d_num, float f0,
    int n_warps) {
  // float4 storage: the kernel's shared-memory buffers are 16-byte aligned
  std::vector<float4> raw4(Raw::floats(k_num) / 4);
  std::vector<float4> rec4(k_num * kRecord / 4);
  std::vector<float4> frames4(kWarp * kFrameFloats / 4);
  float* raw = reinterpret_cast<float*>(raw4.data());
  float* rec = reinterpret_cast<float*>(rec4.data());
  float* frames = reinterpret_cast<float*>(frames4.data());
  const float4* d4 = reinterpret_cast<const float4*>(dirs);
  for (int w = 0; w < n_warps; ++w) {
    for (int j = 0, p = w; p < n_pix; ++j, p += n_warps) {
      if (j % kWarp == 0) {  // lane l: the frame of the warp's pixel j + l
        for (int lane = 0; lane < kWarp; ++lane) {
          const int q = warp_pixel(w, j + lane, n_warps);
          if (q < n_pix) {
            frame_slot(albedo, normal, rough, view, q, hw,
                       frames + kFrameFloats * lane);
          }
        }
      }
      std::copy(axis + p * 3 * k_num, axis + (p + 1) * 3 * k_num, raw);
      std::copy(lamb + p * k_num, lamb + (p + 1) * k_num,
                raw + Raw::lamb(k_num));
      std::copy(weight + p * 3 * k_num, weight + (p + 1) * 3 * k_num,
                raw + Raw::weight(k_num));
      for (int lane = 0; lane < kWarp; ++lane) {
        build_records<kExp2>(rec, raw, k_num, lane, kWarp);
      }
      const float* slot = frames + kFrameFloats * (j % kWarp);
      const Frame f = load_frame(slot);
      float sum[kWarp][6] = {};
      for (int c0 = 0; c0 < d_num; c0 += kPassDirs) {
        for (int lane = 0; lane < kWarp; ++lane) {
          float4 c[kDirsPerLane];
          float mix[kDirsPerLane][3];
          // the pixel's envmap, as the storing kernel passes it; the walk
          // without the stores must leave it as it is
          env_lane_mix<kStoreEnv, kExp2>(rec, k_num, d4, d_num, c0, lane, c,
                                         mix, env + p * 3 * d_num + 3 * c0);
          env_lane_shade(f, c, mix, f0, sum[lane]);
        }
      }
      // the xor butterfly, lane l adding lane l ^ o: warp_sum's sums, and
      // bit for bit the reduce-scatter's
      for (int o = kWarp / 2; o > 0; o >>= 1) {
        float next[kWarp][6];
        for (int l = 0; l < kWarp; ++l) {
          for (int i = 0; i < 6; ++i) next[l][i] = sum[l][i] + sum[l ^ o][i];
        }
        std::copy(&next[0][0], &next[0][0] + kWarp * 6, &sum[0][0]);
      }
      for (int ch = 0; ch < 3; ++ch) {
        diffuse[3 * p + ch] = slot[8 + ch] * sum[0][ch];
        specular[3 * p + ch] = sum[0][3 + ch];
      }
    }
  }
}

extern "C" int render_sg_env_host(
    const float* albedo, const float* normal, const float* rough,
    const float* axis, const float* lamb, const float* weight,
    const float* view, const float* dirs, float* diffuse, float* specular,
    float* env, long long n_pix, int hw, int k_num, int d_num, float f0,
    int n_warps, int store_env, int use_exp2) {
  // render_sg_env, the same storing walk with exp2f, and render_sg_fwd
  auto fn = store_env ? (use_exp2 ? walk<true, true> : walk<true, false>)
                      : walk<false, true>;
  fn(albedo, normal, rough, axis, lamb, weight, view, dirs, diffuse, specular,
     env, n_pix, hw, k_num, d_num, f0, n_warps);
  return 0;
}

extern "C" int sg_envmap_fwd_host(const float* axis, const float* lamb,
                                  const float* weight, const float* dirs,
                                  float* env, long long n_pix, int k_num,
                                  int d_num, int n_warps) {
  std::vector<float4> raw4(Raw::floats(k_num) / 4);
  std::vector<float4> rec4(k_num * kRecord / 4);
  float* raw = reinterpret_cast<float*>(raw4.data());
  float* rec = reinterpret_cast<float*>(rec4.data());
  const float4* d4 = reinterpret_cast<const float4*>(dirs);
  for (int w = 0; w < n_warps; ++w) {
    for (int p = w; p < n_pix; p += n_warps) {
      std::copy(axis + p * 3 * k_num, axis + (p + 1) * 3 * k_num, raw);
      std::copy(lamb + p * k_num, lamb + (p + 1) * k_num,
                raw + Raw::lamb(k_num));
      std::copy(weight + p * 3 * k_num, weight + (p + 1) * 3 * k_num,
                raw + Raw::weight(k_num));
      for (int lane = 0; lane < kWarp; ++lane) {
        build_records<true>(rec, raw, k_num, lane, kWarp);
      }
      for (int c0 = 0; c0 < d_num; c0 += kPassDirs) {
        for (int lane = 0; lane < kWarp; ++lane) {
          float4 c[kDirsPerLane];
          float mix[kDirsPerLane][3];
          env_lane_mix<true, true>(rec, k_num, d4, d_num, c0, lane, c, mix,
                                   env + p * 3 * d_num + 3 * c0);
        }
      }
    }
  }
  return 0;
}
"""

# (b, h, w, k, env_height, env_width, warps): 130 pixels on 3 warps take
# a second batch of frames at a warp's pixel 32 and leave the warps one
# pixel apart; 84 on 100 leave warps without a pixel
CASES = {
    "10x13 K=4 D=128": (1, 10, 13, 4, 8, 16, 3),
    "10x13 K=12 D=128": (1, 10, 13, 12, 8, 16, 3),
    "10x13 K=4 D=60": (1, 10, 13, 4, 6, 10, 3),
    "10x13 K=12 D=60": (1, 10, 13, 12, 6, 10, 3),
    "2x6x7 K=5 D=200": (2, 6, 7, 5, 10, 20, 100),  # two passes, a tail of 72
}
# the envmap walk also at a D that is not a multiple of 4 (any D runs)
ENVMAP_CASES = {**CASES, "10x13 K=12 D=35": (1, 10, 13, 12, 5, 7, 3)}
FOV, F0 = 57.0, 0.05


@pytest.fixture(scope="module")
def render_sg_env_host(tmp_path_factory):
    """The kernel's lane arithmetic built with g++, as a ctypes function."""
    p, i = ctypes.c_void_p, ctypes.c_int
    return build_host(tmp_path_factory, "render_sg_env_host", HOST_LOOP,
                      [p] * 11 + [ctypes.c_longlong, i, i, i, ctypes.c_float,
                                  i, i, i])


@pytest.fixture(scope="module")
def sg_envmap_fwd_host(tmp_path_factory):
    """The walk without the shading built with g++, as a ctypes function."""
    p, i = ctypes.c_void_p, ctypes.c_int
    return build_host(tmp_path_factory, "sg_envmap_fwd_host", HOST_LOOP,
                      [p] * 5 + [ctypes.c_longlong, i, i, i])


def host_outputs(fn, args, env_hw, n_warps, store_env=True, exp2=False):
    """diffuse, specular, env from the g++ build, on the kernel's
    constants, with the pixels walked by ``n_warps`` warps; env starts as
    NaN.  ``exp2`` applies to the storing walk; the other takes exp2f."""
    b, h, w = args[0].shape[:3]
    k = args[4].shape[-1]
    d = env_hw[0] * env_hw[1]
    cpu = torch.device("cpu")
    view = sg_render._view(h, w, FOV, cpu).numpy()
    dirs = sg_render._dir_consts(*env_hw, cpu).numpy()
    ins = [np.ascontiguousarray(x) for x in (*args, view, dirs)]
    outs = [np.full((b, h, w, 3), np.nan, np.float32),
            np.full((b, h, w, 3), np.nan, np.float32),
            np.full((b, h, w, d, 3), np.nan, np.float32)]
    err = fn(*(x.ctypes.data for x in ins), *(o.ctypes.data for o in outs),
             b * h * w, h * w, k, d, F0, n_warps, store_env, exp2)
    assert err == 0
    return outs


@pytest.mark.parametrize("reference", ["plain", "pallas"])
@pytest.mark.parametrize("case", list(CASES))
def test_render_sg_env_lanes_match(render_sg_env_host, case, reference):
    b, h, w, k, eh, ew, n_warps = CASES[case]
    args = make_inputs(b=b, h=h, w=w, k=k, seed=11)
    got = host_outputs(render_sg_env_host, args, (eh, ew), n_warps)
    for x in got:  # every output element written, none NaN
        assert np.isfinite(x).all()
    if reference == "plain":
        want = [x.numpy() for x in sg_render.render_sg_env_plain(
            *map(torch.from_numpy, args), fov_deg=FOV, f0=F0, env_height=eh,
            env_width=ew)]
    else:
        want = jsg_render.render_sg_env(
            *map(jnp.asarray, args), fov_deg=FOV, f0=F0, env_height=eh,
            env_width=ew, interpret=True)
    assert_close_naming_side(
        assert_outputs_close, got, [np.asarray(x) for x in want],
        oracle_outputs(args, FOV, F0, eh, ew), ("diffuse", "specular", "env"))


@pytest.mark.parametrize("reference", ["plain", "pallas"])
@pytest.mark.parametrize("case", list(CASES))
def test_render_sg_fwd_walk_matches(render_sg_env_host, case, reference):
    """The walk without the envmap stores (``render_sg_fwd``)."""
    b, h, w, k, eh, ew, n_warps = CASES[case]
    args = make_inputs(b=b, h=h, w=w, k=k, seed=12)
    d, s, env = host_outputs(render_sg_env_host, args, (eh, ew), n_warps,
                             store_env=False)
    assert np.isnan(env).all()  # the envmap buffer untouched
    stored = host_outputs(render_sg_env_host, args, (eh, ew), n_warps,
                          exp2=True)
    np.testing.assert_array_equal(d, stored[0])
    np.testing.assert_array_equal(s, stored[1])
    if reference == "plain":
        want = [x.numpy() for x in sg_render.render_sg_plain(
            *map(torch.from_numpy, args), fov_deg=FOV, f0=F0, env_height=eh,
            env_width=ew)]
    else:
        want = jsg_render.render_sg(
            *map(jnp.asarray, args), fov_deg=FOV, f0=F0, env_height=eh,
            env_width=ew, interpret=True)
    np.testing.assert_allclose(d, np.asarray(want[0]), atol=2e-5,
                               err_msg="diffuse")
    np.testing.assert_allclose(s, np.asarray(want[1]), atol=5e-4,
                               err_msg="specular")


@pytest.mark.parametrize("reference", ["plain", "pallas"])
@pytest.mark.parametrize("case", list(ENVMAP_CASES))
def test_sg_envmap_fwd_walk_matches(render_sg_env_host, sg_envmap_fwd_host,
                                    case, reference):
    """The walk without the shading (``sg_envmap_fwd``); env starts as
    NaN, so every element must be written."""
    b, h, w, k, eh, ew, n_warps = ENVMAP_CASES[case]
    args = make_inputs(b=b, h=h, w=w, k=k, seed=13)
    lobes = [np.ascontiguousarray(x) for x in args[3:]]
    d = eh * ew
    dirs = sg_render._dir_consts(eh, ew, torch.device("cpu")).numpy()
    env = np.full((b, h, w, d, 3), np.nan, np.float32)
    err = sg_envmap_fwd_host(*(x.ctypes.data for x in lobes),
                             dirs.ctypes.data, env.ctypes.data, b * h * w,
                             k, d, n_warps)
    assert err == 0
    assert np.isfinite(env).all()
    stored = host_outputs(render_sg_env_host, args, (eh, ew), n_warps,
                          exp2=True)
    np.testing.assert_array_equal(env, stored[2])
    if reference == "plain":
        want = sg_render.sg_envmap_plain(*map(torch.from_numpy, lobes),
                                         env_height=eh, env_width=ew).numpy()
    else:
        want = jsg_render.sg_envmap(*map(jnp.asarray, lobes), env_height=eh,
                                    env_width=ew, interpret=True)
    np.testing.assert_allclose(env, np.asarray(want), rtol=2e-5, atol=1e-5,
                               err_msg="env")
