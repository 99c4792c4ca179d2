"""``pipeline/inference.load_real_image`` and
``InverseRenderer.render_file`` against the JAX package's on the CPU:
the photo's read, aspect-preserving resize and fov bit for bit (both
packages call the same OpenCV functions), and the chain on a photo from
disk, level 2 with lighting on both cascades, on JAX-initialised weights
carried into the port by ``utils/weights.py``, at the serving chain's
tolerances (ROADMAP C3: tests/test_torch_inference.py).  Sizes are those
of tests/test_cli_smoke.py (64x64, lighting grid 32x32).
"""

import numpy as np
import pytest
import torch

import jax

from inverserenderingofindoorscene_torch.pipeline.brdf import BRDFNets
from inverserenderingofindoorscene_torch.pipeline.inference import (
    InverseRenderer,
    load_real_image,
)
from inverserenderingofindoorscene_torch.pipeline.light import LightNets
from inverserenderingofindoorscene_torch.utils import weights

IM_HW = (64, 64)
ENV_RC = (32, 32)


@pytest.fixture
def work(tmp_path):
    pytest.importorskip("cv2")
    return tmp_path


@pytest.mark.parametrize("hw,im_hw,env_rc", [
    ((80, 128), IM_HW, ENV_RC),      # landscape, shrunk
    ((120, 90), (240, 320), (120, 160)),  # portrait, enlarged
    ((64, 64), IM_HW, ENV_RC),       # square
])
def test_load_real_image_matches_jax(work, hw, im_hw, env_rc):
    """The same PNG through both packages' ``load_real_image``: the
    resized images, the fov and the original photo, bit for bit (cv2's
    INTER_AREA where it enlarges, INTER_LINEAR where it shrinks)."""
    import cv2

    from inverserenderingofindoorscene_tpu.pipeline.inference import (
        load_real_image as jload,
    )

    path = str(work / "photo.png")
    rng = np.random.RandomState(hw[0])
    cv2.imwrite(path, (rng.rand(*hw, 3) * 255).astype(np.uint8))
    got = load_real_image(path, im_hw, env_rc, return_original=True)
    want = jload(path, im_hw, env_rc, return_original=True)
    assert got[2] == want[2]
    for g, w in zip(got[:2] + got[3:], want[:2] + want[3:]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_render_file_matches_jax(work):
    """``render_file`` on a photo against the JAX ``render_file``, level
    2 with lighting on both cascades, on JAX-initialised weights carried
    into the port by ``utils/weights.py``."""
    from inverserenderingofindoorscene_tpu.pipeline.brdf import (
        BRDFNets as JBRDF,
    )
    from inverserenderingofindoorscene_tpu.pipeline.inference import (
        InverseRenderer as JRenderer,
    )
    from inverserenderingofindoorscene_tpu.pipeline.light import (
        LightNets as JLight,
    )

    rng = jax.random.PRNGKey(8)
    jax_stacks, port_stacks = [], []
    for lvl in range(2):
        k1, k2, rng = jax.random.split(rng, 3)
        jb = JBRDF(cascade_level=lvl)
        jl = JLight(cascade_level=lvl, env_rows=ENV_RC[0],
                    env_cols=ENV_RC[1])
        bp, lp = jb.init(k1, IM_HW), jl.init(k2)
        jax_stacks.append((jb, bp, jl, lp))
        brdf = BRDFNets(lvl, generator=torch.Generator().manual_seed(0))
        brdf.load_state_dict(weights.brdf_state_dict(bp))
        light = LightNets(cascade_level=lvl, env_rows=ENV_RC[0],
                          env_cols=ENV_RC[1],
                          generator=torch.Generator().manual_seed(0))
        light.load_state_dict(weights.light_state_dict(lp))
        port_stacks.append((brdf, light))

    import cv2

    path = str(work / "square.png")
    cv2.imwrite(path, (np.random.RandomState(1).rand(64, 64, 3) * 255)
                .astype(np.uint8))
    want = JRenderer(jax_stacks, is_light=True).render_file(
        path, IM_HW, ENV_RC)
    renderer = InverseRenderer(port_stacks, is_light=True, device="cpu")
    renderer.render_file(path, IM_HW, ENV_RC)  # C12: warm every shape
    got = renderer.render_file(path, IM_HW, ENV_RC)
    for lvl in range(2):
        for k in ("albedo", "normal", "rough", "depth"):
            np.testing.assert_allclose(
                got["preds"][lvl][k].numpy(),
                np.asarray(want["preds"][lvl][k]), atol=1e-4, err_msg=k)
        g, w = got["lights"][lvl], want["lights"][lvl]
        np.testing.assert_allclose([g["c_albedo"], g["c_light"]],
                                   [float(np.asarray(w["c_albedo"])),
                                    float(np.asarray(w["c_light"]))],
                                   rtol=2e-4)
        for k in ("env_img", "diffuse", "specular"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       rtol=1e-3, atol=1e-5, err_msg=k)
