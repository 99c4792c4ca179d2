"""The port's cascade hand-off vs the JAX package's: the exported products,
the ``.h5`` files written from them, and the previous-cascade maps read
back.

Shared weights: the port's seeded cascade-0 modules, carried into flax by
the JAX package's own converter (``utils/torch_import.py``); image 64x64,
lighting grid 32x32, B=2, as in tests/test_torch_train.py.  JAX's
``export_step`` runs its plain route (as the JAX exporter does); the
port's on both routes (on CPU tensors the kernel route runs the plain
versions).

Tolerances, each measured here and stated with its test:
  * the BRDF products: atol 1e-4, as ``brdf_step`` at cascade 0
    (test_torch_train.py); ``env`` (the SG tensor, values in [0, 1]) atol
    1e-4 (3.4e-5 measured); diffuse and specular rtol 1e-3 / atol 1e-5,
    the serving chain's tolerance (2.3e-4 measured, specular; diffuse
    1.1e-5); the losses rtol 5e-5, as the light step.  The fixture runs
    one export before the compared ones: torch's oneDNN convolutions on
    the CPU (torch 2.13, several threads) sometimes give another result
    on the first call at a shape in a process (~5e-5 in a decoder's
    output, in 3 of 6 processes; bit-equal from the second call on, and
    always with one thread or oneDNN off; ROADMAP C12), and the
    random-weight light nets amplify that to 1.7e-3 in diffuse;
  * the files: byte for byte (h5py writes the same bytes for the same
    LZF dataset);
  * the maps read back: bit-equal to the JAX loader's (the same numpy
    arithmetic on the same arrays).
"""

import filecmp
import os

import numpy as np
import pytest
import torch

import jax

from inverserenderingofindoorscene_tpu.data.openrooms import OpenRoomsDataset
from inverserenderingofindoorscene_tpu.data.synthetic import (
    synthetic_batch as jsynthetic_batch,
)
from inverserenderingofindoorscene_tpu.pipeline import export as jexport
from inverserenderingofindoorscene_tpu.pipeline.brdf import BRDFNets as JBRDF
from inverserenderingofindoorscene_tpu.pipeline.light import LightNets as JLight
from inverserenderingofindoorscene_tpu.utils import io as jio
from inverserenderingofindoorscene_tpu.utils import torch_import
from inverserenderingofindoorscene_torch.data import openrooms
from inverserenderingofindoorscene_torch.data.synthetic import synthetic_batch
from inverserenderingofindoorscene_torch.pipeline.brdf import (
    BRDFNets,
    brdf_step,
)
from inverserenderingofindoorscene_torch.pipeline.export import (
    _STEMS,
    export_step,
    write_products,
)
from inverserenderingofindoorscene_torch.pipeline.light import LightNets
from inverserenderingofindoorscene_torch.utils import io

IM_HW = (64, 64)
ENV_RC = (32, 32)
ROUTES = {"kernels": True, "plain": False}
PRODUCTS = ("albedo", "normal", "rough", "depth", "diffuse", "specular",
            "env")


def sub_state(module, name):
    return {k: v.numpy() for k, v in getattr(module, name).state_dict().items()}


@pytest.fixture(scope="module")
def exports():
    """The port's products and losses on each route, and JAX's."""
    gen = torch.Generator().manual_seed(40)
    brdf = BRDFNets(0, generator=gen)
    light = LightNets(env_rows=ENV_RC[0], env_cols=ENV_RC[1], generator=gen)
    bp = torch_import.brdf_params_from_torch(*(
        sub_state(brdf, n)
        for n in ("encoder", "albedo", "normal", "rough", "depth")))
    lp = torch_import.light_params_from_torch(
        *(sub_state(light, n) for n in ("encoder", "axis", "lamb", "weight")))
    kw = dict(batch=2, im_hw=IM_HW, env_rc=ENV_RC, seed=6)
    jnets = (JBRDF(cascade_level=0),
             JLight(cascade_level=0, env_rows=ENV_RC[0], env_cols=ENV_RC[1]))
    want = jax.jit(lambda bp, lp, b: jexport.export_step(*jnets, bp, lp, b))(
        bp, lp, jsynthetic_batch(**kw))
    want = jax.tree.map(np.asarray, want)
    tbatch = synthetic_batch(device="cpu", **kw)
    export_step(brdf, light, tbatch)  # oneDNN's first call (docstring)
    got = {route: export_step(brdf, light, tbatch, use_kernels=flag)
           for route, flag in ROUTES.items()}
    return got, want


@pytest.mark.parametrize("route", list(ROUTES))
def test_export_step_matches_jax(exports, route):
    (products, losses), (jproducts, jlosses) = exports[0][route], exports[1]
    assert sorted(products) == sorted(PRODUCTS)
    r, c = ENV_RC
    assert tuple(products["env"].shape) == (2, r, c, 84)
    assert tuple(products["diffuse"].shape) == (2, r, c, 3)
    for k in PRODUCTS:
        assert not products[k].requires_grad, k
    for k in ("albedo", "normal", "rough", "depth"):
        np.testing.assert_allclose(products[k].numpy(), jproducts[k],
                                   atol=1e-4, err_msg=k)
    for k in ("albedo", "depth"):  # mean 1/3 an image
        np.testing.assert_allclose(products[k].mean(dim=(1, 2, 3)).numpy(),
                                   1 / 3, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(products["env"].numpy(), jproducts["env"],
                               atol=1e-4)
    for k in ("diffuse", "specular"):
        np.testing.assert_allclose(products[k].numpy(), jproducts[k],
                                   rtol=1e-3, atol=1e-5, err_msg=k)
    for k, w in jlosses.items():
        np.testing.assert_allclose(losses[k].numpy(), w, rtol=5e-5, err_msg=k)


def names(root, n=2):
    os.makedirs(root, exist_ok=True)
    return [os.path.join(root, f"scene{i}", f"im_{i + 1}.hdr")
            for i in range(n)]


def write_both(tmp_path, products, env_ind=None):
    """The same arrays through each package's write_products."""
    out = {}
    for pkg, write in (("port", write_products),
                       ("jax", jexport.write_products)):
        ims = names(str(tmp_path / pkg))
        for im in ims:
            os.makedirs(os.path.dirname(im), exist_ok=True)
        out[pkg] = (ims, write(products, ims, 0, env_ind=env_ind))
    return out


def test_write_products_bytes_match_jax(tmp_path, exports):
    products = exports[1][0]
    out = write_both(tmp_path, products)
    (ims, written), (jims, jwritten) = out["port"], out["jax"]
    assert len(written) == 2 * len(_STEMS)
    assert [w.replace(str(tmp_path / "port"), "") for w in written] == [
        w.replace(str(tmp_path / "jax"), "") for w in jwritten]
    for a, b in zip(written, jwritten):
        assert filecmp.cmp(a, b, shallow=False), a
    assert os.path.basename(written[0]) == "imbaseColor_1_0.h5"
    # stored CHW, as the reference
    assert io.read_h5(written[0], hwc_from_chw=False).shape == (3, *IM_HW)


def test_write_products_gating(tmp_path, exports):
    """env only where env_ind == 1; an existing file is skipped unless
    skip_existing is False; the port's tensors write as JAX's arrays."""
    products = exports[0]["kernels"][0]
    ims = names(str(tmp_path))
    for im in ims:
        os.makedirs(os.path.dirname(im), exist_ok=True)
    written = write_products(products, ims, 0, env_ind=np.array([1.0, 0.0]))
    envs = [w for w in written if os.path.basename(w).startswith("imenv_")]
    assert len(written) == 13 and len(envs) == 1 and "scene0" in envs[0]
    assert write_products(products, ims, 0, env_ind=np.array([1.0, 0.0])) \
        == []
    again = write_products(products, ims, 0, env_ind=np.array([1.0, 1.0]),
                           skip_existing=False)
    assert len(again) == 14
    np.testing.assert_array_equal(io.read_h5(again[-1]),
                                  products["env"][1].numpy())


def test_read_h5_reads_jax_files(tmp_path, exports):
    jproducts = exports[1][0]
    path = str(tmp_path / "x.h5")
    for k in ("albedo", "env"):
        jio.write_h5(jproducts[k][0], path)
        for flag in (True, False):
            np.testing.assert_array_equal(io.read_h5(path, flag),
                                          jio.read_h5(path, flag))
        np.testing.assert_array_equal(io.read_h5(path), jproducts[k][0])


def jax_loader(cascade_level=1):
    """The JAX loader's instance methods on an object with nothing else."""
    ds = OpenRoomsDataset.__new__(OpenRoomsDataset)
    ds.cascade_level = cascade_level
    return ds


def test_load_cascade_pre_matches_jax(tmp_path, exports):
    """The port's reader on files that JAX wrote, against the JAX loader on
    the same files: bit-equal, HWC."""
    out = write_both(tmp_path, exports[1][0])
    ds = jax_loader()
    for im in out["jax"][0]:
        got = openrooms.load_cascade_pre(im, 1)
        want = ds._load_cascade_pre(im)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert got[k].dtype == w.dtype and got[k].flags.c_contiguous, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        assert openrooms.pre_path(im, "imenv_", 1) == ds._pre_path(
            im, "imenv_")


@pytest.mark.parametrize("present", [True, False])
def test_load_env_pre_matches_jax(tmp_path, exports, present):
    """The env_pre read of the JAX loader's ``_load_item``: CHW -> HWC,
    and zeros with env_ind 0 where the file is missing."""
    env_ind = np.array([1.0, 1.0 if present else 0.0])
    out = write_both(tmp_path, exports[1][0], env_ind=env_ind)
    ds = jax_loader()
    im = out["jax"][0][1]
    env_pre, ind = openrooms.load_env_pre(im, 1, 1.0, sg_num=12,
                                          env_rc=ENV_RC)
    want = ds._load_h5(ds._pre_path(im, "imenv_"))
    if present:
        np.testing.assert_array_equal(env_pre, want.transpose(1, 2, 0))
        assert ind == 1.0
    else:
        assert want is None
        np.testing.assert_array_equal(
            env_pre, np.zeros((*ENV_RC, 84), np.float32))
        assert ind == 0.0


def test_hand_off_in_memory_equals_files(tmp_path, exports):
    """``normalize_cascade_pre`` on the products in memory gives what
    ``load_cascade_pre`` reads from the written files, and the maps make
    a cascade-1 batch that the port's cascade-1 BRDF step runs on."""
    products = exports[0]["kernels"][0]
    ims = names(str(tmp_path))
    for im in ims:
        os.makedirs(os.path.dirname(im), exist_ok=True)
    write_products(products, ims, 0)
    pre = []
    for n, im in enumerate(ims):
        chw = {key: products[key.replace("_pre", "")][n].permute(2, 0, 1)
               .numpy() for key in openrooms.PRE_STEMS}
        mem = openrooms.normalize_cascade_pre(chw)
        files = openrooms.load_cascade_pre(im, 1)
        for k, v in files.items():
            np.testing.assert_array_equal(mem[k], v, err_msg=k)
        pre.append(mem)
    batch = synthetic_batch(batch=2, im_hw=IM_HW, env_rc=ENV_RC, seed=6,
                            device="cpu")
    batch.update({k: torch.from_numpy(np.stack([p[k] for p in pre]))
                  for k in pre[0]})
    with torch.no_grad():
        _, errors = brdf_step(BRDFNets(1), batch)
    assert all(torch.isfinite(v) for v in errors.values())
