"""The port's evaluation CLIs on the CPU: ``test_synthetic`` at its
three stages, ``test_real`` (the products of both cascades, and at the
photo's own aspect) and ``compare`` against the JAX package's
``compare.main``, bit for bit (both packages run the same numpy and
OpenCV code).

Sizes are those of tests/test_cli_smoke.py (images 64x64, lighting grid
32x32, the OpenRooms tree of tests/test_torch_loaders.py).  Mirrors its
``test_test_synthetic_cli``, ``test_test_real_cli`` and
``test_test_real_native_resolution_products``, and
tests/test_finetune_eval.py's compare checks.  torch runs one thread
here: the CLIs' many small ops slow several-fold when the test workers'
threads outnumber the cores.  ``load_real_image`` and ``render_file``
are in tests/test_torch_render_file.py.
"""

import os
import os.path as osp
import shutil

import numpy as np
import pytest
import torch

from inverserenderingofindoorscene_torch.cli import (
    compare,
    test_real,
    test_synthetic,
)
from inverserenderingofindoorscene_torch.data.fixture import (
    write_iiw_fixture,
    write_nyu_fixture,
)
from inverserenderingofindoorscene_torch.pipeline.brdf import BRDFNets
from inverserenderingofindoorscene_torch.pipeline.inference import (
    InverseRenderer,
)
from inverserenderingofindoorscene_torch.pipeline.light import LightNets
from test_torch_cli_train import one_thread_module, save_nets  # noqa: F401
from test_torch_loaders import ENV_RC, IM_HW, write_dataset

REAL = ["--imHeight", str(IM_HW[0]), "--imWidth", str(IM_HW[1]),
        "--envRow", str(ENV_RC[0]), "--envCol", str(ENV_RC[1]),
        "--device", "cpu", "--noKernels"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    base = tmp_path_factory.mktemp("cli_eval")
    root = write_dataset(base / "openrooms")
    gen = torch.Generator().manual_seed(4)
    brdf = save_nets(str(base / "brdf0"), "brdf", BRDFNets(0, generator=gen))
    light = save_nets(str(base / "light0"), "light", LightNets(
        env_rows=ENV_RC[0], env_cols=ENV_RC[1], generator=gen))
    rng = np.random.RandomState(1)
    photos = {}
    for name, hw in (("square", (64, 64)), ("wide", (80, 128))):
        photos[name] = str(base / f"{name}.png")
        cv2.imwrite(photos[name], (rng.rand(*hw, 3) * 255).astype(np.uint8))
    yield {"root": root, "brdf": brdf, "light": light, "base": base,
           "photos": photos}
    shutil.rmtree(base, ignore_errors=True)


@pytest.fixture
def work(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("stage", ["brdf", "light", "bilateral"])
def test_test_synthetic_cli(tree, work, stage):
    """The TEST split through each stage: finite means, and the reference
    test drivers' files (the testing log, an error row a batch, the
    image grids)."""
    troot = str(work / f"test_{stage}")
    out = test_synthetic.main([
        "--dataRoot", tree["root"], "--stage", stage, "--testRoot", troot,
        "--brdfExperiment", tree["brdf"], "--lightExperiment", tree["light"],
        "--bsExperiment", str(work / "no_bs"), "--batchSize", "2",
        "--numWorkers", "0"] + REAL)
    keys = {"brdf": ["albedo", "normal", "rough", "depth"],
            "light": ["albedo", "normal", "rough", "depth", "reconst",
                      "render"],
            "bilateral": ["albedo_raw", "albedo_bs", "rough_raw", "rough_bs",
                          "depth_raw", "depth_bs", "normal"]}[stage]
    assert sorted(out) == sorted(keys)
    assert all(np.isfinite(v) for v in out.values()), out
    text = open(osp.join(troot, "testingLog_0.txt")).read()
    assert "albedo:" in text and "albedoAccu:" in text
    for k in ("albedo", "normal", "rough", "depth"):
        arr = np.load(osp.join(troot, f"{k}Error_0.npy"))
        # one batch of 2 from the 3-image split; [raw, refined] pairs at
        # the bilateral stage
        want = (1, 2) if stage == "bilateral" and k != "normal" else (1, 1)
        assert arr.shape == want and np.isfinite(arr).all(), (k, arr)
    pngs = {"brdf": ["im", "albedoGt_0", "albedoPred_0", "depthPred_0"],
            "light": ["im", "imRendered", "envmapPred"],
            "bilateral": ["im", "albedoPred_0", "albedoBs_0", "depthBs_0"]}
    for name in pngs[stage]:
        assert osp.isfile(osp.join(troot, f"0_{name}.png")), name


def test_test_real_cli(tree, work):
    """Level 2 with lighting and refinement: each level's products under
    the reference's names and layouts, the photo at its own size, and the
    maps of the chain run on the same photo."""
    import cv2

    im_list = work / "list.txt"
    im_list.write_text(tree["photos"]["square"] + "\n")
    outdir = work / "out"
    argv = ["--imList", str(im_list), "--output", str(outdir),
            "--level", "2", "--isLight", "--isBS"] + REAL
    test_real.main(argv)
    files = os.listdir(outdir)
    for lvl in (0, 1):
        for prod in (f"albedo{lvl}.npy", f"envmap{lvl}.png",
                     f"envmap{lvl}.npz", f"envmapSG{lvl}.npy",
                     f"shading{lvl}.png", f"rendered{lvl}.png",
                     f"albedoBS{lvl}.png", f"albedoBS{lvl}.npy",
                     f"roughBS{lvl}.png", f"depthBS{lvl}.npy",
                     f"cLight{lvl}.npy", f"cLight{lvl}.mat"):
            assert f"square_{prod}" in files, (prod, files)
    assert cv2.imread(str(outdir / "square.png")).shape[:2] == (64, 64)
    sg = np.load(outdir / "square_envmapSG1.npy")
    assert sg.shape == (1, 84, ENV_RC[0], ENV_RC[1]), sg.shape
    env = np.load(outdir / "square_envmap1.npz")["env"]
    assert env.shape == (ENV_RC[0], ENV_RC[1], 8, 16, 3), env.shape

    # the same photo through the chain in this process
    opt = test_real.parse_args(argv)
    renderer = InverseRenderer(test_real.load_stack(opt, "cpu"),
                               is_light=True, use_kernels=False,
                               device="cpu")
    result = renderer.render_file(tree["photos"]["square"], IM_HW, ENV_RC)
    for lvl in (0, 1):
        c_albedo, c_light = np.load(outdir / f"square_cLight{lvl}.npy")
        light = result["lights"][lvl]
        np.testing.assert_allclose([c_albedo, c_light],
                                   [light["c_albedo"], light["c_light"]],
                                   rtol=2e-4)
        np.testing.assert_allclose(
            np.load(outdir / f"square_albedo{lvl}.npy"),
            result["preds"][lvl]["albedo"][0].numpy() * light["c_albedo"],
            rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(
            np.load(outdir / f"square_depth{lvl}.npy"),
            result["preds"][lvl]["depth"][0].numpy(), atol=1e-4)


def test_test_real_fused_matches_staged(tree, work):
    """``--fused`` (the scale fit traced per image) writes the staged
    run's products up to the fit's float32-against-host arithmetic
    (tests/test_cli_smoke.py:609-620)."""
    im_list = work / "list.txt"
    im_list.write_text(tree["photos"]["square"] + "\n")
    argv = ["--imList", str(im_list), "--level", "2", "--isLight"] + REAL
    for mode in ("staged", "fused"):
        test_real.main(argv + ["--output", str(work / mode)]
                       + (["--fused"] if mode == "fused" else []))
    np.testing.assert_allclose(
        np.load(work / "fused" / "square_albedo1.npy"),
        np.load(work / "staged" / "square_albedo1.npy"),
        rtol=1e-3, atol=1e-5)


def test_test_real_native_resolution_products(tree, work):
    """A landscape 80x128 photo at im_hw (64, 64): the PNGs and the
    normal npy at the fitted size (40, 64), the photo at its own."""
    import cv2

    im_list = work / "list.txt"
    im_list.write_text(tree["photos"]["wide"] + "\n")
    outdir = work / "out"
    test_real.main(["--imList", str(im_list), "--output", str(outdir),
                    "--level", "1"] + REAL)
    fitted = (40, 64)
    for prod in ("albedo0", "normal0", "rough0", "depth0"):
        im = cv2.imread(str(outdir / f"wide_{prod}.png"))
        assert im is not None and im.shape[:2] == fitted, (prod, im.shape)
    assert np.load(outdir / "wide_normal0.npy").shape[:2] == fitted
    assert np.load(outdir / "wide_depth0.npy").shape[:2] == fitted
    assert cv2.imread(str(outdir / "wide.png")).shape[:2] == (80, 128)


@pytest.fixture(scope="module")
def compare_dirs(tree):
    """IIW and NYU ground truth from the port's fixture writers, and
    seeded predictions under the names test_real writes."""
    base = tree["base"]
    iiw = str(base / "iiw")
    write_iiw_fixture(iiw, n_train=2, n_test=1, frame_hw=(48, 64))
    nyu = str(base / "nyu")
    write_nyu_fixture(nyu, n_train=2, n_test=1)
    pred = base / "pred"
    pred.mkdir()
    rng = np.random.RandomState(6)
    for i in range(3):
        refl = rng.rand(48, 64, 3).astype(np.float32) + 0.05
        np.save(pred / f"iiw{i:04d}_albedo1.npy", refl)
        np.save(pred / f"iiw{i:04d}_albedoBS1.npy", refl ** 1.1)
        n = rng.uniform(-1, 1, (60, 80, 3))
        n[..., 2] = np.abs(n[..., 2]) + 0.2
        n = n / np.linalg.norm(n, axis=2, keepdims=True)
        np.save(pred / f"frame{i:04d}_normal1.npy", n.astype(np.float32))
        d = (rng.rand(60, 80, 1) * 5 + 0.5).astype(np.float32)
        np.save(pred / f"frame{i:04d}_depth1.npy", d)
        np.save(pred / f"frame{i:04d}_depthBS1.npy", d[..., 0] * 1.1)
    return {"whdr": iiw, "normal": osp.join(nyu, "normals"),
            "depth": osp.join(nyu, "depths"), "pred": str(pred)}


@pytest.mark.parametrize("metric,bs", [("whdr", False), ("whdr", True),
                                       ("normal", False), ("depth", False),
                                       ("depth", True)])
def test_compare_matches_jax(compare_dirs, metric, bs, capsys):
    """The port's ``compare`` prints and returns what the JAX package's
    does on the same prediction directory, bit for bit."""
    from inverserenderingofindoorscene_tpu.cli import compare as jcompare

    argv = [metric, "--predRoot", compare_dirs["pred"], "--gtRoot",
            compare_dirs[metric]] + (["--useBS"] if bs else [])
    want = jcompare.main(argv)
    want_out = capsys.readouterr().out
    got = compare.main(argv)
    assert got == want and capsys.readouterr().out == want_out
    assert "over 3 images" in want_out
    assert np.isfinite(got)
    if metric == "whdr":
        assert 0.0 <= got <= 1.0
    elif metric == "normal":
        assert 0.0 <= got <= 180.0
