"""The port's ``train_bilateral`` and ``output_brdf_light`` CLIs end to
end on the CPU, in process, over the OpenRooms tree of
tests/test_torch_loaders.py (3 images at 64x64, lighting grid 32x32),
``--device cpu --noKernels --numWorkers 0``, and the options the CLIs
refuse; the fine-tune CLIs are in tests/test_torch_cli_finetune.py, on
this file's fixtures (IIW / NYU trees written by the port's
``data/fixture.py``, 2 training frames each).

The frozen nets are seeded port nets saved as epoch checkpoints (nets
only, no optimizer state) under the names the CLIs look for.  Mirrors
the JAX package's ``test_train_bilateral_cli_auto_vmax`` and
``test_output_and_cascade1_roundtrip`` (tests/test_cli_smoke.py), and
``test_preemption_resume_bitwise`` for the bilateral CLI: a run killed
after a step
checkpoint and resumed with ``--resume auto`` ends on the uninterrupted
run's state bit for bit, on one thread after a warm-up of every
convolution shape (tests/test_torch_cli.py says why); one torch thread
for the whole module.  The tests remove what they write.
"""

import builtins
import glob
import os.path as osp
import shutil

import numpy as np
import pytest
import torch

from inverserenderingofindoorscene_torch.cli import (
    output_brdf_light,
    train_bilateral,
    train_light,
)
from inverserenderingofindoorscene_torch.data.fixture import (
    write_iiw_fixture,
    write_nyu_fixture,
)
from inverserenderingofindoorscene_torch.data.openrooms import (
    OpenRoomsDataset,
)
from inverserenderingofindoorscene_torch.pipeline.brdf import BRDFNets
from inverserenderingofindoorscene_torch.pipeline.light import LightNets
from inverserenderingofindoorscene_torch.utils import checkpoint as ckpt
from inverserenderingofindoorscene_torch.utils import h5
from inverserenderingofindoorscene_torch.utils.logging import MetricLogger
from test_torch_cli import state_equal
from test_torch_loaders import ENV_RC, IM_HW, NIMG, write_dataset


def save_nets(exp, stage, nets, cascade=0):
    """``nets`` as the epoch-0 checkpoint of ``stage`` under ``exp``."""
    ckpt.save_checkpoint(exp, stage, cascade, 0, {
        "nets": nets.state_dict(), "optimizer": None, "scheduler": None})
    return exp


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The fixture tree and a seeded cascade-0 BRDF and light
    checkpoint beside it; removed after the module."""
    pytest.importorskip("cv2")
    base = tmp_path_factory.mktemp("cli_train")
    root = write_dataset(base / "openrooms")
    gen = torch.Generator().manual_seed(3)
    brdf = save_nets(str(base / "brdf0"), "brdf", BRDFNets(0, generator=gen))
    light = save_nets(str(base / "light0"), "light", LightNets(
        env_rows=ENV_RC[0], env_cols=ENV_RC[1], generator=gen))
    iiw = str(base / "iiw")
    write_iiw_fixture(iiw, n_train=2, n_test=1, frame_hw=(48, 64))
    nyu = str(base / "nyu")
    write_nyu_fixture(nyu, n_train=2, n_test=1)
    yield {"root": root, "brdf": brdf, "light": light, "base": base,
           "iiw": iiw, "nyu": nyu}
    shutil.rmtree(base, ignore_errors=True)


@pytest.fixture
def work(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module", autouse=True)
def one_thread_module():
    """One torch thread for the module: the bitwise resumes need it
    (tests/test_torch_cli.py says why), and the CLIs' many small ops slow
    several-fold when the test workers' threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(root, extra):
    return [
        "--dataRoot", root, "--device", "cpu", "--noKernels",
        "--imHeight", str(IM_HW[0]), "--imWidth", str(IM_HW[1]),
        "--envRow", str(ENV_RC[0]), "--envCol", str(ENV_RC[1]),
        "--batchSize", "1", "--nepoch", "1", "--maxSteps", "2",
        "--numWorkers", "0",
    ] + extra


def log_values(exp):
    """The logged metrics of each line of ``exp``'s training log."""
    rows = []
    for line in open(osp.join(exp, "trainingLog.txt")).read().splitlines():
        rows.append({part.split()[0]: float(part.split()[1])
                     for part in line.split("] ")[1].split(" | ")})
    return rows


def test_train_bilateral_cli(tree, work, capsys):
    """Two steps on the frozen BRDF checkpoint: an epoch checkpoint of the
    three confidence nets, finite losses, the vertex counts logged."""
    exp = str(work / "exp_bs")
    train_bilateral.main(_args(tree["root"], [
        "--experiment", exp, "--brdfExperiment", tree["brdf"],
        "--vMax", "auto"]))
    assert (f"loaded frozen BRDF from {tree['brdf']} epoch 0"
            in capsys.readouterr().out)
    state = ckpt.restore_checkpoint(exp, "bs", 0, 0)
    assert {k.split(".")[0] for k in state["nets"]} == {"albedo", "rough",
                                                        "depth"}
    rows = log_values(exp)
    assert len(rows) == 2
    for row in rows:
        assert np.isfinite(list(row.values())).all()
        assert 0 < row["nvert_max"] <= IM_HW[0] * IM_HW[1]
        assert row["total"] > 0


def test_train_bilateral_resume_bitwise(tree, work, monkeypatch):
    """Killed after step 0's step checkpoint, resumed with ``--resume
    auto``: the final state equals the uninterrupted run's."""
    def run_args(exp):
        return _args(tree["root"], [
            "--experiment", exp, "--brdfExperiment", tree["brdf"],
            "--maxSteps", "100", "--ckptEverySteps", "1", "--resume", "auto",
            "--logFlushSteps", "1"])

    train_bilateral.main(run_args(str(work / "warm")))  # C12 warm-up
    shutil.rmtree(work / "warm")
    exp_a = str(work / "exp_a")
    train_bilateral.main(run_args(exp_a))

    exp_b = str(work / "exp_b")
    orig_log = MetricLogger.log
    calls = {"n": 0}

    def bomb(self, epoch, j, metrics):
        orig_log(self, epoch, j, metrics)
        calls["n"] += 1
        if calls["n"] == 2:
            raise KeyboardInterrupt  # a simulated preemption

    monkeypatch.setattr(MetricLogger, "log", bomb)
    with pytest.raises(KeyboardInterrupt):
        train_bilateral.main(run_args(exp_b))
    monkeypatch.setattr(MetricLogger, "log", orig_log)
    assert ckpt.latest_epoch(exp_b, "bs", 0) is None
    assert ckpt.list_step_checkpoints(exp_b, "bs", 0)[-1] == (0, 0)

    train_bilateral.main(run_args(exp_b))  # resumes: steps 1 and 2
    state_equal(ckpt.restore_checkpoint(exp_b, "bs", 0, 0),
                ckpt.restore_checkpoint(exp_a, "bs", 0, 0))
    lines = open(osp.join(exp_b, "trainingLog.txt")).read().splitlines()
    assert [line.split()[0] for line in lines] == ["[0/0]", "[0/1]",
                                                  "[0/1]", "[0/2]"]
    # step 1 before the kill and after the resume: the same losses
    assert lines[1].split("(")[0] == lines[2].split("(")[0]


def test_output_brdf_light_then_cascade1(tree, work):
    """The cascade-0 products of every image written beside it, read back
    as a cascade-1 batch; ``train_bilateral --cascadeLevel 1`` takes a
    step on them; a second export skips the files that exist."""
    root = str(work / "c1")
    shutil.copytree(tree["root"], root)
    argv = _args(root, ["--brdfExperiment", tree["brdf"],
                        "--lightExperiment", tree["light"],
                        "--maxSteps", str(NIMG)])
    output_brdf_light.main(argv)
    ds = OpenRoomsDataset(root, im_hw=IM_HW, env_rc=ENV_RC, cascade_level=1,
                          is_light=True, is_all_light=True)
    assert len(ds) == NIMG
    item = ds[0]
    for k in ("albedo_pre", "normal_pre", "rough_pre", "depth_pre",
              "diffuse_pre", "specular_pre", "env_pre"):
        assert k in item and np.isfinite(item[k]).all(), k
    assert item["env_pre"].shape == (ENV_RC[0], ENV_RC[1], 84)
    assert item["albedo_pre"].shape == (IM_HW[0], IM_HW[1], 3)
    assert item["env_ind"][0] == 1.0
    mtimes = {p: osp.getmtime(p) for p in
              [item["name"].replace("im_", "imenv_").replace(".hdr", "_0.h5")]}
    output_brdf_light.main(argv)
    for p, t in mtimes.items():
        assert osp.getmtime(p) == t

    exp = str(work / "exp_bs1")
    train_bilateral.main(_args(root, ["--experiment", exp,
                                      "--cascadeLevel", "1",
                                      "--maxSteps", "1"]))
    assert len(log_values(exp)) == 1
    state = ckpt.restore_checkpoint(exp, "bs", 1, 0)
    assert all(torch.isfinite(v).all() for v in state["nets"].values())


@pytest.mark.parametrize("cli,extra,match", [
    pytest.param(train_bilateral, ["--vMax", "4096"], "left out",
                 id="cli0-extra0-left out"),
])
def test_unported_options_raise(tree, work, cli, extra, match):
    argv = _args(tree["root"], ["--experiment", str(work / "e")])
    with pytest.raises(NotImplementedError, match=match):
        cli.main(argv + extra)


@pytest.mark.parametrize("cli,extra", [
    (output_brdf_light, []),
    (train_light, ["--cascadeLevel", "1"]),
    (train_bilateral, ["--cascadeLevel", "1"]),
], ids=["output_brdf_light", "train_light-c1", "train_bilateral-c1"])
def test_h5_clis_run_without_h5py(tree, work, monkeypatch, cli, extra):
    """With h5py's import blocked, the CLIs that write or read the
    hand-off's ``.h5`` files run: the export writes every product, which
    the port's reader and h5py read back alike; the cascade-1 stages take
    their steps on the exported files (a cascade-1 BRDF checkpoint under
    the light stage)."""
    real_import = builtins.__import__

    def no_h5py(name, *a, **kw):
        if name.split(".")[0] == "h5py":
            raise ImportError("h5py is blocked in this test")
        return real_import(name, *a, **kw)

    root = str(work / "c1")
    shutil.copytree(tree["root"], root)
    monkeypatch.setattr(builtins, "__import__", no_h5py)
    output_brdf_light.main(_args(root, [
        "--brdfExperiment", tree["brdf"], "--lightExperiment", tree["light"],
        "--maxSteps", str(NIMG)]))
    written = sorted(glob.glob(osp.join(root, "**", "*_0.h5"),
                               recursive=True))
    assert len(written) >= 6 * NIMG
    if cli is output_brdf_light:
        monkeypatch.setattr(builtins, "__import__", real_import)
        import h5py

        for path in written:
            with h5py.File(path, "r") as f:
                np.testing.assert_array_equal(f["data"][()],
                                              h5.read(path))
        return
    brdf1 = save_nets(str(work / "brdf1"), "brdf",
                      BRDFNets(1, generator=torch.Generator().manual_seed(4)),
                      cascade=1)
    exp = str(work / "exp_c1")
    cli.main(_args(root, ["--experiment", exp, "--brdfExperiment", brdf1,
                          "--maxSteps", "1"] + extra))
    rows = log_values(exp)
    assert len(rows) == 1 and all(np.isfinite(v) for v in rows[0].values())
