"""The port's ``train_brdf`` and ``train_light`` CLIs end to end on the
CPU, in process, over the OpenRooms tree of tests/test_torch_loaders.py
(3 images at 64x64, lighting grid 32x32), ``--device cpu --numWorkers 0``
(``--noKernels`` for the light stage).

A BRDF smoke; a light smoke whose frozen nets are the BRDF checkpoint
just written; the kill-and-resume of the JAX package's
``test_preemption_resume_bitwise`` (a run killed after a step checkpoint
and resumed with ``--resume auto`` ends bit-equal to an uninterrupted
one, the epoch checkpoints compared tensor by tensor); a cascade-1 BRDF
step on ``*_pre`` maps written by ``pipeline/export.write_products``; and
a step of each CLI in either ``--computeDtype``.  The bitwise comparison runs on one thread
(tests/test_torch_checkpoint.py says why), after a warm-up of every
convolution shape (ROADMAP C12).
"""

import os.path as osp
import shutil

import numpy as np
import pytest
import torch

from inverserenderingofindoorscene_torch.cli import train_brdf, train_light
from inverserenderingofindoorscene_torch.data.openrooms import (
    BatchIterator,
    OpenRoomsDataset,
)
from inverserenderingofindoorscene_torch.pipeline.brdf import BRDFNets
from inverserenderingofindoorscene_torch.pipeline.export import (
    export_step,
    write_products,
)
from inverserenderingofindoorscene_torch.pipeline.light import LightNets
from inverserenderingofindoorscene_torch.utils import checkpoint as ckpt
from inverserenderingofindoorscene_torch.utils.logging import MetricLogger
from test_torch_loaders import ENV_RC, IM_HW, NIMG, write_dataset


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    pytest.importorskip("cv2")
    return write_dataset(tmp_path_factory.mktemp("openrooms"))


def _args(dataset, extra):
    return [
        "--dataRoot", dataset, "--device", "cpu",
        "--imHeight", str(IM_HW[0]), "--imWidth", str(IM_HW[1]),
        "--envRow", str(ENV_RC[0]), "--envCol", str(ENV_RC[1]),
        "--batchSize", "2", "--nepoch", "1", "--maxSteps", "2",
        "--numWorkers", "0",
    ] + extra


@pytest.fixture
def work(tmp_path):
    """tmp_path, emptied after the test: a BRDF checkpoint with its Adam
    moments is ~540 MB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def state_equal(a, b):
    """Two saved states, tensor by tensor (nested dicts and lists)."""
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            state_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            state_equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


def test_train_brdf_then_train_light(dataset, work, capsys):
    """The staged recipe's first two stages: the BRDF CLI writes its
    epoch checkpoint (step checkpoints too, previews and curves), and the
    light CLI loads it as its frozen nets."""
    exp_b = str(work / "exp_brdf")
    train_brdf.main(_args(dataset, ["--experiment", exp_b,
                                    "--ckptEverySteps", "1"]))
    assert ckpt.latest_epoch(exp_b, "brdf", 0) == 0
    assert ckpt.list_step_checkpoints(exp_b, "brdf", 0) == [(0, 0)]
    for name in ("trainingLog.txt", "albedoPred_0_0.png", "totalError_0.npy",
                 "src_snapshot"):
        assert osp.exists(osp.join(exp_b, name)), name
    lines = open(osp.join(exp_b, "trainingLog.txt")).read().splitlines()
    assert [line.split()[0] for line in lines] == ["[0/0]"]

    exp_l = str(work / "exp_light")
    capsys.readouterr()
    train_light.main(_args(dataset, ["--experiment", exp_l,
                                     "--brdfExperiment", exp_b,
                                     "--batchSize", "1", "--noKernels"]))
    assert f"loaded frozen BRDF from {exp_b} epoch 0" in capsys.readouterr(
    ).out
    assert ckpt.latest_epoch(exp_l, "light", 0) == 0
    state = ckpt.restore_checkpoint(exp_l, "light", 0, 0)
    light = LightNets(env_rows=ENV_RC[0], env_cols=ENV_RC[1],
                      generator=torch.Generator().manual_seed(5))
    ckpt.load_train_state(state, light)
    lines = open(osp.join(exp_l, "trainingLog.txt")).read().splitlines()
    assert len(lines) == 2
    for line in lines:
        values = [float(part.split()[1]) for part in line.split("] ")[1]
                  .split(" | ")]
        assert np.isfinite(values).all()


def test_train_light_refuses_kernels_on_the_cpu(dataset, tmp_path):
    with pytest.raises(ValueError, match="--noKernels"):
        train_light.main(_args(dataset, ["--experiment",
                                         str(tmp_path / "e")]))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_compute_dtype_trains_and_checkpoints(dataset, work, dtype):
    """One ``train_brdf`` step and one ``train_light`` step (its light
    nets in ``dtype``, the frozen BRDF nets in float32, as in the JAX
    CLI) with ``--computeDtype``: finite losses, float32 checkpoints
    whose keys do not depend on the dtype."""
    exp_b, exp_l = str(work / "b"), str(work / "l")
    dt = ["--computeDtype", dtype, "--maxSteps", "1", "--batchSize", "1"]
    train_brdf.main(_args(dataset, ["--experiment", exp_b,
                                    "--previewEvery", "0"] + dt))
    train_light.main(_args(dataset, ["--experiment", exp_l,
                                     "--brdfExperiment", exp_b,
                                     "--noKernels"] + dt))
    for exp, stage, nets in ((exp_b, "brdf", BRDFNets(0)),
                             (exp_l, "light", LightNets(
                                 env_rows=ENV_RC[0], env_cols=ENV_RC[1]))):
        state = ckpt.restore_checkpoint(exp, stage, 0, 0)
        assert list(state["nets"]) == list(nets.state_dict())
        assert all(v.dtype == torch.float32
                   for v in state["nets"].values())
        lines = open(osp.join(exp, "trainingLog.txt")).read().splitlines()
        values = [float(part.split()[1]) for part in lines[0].split("] ")[1]
                  .split(" | ")]
        assert len(lines) == 1 and np.isfinite(values).all()


def test_preemption_resume_bitwise(dataset, work, monkeypatch,
                                   one_thread):
    """A run killed after step 0's step checkpoint and resumed with
    ``--resume auto`` ends on the uninterrupted run's state, bit for bit:
    the restored scheduler carries the LR position, the skipped batch
    prefix the data position."""
    def run_args(exp):
        # batch 1: 3 steps an epoch; logFlushSteps 1, because the kill
        # hook is the per-step MetricLogger.log call
        return _args(dataset, [
            "--experiment", exp, "--batchSize", "1", "--maxSteps", "100",
            "--ckptEverySteps", "1", "--resume", "auto",
            "--logFlushSteps", "1", "--previewEvery", "0",
        ])

    train_brdf.main(run_args(str(work / "warm")))  # C12 warm-up
    shutil.rmtree(work / "warm")
    exp_a = str(work / "exp_a")
    train_brdf.main(run_args(exp_a))

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
        train_brdf.main(run_args(exp_b))
    monkeypatch.setattr(MetricLogger, "log", orig_log)

    # killed between step 1's log line and its save: the newest step
    # checkpoint is (0, 0), and there is no epoch checkpoint yet
    assert ckpt.latest_epoch(exp_b, "brdf", 0) is None
    assert ckpt.list_step_checkpoints(exp_b, "brdf", 0)[-1] == (0, 0)

    train_brdf.main(run_args(exp_b))  # resumes: steps 1 and 2

    state_equal(ckpt.restore_checkpoint(exp_b, "brdf", 0, 0),
                ckpt.restore_checkpoint(exp_a, "brdf", 0, 0))
    # pruned to --ckptKeep (default 2)
    assert len(ckpt.list_step_checkpoints(exp_b, "brdf", 0)) <= 2
    # step 1 ran before the kill and again after the resume, on the same
    # state and batch: its losses are logged twice, equal
    lines = open(osp.join(exp_b, "trainingLog.txt")).read().splitlines()
    assert [line.split()[0] for line in lines] == ["[0/0]", "[0/1]",
                                                  "[0/1]", "[0/2]"]
    assert lines[1].split("(")[0] == lines[2].split("(")[0]


def test_train_brdf_cascade1_on_exported_products(dataset, work):
    """Cascade-0 products written by ``pipeline/export.write_products``
    beside the images feed ``train_brdf --cascadeLevel 1``: the loader
    reads the ``*_pre`` maps, the 17-channel encoder trains a step."""
    pytest.importorskip("h5py")
    root = str(work / "c1")
    shutil.copytree(dataset, root)
    ds = OpenRoomsDataset(root, im_hw=IM_HW, env_rc=ENV_RC, is_light=True,
                          is_all_light=True)
    batch = BatchIterator._collate([ds[i] for i in range(NIMG)])
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()
               if k != "name"}
    gen = torch.Generator().manual_seed(2)
    products, _ = export_step(BRDFNets(0, generator=gen),
                              LightNets(env_rows=ENV_RC[0],
                                        env_cols=ENV_RC[1], generator=gen),
                              tensors, use_kernels=False)
    assert len(write_products(products, batch["name"], 0,
                              env_ind=batch["env_ind"][:, 0])) == 7 * NIMG

    exp = str(work / "exp_c1")
    train_brdf.main(_args(root, ["--experiment", exp, "--cascadeLevel", "1",
                                 "--batchSize", "1", "--maxSteps", "1",
                                 "--previewEvery", "0"]))
    state = ckpt.restore_checkpoint(exp, "brdf", 1, 0)
    assert tuple(state["nets"]["encoder.conv1.weight"].shape[:2]) == (64, 17)
    lines = open(osp.join(exp, "trainingLog.txt")).read().splitlines()
    assert len(lines) == 1 and "nan" not in lines[0]
