"""The port's fine-tune CLIs, ``train_finetune_iiw`` and
``train_finetune_nyu``, end to end on the CPU, in process, on the
fixtures of tests/test_torch_cli_train.py (the OpenRooms tree of
tests/test_torch_loaders.py at 64x64, IIW and NYU trees of 2 training
frames, seeded cascade-0 checkpoints), ``--device cpu --noKernels
--numWorkers 0``, torch on one thread: a cascade-0 IIW run, a cascade-1
NYU run whose ``*_pre`` maps are synthesized inline on the cascade-0
checkpoints, and the IIW CLI killed after a step checkpoint and resumed
with ``--resume auto``, ending on the uninterrupted run's state bit for
bit (the JAX package's ``test_preemption_resume_bitwise``).
"""

import os.path as osp
import shutil

import numpy as np
import pytest
import torch

from inverserenderingofindoorscene_torch.cli import (
    output_brdf_light,
    train_finetune_iiw,
    train_finetune_nyu,
)
from inverserenderingofindoorscene_torch.pipeline import finetune
from inverserenderingofindoorscene_torch.utils import checkpoint as ckpt
from inverserenderingofindoorscene_torch.utils.logging import MetricLogger
from test_torch_cli import state_equal
from test_torch_cli_train import (  # noqa: F401
    _args,
    log_values,
    one_thread_module,
    tree,
    work,
)
from test_torch_loaders import ENV_RC, IM_HW, NIMG


def iiw_args(tree, exp, extra=()):
    return _args(tree["root"], [
        "--experiment", exp, "--brdfExperiment", tree["brdf"],
        "--iiwRoot", tree["iiw"],
        "--iiwList", osp.join(tree["iiw"], "IIWTrain.txt")] + list(extra))


def test_finetune_iiw_cli(tree, work):
    """Two cycles at cascade 0 from the BRDF checkpoint: both halves'
    losses logged, a checkpoint of the whole BRDF stack with the shared
    Adam's moments (the nets the ranking loss does not reach move too,
    as optax moves them)."""
    exp = str(work / "exp_iiw")
    train_finetune_iiw.main(iiw_args(tree, exp))
    rows = log_values(exp)
    assert len(rows) == 2
    for row in rows:
        assert {"syn_total", "syn_albedo", "iiw_eq", "iiw_darker",
                "iiw_total"} <= set(row)
        assert np.isfinite(list(row.values())).all()
    state = ckpt.restore_checkpoint(exp, "iiw", 0, 0)
    start = ckpt.restore_checkpoint(tree["brdf"], "brdf", 0, 0)["nets"]
    # two cycles: two updates a cycle on one Adam
    assert all(v["step"] == 4 for v in state["optimizer"]["state"].values())
    for head in ("albedo", "normal"):
        key = f"{head}.dconvFinal.weight"
        assert not torch.equal(state["nets"][key], start[key]), key


def test_finetune_nyu_cascade1_inline_synthesis(tree, work, monkeypatch):
    """At cascade 1 the synthetic batches read the cascade-0 ``*_pre``
    files that ``output_brdf_light`` wrote, and each NYU batch gets its ``*_pre`` maps from the frozen
    cascade-0 stack (``--brdf0Experiment`` / ``--light0Experiment``); a
    missing cascade-0 checkpoint is an error, not random nets."""
    root = str(work / "c1")
    shutil.copytree(tree["root"], root)
    output_brdf_light.main(_args(root, [
        "--brdfExperiment", tree["brdf"], "--lightExperiment", tree["light"],
        "--maxSteps", str(NIMG)]))
    nyu = tree["nyu"]
    argv = _args(root, [
        "--experiment", str(work / "exp_nyu1"), "--cascadeLevel", "1",
        "--brdf0Experiment", tree["brdf"],
        "--light0Experiment", tree["light"],
        "--nyuImRoot", osp.join(nyu, "images"),
        "--nyuNormalRoot", osp.join(nyu, "normals"),
        "--nyuDepthRoot", osp.join(nyu, "depths"),
        "--nyuSegRoot", osp.join(nyu, "segs"),
        "--nyuList", osp.join(nyu, "NYUTrain.txt")])
    synthesized = []
    orig = finetune.synthesize_pre

    def spy(bn0, ln0, batch, use_kernels=True):
        out = orig(bn0, ln0, batch, use_kernels=use_kernels)
        synthesized.append({k: tuple(v.shape) for k, v in out.items()
                            if k.endswith("_pre")})
        assert bn0.cascade_level == 0 and ln0.cascade_level == 0
        assert not use_kernels
        return out

    monkeypatch.setattr(finetune, "synthesize_pre", spy)
    train_finetune_nyu.main(argv)
    assert len(synthesized) == 2
    assert synthesized[0]["env_pre"] == (1, ENV_RC[0], ENV_RC[1], 84)
    assert synthesized[0]["albedo_pre"] == (1, IM_HW[0], IM_HW[1], 3)
    rows = log_values(str(work / "exp_nyu1"))
    assert len(rows) == 2
    for row in rows:
        assert {"syn_total", "nyu_normal", "nyu_depth"} <= set(row)
        assert np.isfinite(list(row.values())).all()
    state = ckpt.restore_checkpoint(str(work / "exp_nyu1"), "nyu", 1, 0)
    assert tuple(state["nets"]["encoder.conv1.weight"].shape[:2]) == (64, 17)

    with pytest.raises(FileNotFoundError, match="light0Experiment"):
        train_finetune_nyu.main(argv + ["--light0Experiment",
                                        str(work / "missing")])


def test_finetune_iiw_resume_bitwise(tree, work, monkeypatch):
    """Killed after cycle 0's step checkpoint, resumed with ``--resume
    auto``: the nets and the shared Adam end as the uninterrupted run's
    (3 cycles an epoch: the 3-image synthetic loader, the 2-frame IIW
    loader starting again)."""
    def run_args(exp):
        return iiw_args(tree, exp, [
            "--maxSteps", "100", "--ckptEverySteps", "1", "--resume", "auto",
            "--logFlushSteps", "1"])

    train_finetune_iiw.main(run_args(str(work / "warm")))  # C12 warm-up
    shutil.rmtree(work / "warm")
    exp_a = str(work / "exp_a")
    train_finetune_iiw.main(run_args(exp_a))

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
        train_finetune_iiw.main(run_args(exp_b))
    monkeypatch.setattr(MetricLogger, "log", orig_log)
    assert ckpt.latest_epoch(exp_b, "iiw", 0) is None
    assert ckpt.list_step_checkpoints(exp_b, "iiw", 0)[-1] == (0, 0)

    train_finetune_iiw.main(run_args(exp_b))  # resumes: cycles 1 and 2
    state_equal(ckpt.restore_checkpoint(exp_b, "iiw", 0, 0),
                ckpt.restore_checkpoint(exp_a, "iiw", 0, 0))
    lines = open(osp.join(exp_b, "trainingLog.txt")).read().splitlines()
    assert [line.split()[0] for line in lines] == ["[0/0]", "[0/1]",
                                                  "[0/1]", "[0/2]"]
    assert lines[1].split("(")[0] == lines[2].split("(")[0]
