"""The port's checkpoints (``utils/checkpoint.py``) and the CLIs' resume
(``cli/common.resume_train_state``).

A checkpoint is a directory with the JAX package's name holding a
``torch.save`` of the nets', the optimizer's and the scheduler's state:
round trip, ``latest_epoch``, step checkpoints listed in order and pruned,
the LR rule against the JAX package's, the three resume modes, a save
killed before its rename, and a ``BRDFTrainStep`` restored from a
checkpoint whose next steps are bit-equal to the uninterrupted run's,
the LR schedule's position included.  The nets run at 32x32 on the CPU;
each compared convolution shape is warmed first (ROADMAP C12), and the
bitwise comparison runs on one thread: with 6 or 8 threads, torch's CPU
convolutions give the encoder's gradient another rounding from call to
call on the same inputs at this size (the decoders' gradients stay
equal), which no resume could reproduce.
"""

import argparse
import os
import os.path as osp
import shutil

import numpy as np
import pytest
import torch

from inverserenderingofindoorscene_tpu.utils import checkpoint as jckpt
from inverserenderingofindoorscene_torch.cli import common
from inverserenderingofindoorscene_torch.data.synthetic import synthetic_batch
from inverserenderingofindoorscene_torch.pipeline.brdf import BRDFNets
from inverserenderingofindoorscene_torch.train.steps import BRDFTrainStep
from inverserenderingofindoorscene_torch.utils import checkpoint as ckpt

HW = (32, 32)


class Small(torch.nn.Module):
    def __init__(self, seed=0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.conv = torch.nn.Conv2d(3, 4, 3)
        self.norm = torch.nn.GroupNorm(2, 4)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=gen))


def small_state(seed=0, steps=1):
    """A Small module after ``steps`` Adam steps, its optimizer and its
    schedule (halving every 2 steps)."""
    from inverserenderingofindoorscene_torch.train.steps import (
        reference_adam,
    )

    nets = Small(seed)
    opt, sched = reference_adam(nets.parameters(), 1e-2, epoch_decay_steps=2)
    for _ in range(steps):
        opt.zero_grad()
        sum((p * p).sum() for p in nets.parameters()).backward()
        opt.step()
        sched.step()
    return nets, opt, sched


def assert_modules_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_roundtrip_and_latest_epoch(tmp_path):
    exp = str(tmp_path / "exp")
    nets, opt, sched = small_state(steps=3)
    assert ckpt.latest_epoch(exp, "brdf", 0) is None
    ckpt.save_checkpoint(exp, "brdf", 0, 3, ckpt.train_state(nets, opt,
                                                             sched))
    ckpt.save_checkpoint(exp, "brdf", 0, 7, ckpt.train_state(nets, opt,
                                                             sched))
    ckpt.save_checkpoint(exp, "light", 0, 9, ckpt.train_state(nets, opt))
    assert ckpt.latest_epoch(exp, "brdf", 0) == 7
    assert ckpt.latest_epoch(exp, "brdf", 1) is None
    assert osp.isfile(osp.join(exp, "brdf0_7", ckpt.STATE_FILE))

    fresh, fopt, fsched = small_state(seed=1, steps=0)
    state = ckpt.restore_checkpoint(exp, "brdf", 0, 7)
    assert state["epoch"] == 7
    ckpt.load_train_state(state, fresh, fopt, fsched)
    assert_modules_equal(fresh, nets)
    assert fsched.last_epoch == sched.last_epoch == 3
    assert fopt.param_groups[0]["lr"] == opt.param_groups[0]["lr"] == 5e-3
    for p, q in zip(fresh.parameters(), nets.parameters()):
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(fopt.state[p][k], opt.state[q][k])
    # a light checkpoint saved without a scheduler leaves one untouched
    ckpt.load_train_state(ckpt.restore_checkpoint(exp, "light", 0, 9),
                          fresh, fopt, fsched)
    assert fsched.last_epoch == 3


def test_killed_save_keeps_the_previous_checkpoint(tmp_path, monkeypatch):
    """A save killed before its rename leaves the previous state readable
    and the half-written directory unlisted."""
    exp = str(tmp_path / "exp")
    nets, opt, sched = small_state()
    ckpt.save_checkpoint(exp, "brdf", 0, 0, ckpt.train_state(nets, opt))

    def killed(src, dst):
        raise KeyboardInterrupt

    monkeypatch.setattr(os, "replace", killed)
    with pytest.raises(KeyboardInterrupt):
        ckpt.save_checkpoint(exp, "brdf", 0, 1, ckpt.train_state(nets, opt))
    with pytest.raises(KeyboardInterrupt):
        ckpt.save_step_checkpoint(exp, "brdf", 0, ckpt.train_state(nets, opt),
                                  1, 0)
    monkeypatch.undo()
    assert osp.isdir(osp.join(exp, "brdf0_1"))
    assert ckpt.latest_epoch(exp, "brdf", 0) == 0
    assert ckpt.list_step_checkpoints(exp, "brdf", 0) == []
    ckpt.load_train_state(ckpt.restore_checkpoint(exp, "brdf", 0, 0),
                          Small(1))


def test_step_checkpoints_listed_and_pruned(tmp_path):
    exp = str(tmp_path / "exp")
    nets, opt, _ = small_state()
    assert ckpt.list_step_checkpoints(exp, "brdf", 0) == []
    for e, j in [(0, 1), (0, 10), (0, 3), (1, 0)]:
        ckpt.save_step_checkpoint(exp, "brdf", 0, ckpt.train_state(nets, opt),
                                  e, j, keep=3)
    # numeric order, not name order; the oldest of four pruned
    assert ckpt.list_step_checkpoints(exp, "brdf", 0) == [(0, 3), (0, 10),
                                                          (1, 0)]
    ckpt.save_step_checkpoint(exp, "brdf", 0, ckpt.train_state(nets, opt),
                              1, 1)  # keep=2
    assert ckpt.list_step_checkpoints(exp, "brdf", 0) == [(1, 0), (1, 1)]
    assert not osp.exists(osp.join(exp, "brdf0_step_0_3"))
    # epoch checkpoints are not step checkpoints, and the other way round
    ckpt.save_checkpoint(exp, "brdf", 0, 4, ckpt.train_state(nets, opt))
    assert ckpt.latest_epoch(exp, "brdf", 0) == 4
    assert ckpt.list_step_checkpoints(exp, "brdf", 1) == []
    state, e, j = ckpt.restore_step_checkpoint(exp, "brdf", 0, 1, 1)
    assert (e, j) == (1, 1) and state["j"] == 1


def test_lr_scale_equals_jax():
    for epoch in range(41):
        assert ckpt.lr_scale_for_epoch(epoch) == jckpt.lr_scale_for_epoch(
            epoch)
    assert ckpt.lr_scale_for_epoch(9) == 0.5


def _opt(mode):
    return argparse.Namespace(resume=mode)


@pytest.mark.parametrize("mode", ["epoch", "auto", "none"])
def test_resume_train_state_modes(tmp_path, mode):
    """Each mode's choice: 'epoch' the last epoch checkpoint (next epoch,
    step 0); 'auto' a step checkpoint newer than it (its epoch, the next
    step), else the epoch checkpoint; 'none' nothing.  The state loads
    into the nets, the optimizer and the schedule."""
    exp = str(tmp_path / "exp")
    nets, opt, sched = small_state(seed=0, steps=2)
    ckpt.save_checkpoint(exp, "brdf", 0, 0, ckpt.train_state(nets, opt,
                                                             sched))
    later, lopt, lsched = small_state(seed=2, steps=5)
    ckpt.save_step_checkpoint(exp, "brdf", 0,
                              ckpt.train_state(later, lopt, lsched), 1, 2)

    def resume(**kw):
        fresh, fopt, fsched = small_state(seed=3, steps=0)
        pos = common.resume_train_state(_opt(mode), exp, "brdf", 0, fresh,
                                        fopt, fsched, **kw)
        return pos, fresh, fsched

    pos, fresh, fsched = resume()
    if mode == "none":
        assert pos == (0, 0)
        assert fsched.last_epoch == 0
    elif mode == "epoch":
        assert pos == (1, 0)
        assert_modules_equal(fresh, nets)
        assert fsched.last_epoch == 2
    else:  # the step checkpoint (1, 2) goes on at (1, 3) > (1, 0)
        assert pos == (1, 3)
        assert_modules_equal(fresh, later)
        assert fsched.last_epoch == 5
    if mode != "none":
        # an explicit epoch wins over any step checkpoint
        pos, fresh, _ = resume(explicit_epoch=0)
        assert pos == (1, 0)
        assert_modules_equal(fresh, nets)


def test_resume_auto_prefers_a_newer_epoch_checkpoint(tmp_path):
    exp = str(tmp_path / "exp")
    nets, opt, sched = small_state(steps=2)
    ckpt.save_step_checkpoint(exp, "light", 1,
                              ckpt.train_state(nets, opt, sched), 0, 5)
    ckpt.save_checkpoint(exp, "light", 1, 0, ckpt.train_state(nets, opt,
                                                              sched))
    fresh, fopt, fsched = small_state(seed=3, steps=0)
    assert common.resume_train_state(_opt("auto"), exp, "light", 1, fresh,
                                     fopt, fsched) == (1, 0)
    assert common.resume_train_state(_opt("auto"), str(tmp_path / "none"),
                                     "light", 1, fresh, fopt,
                                     fsched) == (0, 0)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_restored_brdf_step_continues_bit_equal(tmp_path, one_thread):
    """A BRDFTrainStep restored from a checkpoint into fresh nets (another
    seed) takes the same next steps as the uninterrupted one, bit for
    bit, across the LR schedule's halving (every 2 steps)."""
    batches = [{k: v for k, v in synthetic_batch(
        batch=1, im_hw=HW, env_rc=(16, 16), seed=s, device="cpu").items()
        if k in ("im", "albedo", "normal", "rough", "depth", "seg_area",
                 "seg_env", "seg_brdf", "seg_all")} for s in range(4)]

    def make(seed):
        return BRDFTrainStep(BRDFNets(0, generator=torch.Generator()
                                      .manual_seed(seed)),
                             device="cpu", epoch_decay_steps=2)

    make(9)(batches[0])  # warms every convolution shape (C12)
    run = make(0)
    run(batches[0])
    ckpt.save_checkpoint(str(tmp_path), "brdf", 0, 0, ckpt.train_state(
        run.brdf_nets, run.optimizer, run.scheduler))
    resumed = make(1)
    ckpt.load_train_state(ckpt.restore_checkpoint(str(tmp_path), "brdf", 0, 0,
                                                  map_location="cpu"),
                          resumed.brdf_nets, resumed.optimizer,
                          resumed.scheduler)
    for b in batches[1:]:
        want, got = run(b), resumed(b)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        assert (resumed.optimizer.param_groups[0]["lr"]
                == run.optimizer.param_groups[0]["lr"])
        assert_modules_equal(resumed.brdf_nets, run.brdf_nets)
    assert run.optimizer.param_groups[0]["lr"] == 1e-4 * 0.25
    assert np.isfinite(float(want["total"]))
    shutil.rmtree(tmp_path)  # ~540 MB
