"""The port's convergence harness (``cli/run_convergence.py``) end to end
on the CPU, at a tiny size: image 64x64, lighting grid 32x32, one TRAIN
scene of 4 images and a TEST scene of 4, one epoch a leg, and every leg
of the full recipe, the cascade-1 ones included (h5py imports here).  The
IIW and NYU fixtures are cut to 4 TRAIN and 2 TEST frames.

This is plumbing, not a learning gate: it holds the summary to the JAX
record's schema (``docs/convergence_r5.json``: its stage keys, and each
stage's keys), ``not_run`` to empty, and the start-up refusal of the
cascade-1 legs where h5py does not import.  Learning is gated on the card
(``chip_smoke.py`` phase 12), as the JAX package keeps its own gate
(tests/test_convergence.py) out of the quick suite.  torch runs on one
thread, as in the CLI test files: under the six-worker run the CLIs'
small ops slowed 8-25x with the default threads.  The CLIs' epoch
checkpoints keep the nets alone here: the harness reads nothing else
(every run starts in a fresh experiment dir, and the evaluations, the
fine-tunes' start points and the capstone load nets), and the Adam
moments would triple the run's ~2 GB of checkpoints, which shares the
disk with the other test files' (tests/test_torch_checkpoint.py holds
the full state).
"""

import builtins
import functools
import json
import os.path as osp
import shutil

import pytest
import torch

from inverserenderingofindoorscene_torch.cli import run_convergence
from inverserenderingofindoorscene_torch.data import fixture
from inverserenderingofindoorscene_torch.utils import checkpoint as ckpt

R5 = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "docs",
              "convergence_r5.json")
TINY = [
    "--device", "cpu", "--imHeight", "64", "--imWidth", "64",
    "--envRow", "32", "--envCol", "32", "--scenes", "1", "--perScene", "4",
    "--brdfEpochs", "1", "--brdfBatch", "2", "--lightEpochs", "1",
    "--lightBatch", "2", "--bsEpochs", "1", "--bsBatch", "2",
    "--brdf1Epochs", "1", "--light1Epochs", "1", "--nyuEpochs", "1",
    "--nyuBatch", "2", "--iiwEpochs", "1", "--iiwBatch", "2",
    "--b20Batch", "4", "--bsMidEpochs", "1",
]
ALL_LEGS = ["--cascade1", "--lightB20", "--bsMid", "--finetuneNYU",
            "--finetuneIIW", "--finetuneNYU1", "--finetuneIIW1",
            "--capstone"]


@pytest.fixture(scope="module")
def r5():
    with open(R5) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(summary returned, summary.json on disk) of one tiny run, its dir
    removed at the end."""
    pytest.importorskip("h5py")
    pytest.importorskip("cv2")
    out = tmp_path_factory.mktemp("conv")
    mp = pytest.MonkeyPatch()
    mp.setattr(fixture, "write_iiw_fixture", functools.partial(
        fixture.write_iiw_fixture, n_train=4, n_test=2))
    mp.setattr(fixture, "write_nyu_fixture", functools.partial(
        fixture.write_nyu_fixture, n_train=4, n_test=2))
    save = ckpt.save_checkpoint
    mp.setattr(ckpt, "save_checkpoint",
               lambda exp, stage, cascade, epoch, state: save(
                   exp, stage, cascade, epoch, {"nets": state["nets"]}))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        summary = run_convergence.main(["--out", str(out)] + TINY + ALL_LEGS)
        with open(osp.join(out, "summary.json")) as f:
            on_disk = json.load(f)
    finally:
        torch.set_num_threads(n)
        mp.undo()
        shutil.rmtree(out, ignore_errors=True)
    return summary, on_disk


def test_every_leg_recorded_with_r5_keys(run, r5):
    summary, on_disk = run
    assert set(on_disk["stages"]) == set(r5["stages"]) == set(
        run_convergence.STAGES)
    for name, want in r5["stages"].items():
        got = on_disk["stages"][name]
        assert set(got) == set(want), name
        for part in ("init_test", "trained_test", "test_improvement",
                     "init_products", "trained_products",
                     "product_improvement", "trained_raw", "refined_vs_raw",
                     "vs_base_batch"):
            if part in want:
                assert set(got[part]) == set(want[part]), (name, part)
        if "loss" in want:
            assert set(got["loss"]) == set(want["loss"]), name
            assert got["loss"]["steps"] >= 1, name
    assert summary["stages"].keys() == on_disk["stages"].keys()


def test_config_names_device_and_torch(run, r5):
    _, on_disk = run
    cfg = on_disk["config"]
    assert set(r5["config"]) - {"platform"} <= set(cfg)
    assert cfg["device"] == "cpu"
    assert cfg["torch"] == torch.__version__
    assert cfg["computeDtype"] == "bfloat16"


def test_not_run_is_empty_here(run):
    summary, on_disk = run
    assert on_disk["not_run"] == {} == summary["not_run"]


def test_cascade1_legs_need_h5py_at_start_up(tmp_path, monkeypatch):
    """Where h5py does not import, asking for a cascade-1 leg stops
    before the fixture is written."""
    real_import = builtins.__import__

    def no_h5py(name, *a, **kw):
        if name == "h5py":
            raise ImportError("no h5py")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    for leg in ("--cascade1", "--finetuneNYU1", "--finetuneIIW1"):
        out = tmp_path / leg.strip("-")
        with pytest.raises(ImportError, match="h5py does not import"):
            run_convergence.main(["--out", str(out), "--device", "cpu",
                                  leg])
        assert not osp.exists(out / "fixture")


def test_not_run_names_the_reason():
    """Legs not recorded, with h5py missing and present."""
    opt = run_convergence.parse_args(["--device", "cpu", "--bsMid"])
    summary = {"stages": {"brdf": {}, "light": {}, "bilateral": {}}}
    got = run_convergence.not_run(opt, summary, h5py_ok=False)
    assert got["brdf1"] == got["finetune_iiw1"] == run_convergence.NO_H5PY
    assert got["bilateral_mid"] == "its prerequisite stage did not run"
    assert got["capstone"] == "not asked for"
    assert "brdf" not in got
    got = run_convergence.not_run(opt, summary, h5py_ok=True)
    assert got["brdf1"] == "not asked for"
