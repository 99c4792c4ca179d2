"""The port's ``train_brdf`` CLI against the JAX package's, from the same
checkpoint, on the same files.

One JAX orbax checkpoint of a fresh ``TrainState`` (seeded BRDF params,
``reference_adam``'s state at count 0) and the port's checkpoint of the
same weights and moments (``utils/weights.brdf_state_dict``,
``BRDFTrainStep.load_optax_state``).  Both CLIs resume it
(``--resumeEpoch 0 --nepoch 2 --maxSteps 2 --batchSize 1``, float32) on
the tree of tests/test_torch_loaders.py (64x64) and log two steps of
epoch 1 over the same batches.  Their ``trainingLog.txt`` lines agree:
step 1's metrics within 1e-4 relative, step 2's within 1e-3, because the
second Adam update carries f32 differences of the first into the weights
(ROADMAP C6, 1.6e-3 relative L2 in the weights).  Its own file because it
compiles the JAX step (~1 min).
"""

import os.path as osp
import shutil

import numpy as np
import pytest
import torch

import jax

from inverserenderingofindoorscene_tpu.cli import train_brdf as jtrain_brdf
from inverserenderingofindoorscene_tpu.pipeline.brdf import BRDFNets as JBRDF
from inverserenderingofindoorscene_tpu.train.steps import (
    create_train_state,
    reference_adam,
)
from inverserenderingofindoorscene_tpu.utils import checkpoint as jckpt
from inverserenderingofindoorscene_torch.cli import train_brdf
from inverserenderingofindoorscene_torch.data.synthetic import synthetic_batch
from inverserenderingofindoorscene_torch.pipeline.brdf import BRDFNets
from inverserenderingofindoorscene_torch.train.steps import BRDFTrainStep
from inverserenderingofindoorscene_torch.utils import checkpoint as ckpt
from inverserenderingofindoorscene_torch.utils.weights import brdf_state_dict
from test_torch_loaders import ENV_RC, IM_HW, NIMG, write_dataset

DECAY = 10 * NIMG  # the CLIs' epoch_decay_steps at batch 1


def parse_log(path):
    """{"e/j": {metric: value}} of a trainingLog.txt."""
    out = {}
    for line in open(path).read().splitlines():
        tag, rest = line.split("] ", 1)
        out[tag.lstrip("[")] = {part.split()[0]: float(part.split()[1])
                                for part in rest.split(" | ")}
    return out


@pytest.fixture(autouse=True)
def _empty_tmp(tmp_path):
    """Four BRDF checkpoints with Adam moments, ~540 MB each: removed
    after the test."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_train_brdf_cli_tracks_jax(tmp_path):
    pytest.importorskip("cv2")
    data = write_dataset(tmp_path / "openrooms")
    np_params = jax.tree.map(
        lambda x: np.asarray(x).copy(),
        JBRDF(cascade_level=0, compute_dtype="float32").init(
            jax.random.PRNGKey(3), IM_HW))

    exp_j, exp_p = str(tmp_path / "jax"), str(tmp_path / "port")
    state = create_train_state(np_params, reference_adam(
        1e-4, epoch_decay_steps=DECAY))
    jckpt.save_checkpoint(exp_j, "brdf", 0, 0, state)
    adam = state.opt_state[0]

    nets = BRDFNets(0, generator=torch.Generator().manual_seed(1))
    nets.load_state_dict(brdf_state_dict(np_params))
    step = BRDFTrainStep(nets, device="cpu", epoch_decay_steps=DECAY)
    step.load_optax_state(jax.tree.map(np.asarray, adam.mu),
                          jax.tree.map(np.asarray, adam.nu), int(adam.count))
    ckpt.save_checkpoint(exp_p, "brdf", 0, 0, ckpt.train_state(
        step.brdf_nets, step.optimizer, step.scheduler))
    # warm the port's convolution shapes (ROADMAP C12) on a copy
    warm = BRDFTrainStep(BRDFNets(0), device="cpu")
    warm({k: v for k, v in synthetic_batch(batch=1, im_hw=IM_HW,
                                           env_rc=ENV_RC, device="cpu")
          .items() if k not in ("env_gt", "env_ind")})

    args = ["--dataRoot", data, "--imHeight", str(IM_HW[0]),
            "--imWidth", str(IM_HW[1]), "--envRow", str(ENV_RC[0]),
            "--envCol", str(ENV_RC[1]), "--batchSize", "1", "--nepoch", "2",
            "--maxSteps", "2", "--numWorkers", "0", "--resumeEpoch", "0",
            "--computeDtype", "float32", "--previewEvery", "0",
            "--logFlushSteps", "1"]
    jtrain_brdf.main(args + ["--experiment", exp_j])
    train_brdf.main(args + ["--experiment", exp_p, "--device", "cpu"])

    want = parse_log(osp.join(exp_j, "trainingLog.txt"))
    got = parse_log(osp.join(exp_p, "trainingLog.txt"))
    assert list(got) == list(want) == ["1/0", "1/1"]
    for tag, rtol in (("1/0", 1e-4), ("1/1", 1e-3)):
        assert list(got[tag]) == list(want[tag])
        for k, w in want[tag].items():
            np.testing.assert_allclose(got[tag][k], w, rtol=rtol,
                                       err_msg=f"{tag} {k}")
    assert ckpt.latest_epoch(exp_p, "brdf", 0) == 1
    assert jckpt.latest_epoch(exp_j, "brdf", 0) == 1
