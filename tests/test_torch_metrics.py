"""The port's benchmark metrics vs the JAX package's ``eval/metrics.py``:
WHDR, the masked normal angle and the scale-invariant log-depth RMSE,
bit-equal (the same numpy arithmetic on the same arrays).

WHDR runs on the judgement JSONs of ``data/fixture.write_iiw_fixture``
(judgements classified from the fixture's true reflectance) and on those
of the port's ``synthetic_iiw_batch``, against random, constant and
fixture reflectance maps.
"""

import json
import os.path as osp

import numpy as np
import pytest

from inverserenderingofindoorscene_tpu.data.fixture import write_iiw_fixture
from inverserenderingofindoorscene_tpu.eval import metrics as jmetrics
from inverserenderingofindoorscene_torch.data.synthetic import (
    synthetic_iiw_batch,
)
from inverserenderingofindoorscene_torch.eval import metrics

FRAME_HW = (48, 64)


@pytest.fixture(scope="module")
def iiw_fixture(tmp_path_factory):
    pytest.importorskip("cv2")  # the fixture writer's image encoder
    root = str(tmp_path_factory.mktemp("iiw"))
    write_iiw_fixture(root, n_train=2, n_test=1, frame_hw=FRAME_HW,
                      n_pairs=60)
    names = open(osp.join(root, "IIWTrain.txt")).read().split()
    names += open(osp.join(root, "IIWTest.txt")).read().split()
    out = []
    for name in names:
        with open(osp.join(root, name.replace(".png", ".json"))) as f:
            out.append((osp.join(root, name), json.load(f)))
    return out


def reflectances(rng, hw, image=None):
    maps = {"random": rng.uniform(0, 1, (*hw, 3)),
            "constant": np.full((*hw, 3), 0.5),
            "dark rows": np.concatenate([np.full((hw[0] // 2, hw[1], 3), 0.2),
                                         np.ones((hw[0] - hw[0] // 2, hw[1],
                                                  3))])}
    if image is not None:
        maps["image"] = image
    return maps


def test_whdr_on_fixture_judgements(iiw_fixture):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(0)
    n = 0
    for path, judgements in iiw_fixture:
        image = cv2.imread(path)[:, :, ::-1].astype(np.float64) / 255.0
        for kind, refl in reflectances(rng, FRAME_HW, image).items():
            got = metrics.compute_whdr(refl, judgements)
            want = jmetrics.compute_whdr(refl, judgements)
            assert got == want, (kind, got, want)
            assert 0.0 <= got[0] <= 1.0
            n += 1
    assert n == 12


def test_whdr_on_synthetic_iiw_judgements():
    _, judgements = synthetic_iiw_batch(batch=2, im_hw=(32, 40), max_num=50,
                                        seed=2, device="cpu")
    rng = np.random.RandomState(1)
    for j in judgements:
        kinds = {c["darker"] for c in j["intrinsic_comparisons"]}
        assert kinds == {"1", "2", "E"}
        for kind, refl in reflectances(rng, (32, 40)).items():
            got = metrics.compute_whdr(refl, j)
            assert got == jmetrics.compute_whdr(refl, j), kind
    # no valid pair: both return None
    empty = {"intrinsic_points": [], "intrinsic_comparisons": []}
    assert metrics.compute_whdr(np.ones((4, 4, 3)), empty) is None
    assert jmetrics.compute_whdr(np.ones((4, 4, 3)), empty) is None


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_normal_angle_error_bit_equal(dtype):
    rng = np.random.RandomState(3)
    hw = (30, 40)
    gt = rng.uniform(-1, 1, (*hw, 3))
    gt[..., 2] = np.abs(gt[..., 2]) + 0.3
    pred = gt + rng.normal(0, 0.3, gt.shape)
    pred /= np.linalg.norm(pred, axis=-1, keepdims=True)
    mask = (rng.uniform(0, 1, hw) > 0.4).astype(dtype)
    args = (pred.astype(dtype), (gt * 127.5).astype(dtype), mask)
    got = metrics.normal_angle_error(*args)
    want = jmetrics.normal_angle_error(*args)
    assert got == want
    assert 0 < got[0] < 180 and 0 < got[1] < 180


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_si_log_depth_rmse_bit_equal(dtype):
    rng = np.random.RandomState(4)
    gt = rng.uniform(0.5, 11.0, (30, 40)).astype(dtype)  # some outside
    pred = (gt * rng.uniform(0.8, 1.25, gt.shape)).astype(dtype)
    got = metrics.si_log_depth_rmse(pred, gt)
    assert got == jmetrics.si_log_depth_rmse(pred, gt)
    assert got > 0
    assert metrics.si_log_depth_rmse(2.0 * gt, gt) < 1e-6
