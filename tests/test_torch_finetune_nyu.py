"""The port's NYU fine-tune vs the JAX package's: ``nyu_step`` at cascades
0 and 1 with the ground truth at 1x and 2x the input, and the step's
default device.  The alternating cycle on a shared Adam is held in
tests/test_torch_finetune.py with the IIW step: the NYU step shares its
update (``BRDFTrainStep.__call__``, a zero gradient for the decoders the
loss does not reach) and differs only in its loss, held here.

Weights, sizes and the cascade-1 ``*_pre`` maps as in
tests/test_torch_finetune.py, whose helpers this file uses.  The NYU
batches are ``synthetic_nyu_batch``: unit normals with z > 0, depth in
(1, 10) but for ~2% of the pixels, ``seg_depth`` = 1 < depth < 10, a
``seg_normal`` mask.

Tolerances, each measured here and stated with its test:
  * ``nyu_step``: normal, depth, angle_deg and the total rtol 1e-5 (4.4e-7
    measured), ``normal_full`` and ``depth_full`` atol 1e-4 as the BRDF
    predictions (tests/test_torch_cascade.py; 1.7e-5 measured), each net's
    gradient relative L2 2e-3, the BRDF step's tolerance and reason
    (9.6e-5 measured, the cascade-0 encoder with the ground truth at 2x).
"""

import numpy as np
import pytest
import torch

import jax

from inverserenderingofindoorscene_tpu.pipeline import finetune as jfinetune
from inverserenderingofindoorscene_tpu.pipeline.brdf import BRDFNets as JBRDF
from inverserenderingofindoorscene_torch.data.synthetic import (
    synthetic_nyu_batch,
)
from inverserenderingofindoorscene_torch.pipeline.brdf import BRDFNets
from inverserenderingofindoorscene_torch.pipeline.finetune import nyu_step
from inverserenderingofindoorscene_torch.train.steps import (
    make_nyu_train_step,
)
from test_torch_finetune import (
    IM_HW,
    flax_brdf,
    grads_match,
    port_loss,
    to_jax,
    with_pre,
)

NYU_KEYS = ("normal", "depth", "angle_deg")


def nyu_batch(scale, seed=0):
    gt_hw = (IM_HW[0] * scale, IM_HW[1] * scale)
    return synthetic_nyu_batch(batch=2, im_hw=IM_HW, gt_hw=gt_hw, seed=seed,
                               device="cpu")


def test_nyu_batch_has_the_loader_format():
    batch = nyu_batch(2)
    n, d = batch["normal"], batch["depth"]
    assert tuple(n.shape) == (2, 128, 128, 3)
    np.testing.assert_allclose(n.norm(dim=-1).numpy(), 1.0, rtol=1e-6)
    assert float(n[..., 2].min()) > 0
    inside = (d > 1) & (d < 10)
    assert 0.9 < float(inside.float().mean()) < 1.0
    assert torch.equal(batch["seg_depth"], inside.float())
    assert set(torch.unique(batch["seg_normal"]).tolist()) == {0.0, 1.0}


def _jax_nyu(jnets, params, batch):
    preds, losses = jfinetune.nyu_step(jnets, params, batch)
    total = 4.5 * losses["normal"] + 4.5 * losses["depth"]
    return total, (losses, {k: preds[k] for k in ("normal_full",
                                                  "depth_full")})


JAX_NYU_GRAD = jax.jit(jax.value_and_grad(_jax_nyu, argnums=1, has_aux=True),
                       static_argnums=0)


@pytest.fixture(scope="module", params=[(0, 1), (0, 2), (1, 1), (1, 2)],
                ids=["c0-gt1x", "c0-gt2x", "c1-gt1x", "c1-gt2x"])
def nyu_setup(request):
    level, scale = request.param
    nets = BRDFNets(level, generator=torch.Generator().manual_seed(70 + level))
    batch = nyu_batch(scale, seed=level + scale)
    if level:
        batch = with_pre(batch)
    (jtotal, (jlosses, jpreds)), jgrads = JAX_NYU_GRAD(
        JBRDF(cascade_level=level), flax_brdf(nets), to_jax(batch))
    nyu_step(nets, batch)  # C12
    with torch.no_grad():
        preds, _ = nyu_step(nets, batch)
    return {"port": port_loss(make_nyu_train_step, nets, batch),
            "preds": preds, "scale": scale,
            "jax": (jtotal, jlosses, jgrads, jpreds)}


def test_nyu_losses_match_jax(nyu_setup):
    total, losses, _ = nyu_setup["port"]
    jtotal, jlosses, _, _ = nyu_setup["jax"]
    assert sorted(losses) == sorted(NYU_KEYS)
    assert not losses["angle_deg"].requires_grad
    assert 0 < float(losses["angle_deg"]) < 180
    for k in NYU_KEYS:
        np.testing.assert_allclose(losses[k].detach().numpy(),
                                   float(jlosses[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(total.detach().numpy(), float(jtotal),
                               rtol=1e-5)


def test_nyu_full_size_preds_match_jax(nyu_setup):
    preds, jpreds = nyu_setup["preds"], nyu_setup["jax"][3]
    hw = (IM_HW[0] * nyu_setup["scale"], IM_HW[1] * nyu_setup["scale"])
    for k, c in (("normal_full", 3), ("depth_full", 1)):
        assert tuple(preds[k].shape) == (2, *hw, c), k
        np.testing.assert_allclose(preds[k].numpy(), np.asarray(jpreds[k]),
                                   atol=1e-4, err_msg=k)


def test_nyu_grads_match_jax(nyu_setup):
    grads_match(nyu_setup["port"][2], nyu_setup["jax"][2])


def test_nyu_angle_has_no_gradient_path():
    """A prediction equal to the ground truth puts cos at 1, where
    arccos's slope is infinite: the losses' gradients stay finite."""
    nets = BRDFNets(0, generator=torch.Generator().manual_seed(75))
    batch = nyu_batch(1, seed=8)
    with torch.no_grad():
        preds, _ = nyu_step(nets, batch)
    batch["normal"] = preds["normal_full"].clone()
    step = make_nyu_train_step(nets, device="cpu")
    total, losses = step.loss(batch)
    total.backward()
    assert float(losses["angle_deg"]) < 0.1
    reached = [n for n, p in nets.named_parameters() if p.grad is not None]
    assert {n.split(".")[0] for n in reached} == {"encoder", "normal",
                                                  "depth"}
    for n, p in nets.named_parameters():
        assert p.grad is None or torch.isfinite(p.grad).all(), n


def test_nyu_step_defaults_to_cuda():
    """No quiet move to the CPU: device=None means CUDA."""
    if torch.cuda.is_available():
        assert make_nyu_train_step(BRDFNets(0)).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_nyu_train_step(BRDFNets(0))
