"""The image ops' deterministic backwards (``core/imageops.py``).

The CUDA backwards of ``F.interpolate`` (bilinear, with or without
antialiasing), ``F.adaptive_avg_pool2d`` and ``F.pad(mode="replicate")``
add with atomics and have no deterministic path under
``torch.use_deterministic_algorithms(True)``; on the card they made the
BRDF step differ from run to run (ROADMAP C17).  The port's ops run the
same forward call and take the adjoint without atomics.  Held on the
CPU, at the shapes of the nets and odd ones:
  * the forward bit-equal to the plain ``F`` call;
  * the backward within relative L2 1e-6 of autograd's through the plain
    call in float32 (a float64 finite-difference ``gradcheck`` too), and
    a bf16 gradient returned in bf16;
  * one c0 BRDF step under ``torch.use_deterministic_algorithms(True)``
    raises nothing, and taken twice from one state and batch gives
    bit-equal gradients (one torch thread: ROADMAP C12);
  * ``cli.common.setup_device`` turns cuDNN's autotuning on only when the
    deterministic mode is off.
The port-against-JAX files that run these ops (test_torch_brdf_train.py,
test_torch_train.py, test_torch_bilateral.py, test_torch_finetune.py)
hold them at their own tolerances.
"""

import argparse

import pytest
import torch
import torch.nn.functional as F

from inverserenderingofindoorscene_torch.cli import common
from inverserenderingofindoorscene_torch.core import imageops
from inverserenderingofindoorscene_torch.data.synthetic import synthetic_batch
from inverserenderingofindoorscene_torch.pipeline.brdf import BRDFNets
from inverserenderingofindoorscene_torch.train.steps import (
    make_brdf_train_step,
)
from test_torch_cli_train import one_thread_module  # noqa: F401

REL_L2 = 1e-6

# (input [B,C,H,W], output (H', W')): odd sizes, the nets' 2x upsample,
# the antialiased shrinks (the light input's, the decoders' skips), an
# identity, and a shrink on one side with a stretch on the other
RESIZES = [
    ((2, 3, 7, 9), (14, 18)),
    ((2, 5, 15, 20), (30, 40)),
    ((1, 4, 13, 11), (26, 22)),
    ((2, 3, 24, 32), (7, 10)),
    ((1, 2, 64, 80), (32, 40)),
    ((1, 2, 9, 7), (18, 5)),
    ((1, 3, 5, 6), (5, 6)),
]
# the pool's ratios: 2 (the render layer at every cascade), 4, 3 and
# ratios that do not divide (adaptive bins of unequal width)
POOLS = [
    ((2, 3, 64, 80), (32, 40)),
    ((1, 3, 64, 64), (16, 16)),
    ((2, 1, 30, 45), (10, 15)),
    ((1, 3, 24, 32), (7, 10)),
    ((2, 2, 13, 11), (5, 4)),
]
PADS = [((2, 3, 5, 7), 1), ((1, 1, 1, 4), 1), ((2, 16, 33, 41), 1),
        ((1, 2, 6, 5), 2)]


def rel_l2(got, want):
    return float((got - want).norm() / want.norm())


def plain_resize(x, out_hw):
    shrinks = out_hw[0] < x.shape[-2] or out_hw[1] < x.shape[-1]
    return F.interpolate(x, size=out_hw, mode="bilinear",
                         align_corners=False, antialias=shrinks)


CASES = (
    [("resize", s, o) for s, o in RESIZES]
    + [("pool", s, o) for s, o in POOLS]
    + [("pad", s, p) for s, p in PADS]
)
OPS = {
    "resize": (imageops.resize_bilinear, plain_resize),
    "pool": (imageops.adaptive_avg_pool, F.adaptive_avg_pool2d),
    "pad": (imageops.replication_pad,
            lambda x, p: F.pad(x, (p, p, p, p), mode="replicate")),
}


@pytest.mark.parametrize("kind,shape,arg", CASES)
def test_forward_is_the_plain_call_and_backward_its_adjoint(kind, shape,
                                                            arg):
    ours, plain = OPS[kind]
    gen = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(shape, generator=gen, requires_grad=True)
    y = ours(x, arg)
    y0 = plain(x, arg)
    assert torch.equal(y, y0)
    g = torch.randn(y.shape, generator=gen)
    got, = torch.autograd.grad(y, x, g)
    want, = torch.autograd.grad(y0, x, g)
    assert rel_l2(got, want) <= REL_L2
    # no gradient asked: the plain call itself, no custom Function
    with torch.no_grad():
        assert torch.equal(ours(x, arg), y0)


@pytest.mark.parametrize("kind,shape,arg", [
    ("resize", (1, 2, 5, 7), (10, 14)),
    ("resize", (1, 2, 12, 9), (5, 4)),
    ("pool", (1, 2, 9, 7), (4, 3)),
    ("pad", (1, 2, 4, 3), 1),
])
def test_backward_passes_gradcheck(kind, shape, arg):
    x = torch.randn(shape, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    assert torch.autograd.gradcheck(lambda t: OPS[kind][0](t, arg), (x,))


def test_bf16_gradient_is_bf16():
    """A bf16 trunk's upsample (``compute_dtype`` bfloat16): the adjoint
    runs in float32 and returns bf16."""
    gen = torch.Generator().manual_seed(2)
    x32 = torch.randn((2, 8, 15, 20), generator=gen)
    x = x32.to(torch.bfloat16).requires_grad_()
    y = imageops.upsample2x(x)
    assert y.dtype == torch.bfloat16
    g = torch.randn(y.shape, generator=gen).to(torch.bfloat16)
    got, = torch.autograd.grad(y, x, g)
    assert got.dtype == torch.bfloat16
    x64 = x.detach().double().requires_grad_()
    want, = torch.autograd.grad(plain_resize(x64, (30, 40)), x64, g.double())
    assert rel_l2(got.double(), want) <= 1e-2


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def test_brdf_step_repeats_under_deterministic_algorithms(
        one_thread_module, deterministic):  # noqa: F811
    """The probe of ROADMAP C17 on the CPU: the c0 BRDF step's loss and
    backward, twice from one state and batch, bit-equal gradients in every
    net (after a warm call, C12)."""
    step = make_brdf_train_step(BRDFNets(0), device="cpu")
    batch = synthetic_batch(batch=2, im_hw=(32, 48), env_rc=(16, 24),
                            seed=3, device="cpu")
    grads = []
    for _ in range(3):
        step.loss(batch)[0].backward()
        grads.append([p.grad.clone() for p in step.brdf_nets.parameters()
                      if p.grad is not None])
        step.brdf_nets.zero_grad(set_to_none=True)
    assert len(grads[1]) == len(list(step.brdf_nets.parameters()))
    for a, b in zip(grads[1], grads[2]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", [False, True])
def test_setup_device_autotunes_only_outside_deterministic_mode(mode):
    before = torch.backends.cudnn.benchmark
    torch.use_deterministic_algorithms(mode)
    try:
        common.setup_device(argparse.Namespace(device="cpu"))
        assert torch.backends.cudnn.benchmark is (not mode)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.benchmark = before
