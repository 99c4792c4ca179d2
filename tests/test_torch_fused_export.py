"""The fused chain's export (``InverseRenderer.serialize`` ->
``deserialize_chain``) and ``render_sg_env`` as a ``torch.library``
custom op, on the CPU.

Mirrors the export check of tests/test_pipeline.py:321-341: the chain
exported at B=2 and served from the bytes and the weights alone, against
the fused call, c_light rtol 1e-5 and the final albedo atol 1e-6 (the
same float32 ops, run by the exported graph), after a warm-up call of
every convolution shape (ROADMAP C12).  Nets and sizes are those of
tests/test_torch_inference.py.  On the kernel route the program holds
``render_sg_env`` as the op ``irois_torch::render_sg_env``, twice a call,
whose CPU implementation is the plain version.  torch runs one thread
here (tests/test_torch_fused.py says why).
"""

import io

import numpy as np
import pytest
import torch

from inverserenderingofindoorscene_torch.models import lightnet, mgnet
from inverserenderingofindoorscene_torch.ops import sg_render
from inverserenderingofindoorscene_torch.pipeline.brdf import BRDFNets
from inverserenderingofindoorscene_torch.pipeline.inference import (
    InverseRenderer,
    deserialize_chain,
)
from inverserenderingofindoorscene_torch.pipeline.light import LightNets
from test_torch_cli_train import one_thread_module  # noqa: F401

IM_HW = (64, 64)
ENV_RC = (32, 32)
ROUTES = {"kernels": True, "plain": False}


@pytest.fixture(scope="module")
def port_stacks():
    out = []
    for lvl in range(2):
        gen = torch.Generator().manual_seed(10 + lvl)
        out.append((BRDFNets(lvl, generator=gen),
                    LightNets(cascade_level=lvl, env_rows=ENV_RC[0],
                              env_cols=ENV_RC[1], generator=gen)))
    return out


@pytest.fixture(scope="module")
def batch2():
    rng = np.random.RandomState(7)
    return (torch.from_numpy(rng.rand(2, *IM_HW, 3).astype(np.float32)
                             ** 2.2),
            torch.from_numpy(rng.rand(2, *ENV_RC, 3).astype(np.float32)
                             ** 2.2))


@pytest.mark.parametrize("route", list(ROUTES))
def test_serialize_round_trip(port_stacks, batch2, route, monkeypatch):
    r = InverseRenderer(port_stacks, is_light=True, fused=True,
                        use_kernels=ROUTES[route], device="cpu")
    r(*batch2)  # warm-up: each convolution shape (ROADMAP C12)
    want = r(*batch2)
    blob, params = r.serialize(IM_HW, ENV_RC, fov=57.0, batch=2)
    assert isinstance(blob, bytes) and len(blob) > 0
    # the weights are the program's inputs, not part of the bytes
    assert len(blob) < sum(p.numel() * 4 for p in params.values()) / 10
    ops = [n.target for n in torch.export.load(io.BytesIO(blob)).graph.nodes
           if n.op == "call_function"]
    n_ops = ops.count(torch.ops.irois_torch.render_sg_env.default)
    assert n_ops == (2 if ROUTES[route] else 0)

    # served from the bytes and the weights, none of the nets called
    def no_net(self, *a, **kw):
        raise AssertionError(f"{type(self).__name__} called")

    for cls in (BRDFNets, LightNets, mgnet.Encoder, mgnet.Decoder,
                lightnet.LightEncoder, lightnet.LightDecoder):
        monkeypatch.setattr(cls, "forward", no_net)
    served = deserialize_chain(blob)(params, *batch2)
    assert served["light"] is served["lights"][-1]
    np.testing.assert_allclose(served["light"]["c_light"].numpy(),
                               want["light"]["c_light"].numpy(), rtol=1e-5)
    np.testing.assert_allclose(served["preds"][-1]["albedo"].numpy(),
                               want["preds"][-1]["albedo"].numpy(),
                               atol=1e-6)


def test_serialize_needs_fused(port_stacks):
    r = InverseRenderer(port_stacks[:1], is_light=True, device="cpu")
    with pytest.raises(ValueError, match="fused=True"):
        r.serialize(IM_HW, ENV_RC)


def _shading_inputs(b=2, h=5, w=7, k=4):
    g = torch.Generator().manual_seed(3)
    normal = torch.rand((b, h, w, 3), generator=g) - 0.5
    normal = 0.9 * normal / normal.norm(dim=-1, keepdim=True)
    axis = torch.rand((b, h, w, k, 3), generator=g) - 0.5
    return (torch.rand((b, h, w, 3), generator=g), normal,
            torch.rand((b, h, w, 1), generator=g) * 2 - 1,
            axis / axis.norm(dim=-1, keepdim=True),
            torch.rand((b, h, w, k), generator=g) * 20,
            torch.rand((b, h, w, k, 3), generator=g) * 2)


def test_render_sg_env_op_cpu_is_the_plain_version():
    args = _shading_inputs()
    before = sg_render.render_sg_env.launches
    got = torch.ops.irois_torch.render_sg_env(*args, 57.0, 0.05, 8, 16)
    assert sg_render.render_sg_env.launches == before
    for g, w in zip(got, sg_render.render_sg_env_plain(*args)):
        assert torch.equal(g, w)


def test_render_sg_env_op_fake_shapes():
    """The fake implementation, which ``torch.export`` traces with, gives
    the kernel's output shapes: diffuse, specular [B,H,W,3], the envmap
    [B,H,W,eh*ew,3]."""
    args = [x.to("meta") for x in _shading_inputs(b=3, h=4, w=6, k=5)]
    out = torch.ops.irois_torch.render_sg_env(*args, 42.75, 0.05, 4, 8)
    assert [tuple(x.shape) for x in out] == [(3, 4, 6, 3), (3, 4, 6, 3),
                                              (3, 4, 6, 32, 3)]
    assert all(x.dtype == torch.float32 for x in out)


def test_tables_made_while_tracing_are_not_kept():
    """A constant table first asked for while ``torch.export`` traces is
    the trace's fake tensor: it is not kept, and the next eager call
    makes (and keeps) the real one."""
    from inverserenderingofindoorscene_torch.core import camera, tables

    key = (3, 5, 33.0, torch.float32, torch.device("cpu"))

    class AddView(torch.nn.Module):
        def forward(self, x):
            return x + tables.view(*key)

    torch.export.export(AddView(), (torch.zeros(3, 5, 3),))
    got = tables.view(*key)
    want = torch.as_tensor(camera.view_dirs(3, 5, 33.0), dtype=torch.float32)
    assert type(got) is torch.Tensor and torch.equal(got, want)
    assert tables.view(*key) is got


def test_tables_made_in_inference_mode_serve_autograd():
    """A table first made under ``torch.inference_mode`` (a served
    request) is read by a differentiable call after (a training step)."""
    from inverserenderingofindoorscene_torch.core import sg, tables

    key = (3, 7, torch.float64, torch.device("cpu"))
    with torch.inference_mode():
        assert not tables.hemisphere(*key).is_inference()
    axis = torch.rand((2, 4, 3), dtype=torch.float64, requires_grad=True)
    lamb = torch.rand((2, 4), dtype=torch.float64) * 10
    env = sg.sg_to_envmap(axis, lamb, torch.rand((2, 4, 3),
                                                 dtype=torch.float64), 3, 7)
    env.sum().backward()
    assert torch.isfinite(axis.grad).all()
