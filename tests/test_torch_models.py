"""Port networks vs the flax modules on shared weights.

The port's modules draw their weights from a seeded generator; the JAX
package's own converter for reference checkpoints
(``utils/torch_import.py``) carries them into flax param trees, so the
module semantics are checked against a mapping this package did not
write.  ``utils.weights`` (the inverse direction) must then give the
state dicts back bit for bit.  Both networks run the same numpy input
(NHWC for flax, NCHW for the port); rtol/atol 1e-4, because the two
frameworks' f32 convolutions and GroupNorms sum in different orders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from inverserenderingofindoorscene_tpu.models import lightnet as jlightnet
from inverserenderingofindoorscene_tpu.models import mgnet as jmgnet
from inverserenderingofindoorscene_tpu.utils import torch_import
from inverserenderingofindoorscene_torch.models import lightnet, mgnet
from inverserenderingofindoorscene_torch.utils import weights

TOL = dict(rtol=1e-4, atol=1e-4)
LIGHT_HW = (128, 128)
ENV_HW = (32, 32)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def seeded(module, seed):
    return mgnet.init_weights(module, torch.Generator().manual_seed(seed)).eval()


def np_state(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


def apply(module, params, *args):
    return jax.jit(lambda p: module.apply(p, *args))(params)


# name -> (port module, flax module, the JAX package's converter of
# reference state dicts, the port converter's name map)
MODULES = {
    "encoder3": (lambda: mgnet.Encoder(3), lambda: jmgnet.Encoder(3),
                 torch_import.encoder_params, weights.ENCODER_NAMES),
    "encoder17": (lambda: mgnet.Encoder(17), lambda: jmgnet.Encoder(17),
                  torch_import.encoder_params, weights.ENCODER_NAMES),
    "light_encoder0": (lambda: lightnet.LightEncoder(12, 0),
                       lambda: jlightnet.LightEncoder(12, 0),
                       torch_import.light_encoder_params,
                       weights.LIGHT_ENCODER_NAMES),
    "light_encoder1": (lambda: lightnet.LightEncoder(12, 1),
                       lambda: jlightnet.LightEncoder(12, 1),
                       torch_import.light_encoder_params,
                       weights.LIGHT_ENCODER_NAMES),
}
for _mode in (0, 1, 2, 4):
    MODULES[f"decoder{_mode}"] = (
        lambda m=_mode: mgnet.Decoder(m), lambda m=_mode: jmgnet.Decoder(m),
        torch_import.decoder_params, weights.DECODER_NAMES)
for _mode in (0, 1, 2):
    MODULES[f"light_decoder{_mode}"] = (
        lambda m=_mode: lightnet.LightDecoder(12, m),
        lambda m=_mode: jlightnet.LightDecoder(12, m),
        torch_import.light_decoder_params, weights.DECODER_NAMES)


def build(name, seed):
    """(port module, flax module, flax params) on shared weights."""
    make_port, make_flax, to_flax, _ = MODULES[name]
    port = seeded(make_port(), seed)
    return port, make_flax(), to_flax(np_state(port))


@pytest.mark.parametrize("name", list(MODULES))
def test_converter_round_trip(name):
    """utils.weights inverts the JAX package's converter exactly: every
    flax leaf maps to one key, and strict loading succeeds."""
    port, _, params = build(name, 1)
    sd = weights.module_state_dict(jax.tree.map(np.asarray, params),
                                   MODULES[name][3])
    assert len(sd) == len(jax.tree.leaves(params))
    ref = port.state_dict()
    assert all(torch.equal(sd[k], ref[k]) for k in ref)
    MODULES[name][0]().load_state_dict(sd, strict=True)


@pytest.fixture(scope="module")
def encoders():
    """{in_ch: (port, flax module, flax params)}; conv params do not depend
    on the input size, so one set serves every test size."""
    return {3: build("encoder3", 2), 17: build("encoder17", 3)}


@pytest.mark.parametrize("in_ch", [3, 17])
def test_encoder_matches_flax(encoders, in_ch):
    tenc, enc, jp = encoders[in_ch]
    x = np.random.RandomState(0).rand(1, 64, 64, in_ch).astype(np.float32)
    want = apply(enc, jp, jnp.asarray(x))
    with torch.no_grad():
        got = tenc(nchw(x))
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), err_msg=f"x{i+1}",
                                   **TOL)


# 48x80 collapses x5 to 1x2, so the 2x upsample misses x4's 3x5 and the
# _match_hw resize runs
@pytest.mark.parametrize("mode,hw", [(0, (64, 64)), (1, (64, 64)),
                                     (2, (64, 64)), (4, (64, 64)),
                                     (0, (48, 80))])
def test_decoder_matches_flax(encoders, mode, hw):
    tenc, enc, jp = encoders[3]
    x = np.random.RandomState(1).rand(1, *hw, 3).astype(np.float32)
    feats = apply(enc, jp, jnp.asarray(x))
    tdec, dec, dp = build(f"decoder{mode}", 10 + mode)
    want = np.asarray(apply(dec, dp, jnp.asarray(x), feats))
    with torch.no_grad():
        got = tdec(nchw(x), tenc(nchw(x)))
    np.testing.assert_allclose(nhwc(got), want, **TOL)


@pytest.fixture(scope="module")
def light_feats():
    """{cascade level: (flax features, port features)} on one input."""
    rng = np.random.RandomState(3)
    x = rng.rand(1, *LIGHT_HW, 11).astype(np.float32)
    env_pre = rng.rand(1, *ENV_HW, 84).astype(np.float32)
    out = {}
    for level in (0, 1):
        tenc, enc, jp = build(f"light_encoder{level}", 20 + level)
        j_env = jnp.asarray(env_pre) if level else None
        with torch.no_grad():
            tfeats = tenc(nchw(x), nchw(env_pre) if level else None)
        out[level] = (apply(enc, jp, jnp.asarray(x), j_env), tfeats)
    return out


@pytest.mark.parametrize("cascade_level", [0, 1])
def test_light_encoder_matches_flax(light_feats, cascade_level):
    feats, tfeats = light_feats[cascade_level]
    for i, (g, w) in enumerate(zip(tfeats, feats)):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), err_msg=f"x{i+1}",
                                   **TOL)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_light_decoder_matches_flax(light_feats, mode):
    feats, tfeats = light_feats[0]
    tdec, dec, dp = build(f"light_decoder{mode}", 30 + mode)
    want = np.asarray(apply(dec, dp, feats, ENV_HW))
    with torch.no_grad():
        got = nhwc(tdec(tfeats, ENV_HW))
    np.testing.assert_allclose(got.reshape(want.shape), want, **TOL)


def test_seeded_init_is_reproducible():
    """Weights come from the generator alone: equal seeds, equal weights."""
    a = seeded(mgnet.Encoder(3), 3).state_dict()
    b = seeded(mgnet.Encoder(3), 3).state_dict()
    c = seeded(mgnet.Encoder(3), 4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1.weight"], c["conv1.weight"])
    std = float(a["conv6.weight"].std())
    np.testing.assert_allclose(std, (512 * 9) ** -0.5, rtol=0.01)
