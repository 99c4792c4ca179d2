"""Carry the JAX package's parameters across to the port's modules.

The inverse of the JAX package's ``utils/torch_import.py``: flax param
trees, given as nested dicts of numpy arrays (``jax.tree.map(np.asarray,
params)``), become ``state_dict``s of :class:`BRDFNets` / :class:`LightNets` /
:class:`BilateralNets`:

  * conv kernels HWIO -> OIHW (transpose (3, 2, 0, 1)), biases as they are;
  * GroupNorm ``scale`` -> ``weight``;
  * flax's ``Conv_i``/``GroupNorm_i`` -> the reference names
    (``conv{i}``/``gn{i}``, ``dconv{i}``/``dgn{i}``/``dconvFinal``,
    ``preProcess.1/.2/.5/.6``, and the confidence nets' ``conv1/2``,
    ``dconv1/2``, ``dconvFinal``).

Every flax leaf maps to exactly one key, and an unknown layer raises, so
the result loads with ``load_state_dict(strict=True)``.  An optax Adam
state of the BRDF or light params becomes a ``torch.optim.Adam`` state
dict (:func:`brdf_adam_state_dict`, :func:`light_adam_state_dict`).  numpy
only: the port stays free of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

_LEAF = {
    ("Conv", "kernel"): "weight",
    ("Conv", "bias"): "bias",
    ("GroupNorm", "scale"): "weight",
    ("GroupNorm", "bias"): "bias",
}


def _names(first_conv: str, first_gn: str, n: int, final=None) -> dict:
    """flax layer name -> torch module name for n conv+GN blocks."""
    names = {}
    for i in range(n):
        names[f"Conv_{i}"] = f"{first_conv}{i + 1}"
        names[f"GroupNorm_{i}"] = f"{first_gn}{i + 1}"
    if final is not None:
        names[f"Conv_{n}"] = final
    return names


ENCODER_NAMES = _names("conv", "gn", 6)
DECODER_NAMES = _names("dconv", "dgn", 6, final="dconvFinal")
LIGHT_ENCODER_NAMES = {
    "Conv_0": "preProcess.1",
    "GroupNorm_0": "preProcess.2",
    "Conv_1": "preProcess.5",
    "GroupNorm_1": "preProcess.6",
    **{f"Conv_{i + 2}": f"conv{i + 1}" for i in range(6)},
    **{f"GroupNorm_{i + 2}": f"gn{i + 1}" for i in range(6)},
}

CONFIDENCE_NAMES = {
    "Conv_0": "conv1", "GroupNorm_0": "gn1",
    "Conv_1": "conv2", "GroupNorm_1": "gn2",
    "Conv_2": "dconv1", "GroupNorm_2": "dgn1",
    "Conv_3": "dconv2", "GroupNorm_3": "dgn2",
    "Conv_4": "dconvFinal",
}


def module_state_dict(flax_tree: dict, names: dict, prefix: str = "") -> dict:
    """One flax module's ``{"params": {layer: {leaf: array}}}`` ->
    ``{prefix + torch name: tensor}``."""
    out = {}
    for layer, leaves in flax_tree["params"].items():
        base = names[layer]  # KeyError: a layer the port does not have
        kind = layer.rsplit("_", 1)[0]
        for leaf, value in leaves.items():
            arr = np.array(value, dtype=np.float32)
            if kind == "Conv" and leaf == "kernel":
                arr = np.transpose(arr, (3, 2, 0, 1))
            key = f"{prefix}{base}.{_LEAF[(kind, leaf)]}"
            if key in out:
                raise ValueError(f"two flax leaves map to {key}")
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def brdf_state_dict(params: dict) -> dict:
    """JAX ``BRDFNets`` params -> port ``BRDFNets`` state dict (either
    cascade level: the cascade-1 encoder only has a wider ``conv1``).  Any
    tree shaped like the params (gradients, Adam moments) converts the
    same way."""
    sd = module_state_dict(params["encoder"], ENCODER_NAMES, "encoder.")
    for head in ("albedo", "normal", "rough", "depth"):
        sd.update(module_state_dict(params[head], DECODER_NAMES, f"{head}."))
    return sd


def light_state_dict(params: dict) -> dict:
    """JAX ``LightNets`` params -> port ``LightNets`` state dict (either
    cascade level: the cascade-1 encoder only has a wider ``conv1``).
    Any tree shaped like the params (gradients, Adam moments) converts the
    same way."""
    sd = module_state_dict(params["encoder"], LIGHT_ENCODER_NAMES, "encoder.")
    for head in ("axis", "lamb", "weight"):
        sd.update(module_state_dict(params[head], DECODER_NAMES, f"{head}."))
    return sd


def bilateral_state_dict(params: dict) -> dict:
    """JAX ``BilateralNets.init`` params ({"albedo", "rough", "depth"},
    each a flax ``ConfidenceNet``) -> port ``BilateralNets`` state dict.
    Gradient trees convert the same way."""
    sd = {}
    for mode in ("albedo", "rough", "depth"):
        sd.update(module_state_dict(params[mode], CONFIDENCE_NAMES,
                                    f"{mode}."))
    return sd


def adam_state_dict(optimizer: torch.optim.Adam, module, convert, mu: dict,
                    nu: dict, count: int) -> dict:
    """An optax Adam state of a JAX param tree -> the ``state_dict`` of
    ``optimizer``, a ``torch.optim.Adam`` over ``module``'s parameters.

    ``convert`` is the tree's state-dict converter (:func:`brdf_state_dict`,
    :func:`light_state_dict`).  ``mu`` and ``nu`` are optax's first and
    second moments as numpy trees shaped like the params, ``count`` its
    step count.  The moments are elementwise, so they take the params' own
    layout change (HWIO -> OIHW).  optax and torch apply the same update
    from these (bias correction by the count, eps outside the square
    root), so a JAX run resumed from its ``TrainState`` continues in the
    port: load the params with ``convert`` and this with
    ``optimizer.load_state_dict``."""
    moments = (convert(mu), convert(nu))
    name_of = {id(p): n for n, p in module.named_parameters()}
    sd = optimizer.state_dict()
    state, index = {}, 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = name_of[id(p)]
            state[index] = {
                "step": torch.tensor(float(count)),
                "exp_avg": moments[0][name].to(p.device),
                "exp_avg_sq": moments[1][name].to(p.device),
            }
            index += 1
    if index != len(moments[0]):
        raise ValueError(f"{len(moments[0])} moments for {index} parameters")
    sd["state"] = state
    return sd


def light_adam_state_dict(optimizer: torch.optim.Adam, module, mu: dict,
                          nu: dict, count: int) -> dict:
    """:func:`adam_state_dict` of JAX ``LightNets`` params, for an Adam
    over a port ``LightNets``."""
    return adam_state_dict(optimizer, module, light_state_dict, mu, nu, count)


def brdf_adam_state_dict(optimizer: torch.optim.Adam, module, mu: dict,
                         nu: dict, count: int) -> dict:
    """:func:`adam_state_dict` of JAX ``BRDFNets`` params, for an Adam
    over a port ``BRDFNets``."""
    return adam_state_dict(optimizer, module, brdf_state_dict, mu, nu, count)
