"""Seeded weights, made on the device in one draw, for the reference's
nets and the program's alike (their parameter names are the published
checkpoints').

Every convolution kernel is LeCun normal (variance 1 / fan-in); biases
are zero; GroupNorm scales one and shifts zero.  The draws for a bundle
are one ``normal_`` of a ``torch.Generator`` on the device, seeded from
the run's seed and the bundle's name, sliced into the kernels in
parameter order, so a seed gives the same weights on every call.
"""

from __future__ import annotations

import hashlib
import math

import torch
import torch.nn as nn


def sub_seed(seed: int, *labels) -> int:
    """A 63-bit seed of ``seed`` and ``labels``, the same in every
    process."""
    text = "/".join([str(int(seed))] + [str(x) for x in labels])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1


def generator(device, seed: int, *labels) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *labels))


def seeded_state(module: nn.Module, device, seed: int, label: str) -> dict:
    """{name: tensor} for every parameter of ``module`` (built anywhere,
    the meta device included), on ``device``, float32."""
    convs = {f"{n}.weight": m for n, m in module.named_modules()
             if isinstance(m, nn.Conv2d)}
    shapes = dict(module.named_parameters())
    total = sum(shapes[n].numel() for n in convs)
    draws = torch.empty(total, device=device).normal_(
        generator=generator(device, seed, "weights", label))
    state, at = {}, 0
    for name, p in shapes.items():
        if name in convs:
            m = convs[name]
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            n = p.numel()
            state[name] = (draws[at:at + n].view(p.shape)
                           * math.sqrt(1.0 / fan_in))
            at += n
        elif name.endswith(".weight"):  # GroupNorm scale
            state[name] = torch.ones(p.shape, device=device)
        else:  # conv bias, GroupNorm shift
            state[name] = torch.zeros(p.shape, device=device)
    return state


def load(module: nn.Module, state: dict) -> nn.Module:
    """``state`` into ``module`` (its parameters replaced, not copied
    into: a module built on the meta device takes them as they are)."""
    module.load_state_dict({k: v.clone() for k, v in state.items()},
                           strict=True, assign=True)
    return module
