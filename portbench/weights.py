"""The run's weights, drawn from the seed on the device.

One normal draw for every parameter the specification initializes at
random (in the specification's order), each then scaled to its standard
deviation; constants are filled.  The same seed gives the same weights,
to the program and to the reference alike.
"""

from __future__ import annotations

import math

import torch

from .data import generator

__all__ = ["draw", "load_into"]


def draw(specs, seed, device):
    """``{name: float32 tensor}`` for ``specs`` (``[(name, shape,
    ("normal", std) | ("const", value))]``)."""
    sizes = [math.prod(shape) for _, shape, _ in specs]
    n = sum(s for s, (_, _, (kind, _)) in zip(sizes, specs)
            if kind == "normal")
    flat = torch.randn(n, generator=generator(seed, 0, device),
                       device=device)
    out, offset = {}, 0
    for size, (name, shape, (kind, value)) in zip(sizes, specs):
        if kind == "normal":
            out[name] = flat[offset:offset + size].view(shape).mul_(value)
            offset += size
        elif kind == "const":
            out[name] = torch.full(shape, float(value), device=device)
        else:
            raise ValueError(f"unknown init {kind!r} for {name}")
    return out


def load_into(model, weights):
    """Copy ``weights`` into ``model``'s parameters, which must be
    exactly the specification's: the same names and shapes."""
    params = dict(model.namedparams())
    if set(params) != set(weights):
        missing = sorted(set(weights) - set(params))
        extra = sorted(set(params) - set(weights))
        raise ValueError(f"the model's parameters are not the "
                         f"configuration's: missing {missing[:5]}, "
                         f"extra {extra[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise ValueError(f"{name}: shape {tuple(p.shape)}, the "
                                 f"configuration's "
                                 f"{tuple(weights[name].shape)}")
            p.copy_(weights[name])
