"""Seeded network weights, made on the device in a few large draws.

The benchmark makes every weight itself and hands the same state dict to the
program and to the plain reference.  The draws keep activations of order 1
through the depth (each weight of two or more dimensions normal with
variance 1 / fan-in, BatchNorm scales and running variances uniform in
[0.5, 1.5], every other float normal with scale 0.1), so that a detector's
scores spread and the agent's probabilities are not tied: a fresh network's
initial distributions give near-equal scores, whose order float noise
decides.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Mapping, Tuple

import torch


def seed_of(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's ``--seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


Shapes = Mapping[str, Tuple[Tuple[int, ...], torch.dtype, str]]


def spread_state(shapes: Shapes, seed: int, device) -> Dict[str, torch.Tensor]:
    """A state dict for ``shapes`` ({key: (shape, dtype, kind)} in the
    module's order, from :func:`shapes_of`): one normal and one uniform draw
    from a generator on ``device``, split and scaled per tensor."""
    kinds = {k: kind for k, (_, _, kind) in shapes.items()}
    numel = {k: int(torch.Size(s).numel()) for k, (s, _, _) in shapes.items()}
    n_normal = sum(numel[k] for k in shapes if kinds[k] in ("fan_in", "small"))
    n_uniform = sum(numel[k] for k in shapes if kinds[k] == "uniform")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    out, i, j = {}, 0, 0
    for k, (shape, dtype, _) in shapes.items():
        n, kind = numel[k], kinds[k]
        if kind == "zero":
            out[k] = torch.zeros(shape, dtype=dtype, device=device)
            continue
        if kind == "uniform":
            t = uniform[j:j + n] + 0.5
            j += n
        else:
            scale = (0.1 if kind == "small"
                     else float(torch.Size(shape[1:]).numel()) ** -0.5)
            t = normal[i:i + n] * scale
            i += n
        out[k] = t.reshape(shape).to(dtype)
    return out


def shapes_of(module: torch.nn.Module) -> Shapes:
    """{key: (shape, dtype, kind)} of a module's state dict; kind is how
    :func:`spread_state` draws the tensor."""
    bn_uniform = set()
    for name, m in module.named_modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            prefix = f"{name}." if name else ""
            bn_uniform |= {prefix + "weight", prefix + "running_var"}
    out = {}
    for k, v in module.state_dict().items():
        if not v.dtype.is_floating_point:
            kind = "zero"
        elif k in bn_uniform:
            kind = "uniform"
        elif v.dim() >= 2:
            kind = "fan_in"
        else:
            kind = "small"
        out[k] = (tuple(v.shape), v.dtype, kind)
    return out
