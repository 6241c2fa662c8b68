"""The activation zoo and the spec-level activation override (port of
``adaptiveisp_tpu/detect/activations.py``).

Stateless activations are functions; FReLU, AconC and MetaAconC hold
parameters and are modules built for a channel count, kept as the owning
block's ``act`` child so their keys read ``....act.p1`` (the flax tree's
``.../act``).  NCHW inside.  Their parameters start from the initializers
the JAX modules declare (``flax_init_``); their convolutions from flax's
defaults (``nn_init.flax_init_``).

    spec = {**YOLOV3_SPEC, "activation": "mish"}   # whole-model override
    ConvBNAct(c1, 64, 3, 1, act="frelu")           # per-block override
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn as nn
import torch.nn.functional as F

from adaptiveisp_tpu_torch.policy.nets import FlaxBatchNorm2d

# ---------------------------------------------------------------- stateless


def silu(x):
    return F.silu(x)


def hardswish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def mish(x):
    return x * torch.tanh(F.softplus(x))


def leaky_relu(x):
    return F.leaky_relu(x, 0.1)


def relu(x):
    return F.relu(x)


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def hardsigmoid(x):
    return torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


def identity(x):
    return x


# ------------------------------------------------------------ parameterized


class FReLU(nn.Module):
    """Funnel activation: ``max(x, BN(depthwise3x3(x)))``."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, 1, 1, groups=c, bias=False)
        self.bn = FlaxBatchNorm2d(c, eps=1e-5)

    def forward(self, x):
        return torch.maximum(x, self.bn(self.conv(x)))


class AconC(nn.Module):
    """ACON-C: ``(p1-p2)*x*sigmoid(beta*(p1-p2)*x) + p2*x``, per-channel
    p1, p2 (flax ``normal(1.0)``) and beta (ones)."""

    def __init__(self, c: int):
        super().__init__()
        self.p1 = nn.Parameter(torch.empty(1, c, 1, 1))
        self.p2 = nn.Parameter(torch.empty(1, c, 1, 1))
        self.beta = nn.Parameter(torch.empty(1, c, 1, 1))
        self.flax_init_()

    @torch.no_grad()
    def flax_init_(self, generator=None):
        self.p1.normal_(0.0, 1.0, generator=generator)
        self.p2.normal_(0.0, 1.0, generator=generator)
        self.beta.fill_(1.0)

    def forward(self, x):
        d = (self.p1 - self.p2) * x
        return d * torch.sigmoid(self.beta * d) + self.p2 * x


class MetaAconC(nn.Module):
    """ACON-C with beta from two 1x1 convolutions (r = 16) over the image's
    channel means."""

    def __init__(self, c: int, r: int = 16):
        super().__init__()
        c2 = max(r, c // r)
        self.p1 = nn.Parameter(torch.empty(1, c, 1, 1))
        self.p2 = nn.Parameter(torch.empty(1, c, 1, 1))
        self.fc1 = nn.Conv2d(c, c2, 1, bias=True)
        self.fc2 = nn.Conv2d(c2, c, 1, bias=True)
        self.flax_init_()

    @torch.no_grad()
    def flax_init_(self, generator=None):
        self.p1.normal_(0.0, 1.0, generator=generator)
        self.p2.normal_(0.0, 1.0, generator=generator)

    def forward(self, x):
        y = x.mean(dim=(2, 3), keepdim=True)
        beta = torch.sigmoid(self.fc2(self.fc1(y)))
        d = (self.p1 - self.p2) * x
        return d * torch.sigmoid(beta * d) + self.p2 * x


ACTIVATIONS: dict[str, Any] = {
    "silu": silu,
    "hardswish": hardswish,
    "mish": mish,
    "leaky_relu": leaky_relu,
    "relu": relu,
    "relu6": relu6,
    "hardsigmoid": hardsigmoid,
    "identity": identity,
    "frelu": FReLU,
    "aconc": AconC,
    "meta_aconc": MetaAconC,
}


class Activation(nn.Module):
    """A stateless activation function as a parameter-free child."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)

    def extra_repr(self):
        return getattr(self.fn, "__name__", repr(self.fn))


def apply_activation(act: Any, c: int) -> nn.Module:
    """The module for a ConvBNAct ``act`` setting over ``c`` channels:
    ``True`` SiLU (the reference Conv default), ``False``/``None``
    identity, a name from :data:`ACTIVATIONS` (a parameterized one built
    for ``c`` channels), a callable as is."""
    if act is True:
        return nn.SiLU()
    if act is False or act is None:
        return nn.Identity()
    if isinstance(act, str):
        try:
            entry = ACTIVATIONS[act]
        except KeyError:
            raise KeyError(f"unknown activation {act!r}; known: "
                           f"{sorted(ACTIVATIONS)}") from None
        if isinstance(entry, type) and issubclass(entry, nn.Module):
            return entry(c)
        return Activation(entry)
    if callable(act):
        return Activation(act)
    raise TypeError(f"activation spec must be bool/str/callable, got {act!r}")
