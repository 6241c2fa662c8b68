"""flax's default initial distributions for a freshly built network.

The JAX package declares no initializer on its ``nn.Conv`` / ``nn.Dense``
layers, so every kernel starts from flax's ``lecun_normal`` (a normal
truncated at two standard deviations and rescaled to variance 1 / fan_in)
and every bias from zero.  torch's own defaults differ
(``kaiming_uniform(a=sqrt(5))``: variance 1 / (3 fan_in), uniform biases),
so each constructor of a network the JAX package initialises calls
:func:`flax_init_` last.  BatchNorm keeps scale 1 and bias 0 in both.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

# std of a standard normal truncated to [-2, 2] (flax's variance_scaling
# divides by it so the truncated draw keeps the asked variance)
TRUNCATED_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(w: torch.Tensor, fan_in: int | None = None,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """flax ``lecun_normal`` in place: std sqrt(1 / fan_in) / 0.8796,
    truncated at +-2 std.  ``fan_in`` defaults to ``w[0].numel()``: a
    Linear's in_features, a conv's (in_channels / groups) * kh * kw, as
    flax's kernel shape ``(kh, kw, in / groups, out)`` gives it."""
    fan_in = int(w[0].numel()) if fan_in is None else int(fan_in)
    std = math.sqrt(1.0 / fan_in) / TRUNCATED_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


@torch.no_grad()
def flax_init_(module: nn.Module,
               generator: torch.Generator | None = None) -> nn.Module:
    """Every ``Conv2d`` / ``Linear`` weight of ``module`` to
    :func:`lecun_normal_`, every bias of theirs to zero; a submodule with
    parameters of its own declares flax's initializers for them in a
    ``flax_init_(generator)`` method, called here."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            lecun_normal_(m.weight, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif m is not module and hasattr(m, "flax_init_"):
            m.flax_init_(generator)
    return module
