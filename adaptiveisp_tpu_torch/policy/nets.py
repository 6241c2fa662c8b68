"""Shared CNN trunk and heads of the policy and value networks (port of
``adaptiveisp_tpu/policy/nets.py``).

The trunk is the original AdaptiveISP ``FeatureExtractor``: a stride-2 conv
ladder from 64x64 down to 4x4, each conv followed by BatchNorm (eps 1e-5) and
LeakyReLU(0.2), in an ``nn.Sequential`` named ``layers`` so the state-dict
keys are the original ones (``layers.{3k}`` conv, ``layers.{3k+1}`` BN).
It takes NHWC like the JAX package, runs NCHW inside, and flattens (C, H, W)
as PyTorch does; ``convert.py`` permutes the consuming Linear weights.

Train mode follows flax, not torch: BatchNorm normalises with the batch
mean and biased variance and moves its running statistics by
``0.9 * old + 0.1 * batch`` with the biased variance; dropout draws its mask
from a ``torch.Generator`` the caller passes (flax's ``dropout`` rng).

Channel schedule for a 64x64 input with mid_channels=32, output_dim=4096:
64 -> 32 (32ch) -> 16 (64ch) -> 8 (128ch) -> 4 (256ch), 4*4*256 = 4096.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

MIN_FEATURE_MAP_SIZE = 4
LEAKY_SLOPE = 0.2
BN_MOMENTUM = 0.9   # flax's: running = 0.9 * running + 0.1 * batch


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (same state-dict keys, same eval mode) whose train
    mode is flax ``BatchNorm(momentum=0.9)``'s: the biased batch variance
    both normalises and enters the running variance."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=1.0 - BN_MOMENTUM)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        with torch.no_grad():
            self.running_mean.mul_(BN_MOMENTUM).add_(
                mean * (1.0 - BN_MOMENTUM))
            self.running_var.mul_(BN_MOMENTUM).add_(
                var * (1.0 - BN_MOMENTUM))
            self.num_batches_tracked.add_(1)
        scale = self.weight * torch.rsqrt(var + self.eps)
        return ((x - mean[None, :, None, None]) * scale[None, :, None, None]
                + self.bias[None, :, None, None])


def dropout(x, rate: float, generator: torch.Generator | None):
    """flax ``nn.Dropout`` in train mode: keep with probability 1 - rate,
    scale kept values by 1 / (1 - rate); the mask comes from ``generator``
    (on x's device)."""
    if rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("train-mode dropout needs a torch.Generator")
    keep = torch.empty_like(x).bernoulli_(1.0 - rate, generator=generator)
    return torch.where(keep != 0, x / (1.0 - rate), 0.0)


class FeatureExtractor(nn.Module):
    """Stride-2 conv ladder -> flat feature vector; dropout on the output in
    train mode when dropout_prob > 0."""

    def __init__(self, in_channels: int, mid_channels: int = 32,
                 output_dim: int = 4096, dropout_prob: float = 0.5,
                 input_size: int = 64):
        super().__init__()
        assert output_dim % (MIN_FEATURE_MAP_SIZE ** 2) == 0
        size, ch = input_size // 2, mid_channels
        chans = [ch]
        while size > MIN_FEATURE_MAP_SIZE:
            if size == MIN_FEATURE_MAP_SIZE * 2:
                ch = output_dim // (MIN_FEATURE_MAP_SIZE ** 2)
            else:
                ch *= 2
            assert size % 2 == 0
            size //= 2
            chans.append(ch)
        layers, c_in = [], in_channels
        for c_out in chans:
            layers += [nn.Conv2d(c_in, c_out, 4, 2, 1),
                       FlaxBatchNorm2d(c_out, eps=1e-5),
                       nn.LeakyReLU(LEAKY_SLOPE)]
            c_in = c_out
        self.layers = nn.Sequential(*layers)
        self.dropout_prob = dropout_prob

    def forward(self, x_nhwc, generator: torch.Generator | None = None):
        x = self.layers(x_nhwc.permute(0, 3, 1, 2))
        x = x.reshape(x.shape[0], -1)
        if self.training:
            x = dropout(x, self.dropout_prob, generator)
        return x


def mlp_head(x, fc1: nn.Linear, fc_out: nn.Linear):
    """fc1 -> LeakyReLU(0.2) -> fc_out: the selector and value heads.  A
    function, not a module, because its owners keep the layers at their own
    top level under the original names ``fc1``/``fc2``."""
    return fc_out(F.leaky_relu(fc1(x), LEAKY_SLOPE))


class FilterHead(nn.Module):
    """Shared fc1 with separate filter-param and mask-param outputs."""

    def __init__(self, in_dim: int, hidden: int = 128, n_filter_params: int = 1,
                 n_mask_params: int = 6):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden)
        self.fc_filter = nn.Linear(hidden, n_filter_params)
        self.fc_mask = nn.Linear(hidden, n_mask_params)

    def forward(self, x):
        h = F.leaky_relu(self.fc1(x), LEAKY_SLOPE)
        return self.fc_filter(h), self.fc_mask(h)
