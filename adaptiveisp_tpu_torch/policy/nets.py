"""Shared CNN trunk and heads of the policy (port of
``adaptiveisp_tpu/policy/nets.py``).

The trunk is the original AdaptiveISP ``FeatureExtractor``: a stride-2 conv
ladder from 64x64 down to 4x4, each conv followed by BatchNorm (eps 1e-5) and
LeakyReLU(0.2), in an ``nn.Sequential`` named ``layers`` so the state-dict
keys are the original ones (``layers.{3k}`` conv, ``layers.{3k+1}`` BN).
It takes NHWC like the JAX package, runs NCHW inside, and flattens (C, H, W)
as PyTorch does; ``convert.py`` permutes the consuming Linear weights.

Channel schedule for a 64x64 input with mid_channels=32, output_dim=4096:
64 -> 32 (32ch) -> 16 (64ch) -> 8 (128ch) -> 4 (256ch), 4*4*256 = 4096.
"""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

MIN_FEATURE_MAP_SIZE = 4
LEAKY_SLOPE = 0.2


class FeatureExtractor(nn.Module):
    """Stride-2 conv ladder -> flat feature vector; dropout (inactive in
    eval mode) on the output when dropout_prob > 0."""

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
                       nn.BatchNorm2d(c_out, eps=1e-5, momentum=0.1),
                       nn.LeakyReLU(LEAKY_SLOPE)]
            c_in = c_out
        self.layers = nn.Sequential(*layers)
        self.dropout = nn.Dropout(dropout_prob) if dropout_prob > 0 else None

    def forward(self, x_nhwc):
        x = self.layers(x_nhwc.permute(0, 3, 1, 2))
        x = x.reshape(x.shape[0], -1)
        return self.dropout(x) if self.dropout is not None else x


def mlp_head(x, fc1: nn.Linear, fc_out: nn.Linear):
    """fc1 -> LeakyReLU(0.2) -> fc_out: the selector head.  A function, not a
    module, because its owner keeps the layers at its own top level under
    the original names ``fc1``/``fc2``."""
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
