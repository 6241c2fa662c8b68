"""The YOLO layers that the benchmark's detectors use (port of
``adaptiveisp_tpu/detect/layers.py``): Conv (conv + BN + SiLU), Bottleneck,
and the parameter-free Upsample and Concat.  A configuration that needs
another layer brings its frozen copy.

NCHW inside, ultralytics child names (``conv``, ``bn``, ``cv1``, ``cv2``),
so that a ``state_dict()`` of the port loads unchanged.  BatchNorm is
flax's ``BatchNorm(momentum=0.9, epsilon=1e-5)``: eval mode is
``nn.BatchNorm2d``'s, and train mode normalises with the biased batch
variance and moves the running statistics by ``0.9 * old + 0.1 * batch``
with that same biased variance (``FlaxBatchNorm2d``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.policy.nets import FlaxBatchNorm2d


class ConvBNAct(nn.Module):
    """conv(bias=False) -> BN -> SiLU; ``p`` overrides the k//2 pad."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p=None):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2 if p is None else p,
                              bias=False)
        self.bn = FlaxBatchNorm2d(c2, eps=1e-5)
        self.act = nn.SiLU()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    """1x1 reduce -> 3x3 expand, residual when ``shortcut`` and c1 == c2."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True,
                 e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBNAct(c1, c_, 1, 1)
        self.cv2 = ConvBNAct(c_, c2, 3, 1)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class Upsample(nn.Module):
    """Nearest-neighbour 2x upsample."""

    def forward(self, x):
        return F.interpolate(x, scale_factor=2, mode="nearest")


class Concat(nn.Module):
    """Channel concat of the listed inputs."""

    def forward(self, xs):
        return torch.cat(xs, dim=1)
