"""YOLO layers used by the YOLOv3 and YOLOv3-tiny specs (port of the
matching part of ``adaptiveisp_tpu/detect/layers.py``).

NCHW inside, ultralytics child names (``conv``, ``bn``, ``cv1``, ``cv2``) so
state dicts keep the original keys.  BatchNorm is flax's ``BatchNorm(
momentum=0.9, epsilon=1e-5)``: eval mode is ``nn.BatchNorm2d``'s, and train
mode normalises with the biased batch variance and moves the running
statistics by ``0.9 * old + 0.1 * batch`` with that same biased variance
(``FlaxBatchNorm2d``), where ``nn.BatchNorm2d`` would take the unbiased one.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from adaptiveisp_tpu_torch.policy.nets import FlaxBatchNorm2d


def autopad(k: int) -> int:
    return k // 2


def activation(act):
    """The spec's activation as a module: True is SiLU (the original
    ``Conv`` default), False/None identity.  Named activations of the JAX
    package's zoo are not ported yet."""
    if act is True:
        return nn.SiLU()
    if act is False or act is None:
        return nn.Identity()
    raise NotImplementedError(f"activation {act!r} is not ported")


class ConvBNAct(nn.Module):
    """conv(bias=False) -> BN -> act; ``p`` overrides the k//2 autopad."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1,
                 p: int | None = None, act=True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k) if p is None else p,
                              bias=False)
        self.bn = FlaxBatchNorm2d(c2, eps=1e-5)
        self.act = activation(act)

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    """1x1 reduce -> 3x3 expand, residual when ``shortcut`` and c1 == c2."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True,
                 e: float = 0.5, act=True):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBNAct(c1, c_, 1, 1, act=act)
        self.cv2 = ConvBNAct(c_, c2, 3, 1, act=act)
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


class MaxPool(nn.Module):
    """``nn.MaxPool2d(k, s)`` with no padding (VALID); the tiny spec's
    ZeroPad row supplies the asymmetric pad before its stride-1 pool."""

    def __init__(self, k: int, s: int):
        super().__init__()
        self.k, self.s = k, s

    def forward(self, x):
        return F.max_pool2d(x, self.k, self.s)


class ZeroPad(nn.Module):
    """Zero padding [left, right, top, bottom]."""

    def __init__(self, pad):
        super().__init__()
        self.pad = tuple(int(v) for v in pad)

    def forward(self, x):
        return F.pad(x, self.pad)
