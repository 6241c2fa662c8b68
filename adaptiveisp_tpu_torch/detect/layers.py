"""The YOLO layer zoo (port of ``adaptiveisp_tpu/detect/layers.py``):
Conv (conv + BN + act), DWConv, Bottleneck, CrossConv, GhostConv,
GhostBottleneck, TransformerLayer / TransformerBlock, C3 with its C3x /
C3TR / C3SPP / C3Ghost variants, BottleneckCSP, SPP, SPPF, Focus, the
segmentation head's Proto tower, and the parameter-free Upsample, Concat,
MaxPool, ZeroPad, Contract and Expand.

NCHW inside, ultralytics child names (``conv``, ``bn``, ``cv1``..``cv4``,
``m.{r}``, GhostBottleneck's ``conv.{j}`` / ``shortcut.{j}``, the
transformer's ``linear``, ``tr.{r}`` and ``ma.in_proj_weight`` /
``ma.out_proj``), so that the JAX package's ``convert_yolo_state_dict``
loads a ``state_dict()`` of the port unchanged.  BatchNorm is flax's
``BatchNorm(momentum=0.9, epsilon=1e-5)``: eval mode is
``nn.BatchNorm2d``'s, and train mode normalises with the biased batch
variance and moves the running statistics by ``0.9 * old + 0.1 * batch``
with that same biased variance (``FlaxBatchNorm2d``).  The attention is
written out as the JAX layer writes it (no LayerNorm), with plain torch
operations, as JAX computes it outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Any, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from adaptiveisp_tpu_torch.detect.activations import apply_activation
from adaptiveisp_tpu_torch.nn_init import lecun_normal_
from adaptiveisp_tpu_torch.policy.nets import FlaxBatchNorm2d


def autopad(k: int) -> int:
    return k // 2


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


class ConvBNAct(nn.Module):
    """conv(bias=False) -> BN -> act.  ``p`` overrides the k//2 autopad (the
    v5 6x6 stem), ``g`` is the group count, ``k``/``s`` may be (kh, kw)
    pairs (CrossConv's 1xk / kx1); ``act`` as in
    :func:`activations.apply_activation`."""

    def __init__(self, c1: int, c2: int, k: Union[int, Tuple] = 1,
                 s: Union[int, Tuple] = 1, p=None, act: Any = True,
                 g: int = 1):
        super().__init__()
        kh, kw = _pair(k)
        pad = (autopad(kh), autopad(kw)) if p is None else _pair(p)
        self.conv = nn.Conv2d(c1, c2, (kh, kw), _pair(s), pad, groups=g,
                              bias=False)
        self.bn = FlaxBatchNorm2d(c2, eps=1e-5)
        self.act = apply_activation(act, c2)

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class DWConv(ConvBNAct):
    """Depthwise conv: a ConvBNAct at groups = gcd(c1, c2)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1,
                 act: Any = True):
        super().__init__(c1, c2, k, s, act=act, g=math.gcd(c1, c2))


class Bottleneck(nn.Module):
    """1x1 reduce -> 3x3 expand, residual when ``shortcut`` and c1 == c2."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True,
                 e: float = 0.5, act: Any = True):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBNAct(c1, c_, 1, 1, act=act)
        self.cv2 = ConvBNAct(c_, c2, 3, 1, act=act)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class CrossConv(nn.Module):
    """1xk then kx1 convolution, residual when ``shortcut`` and c1 == c2."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1,
                 e: float = 1.0, shortcut: bool = False, act: Any = True):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBNAct(c1, c_, (1, k), (1, s), act=act)
        self.cv2 = ConvBNAct(c_, c2, (k, 1), (s, 1), act=act)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class GhostConv(nn.Module):
    """A dense conv to half the channels, then a depthwise 5x5 making the
    other ("ghost") half from it."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1,
                 act: Any = True):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = ConvBNAct(c1, c_, k, s, act=act)
        self.cv2 = ConvBNAct(c_, c_, 5, 1, act=act, g=c_)

    def forward(self, x):
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], dim=1)


class GhostBottleneck(nn.Module):
    """GhostConv -> [DWConv at s=2] -> linear GhostConv, plus a DWConv +
    Conv shortcut when striding (identity otherwise).  ``conv`` and
    ``shortcut`` are ultralytics' Sequentials (an Identity holds index 1
    when s == 1), so the keys are ``conv.{0,1,2}`` / ``shortcut.{0,1}``."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1,
                 act: Any = True):
        super().__init__()
        c_ = c2 // 2
        self.conv = nn.Sequential(
            GhostConv(c1, c_, 1, 1, act=act),
            DWConv(c_, c_, k, s, act=False) if s == 2 else nn.Identity(),
            GhostConv(c_, c2, 1, 1, act=False))
        self.shortcut = (nn.Sequential(DWConv(c1, c1, k, s, act=False),
                                       ConvBNAct(c1, c2, 1, 1, act=False))
                         if s == 2 else nn.Identity())

    def forward(self, x):
        return self.conv(x) + self.shortcut(x)


class MultiheadAttention(nn.Module):
    """The joint in-projection and the out-projection of torch's
    ``nn.MultiheadAttention`` (its parameter names), computed as the JAX
    layer computes it: per-head softmax(q k^T / sqrt(d)) v, batch first."""

    def __init__(self, c: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * c, c))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * c))
        self.out_proj = nn.Linear(c, c)
        self.flax_init_()

    @torch.no_grad()
    def flax_init_(self, generator=None):
        # three flax Dense layers (in_q, in_k, in_v), each of fan-in c
        lecun_normal_(self.in_proj_weight, generator=generator)
        self.in_proj_bias.zero_()

    def forward(self, q, k, v):
        b, l, c = q.shape
        h = self.num_heads
        d = c // h
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)

        def heads(t):  # [B, L, C] -> [B, H, L, d]
            return t.reshape(b, l, h, d).transpose(1, 2)

        qh = heads(F.linear(q, wq, bq))
        kh = heads(F.linear(k, wk, bk))
        vh = heads(F.linear(v, wv, bv))
        logits = qh @ kh.transpose(-1, -2) / math.sqrt(d)
        o = torch.softmax(logits, dim=-1) @ vh
        return self.out_proj(o.transpose(1, 2).reshape(b, l, c))


class TransformerLayer(nn.Module):
    """q/k/v Linears (no bias) into multi-head attention, then a 2-Linear
    feedforward; both residual, no LayerNorm.  x is [B, L, C]."""

    def __init__(self, c: int, num_heads: int):
        super().__init__()
        self.q = nn.Linear(c, c, bias=False)
        self.k = nn.Linear(c, c, bias=False)
        self.v = nn.Linear(c, c, bias=False)
        self.ma = MultiheadAttention(c, num_heads)
        self.fc1 = nn.Linear(c, c, bias=False)
        self.fc2 = nn.Linear(c, c, bias=False)

    def forward(self, x):
        x = self.ma(self.q(x), self.k(x), self.v(x)) + x
        return self.fc2(self.fc1(x)) + x


class TransformerBlock(nn.Module):
    """Optional Conv to c2, the H x W map flattened to a sequence in (h, w)
    order, a Linear position embedding added, num_layers
    TransformerLayers, reshaped back."""

    def __init__(self, c1: int, c2: int, num_heads: int, num_layers: int,
                 act: Any = True):
        super().__init__()
        self.conv = ConvBNAct(c1, c2, 1, 1, act=act) if c1 != c2 else None
        self.linear = nn.Linear(c2, c2)
        self.tr = nn.Sequential(*(TransformerLayer(c2, num_heads)
                                  for _ in range(num_layers)))

    def forward(self, x):
        if self.conv is not None:
            x = self.conv(x)
        b, c, h, w = x.shape
        p = x.flatten(2).transpose(1, 2)
        p = self.tr(p + self.linear(p))
        return p.transpose(1, 2).reshape(b, c, h, w)


def _pool_same(x, k: int):
    return F.max_pool2d(x, k, 1, k // 2)


class SPP(nn.Module):
    """1x1 reduce, parallel stride-1 max-pools at ``k``, concat, 1x1."""

    def __init__(self, c1: int, c2: int, k: Sequence[int] = (5, 9, 13),
                 act: Any = True):
        super().__init__()
        c_ = c1 // 2
        self.k = tuple(int(v) for v in k)
        self.cv1 = ConvBNAct(c1, c_, 1, 1, act=act)
        self.cv2 = ConvBNAct(c_ * (len(self.k) + 1), c2, 1, 1, act=act)

    def forward(self, x):
        x = self.cv1(x)
        return self.cv2(torch.cat([x] + [_pool_same(x, k) for k in self.k],
                                  dim=1))


class SPPF(nn.Module):
    """SPP(k, 2k-1, 3k-2) as three chained k-pools."""

    def __init__(self, c1: int, c2: int, k: int = 5, act: Any = True):
        super().__init__()
        c_ = c1 // 2
        self.k = int(k)
        self.cv1 = ConvBNAct(c1, c_, 1, 1, act=act)
        self.cv2 = ConvBNAct(c_ * 4, c2, 1, 1, act=act)

    def forward(self, x):
        x = self.cv1(x)
        y1 = _pool_same(x, self.k)
        y2 = _pool_same(y1, self.k)
        return self.cv2(torch.cat([x, y1, y2, _pool_same(y2, self.k)],
                                  dim=1))


class C3(nn.Module):
    """CSP bottleneck with 3 convolutions: cv1 -> n inner blocks (e = 1.0),
    cv2 beside it, concat, cv3.  ``variant`` picks the inner block:
    ``bottleneck`` (C3), ``cross`` (C3x), ``ghost`` (C3Ghost),
    ``transformer`` (C3TR: one TransformerBlock of n layers) or ``spp``
    (C3SPP: one SPP)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 e: float = 0.5, act: Any = True,
                 variant: str = "bottleneck",
                 k_spp: Sequence[int] = (5, 9, 13)):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBNAct(c1, c_, 1, 1, act=act)
        self.cv2 = ConvBNAct(c1, c_, 1, 1, act=act)
        self.cv3 = ConvBNAct(2 * c_, c2, 1, 1, act=act)
        if variant == "bottleneck":
            self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, e=1.0,
                                                act=act) for _ in range(n)))
        elif variant == "cross":
            self.m = nn.Sequential(*(CrossConv(c_, c_, 3, 1, e=1.0,
                                               shortcut=shortcut, act=act)
                                     for _ in range(n)))
        elif variant == "ghost":
            self.m = nn.Sequential(*(GhostBottleneck(c_, c_, act=act)
                                     for _ in range(n)))
        elif variant == "transformer":
            self.m = TransformerBlock(c_, c_, 4, n, act=act)
        elif variant == "spp":
            self.m = SPP(c_, c_, k=k_spp, act=act)
        else:
            raise ValueError(f"unknown C3 variant {variant!r}")

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], dim=1))


class BottleneckCSP(nn.Module):
    """The original CSP bottleneck: cv1 -> bottlenecks -> raw 1x1 cv3,
    beside a raw 1x1 cv2; concat -> BN -> SiLU -> cv4."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 e: float = 0.5, act: Any = True):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBNAct(c1, c_, 1, 1, act=act)
        self.cv2 = nn.Conv2d(c1, c_, 1, bias=False)
        self.cv3 = nn.Conv2d(c_, c_, 1, bias=False)
        self.cv4 = ConvBNAct(2 * c_, c2, 1, 1, act=act)
        self.bn = FlaxBatchNorm2d(2 * c_, eps=1e-5)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, e=1.0, act=act)
                                 for _ in range(n)))

    def forward(self, x):
        a = self.cv3(self.m(self.cv1(x)))
        y = torch.cat([a, self.cv2(x)], dim=1)
        return self.cv4(F.silu(self.bn(y)))


def space_to_depth(x):
    """The 2x2 pixel shuffle: channels (even, even), (odd, even),
    (even, odd), (odd, odd) in (row, col) order."""
    return torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2],
                      x[..., ::2, 1::2], x[..., 1::2, 1::2]], dim=1)


class Focus(nn.Module):
    """Space-to-depth stem followed by a Conv."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1,
                 act: Any = True):
        super().__init__()
        self.conv = ConvBNAct(4 * c1, c2, k, s, act=act)

    def forward(self, x):
        return self.conv(space_to_depth(x))


def contract(x, gain: int = 2):
    """Fold gain x gain spatial blocks into channels, in the (s, s, c)
    channel order of the JAX function (ultralytics' Contract)."""
    b, c, h, w = x.shape
    s = gain
    x = x.view(b, c, h // s, s, w // s, s).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, c * s * s, h // s, w // s)


def expand(x, gain: int = 2):
    """Unfold channels into gain x gain spatial blocks, the inverse of
    :func:`contract` (ultralytics' Expand)."""
    b, c, h, w = x.shape
    s = gain
    x = x.view(b, s, s, c // s ** 2, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(b, c // s ** 2, h * s, w * s)


class Lambda(nn.Module):
    """A parameter-free row (Contract, Expand, Identity)."""

    def __init__(self, fn, *args):
        super().__init__()
        self.fn, self.args = fn, args

    def forward(self, x):
        return self.fn(x, *self.args)


def upsample_nearest_2x(x):
    """Nearest-neighbour 2x upsample of an NCHW map."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Upsample(nn.Module):
    """Nearest-neighbour 2x upsample."""

    def forward(self, x):
        return upsample_nearest_2x(x)


class Proto(nn.Module):
    """Mask prototype tower of the segmentation head: Conv3x3 -> nearest 2x
    -> Conv3x3 -> Conv1x1 to ``nm`` channels (children ``cv1``..``cv3``)."""

    def __init__(self, c1: int, npr: int = 256, nm: int = 32,
                 act: Any = True):
        super().__init__()
        self.cv1 = ConvBNAct(c1, npr, 3, 1, act=act)
        self.cv2 = ConvBNAct(npr, npr, 3, 1, act=act)
        self.cv3 = ConvBNAct(npr, nm, 1, 1, act=act)

    def forward(self, x):
        return self.cv3(self.cv2(upsample_nearest_2x(self.cv1(x))))


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
