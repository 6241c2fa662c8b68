"""Shared math primitives of the ISP op library (port of
``adaptiveisp_tpu/ops/math.py``).

Plain tensor functions over NHWC float32 images in [0, 1], the JAX package's
layout, so each function compares one to one with its JAX counterpart.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def clip_grad_mask(x, lo=None, hi=None):
    """d clip(x, lo, hi) / dx with JAX's ties: 1 strictly inside the
    bounds, 0.5 at an exact bound, 0 outside (``jnp.clip`` and
    ``jnp.maximum`` split the gradient of a tie in half)."""
    m = torch.ones_like(x)
    if lo is not None:
        m = torch.where(x < lo, 0.0, torch.where(x == lo, 0.5, m))
    if hi is not None:
        m = torch.where(x > hi, 0.0, torch.where(x == hi, 0.5 * m, m))
    return m


class _Clip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * clip_grad_mask(x, *ctx.bounds), None, None


def clip(x, lo=None, hi=None):
    """``torch.clamp`` values with ``jnp.clip`` gradients (see
    :func:`clip_grad_mask`); ``clip(x, 0.0)`` is ``jnp.maximum(x, 0)``."""
    return _Clip.apply(x, lo, hi)


def lerp(a, b, l):
    return (1 - l) * a + l * b


def tanh01(x):
    return torch.tanh(x) * 0.5 + 0.5


def tanh_range(left: float, right: float, initial: float | None = None):
    """Squash an unbounded feature into (left, right); with ``initial`` a
    constant bias maps a zero input to ``initial``."""
    if initial is not None:
        bias = math.atanh(2.0 * (initial - left) / (right - left) - 1.0)
    else:
        bias = 0.0

    def activation(x):
        return tanh01(x + bias) * (right - left) + left

    return activation


def rgb2lum(img):
    """Perceptual luminance used by the filter stack (NHWC -> NHW1)."""
    lum = 0.27 * img[..., 0] + 0.67 * img[..., 1] + 0.06 * img[..., 2]
    return lum[..., None]


def rgb_to_luminance(img):
    """BT.601 luminance of the clipped image, used by the NLM denoiser
    (NHWC -> NHW1)."""
    img = clip(img, 0.0, 1.0)
    lum = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    return lum[..., None]


def rgb2hsv(img):
    """RGB -> HSV over NHWC, range [0, 1).

    Hue priority (highest first): min == max, r == max, g == max, b == max,
    as the JAX ``where`` chain has it (the last applied ``where`` wins).
    ``%`` on tensors is the floored modulo, like ``jnp``'s.
    """
    eps = 1e-8
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = img.amax(dim=-1)
    minc = img.amin(dim=-1)
    rng = maxc - minc + eps

    zero = torch.zeros_like(maxc)
    hue = zero
    hue = torch.where(b == maxc, 4.0 + (r - g) / rng, hue)
    hue = torch.where(g == maxc, 2.0 + (b - r) / rng, hue)
    hue = torch.where(r == maxc, ((g - b) / rng) % 6.0, hue)
    hue = torch.where(minc == maxc, zero, hue)
    hue = hue / 6.0

    sat = (maxc - minc) / (maxc + eps)
    sat = torch.where(maxc == 0, zero, sat)
    return torch.stack([hue, sat, maxc], dim=-1)


def hsv2rgb(hsv):
    """HSV -> RGB over NHWC."""
    h = hsv[..., 0] % 1.0
    s = clip(hsv[..., 1], 0.0, 1.0)
    v = clip(hsv[..., 2], 0.0, 1.0)

    hi = torch.floor(h * 6.0)
    f = h * 6.0 - hi
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)

    def pick(*cases):
        out = torch.zeros_like(h)
        for k, c in enumerate(cases):
            out = torch.where(hi == k, c, out)
        return out

    r = pick(v, q, p, p, t, v)
    g = pick(t, v, v, q, p, p)
    b = pick(p, p, t, v, v, q)
    return torch.stack([r, g, b], dim=-1)


def adaptive_avg_pool(img, out_hw: int):
    """``AdaptiveAvgPool2d`` over NHWC: bin i spans
    [floor(i*size/out), ceil((i+1)*size/out)), torch's own arithmetic."""
    x = F.adaptive_avg_pool2d(img.permute(0, 3, 1, 2), out_hw)
    return x.permute(0, 2, 3, 1)


def depthwise_conv3x3(img, kernel, padding: str = "VALID"):
    """Depthwise 3x3 conv over NHWC with one shared [3, 3] kernel, as nine
    shifted multiply-adds in the JAX package's order.  ``kernel`` is a host
    array (numpy or nested lists)."""
    if padding == "SAME":
        img = F.pad(img, (0, 0, 1, 1, 1, 1))
    n, hp, wp, c = img.shape
    h, w = hp - 2, wp - 2
    out = torch.zeros((n, h, w, c), dtype=img.dtype, device=img.device)
    for i in range(3):
        for j in range(3):
            out = out + float(kernel[i][j]) * img[:, i:i + h, j:j + w, :]
    return out
