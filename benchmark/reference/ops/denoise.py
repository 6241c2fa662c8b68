"""Plain gray non-local means (frozen copy of the port's ``ops/denoise.py``
plain chain): 121 circular ``torch.roll`` shifts with a separable 5x5 box
sum.  ``nlm_gray_dispatch`` runs it on every image and zeroes the images
whose gate is 0, which is what the port's kernels return; autograd of the
chain is the backward.

All tensors are NHWC float32 in [0, 1]; ``h`` (filter strength) is [N, 1].
"""

from __future__ import annotations

import torch

from benchmark.reference.ops.math import (
    clip,
    rgb_to_luminance,
)

EPS = 1e-8


def box_sum(x, window_size: int):
    """Circular box sum over the H, W axes of an NHWC tensor (rows, then
    columns)."""
    r = window_size // 2
    row = torch.zeros_like(x)
    for dy in range(-r, r + 1):
        row = row + torch.roll(x, dy, dims=1)
    out = torch.zeros_like(x)
    for dx in range(-r, r + 1):
        out = out + torch.roll(row, dx, dims=2)
    return out


def box_mean(x, window_size: int):
    return box_sum(x, window_size) / float(window_size * window_size)


def _safe_sqrt(x):
    """sqrt with zero value and zero gradient where x <= 0 (the double
    ``where`` keeps the gradient finite at the zero-distance centre)."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, torch.ones_like(x))),
                       torch.zeros_like(x))


def nlm_gray(rgb, h, search_window_size: int = 11, patch_size: int = 5):
    """Gray-guided non-local means, circular boundaries.

    rgb: [N, H, W, 3]; h: [N, 1].  Distances on the luminance of the clipped
    image; weights ``exp(-sqrt(relu(boxsum((y - y')^2))) / (relu(h) + eps))``.
    Returns the clipped ratio.
    """
    u, _ = nlm_gray_uw(rgb, h, search_window_size, patch_size)
    return clip(u, 0.0, 1.0)


def nlm_gray_uw(rgb, h, search_window_size: int = 11, patch_size: int = 5):
    """:func:`nlm_gray` before the clip: (U [N, H, W, 3] unclipped ratio,
    W [N, H, W, 1] weight sum), what the CUDA kernel writes."""
    hh = clip(h, 0.0)[:, None, None, :] + EPS
    return _nlm_uw_hh(rgb, hh, search_window_size, patch_size)


def _nlm_uw_hh(rgb, hh, search_window_size: int = 11, patch_size: int = 5):
    """(U, W) for the strength hh = relu(h) + eps, [N, 1, 1, 1]."""
    r = search_window_size // 2
    y = rgb_to_luminance(rgb)
    weights = torch.zeros_like(y)
    denoised = torch.zeros_like(rgb)
    for dx in range(-r, r + 1):
        for dy in range(-r, r + 1):
            shifted_rgb = torch.roll(rgb, (dy, dx), dims=(1, 2))
            shifted_y = torch.roll(y, (dy, dx), dims=(1, 2))
            dist = _safe_sqrt(box_sum((y - shifted_y) ** 2, patch_size))
            w = torch.exp(-dist / hh)
            denoised = denoised + shifted_rgb * w
            weights = weights + w
    return denoised / weights, weights


def canon_gate(gate, n: int, device):
    """[N] / [N, 1] blend weights (e.g. a one-hot column, a strided view) ->
    contiguous [N, 1] float32 with no gradient; None means every image is
    on."""
    if gate is None:
        return torch.ones((n, 1), dtype=torch.float32, device=device)
    return torch.as_tensor(gate, dtype=torch.float32,
                           device=device).detach().reshape(n, 1).contiguous()


def nlm_gray_dispatch(rgb, h, gate=None):
    """Gated gray NLM: images whose gate is exactly 0 return zeros."""
    n = rgb.shape[0]
    out = nlm_gray(rgb, h.to(torch.float32).expand(n, 1))
    return torch.where(canon_gate(gate, n, rgb.device)[:, :, None, None] != 0,
                       out, 0.0)
