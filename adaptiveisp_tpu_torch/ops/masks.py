"""Quadratic scene-luminance spatial masks (port of
``adaptiveisp_tpu/ops/masks.py``).

Off by default (``cfg.masking = False``); the roster path still calls
:func:`get_mask`, which then returns a broadcastable one.  NHWC throughout
([N, H, W, 1] mask).
"""

from __future__ import annotations

import numpy as np
import torch

from adaptiveisp_tpu_torch.obs.profile import count
from adaptiveisp_tpu_torch.ops.math import rgb2lum, tanh_range

FILTER_INPUT_RANGE = 5.0
NUM_MASK_PARAMETERS = 6


def mask_grid(h: int, w: int, dtype=torch.float32, device=None):
    """Centered coordinate grid normalised by the shorter edge."""
    shorter = min(h, w)
    i = (np.arange(h, dtype=np.float64) + (shorter - h) / 2.0) / shorter - 0.5
    j = (np.arange(w, dtype=np.float64) + (shorter - w) / 2.0) / shorter - 0.5
    count("host_read.upload.render", 2)
    gy = torch.as_tensor(np.broadcast_to(i[:, None], (h, w)).copy(),
                         dtype=dtype, device=device)
    gx = torch.as_tensor(np.broadcast_to(j[None, :], (h, w)).copy(),
                         dtype=dtype, device=device)
    return gy, gx


def get_mask(cfg, img, mask_parameters=None, row_window=None):
    """Spatial strength mask in [minimum_strength, 1].

    img: [N, H, W, 3]; mask_parameters: [N, 6] raw (pre-squash) or None.
    row_window: ``(lo, height)`` when img holds rows ``lo ...`` of a frame
    of ``height`` rows (a spatial rank's block); the grid is the frame's.
    Returns [N, H, W, 1], or a broadcastable ones tensor when masking is off.
    """
    if not cfg.masking or mask_parameters is None:
        return torch.ones((1, 1, 1, 1), dtype=img.dtype, device=img.device)
    mp = tanh_range(-FILTER_INPUT_RANGE, FILTER_INPUT_RANGE, initial=0)(
        mask_parameters)
    n, h, w, _ = img.shape
    if row_window is None:
        gy, gx = mask_grid(h, w, img.dtype, img.device)
    else:
        lo, height = row_window
        gy, gx = (g[lo:lo + h] for g in mask_grid(height, w, img.dtype,
                                                   img.device))

    def col(k):
        return mp[:, k, None, None, None]

    inp = (gy[None, :, :, None] * col(0) + gx[None, :, :, None] * col(1)
           + col(2) * (rgb2lum(img) - 0.5) + col(3) * 2.0)
    inp = inp * (cfg.maximum_sharpness * col(4) / FILTER_INPUT_RANGE)
    mask = 1.0 / (1.0 + torch.exp(-inp))
    strength = col(5) / FILTER_INPUT_RANGE * 0.5 + 0.5
    return (mask * strength * (1.0 - cfg.minimum_strength)
            + cfg.minimum_strength)
