"""Sharpening (port of ``adaptiveisp_tpu/ops/sharpen.py``).

  - adjust_sharpness / sharpness: VALID 3x3 blur with kernel ones(3, 3) with
    centre 5, normalised by 13; the 1-pixel border keeps the original image.
  - unsharp_mask: reflect-padded Gaussian blur with per-sample sigma,
    out = img + (img - blur) * amount.

All NHWC, float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.ops.math import clip as clip_range
from benchmark.reference.ops.math import depthwise_conv3x3

_SHARPEN_KERNEL = np.array(
    [[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]], np.float32) / 13.0


def _blur_keep_border(img):
    """VALID 3x3 blur; border pixels keep the original image value."""
    inner = depthwise_conv3x3(img, _SHARPEN_KERNEL, padding="VALID")
    out = img.clone()
    out[:, 1:-1, 1:-1, :] = inner
    return out


def adjust_sharpness(img, factor):
    """out = img * factor + blurred * (1 - factor), clipped to [0, 1];
    factor broadcastable to [N, 1, 1, 1]."""
    blurred = _blur_keep_border(img)
    return clip_range(img * factor + blurred * (1.0 - factor), 0.0, 1.0)


def sharpness(img, factor):
    """out = img + (img - blurred) * factor, clipped to [0, 1]."""
    blurred = _blur_keep_border(img)
    return clip_range(img + (img - blurred) * factor, 0.0, 1.0)


def gaussian_kernel1d(kernel_size: int, sigma):
    """Normalised 1-D Gaussian per sample: sigma [N] -> [N, kernel_size]."""
    half = (kernel_size - 1) * 0.5
    x = torch.from_numpy(
        np.linspace(-half, half, kernel_size).astype(np.float32)).to(
            sigma.device)
    pdf = torch.exp(-0.5 * (x[None, :] / sigma[:, None]) ** 2)
    return pdf / pdf.sum(dim=1, keepdim=True)


def unsharp_mask(img, sigma, amount, kernel_size: int = 5, clip: bool = True):
    """Gaussian unsharp mask; img [N, H, W, C], sigma and amount [N]."""
    assert kernel_size % 2 == 1, "slice-sum blur needs an odd kernel"
    k1 = gaussian_kernel1d(kernel_size, sigma)
    k2 = k1[:, :, None] * k1[:, None, :]  # [N, ks, ks]
    pad = kernel_size // 2
    x = F.pad(img.permute(0, 3, 1, 2), (pad, pad, pad, pad),
              mode="reflect").permute(0, 2, 3, 1)
    n, h, w, c = img.shape
    blurred = torch.zeros_like(img)
    for i in range(kernel_size):
        for j in range(kernel_size):
            blurred = blurred + (k2[:, i, j, None, None, None]
                                 * x[:, i:i + h, j:j + w, :])
    out = img + (img - blurred) * amount[:, None, None, None]
    if clip:
        out = clip_range(out, 0.0, 1.0)
    return out
