"""Bayer mosaic utilities (port of ``adaptiveisp_tpu/raw/bayer.py``) on
torch tensors, on any device."""

from __future__ import annotations

import torch

BAYER_INDICES = {
    # (x0, y0) of each of the four sub-planes
    "gbrg": ((0, 1), (1, 1), (0, 0), (1, 0)),
    "rggb": ((0, 0), (1, 0), (0, 1), (1, 1)),
    "bggr": ((1, 1), (0, 1), (1, 0), (0, 0)),
    "grbg": ((1, 0), (0, 0), (1, 1), (0, 1)),
    "rgbg": ((0, 0), (1, 0), (1, 1), (0, 1)),
}


def mosaic(image: torch.Tensor, pattern: str = "RGGB") -> torch.Tensor:
    """Bayer planes of an [..., H, W, 3] RGB image -> [..., H/2, W/2, 4]."""
    red = image[..., 0::2, 0::2, 0]
    green_red = image[..., 0::2, 1::2, 1]
    green_blue = image[..., 1::2, 0::2, 1]
    blue = image[..., 1::2, 1::2, 2]
    p = pattern.upper()
    if p == "RGGB":
        return torch.stack((red, green_red, green_blue, blue), dim=-1)
    if p == "RGBG":  # Canon 5D Mark IV layout
        return torch.stack((red, green_red, blue, green_blue), dim=-1)
    raise ValueError(f"Unsupported Bayer pattern: {p}")


def reconstruct_bayer(raw: torch.Tensor, bayer_pattern: str) -> torch.Tensor:
    """A [H, W] Bayer array from [H/2, W/2, 4] planes."""
    idx = BAYER_INDICES[bayer_pattern.lower()]
    h2, w2 = raw.shape[0], raw.shape[1]
    bayer = raw.new_zeros((2 * h2, 2 * w2))
    for i, (x0, y0) in enumerate(idx):
        bayer[y0::2, x0::2] = raw[..., i]
    return bayer
