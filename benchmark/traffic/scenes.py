"""Seeded low-light scenes with box labels, made on the device.

Every traffic mix draws its images here, from ``--seed`` and the mix's
``scene`` parameters: a smooth dark background (a coarse random grid,
upsampled), a few filled rectangles and ellipses of random colours, each
with a box label of a COCO class, the whole scaled to a low mean brightness
and given sensor-like noise.  The same seed gives the same images and
labels, on any card.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

DEFAULT_SCENE = {
    "grid": 6,                  # coarse background grid, per side
    "objects": [2, 6],          # objects an image, inclusive
    "object_size": [0.06, 0.35],  # box side as a share of the frame's
    "mean_brightness": [0.03, 0.12],
    "noise_std": 0.01,
    "classes": 80,
    "chunk": 16,                # images painted at once
}


def make_scenes(n: int, height: int, width: int, seed: int, device,
                params: Dict = None) -> Tuple[torch.Tensor, List[np.ndarray]]:
    """``n`` NHWC float32 images in [0, 1] on ``device`` and one label array
    per image ([k, 5]: class, x centre, y centre, width, height, normalised
    as YOLO's text labels)."""
    p = dict(DEFAULT_SCENE, **(params or {}))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    k = int(p["objects"][1])
    count = torch.randint(int(p["objects"][0]), k + 1, (n,), generator=gen,
                          device=device)
    lo, hi = p["object_size"]
    bw, bh = lo + (hi - lo) * rand(n, k), lo + (hi - lo) * rand(n, k)
    cx = bw / 2 + (1 - bw) * rand(n, k)
    cy = bh / 2 + (1 - bh) * rand(n, k)
    ellipse = rand(n, k) < 0.5
    colour = rand(n, k, 3)
    cls = torch.randint(0, int(p["classes"]), (n, k), generator=gen,
                        device=device)
    b_lo, b_hi = p["mean_brightness"]
    target = b_lo + (b_hi - b_lo) * rand(n)
    grid = int(p["grid"])
    coarse = rand(n, 3, grid, grid)
    noise_seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                                   device=device).item())

    out = torch.empty((n, height, width, 3), dtype=torch.float32,
                      device=device)
    ys = (torch.arange(height, device=device, dtype=torch.float32) + 0.5
          ) / height
    xs = (torch.arange(width, device=device, dtype=torch.float32) + 0.5
          ) / width
    noise_gen = torch.Generator(device=device)
    noise_gen.manual_seed(noise_seed)
    step = int(p["chunk"])
    for a in range(0, n, step):
        b = min(n, a + step)
        img = F.interpolate(coarse[a:b], size=(height, width),
                            mode="bilinear", align_corners=False)
        img = img.permute(0, 2, 3, 1).contiguous()
        for j in range(k):
            dx = (xs[None, None, :] - cx[a:b, j, None, None]) / (
                bw[a:b, j, None, None] / 2)
            dy = (ys[None, :, None] - cy[a:b, j, None, None]) / (
                bh[a:b, j, None, None] / 2)
            inside = torch.where(ellipse[a:b, j, None, None],
                                 dx * dx + dy * dy <= 1.0,
                                 (dx.abs() <= 1.0) & (dy.abs() <= 1.0))
            inside = inside & (j < count[a:b, None, None])
            img = torch.where(inside[..., None],
                              colour[a:b, j, None, None, :], img)
        img = img * (target[a:b] / img.mean(dim=(1, 2, 3)).clamp_min(1e-6)
                     )[:, None, None, None]
        img = img + float(p["noise_std"]) * torch.randn(
            img.shape, generator=noise_gen, device=device)
        out[a:b] = img.clamp(0.0, 1.0)

    host = torch.stack([cls.to(torch.float32), cx, cy, bw, bh], -1).cpu()
    counts = count.cpu().tolist()
    labels = [host[i, :counts[i]].numpy().copy() for i in range(n)]
    return out, labels
