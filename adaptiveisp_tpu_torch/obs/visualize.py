"""Trajectory pictures: per-step images above the action distribution of
each step (port of ``adaptiveisp_tpu/obs/visualize.py``; PIL-free NumPy,
saved by ``obs.logging.save_img``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def pdf_bars(pdf: np.ndarray, selected: int, size: int = 64,
             names: Optional[Sequence[str]] = None) -> np.ndarray:
    """Render an action distribution as a horizontal-bar panel [size,size,3]."""
    k = len(pdf)
    img = np.full((size, size, 3), 0.5, np.float32)
    row_h = max(size // (k + 1), 2)
    for i, p in enumerate(pdf):
        y0 = i * row_h + 1
        y1 = min(y0 + row_h - 2, size - 1)
        width = int(np.clip(p, 0, 1) * (size - 10))
        color = (np.array([1.0, 0.3, 0.3]) if i == selected
                 else np.array([0.3, 0.3, 0.3]))
        img[y0:y1, 4:4 + max(width, 1)] = color
    return img


def trajectory_strip(images: List[np.ndarray], pdfs: List[np.ndarray],
                     selected: List[int], patch: int = 64,
                     padding: int = 4) -> np.ndarray:
    """Two-row strip: step images on top, decision bars below.

    images: per-step HWC arrays (len = steps+1 incl. the input);
    pdfs/selected: per-step (len = steps).
    """
    from adaptiveisp_tpu_torch.data.letterbox import resize_bilinear

    grid = patch + padding
    steps = len(images)
    out = np.ones((grid * 2, grid * steps, 3), np.float32)
    for i, im in enumerate(images):
        thumb = resize_bilinear(np.clip(im, 0, 1).astype(np.float32),
                                patch, patch)
        out[0:patch, i * grid:i * grid + patch] = thumb
    for i, (pdf, sel) in enumerate(zip(pdfs, selected)):
        if sel < 0:
            continue
        panel = pdf_bars(np.asarray(pdf), int(sel), patch)
        sx = i * grid + grid // 2
        sx = min(sx, out.shape[1] - patch)
        out[grid:grid + patch, sx:sx + patch] = panel
    return out
