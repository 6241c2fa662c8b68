"""Run-directory and image-saving helpers (port of the host-only
``increment_path`` and ``save_img`` of ``adaptiveisp_tpu/obs/logging.py``).
"""

from __future__ import annotations

import os

import numpy as np


def increment_path(path: str, exist_ok: bool = False, sep: str = "",
                   mkdir: bool = False) -> str:
    """runs/exp -> runs/exp{sep}2, {sep}3... when the path already exists:
    run directories never overwrite each other unless the caller passes
    exist_ok."""
    p = str(path)
    if os.path.exists(p) and not exist_ok:
        base, suffix = (os.path.splitext(p) if os.path.isfile(p)
                        else (p, ""))
        for n in range(2, 9999):
            cand = f"{base}{sep}{n}{suffix}"
            if not os.path.exists(cand):
                p = cand
                break
    if mkdir:
        os.makedirs(p, exist_ok=True)
    return p


def save_img(img, path: str):
    """Save an HWC [0, 1] float image as PNG: NaN becomes 0, values are
    clipped, then floored to 8 bits."""
    from PIL import Image

    img = np.asarray(img)
    if img.ndim == 4:
        img = img[0]
    img = np.nan_to_num(img, nan=0.0)
    img = np.clip(img, 0.0, 1.0)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray((img * 255).astype(np.uint8)).save(path)
