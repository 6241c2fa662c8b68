"""Observability on the host: stdout tee, metric writer, run directories
and image dumps (port of ``adaptiveisp_tpu/obs/logging.py``).

``MetricWriter`` writes TensorBoard events when ``torch.utils.tensorboard``
imports and a JSONL metric log always.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict

import numpy as np


class Tee:
    """Mirror stdout and stderr into a log file until ``close()``."""

    def __init__(self, path: str):
        self.file = open(path, "w")
        self.stdout = sys.stdout
        self.stderr = sys.stderr
        sys.stdout = self
        sys.stderr = self

    def write(self, data):
        self.file.write(data)
        self.stdout.write(data)
        self.file.flush()
        self.stdout.flush()

    def flush(self):
        self.file.flush()
        self.stdout.flush()

    def close(self):
        sys.stdout = self.stdout
        sys.stderr = self.stderr
        self.file.close()


class MetricWriter:
    """Scalar and image writer: ``metrics.jsonl`` (one JSON object a
    scalar) always, TensorBoard too when it imports."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self.tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.tb = SummaryWriter(log_dir)
        except Exception:  # no tensorboard, or it fails to start: JSONL only
            self.tb = None

    def scalar(self, tag: str, value: float, step: int):
        self.jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step),
             "ts": time.time()}) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            self.tb.add_scalar(tag, value, global_step=step)

    def scalars(self, values: Dict[str, float], step: int):
        for k, v in values.items():
            self.scalar(k, v, step)

    def image(self, tag: str, img_hwc: np.ndarray, step: int):
        save_img(img_hwc, os.path.join(
            self.log_dir, f"{tag.replace('/', '_')}_{step}.png"))
        if self.tb is not None:
            self.tb.add_image(tag, np.clip(img_hwc, 0, 1),
                              global_step=step, dataformats="HWC")

    def close(self):
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()


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


def make_image_grid(images: np.ndarray, per_row: int = 2,
                    padding: int = 2) -> np.ndarray:
    """NHWC -> one grid image, ``per_row`` images a row, white padding."""
    npad = ((0, 0), (padding, padding), (padding, padding), (0, 0))
    images = np.pad(images, pad_width=npad, mode="constant",
                    constant_values=1.0)
    if images.shape[0] % per_row:
        raise ValueError(f"{images.shape[0]} images do not fill rows of "
                         f"{per_row}")
    rows = [np.hstack(images[i * per_row:(i + 1) * per_row])
            for i in range(images.shape[0] // per_row)]
    return np.vstack(rows)
