"""The plain reference's view of a training image: the PNG and the label
file that the benchmark wrote, read as LOD's ``normalize`` source reads
them (a frozen copy of the port's plain data code: PIL decode to [0, 1],
the longest side resized to the image size by a cv2-convention bilinear
resize, a black letterbox, the labels moved into the letterboxed frame).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from benchmark.reference.detect.boxes import xywhn2xyxy, xyxy2xywhn


def resize_bilinear(im: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """cv2.resize(INTER_LINEAR) with half-pixel centres, HWC float32."""
    h, w = im.shape[:2]
    if (h, w) == (out_h, out_w):
        return im
    ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0, x0 = np.floor(ys).astype(int), np.floor(xs).astype(int)
    wy, wx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    y0c, y1c = np.clip(y0, 0, h - 1), np.clip(y0 + 1, 0, h - 1)
    x0c, x1c = np.clip(x0, 0, w - 1), np.clip(x0 + 1, 0, w - 1)
    top = im[y0c][:, x0c] * (1 - wx) + im[y0c][:, x1c] * wx
    bot = im[y1c][:, x0c] * (1 - wx) + im[y1c][:, x1c] * wx
    return (top * (1 - wy) + bot * wy).astype(np.float32)


def letterbox(im: np.ndarray, size: int
              ) -> Tuple[np.ndarray, float, Tuple[float, float]]:
    """Pad (never enlarge) to ``size`` x ``size`` with black borders:
    (image, ratio, (dw, dh))."""
    h, w = im.shape[:2]
    r = min(size / h, size / w, 1.0)
    new_w, new_h = int(round(w * r)), int(round(h * r))
    dw, dh = (size - new_w) / 2, (size - new_h) / 2
    if (w, h) != (new_w, new_h):
        im = resize_bilinear(im, new_h, new_w)
    top, left = int(round(dh - 0.1)), int(round(dw - 0.1))
    out = np.zeros((size, size, im.shape[2]), np.float32)
    out[top:top + im.shape[0], left:left + im.shape[1]] = im
    return out, r, (dw, dh)


def label_path(image_path: str) -> str:
    """``.../images/x.png`` -> ``.../labels/x.txt``."""
    a, b = f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}"
    return b.join(image_path.rsplit(a, 1)).rsplit(".", 1)[0] + ".txt"


def read_labels(path: str) -> np.ndarray:
    """[n, 5] (class, normalised xywh), identical rows once each."""
    with open(path) as f:
        rows = [ln.split() for ln in f.read().strip().splitlines() if ln]
    if not rows:
        return np.zeros((0, 5), np.float32)
    lb = np.asarray(rows, dtype=np.float32)
    _, idx = np.unique(lb, axis=0, return_index=True)
    return lb[np.sort(idx)]


def load(image_path: str, size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(image [size, size, 3] float32 in [0, 1], labels [n, 5] in the
    letterboxed frame) of one training file."""
    from PIL import Image

    with Image.open(image_path) as f:
        im = np.asarray(f.convert("RGB"), dtype=np.float32) / 255.0
    h0, w0 = im.shape[:2]
    r0 = size / max(h0, w0)
    if r0 != 1:
        im = resize_bilinear(im, int(round(h0 * r0)), int(round(w0 * r0)))
    h, w = im.shape[:2]
    im, r, (dw, dh) = letterbox(im, size)
    lb = read_labels(label_path(image_path))
    if len(lb):
        lb[:, 1:] = xywhn2xyxy(lb[:, 1:], r * w, r * h, padw=dw, padh=dh)
        lb[:, 1:5] = xyxy2xywhn(lb[:, 1:5], w=size, h=size, clip=True,
                                eps=1e-3)
    return im, lb
