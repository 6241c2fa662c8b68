"""Letterbox resize, host-side NumPy (port of
``adaptiveisp_tpu/data/letterbox.py``).

The resize is cv2's ``INTER_LINEAR`` (half-pixel centres): the port's own
build of ``csrc/preprocess.cpp`` (:mod:`.native`) where it builds, else the
NumPy version below.  Ratios and padding follow the reference's letterbox.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def resize_bilinear(im: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """cv2.resize(INTER_LINEAR)-compatible bilinear resize, HWC float.

    Dispatches to the native C++ library (csrc/preprocess.cpp) when built;
    the NumPy path below is the reference implementation and fallback.
    """
    h, w = im.shape[:2]
    if (h, w) == (out_h, out_w):
        return im
    if im.ndim == 3:
        from adaptiveisp_tpu_torch.data.native import resize_bilinear_native

        out = resize_bilinear_native(im, out_h, out_w)
        if out is not None:
            return out
    # half-pixel centers (cv2 convention)
    ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    y0c = np.clip(y0, 0, h - 1)
    y1c = np.clip(y0 + 1, 0, h - 1)
    x0c = np.clip(x0, 0, w - 1)
    x1c = np.clip(x0 + 1, 0, w - 1)
    im = im.astype(np.float32)
    top = im[y0c][:, x0c] * (1 - wx) + im[y0c][:, x1c] * wx
    bot = im[y1c][:, x0c] * (1 - wx) + im[y1c][:, x1c] * wx
    return top * (1 - wy) + bot * wy


def letterbox(im: np.ndarray, new_shape=(640, 640), scaleup: bool = True
              ) -> Tuple[np.ndarray, Tuple[float, float], Tuple[float, float]]:
    """Resize + pad to `new_shape` keeping aspect, with black borders: the
    reference's letterbox (:111-143) as the datasets call it (auto=False,
    color=(0,0,0), reference dataset.py:616).

    Returns (image, (rw, rh), (dw, dh)).
    """
    shape = im.shape[:2]  # h, w
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)

    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:
        r = min(r, 1.0)

    ratio = (r, r)
    new_unpad = (int(round(shape[1] * r)), int(round(shape[0] * r)))  # w, h
    dw = new_shape[1] - new_unpad[0]
    dh = new_shape[0] - new_unpad[1]
    dw /= 2
    dh /= 2

    if shape[::-1] != new_unpad:
        im = resize_bilinear(im, new_unpad[1], new_unpad[0])
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    oh, ow = im.shape[0] + top + bottom, im.shape[1] + left + right
    if im.dtype == np.float32:
        from adaptiveisp_tpu_torch.data.native import fill_paste_native

        out = fill_paste_native(im, oh, ow, top, left, 0.0)
        if out is not None:
            return out, ratio, (dw, dh)
    out = np.zeros((oh, ow, im.shape[2]), dtype=im.dtype)
    out[top:top + im.shape[0], left:left + im.shape[1]] = im
    return out, ratio, (dw, dh)

