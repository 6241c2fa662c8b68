"""Detector-training augmentations, host-side NumPy (port of
``adaptiveisp_tpu/data/augment.py``).

  augment_hsv          HSV gains on float RGB (no uint8 LUT)
  random_perspective   affine/perspective compose, box warp, box_candidates
  mixup                Beta(32, 32) blend
  mosaic4 / mosaic9    4- and 9-image mosaics with the border-removing warp
  flips, ExtraAugment, copy_paste, rect_batch_shapes

Images are float32 RGB HWC in [0, 1].  Every random draw comes from the
``np.random.RandomState`` the caller passes, in the JAX package's order, so
the same state gives the same arrays.  The warp is a vectorised inverse-map
bilinear sampler with cv2's integer pixel centres and constant fill.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple

import numpy as np

from adaptiveisp_tpu_torch.detect.boxes import (  # noqa: F401
    xywhn2xyxy,
    xyxy2xywhn,
)

FILL = 114.0 / 255.0  # the reference's gray border (114 uint8)


def _rgb2hsv(img: np.ndarray) -> np.ndarray:
    """Float RGB [H, W, 3] in [0,1] -> HSV with h in [0, 1)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    mx = img.max(-1)
    mn = img.min(-1)
    rng = mx - mn + 1e-8
    hue = np.zeros_like(mx)
    hue = np.where(b == mx, 4.0 + (r - g) / rng, hue)
    hue = np.where(g == mx, 2.0 + (b - r) / rng, hue)
    hue = np.where(r == mx, ((g - b) / rng) % 6.0, hue)
    hue = np.where(mn == mx, 0.0, hue) / 6.0
    sat = np.where(mx == 0, 0.0, (mx - mn) / (mx + 1e-8))
    return np.stack([hue, sat, mx], axis=-1)


def _hsv2rgb(hsv: np.ndarray) -> np.ndarray:
    h = hsv[..., 0] % 1.0
    s = np.clip(hsv[..., 1], 0, 1)
    v = np.clip(hsv[..., 2], 0, 1)
    hi = np.floor(h * 6.0)
    f = h * 6.0 - hi
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)

    def pick(*cands):
        out = np.zeros_like(h)
        for idx, c in enumerate(cands):
            out = np.where(hi == idx, c, out)
        return out

    return np.stack([pick(v, q, p, p, t, v),
                     pick(t, v, v, q, p, p),
                     pick(p, p, t, v, v, q)], axis=-1)


# --------------------------------------------------------------------------- #
# Box utilities
# --------------------------------------------------------------------------- #


def box_candidates(box1: np.ndarray, box2: np.ndarray, wh_thr: float = 2,
                   ar_thr: float = 100, area_thr: float = 0.1,
                   eps: float = 1e-16) -> np.ndarray:
    """Keep boxes that survived augmentation (reference augmentations.py:299-
    307): min side, area ratio, aspect ratio.  box1/box2: [4, n] xyxy."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return ((w2 > wh_thr) & (h2 > wh_thr)
            & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr))


# --------------------------------------------------------------------------- #
# Photometric
# --------------------------------------------------------------------------- #
def augment_hsv(im: np.ndarray, rng: np.random.RandomState,
                hgain: float = 0.5, sgain: float = 0.5,
                vgain: float = 0.5) -> np.ndarray:
    """Random HSV jitter.  im: [H, W, 3] float RGB in [0, 1].

    Reference semantics (augmentations.py:67-80): three gains drawn
    uniform(1-g, 1+g); hue shifts modulo the hue wheel, sat/val scale with
    clipping.  Float-native here (no uint8 LUT)."""
    if not (hgain or sgain or vgain):
        return im
    r = rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
    hsv = _rgb2hsv(im)
    hsv[..., 0] = (hsv[..., 0] * r[0]) % 1.0
    hsv[..., 1] = np.clip(hsv[..., 1] * r[1], 0, 1)
    hsv[..., 2] = np.clip(hsv[..., 2] * r[2], 0, 1)
    return _hsv2rgb(hsv).astype(np.float32)


def mixup(im: np.ndarray, labels: np.ndarray, im2: np.ndarray,
          labels2: np.ndarray, rng: np.random.RandomState
          ) -> Tuple[np.ndarray, np.ndarray]:
    """Beta(32, 32) image blend, labels concatenated
    (reference augmentations.py:289-296)."""
    r = rng.beta(32.0, 32.0)
    im = (im * r + im2 * (1 - r)).astype(np.float32)
    return im, np.concatenate([labels, labels2], 0)


class ExtraAugment:
    """Extra low-probability photometric transforms.

    Counterpart of the reference's optional Albumentations wrapper
    (augmentations.py:22-52), which — when the external package is
    installed — applies Blur/MedianBlur/ToGray/CLAHE each at p=0.01.
    Those four are implemented here in plain NumPy (box blur, 3x3 median,
    luminance grayscale, tile-free histogram equalization as the CLAHE
    stand-in), so the capability ships without the dependency; box-only
    transforms (the preset's p=0.0 entries) are omitted.  Custom
    callables can be appended via ``transforms``: each is
    ``f(img, rng) -> img`` with its own probability."""

    def __init__(self, p_blur: float = 0.01, p_median: float = 0.01,
                 p_gray: float = 0.01, p_clahe: float = 0.01,
                 transforms: Sequence = ()):
        self.ops = [(p_blur, self._blur), (p_median, self._median),
                    (p_gray, self._gray), (p_clahe, self._equalize)]
        self.ops += [(p, f) for p, f in transforms]

    def __call__(self, img: np.ndarray,
                 rng: np.random.RandomState) -> np.ndarray:
        for p, f in self.ops:
            if p and rng.rand() < p:
                img = f(img, rng)
        return img

    @staticmethod
    def _blur(img, rng, k: int = 3):
        pad = k // 2
        x = np.pad(img, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
        out = np.zeros_like(img)
        for dy in range(k):
            for dx in range(k):
                out += x[dy:dy + img.shape[0], dx:dx + img.shape[1]]
        return out / (k * k)

    @staticmethod
    def _median(img, rng, k: int = 3):
        pad = k // 2
        x = np.pad(img, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
        stack = [x[dy:dy + img.shape[0], dx:dx + img.shape[1]]
                 for dy in range(k) for dx in range(k)]
        return np.median(np.stack(stack), axis=0).astype(img.dtype)

    @staticmethod
    def _gray(img, rng):
        lum = (0.299 * img[..., 0] + 0.587 * img[..., 1]
               + 0.114 * img[..., 2])
        return np.repeat(lum[..., None], 3, axis=-1).astype(img.dtype)

    @staticmethod
    def _equalize(img, rng, bins: int = 256):
        lum = (0.299 * img[..., 0] + 0.587 * img[..., 1]
               + 0.114 * img[..., 2])
        hist, edges = np.histogram(lum, bins=bins, range=(0.0, 1.0))
        cdf = hist.cumsum().astype(np.float64)
        if cdf[-1] == 0:
            return img
        cdf /= cdf[-1]
        eq = np.interp(lum.ravel(), edges[:-1], cdf).reshape(lum.shape)
        gain = eq / np.maximum(lum, 1e-6)
        return np.clip(img * gain[..., None], 0.0, 1.0).astype(img.dtype)


def bbox_ioa(box: np.ndarray, boxes: np.ndarray,
             eps: float = 1e-7) -> np.ndarray:
    """Intersection of `box` with each of `boxes`, over the AREA OF
    `boxes` (reference utils/metrics.py bbox_ioa).  xyxy pixel coords."""
    b1x1, b1y1, b1x2, b1y2 = box
    b2x1, b2y1, b2x2, b2y2 = boxes.T
    iw = np.clip(np.minimum(b1x2, b2x2) - np.maximum(b1x1, b2x1), 0, None)
    ih = np.clip(np.minimum(b1y2, b2y2) - np.maximum(b1y1, b2y1), 0, None)
    area2 = (b2x2 - b2x1) * (b2y2 - b2y1) + eps
    return iw * ih / area2


def polygon2mask(shape: Tuple[int, int], polygon: np.ndarray) -> np.ndarray:
    """Rasterise one polygon (pixel coordinates) to a float {0, 1} mask of
    ``shape`` (h, w), with PIL (cv2.fillPoly in the reference); shared with
    ``segment_dataset``."""
    from PIL import Image, ImageDraw

    im = Image.new("L", (shape[1], shape[0]), 0)
    pts = [(float(x), float(y)) for x, y in polygon]
    if len(pts) >= 3:
        ImageDraw.Draw(im).polygon(pts, outline=1, fill=1)
    return np.asarray(im, np.float32)


def copy_paste(im: np.ndarray, labels: np.ndarray,
               segments: List[np.ndarray], p: float,
               rng: np.random.RandomState):
    """Copy-Paste augmentation (arXiv:2012.07177; reference
    augmentations.py:240-258): mirror round(p*n) random instances
    left-right and paste their pixels at the mirrored location, when the
    mirrored box obscures <30% of every existing label.

    im: float [h, w, 3]; labels: [n, 5] (cls, xyxy pixels); segments:
    list of [k, 2] pixel polygons.  Returns the augmented triple."""
    n = len(segments)
    if not (p and n):
        return im, labels, segments
    h, w = im.shape[:2]
    pasted = np.zeros((h, w), np.float32)
    any_pasted = False
    for j in rng.choice(n, size=round(p * n), replace=False):
        lb, seg = labels[j], segments[j]
        box = np.array([w - lb[3], lb[2], w - lb[1], lb[4]], np.float32)
        ioa = bbox_ioa(box, labels[:, 1:5])
        if (ioa < 0.30).all():  # allow 30% obscuration of existing labels
            labels = np.concatenate(
                (labels, [[lb[0], *box]]), 0).astype(np.float32)
            segments.append(np.concatenate(
                (w - seg[:, 0:1], seg[:, 1:2]), 1))
            pasted = np.maximum(pasted, polygon2mask((h, w), seg))
            any_pasted = True
    if any_pasted:
        m = pasted[:, ::-1] > 0.5  # instance regions, mirrored
        im = im.copy()
        im[m] = im[:, ::-1][m]
    return im, labels, segments


def flip_lr(im: np.ndarray, labels_xywhn: np.ndarray):
    im = np.ascontiguousarray(im[:, ::-1])
    if labels_xywhn.size:
        labels_xywhn = labels_xywhn.copy()
        labels_xywhn[:, 1] = 1 - labels_xywhn[:, 1]
    return im, labels_xywhn


def flip_ud(im: np.ndarray, labels_xywhn: np.ndarray):
    im = np.ascontiguousarray(im[::-1])
    if labels_xywhn.size:
        labels_xywhn = labels_xywhn.copy()
        labels_xywhn[:, 2] = 1 - labels_xywhn[:, 2]
    return im, labels_xywhn


# --------------------------------------------------------------------------- #
# Geometric: affine/perspective warp
# --------------------------------------------------------------------------- #
def warp_image(im: np.ndarray, M: np.ndarray, out_h: int, out_w: int,
               fill: float = FILL) -> np.ndarray:
    """dst(x, y) = src(M^-1 [x, y, 1]) with bilinear sampling and constant
    fill outside the source — the cv2.warpAffine/warpPerspective convention
    (integer pixel centers)."""
    h, w = im.shape[:2]
    Minv = np.linalg.inv(M)
    ys, xs = np.mgrid[0:out_h, 0:out_w].astype(np.float64)
    denom = Minv[2, 0] * xs + Minv[2, 1] * ys + Minv[2, 2]
    sx = (Minv[0, 0] * xs + Minv[0, 1] * ys + Minv[0, 2]) / denom
    sy = (Minv[1, 0] * xs + Minv[1, 1] * ys + Minv[1, 2]) / denom

    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    wx = (sx - x0).astype(np.float32)[..., None]
    wy = (sy - y0).astype(np.float32)[..., None]

    def sample(yy, xx):
        inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        v = im[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        return np.where(inside[..., None], v, np.float32(fill))

    top = sample(y0, x0) * (1 - wx) + sample(y0, x0 + 1) * wx
    bot = sample(y0 + 1, x0) * (1 - wx) + sample(y0 + 1, x0 + 1) * wx
    return (top * (1 - wy) + bot * wy).astype(np.float32)


def random_perspective(im: np.ndarray, targets: np.ndarray,
                       rng: np.random.RandomState, degrees: float = 10,
                       translate: float = 0.1, scale: float = 0.1,
                       shear: float = 10, perspective: float = 0.0,
                       border: Tuple[int, int] = (0, 0)
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Random affine/perspective warp of image + [cls, xyxy] targets
    (reference augmentations.py:144-237).

    The transform composes center -> perspective -> rotation+scale -> shear
    -> translation; boxes are warped by their 4 corners and re-axis-aligned,
    then filtered by box_candidates."""
    height = im.shape[0] + border[0] * 2
    width = im.shape[1] + border[1] * 2

    C = np.eye(3)
    C[0, 2] = -im.shape[1] / 2
    C[1, 2] = -im.shape[0] / 2

    P = np.eye(3)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)

    R = np.eye(3)
    a = math.radians(rng.uniform(-degrees, degrees))
    s = rng.uniform(1 - scale, 1 + scale)
    R[0, 0] = s * math.cos(a)
    R[0, 1] = s * math.sin(a)
    R[1, 0] = -s * math.sin(a)
    R[1, 1] = s * math.cos(a)

    S = np.eye(3)
    S[0, 1] = math.tan(math.radians(rng.uniform(-shear, shear)))
    S[1, 0] = math.tan(math.radians(rng.uniform(-shear, shear)))

    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * width
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * height

    M = T @ S @ R @ P @ C
    if (border[0] != 0) or (border[1] != 0) or np.any(M != np.eye(3)):
        im = warp_image(im, M, height, width)

    n = len(targets)
    if n:
        corners = np.ones((n * 4, 3))
        corners[:, :2] = targets[:, [1, 2, 3, 4, 1, 4, 3, 2]].reshape(n * 4, 2)
        warped = corners @ M.T
        if perspective:
            warped = warped[:, :2] / warped[:, 2:3]
        else:
            warped = warped[:, :2]
        warped = warped.reshape(n, 8)
        x = warped[:, [0, 2, 4, 6]]
        y = warped[:, [1, 3, 5, 7]]
        new = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], axis=1)
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)
        keep = box_candidates(targets[:, 1:5].T * s, new.T, area_thr=0.10)
        targets = targets[keep]
        targets[:, 1:5] = new[keep]
    return im, targets


# --------------------------------------------------------------------------- #
# Mosaic
# --------------------------------------------------------------------------- #
def mosaic4(load_fn: Callable, labels_fn: Callable, indices: Sequence[int],
            s: int, rng: np.random.RandomState, hyp) -> Tuple[np.ndarray,
                                                              np.ndarray]:
    """4-image mosaic (reference dataloaders.py:736-780).

    load_fn(i) -> (im [h, w, 3] float, (h, w));  labels_fn(i) -> [n, 5]
    normalized (cls, xywhn).  Returns (img [s, s, 3], labels [m, 5] pixel
    cls-xyxy after the border-removing random_perspective)."""
    border = (-s // 2, -s // 2)
    yc = int(rng.uniform(-border[0], 2 * s + border[0]))
    xc = int(rng.uniform(-border[1], 2 * s + border[1]))
    img4 = np.full((s * 2, s * 2, 3), FILL, np.float32)
    labels4: List[np.ndarray] = []

    for i, idx in enumerate(indices[:4]):
        img, (h, w) = load_fn(idx)
        if i == 0:  # top left
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b = w - (x2a - x1a), h - (y2a - y1a)
            x2b, y2b = w, h
        elif i == 1:  # top right
            x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, s * 2), yc
            x1b, y1b = 0, h - (y2a - y1a)
            x2b, y2b = min(w, x2a - x1a), h
        elif i == 2:  # bottom left
            x1a, y1a, x2a, y2a = (max(xc - w, 0), yc, xc,
                                  min(s * 2, yc + h))
            x1b, y1b = w - (x2a - x1a), 0
            x2b, y2b = w, min(y2a - y1a, h)
        else:  # bottom right
            x1a, y1a, x2a, y2a = (xc, yc, min(xc + w, s * 2),
                                  min(s * 2, yc + h))
            x1b, y1b = 0, 0
            x2b, y2b = min(w, x2a - x1a), min(y2a - y1a, h)
        img4[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]

        lb = labels_fn(idx)
        if lb.size:
            lb = lb.copy()
            lb[:, 1:] = xywhn2xyxy(lb[:, 1:], w, h, x1a - x1b, y1a - y1b)
        labels4.append(lb)

    labels = (np.concatenate(labels4, 0) if labels4
              else np.zeros((0, 5), np.float32))
    if labels.size:
        labels[:, 1:] = labels[:, 1:].clip(0, 2 * s)
    return random_perspective(
        img4, labels, rng, degrees=hyp.degrees, translate=hyp.translate,
        scale=hyp.scale, shear=hyp.shear, perspective=hyp.perspective,
        border=border)


def mosaic9(load_fn: Callable, labels_fn: Callable, indices: Sequence[int],
            s: int, rng: np.random.RandomState, hyp) -> Tuple[np.ndarray,
                                                              np.ndarray]:
    """9-image mosaic (reference dataloaders.py:816-890)."""
    border = (-s // 2, -s // 2)
    img9 = np.full((s * 3, s * 3, 3), FILL, np.float32)
    labels9: List[np.ndarray] = []
    hp = wp = -1
    h0 = w0 = 0

    for i, idx in enumerate(indices[:9]):
        img, (h, w) = load_fn(idx)
        if i == 0:
            h0, w0 = h, w
            c = s, s, s + w, s + h
        elif i == 1:
            c = s, s - h, s + w, s
        elif i == 2:
            c = s + wp, s - h, s + wp + w, s
        elif i == 3:
            c = s + w0, s, s + w0 + w, s + h
        elif i == 4:
            c = s + w0, s + hp, s + w0 + w, s + hp + h
        elif i == 5:
            c = s + w0 - w, s + h0, s + w0, s + h0 + h
        elif i == 6:
            c = s + w0 - wp - w, s + h0, s + w0 - wp, s + h0 + h
        elif i == 7:
            c = s - w, s + h0 - h, s, s + h0
        else:
            c = s - w, s + h0 - hp - h, s, s + h0 - hp
        padx, pady = c[:2]
        x1, y1, x2, y2 = (max(v, 0) for v in c)
        img9[y1:y2, x1:x2] = img[y1 - pady:, x1 - padx:][:y2 - y1, :x2 - x1]
        hp, wp = h, w

        lb = labels_fn(idx)
        if lb.size:
            lb = lb.copy()
            lb[:, 1:] = xywhn2xyxy(lb[:, 1:], w, h, padx, pady)
        labels9.append(lb)

    yc = int(rng.uniform(0, s))
    xc = int(rng.uniform(0, s))
    img9 = img9[yc:yc + 2 * s, xc:xc + 2 * s]

    labels = (np.concatenate(labels9, 0) if labels9
              else np.zeros((0, 5), np.float32))
    if labels.size:
        labels[:, [1, 3]] -= xc
        labels[:, [2, 4]] -= yc
        labels[:, 1:] = labels[:, 1:].clip(0, 2 * s)
    return random_perspective(
        img9, labels, rng, degrees=hyp.degrees, translate=hyp.translate,
        scale=hyp.scale, shear=hyp.shear, perspective=hyp.perspective,
        border=border)


# --------------------------------------------------------------------------- #
# Rect-batch aspect bucketing
# --------------------------------------------------------------------------- #
def rect_batch_shapes(shapes_wh: np.ndarray, batch_size: int, img_size: int,
                      stride: int = 32, pad: float = 0.5
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Sort by aspect ratio and compute per-batch letterbox shapes
    (reference dataloaders.py:552-575).

    shapes_wh: [n, 2] original (w, h).  Returns (sort_order [n],
    batch_shapes [nb, 2] (h, w) stride-multiples)."""
    n = len(shapes_wh)
    bi = np.floor(np.arange(n) / batch_size).astype(int)
    nb = bi[-1] + 1 if n else 0
    ar = shapes_wh[:, 1] / shapes_wh[:, 0]  # h / w
    order = ar.argsort()
    ar = ar[order]

    shapes = np.ones((nb, 2))
    for i in range(nb):
        ari = ar[bi == i]
        mini, maxi = ari.min(), ari.max()
        if maxi < 1:
            shapes[i] = [maxi, 1]
        elif mini > 1:
            shapes[i] = [1, 1 / mini]
    batch_shapes = (np.ceil(shapes * img_size / stride + pad).astype(int)
                    * stride)
    return order, batch_shapes
