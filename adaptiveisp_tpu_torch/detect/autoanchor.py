"""Anchor-fit checking and k-means anchor refit, host NumPy (port of
``adaptiveisp_tpu/detect/autoanchor.py``): best-possible recall under the
anchor-ratio criterion, anchor order against the strides, a k-means refit
from the dataset's label sizes, and the class and image weights behind
``--image-weights``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def anchor_metric(wh: np.ndarray, anchors: np.ndarray,
                  thr: float = 4.0) -> Tuple[float, float]:
    """(best-anchor-ratio mean, best-possible-recall) for label wh pixels.

    ratio metric r = min(wh/anchor, anchor/wh).min(axis=-1); a label is
    recallable when its best anchor has r > 1/thr.
    """
    r = wh[:, None, :] / anchors[None, :, :]
    ratio = np.minimum(r, 1.0 / r).min(2)  # [n, na]
    best = ratio.max(1)
    bpr = (best > 1.0 / thr).mean()
    aat = (ratio > 1.0 / thr).sum(1).mean()  # anchors above threshold
    return float(aat), float(bpr)


def check_anchor_order(anchors_per_level: Sequence[np.ndarray],
                       strides: Sequence[int]) -> List[np.ndarray]:
    """Ensure anchor areas grow with stride (reference check_anchor_order);
    returns the (possibly reversed) per-level anchor list."""
    mean_area = np.array([np.prod(a, axis=1).mean()
                          for a in anchors_per_level])
    da = mean_area[-1] - mean_area[0]
    ds = strides[-1] - strides[0]
    if np.sign(da) != np.sign(ds):
        return list(anchors_per_level[::-1])
    return list(anchors_per_level)


def kmean_anchors(wh: np.ndarray, n: int = 9, thr: float = 4.0,
                  iters: int = 100, seed: int = 0) -> np.ndarray:
    """Fit n anchors to label wh pixels with k-means (IoU-ish whitened
    metric) + mutation-free refinement.  wh: [m, 2] in pixels."""
    rng = np.random.RandomState(seed)
    wh = wh[(wh >= 2.0).all(1)]
    assert len(wh) >= n, "not enough labels to fit anchors"
    # init: k-means++ style on log-wh
    lw = np.log(wh)
    centers = lw[rng.choice(len(lw), 1)]
    while len(centers) < n:
        d = ((lw[:, None, :] - centers[None]) ** 2).sum(-1).min(1)
        p = d / d.sum()
        centers = np.vstack([centers, lw[rng.choice(len(lw), p=p)]])
    for _ in range(iters):
        d = ((lw[:, None, :] - centers[None]) ** 2).sum(-1)
        assign = d.argmin(1)
        for k in range(n):
            sel = lw[assign == k]
            if len(sel):
                centers[k] = sel.mean(0)
    anchors = np.exp(centers)
    return anchors[np.argsort(anchors.prod(1))]


def check_anchors(labels_wh_px: np.ndarray, anchors_px: np.ndarray,
                  thr: float = 4.0, bpr_threshold: float = 0.98,
                  n: int | None = None):
    """If the current anchors' best-possible recall is poor, refit.

    Returns (anchors, bpr, refitted: bool).
    """
    aat, bpr = anchor_metric(labels_wh_px, anchors_px, thr)
    if bpr >= bpr_threshold:
        return anchors_px, bpr, False
    new = kmean_anchors(labels_wh_px, n=n or len(anchors_px), thr=thr)
    _, new_bpr = anchor_metric(labels_wh_px, new, thr)
    if new_bpr > bpr:
        return new, new_bpr, True
    return anchors_px, bpr, False


def labels_to_class_weights(labels: Sequence[np.ndarray],
                            nc: int = 80) -> np.ndarray:
    """Inverse-frequency class weights (reference general.py
    labels_to_class_weights, consumed train.py:147)."""
    if not len(labels):
        return np.ones(nc) / nc
    classes = np.concatenate(
        [lb[:, 0] if lb.shape[1] == 5 else lb[:, 1] for lb in labels]
    ).astype(int)
    counts = np.bincount(classes, minlength=nc).astype(float)
    counts[counts == 0] = 1
    weights = 1.0 / counts
    return weights / weights.sum()


def labels_to_image_weights(labels: Sequence[np.ndarray], nc: int,
                            class_weights: np.ndarray) -> np.ndarray:
    """Per-image sampling weights = sum of class weights over each image's
    labels (reference general.py:703-707, feeds train.py --image-weights)."""
    counts = np.array([
        np.bincount((lb[:, 0] if lb.shape[1] == 5 else lb[:, 1]).astype(int),
                    minlength=nc) if len(lb) else np.zeros(nc, int)
        for lb in labels])
    return (class_weights.reshape(1, nc) * counts).sum(1)
