"""Segmentation dataset: polygon labels -> boxes + rasterised masks (port of
``adaptiveisp_tpu/data/segment_dataset.py``).

One ``.txt`` per image under ``labels/`` beside ``images/``, one instance
per line ``cls x1 y1 x2 y2 ...`` (normalised polygon).  Masks are rasterised
at ``img_size / mask_ratio`` (the Proto tower's resolution).  Batches are
host NumPy of fixed shape: (images [B,s,s,3], targets [B,T,5] (cls,
xywhn), tmask [B,T], masks [B,T,s/r,s/r]).  Every ``RandomState`` draw
(shuffle, copy-paste, flip) comes in the JAX package's order, so the same
seed gives the same batches.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

from adaptiveisp_tpu_torch.data.augment import copy_paste, polygon2mask
from adaptiveisp_tpu_torch.data.labels import img2label_paths
from adaptiveisp_tpu_torch.data.letterbox import letterbox, resize_bilinear
from adaptiveisp_tpu_torch.data.sources import (
    load_image_file,
    parse_image_list,
)

__all__ = ["SegmentDataset", "parse_polygon_labels", "polygon2mask"]


def parse_polygon_labels(path: str) -> List[Tuple[int, np.ndarray]]:
    """One (cls, [n,2] normalised polygon) per line; absent file -> []."""
    out = []
    if not os.path.isfile(path):
        return out
    with open(path) as f:
        lines = f.read().strip().splitlines()
    for line in lines:
        vals = line.split()
        if len(vals) < 7 or (len(vals) - 1) % 2:
            continue
        pts = np.asarray([float(v) for v in vals[1:]],
                         np.float32).reshape(-1, 2)
        out.append((int(float(vals[0])), pts))
    return out


class SegmentDataset:
    def __init__(self, path_or_files, img_size: int = 320,
                 batch_size: int = 8, augment: bool = False,
                 mask_ratio: int = 4, fliplr: float = 0.5,
                 copy_paste: float = 0.0, seed: int = 0):
        if isinstance(path_or_files, (list, tuple)):
            self.im_files = list(path_or_files)
        else:
            self.im_files = parse_image_list(path_or_files)
        if not self.im_files:
            raise FileNotFoundError(f"no images under {path_or_files}")
        self.label_files = img2label_paths(self.im_files)
        self.img_size = img_size
        self.batch_size = batch_size
        self.augment = augment
        self.mask_ratio = mask_ratio
        self.fliplr = fliplr
        self.copy_paste = copy_paste
        self.rng = np.random.RandomState(seed)
        self.instances = [parse_polygon_labels(f) for f in self.label_files]

    def __len__(self):
        return len(self.im_files)

    @property
    def labels(self):
        """Per-file [n,5] (cls, xywhn) rows from the polygon bounds (the
        ``DetectorDataset.labels`` surface, for ``plot_labels``)."""
        out = []
        for inst in self.instances:
            rows = []
            for cls, poly in inst:
                x1, x2 = float(poly[:, 0].min()), float(poly[:, 0].max())
                y1, y2 = float(poly[:, 1].min()), float(poly[:, 1].max())
                rows.append([cls, (x1 + x2) / 2, (y1 + y2) / 2,
                             x2 - x1, y2 - y1])
            out.append(np.asarray(rows, np.float32).reshape(-1, 5))
        return out

    def __getitem__(self, i: int):
        """(img [s,s,3], targets [n,5] (cls, xywhn), masks [n, s/r, s/r])."""
        img = load_image_file(self.im_files[i])
        h0, w0 = img.shape[:2]
        r = self.img_size / max(h0, w0)
        if r != 1:
            img = resize_bilinear(img, int(round(h0 * r)),
                                  int(round(w0 * r)))
        img, ratio, pad = letterbox(img, self.img_size,
                                    color=(114 / 255,) * 3)
        h, w = img.shape[:2]
        ms = self.img_size // self.mask_ratio

        segments, labels = [], []
        for cls, poly in self.instances[i]:
            # normalised polygon -> letterboxed input pixels (ratio is
            # (rw, rh))
            px = poly[:, 0] * (w0 * r) * ratio[0] + pad[0]
            py = poly[:, 1] * (h0 * r) * ratio[1] + pad[1]
            x1, x2 = float(px.min()), float(px.max())
            y1, y2 = float(py.min()), float(py.max())
            if x2 - x1 < 2 or y2 - y1 < 2:
                continue
            segments.append(np.stack([px, py], 1))
            labels.append([cls, x1, y1, x2, y2])
        labels = np.asarray(labels, np.float32).reshape(-1, 5)

        if self.augment and self.copy_paste and len(segments):
            img, labels, segments = copy_paste(
                img, labels, segments, self.copy_paste, self.rng)

        targets, masks = [], []
        for lb, seg in zip(labels, segments):
            cls, x1, y1, x2, y2 = lb
            targets.append([cls, (x1 + x2) / 2 / w, (y1 + y2) / 2 / h,
                            (x2 - x1) / w, (y2 - y1) / h])
            masks.append(polygon2mask((ms, ms), seg / self.mask_ratio))
        targets = np.asarray(targets, np.float32).reshape(-1, 5)
        masks = (np.stack(masks, 0) if masks
                 else np.zeros((0, ms, ms), np.float32))

        if self.augment and self.rng.rand() < self.fliplr:
            img = img[:, ::-1].copy()
            if len(targets):
                targets[:, 1] = 1.0 - targets[:, 1]
            masks = masks[:, :, ::-1].copy()
        return img.astype(np.float32), targets, masks

    def collate(self, indices: Sequence[int], t_max: int = 32):
        ms = self.img_size // self.mask_ratio
        n = len(indices)
        images = np.zeros((n, self.img_size, self.img_size, 3), np.float32)
        targets = np.zeros((n, t_max, 5), np.float32)
        tmask = np.zeros((n, t_max), bool)
        masks = np.zeros((n, t_max, ms, ms), np.float32)
        for bi, i in enumerate(indices):
            img, t, m = self[int(i)]
            images[bi] = img
            k = min(len(t), t_max)
            if k:
                targets[bi, :k] = t[:k]
                tmask[bi, :k] = True
                masks[bi, :k] = m[:k]
        return images, targets, tmask, masks

    def epoch_batches(self, shuffle: bool = True, t_max: int = 32,
                      shard_rank: int = 0, shard_count: int = 1):
        """Full batches of one epoch, shuffled by the dataset's stream;
        shard_rank / shard_count as ``DetectorDataset.epoch_batches`` (one
        shuffle on every host, disjoint strided slices)."""
        order = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(order)
        if shard_count > 1:
            order = order[shard_rank::shard_count]
        bs = self.batch_size
        for s in range(0, len(order) - bs + 1, bs):
            yield self.collate(order[s:s + bs], t_max=t_max)
