"""Detector-training dataset (port of
``adaptiveisp_tpu/data/detector_dataset.py``): mosaic / mixup / HSV / flip
augmentation, rect batching, RAM or disk image caching, fixed-shape batch
collation.

File list and ``.cache`` label parsing (:mod:`.labels`), max-side image
resize, mosaic4/9 with the border-removing random_perspective, mixup, HSV
jitter, up-down and left-right flips, aspect-ratio rect buckets, and the
RAM / disk cache of resized images.  Batches collate to fixed shapes:
images [B, S, S, 3] float32 and padded targets [B, T_max, 5] with a mask.
Randomness is the dataset's ``np.random.RandomState(seed)``, drawn in the
JAX package's order, so the same seed gives the same batches.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from adaptiveisp_tpu_torch.data import augment as A
from adaptiveisp_tpu_torch.data.image_cache import ImageCache
from adaptiveisp_tpu_torch.data.labels import img2label_paths, load_labels
from adaptiveisp_tpu_torch.data.letterbox import letterbox, resize_bilinear
from adaptiveisp_tpu_torch.data.sources import (
    load_image_file,
    parse_image_list,
)


@dataclasses.dataclass(frozen=True)
class AugHyp:
    """Augmentation hyperparameters
    (reference data/hyps/hyp.scratch-low.yaml)."""

    hsv_h: float = 0.015
    hsv_s: float = 0.7
    hsv_v: float = 0.4
    degrees: float = 0.0
    translate: float = 0.1
    scale: float = 0.5
    shear: float = 0.0
    perspective: float = 0.0
    flipud: float = 0.0
    fliplr: float = 0.5
    mosaic: float = 1.0
    mosaic9: float = 0.0   # probability a mosaic is the 9-image variant
    mixup: float = 0.0
    copy_paste: float = 0.0  # segment copy-paste (needs polygon labels;
    #                          consumed by SegmentDataset, not the box-only
    #                          DetectorDataset — reference wires it in
    #                          utils/segment/dataloaders.py:254)


class DetectorDataset:
    """Training/val dataset for the standalone detector trainer."""

    def __init__(self, path_or_files, img_size: int = 640,
                 batch_size: int = 16, augment: bool = True,
                 rect: bool = False, stride: int = 32, pad: float = 0.0,
                 cache: str = "none", hyp: Optional[AugHyp] = None,
                 nc: Optional[int] = None, single_cls: bool = False,
                 seed: int = 0, extra_augment=None):
        if augment and rect:
            # rect training keeps per-image augmentation (HSV, flips,
            # shape-preserving perspective) but disables mosaic/mixup —
            # random canvas composition breaks the per-batch shape
            # buckets (reference dataloaders.py: mosaic = augment and
            # not rect)
            import dataclasses as _dc

            hyp = _dc.replace(hyp or AugHyp(), mosaic=0.0, mosaic9=0.0,
                              mixup=0.0)
        if isinstance(path_or_files, (list, tuple)):
            self.im_files = list(path_or_files)
        elif os.path.isdir(path_or_files):
            exts = (".jpg", ".jpeg", ".png", ".bmp", ".npy")
            self.im_files = sorted(
                os.path.join(path_or_files, f)
                for f in os.listdir(path_or_files)
                if f.lower().endswith(exts))
        else:
            self.im_files = parse_image_list(path_or_files)
        self.label_files = img2label_paths(self.im_files)
        cache_path = (os.path.join(os.path.dirname(self.label_files[0]),
                                   "detector.cache")
                      if self.label_files else None)
        self.labels = load_labels(self.im_files, self.label_files,
                                  cache_path=cache_path)
        if single_cls:
            self.labels = [
                np.concatenate([np.zeros_like(lb[:, :1]), lb[:, 1:]], 1)
                for lb in self.labels]

        self.img_size = img_size
        self.batch_size = batch_size
        self.augment = augment
        self.rect = rect
        self.stride = stride
        self.hyp = hyp or AugHyp()
        self.rng = np.random.RandomState(seed)
        self.extra_augment = extra_augment  # data/augment.ExtraAugment
        n = len(self.im_files)
        self.indices = np.arange(n)

        # ---- rect bucketing (reference dataloaders.py:552-575) ----------- #
        self.batch_shapes = None
        if rect:
            shapes_wh = np.array(
                [self._image_shape(f)[::-1] for f in self.im_files],
                np.float64)  # (w, h)
            order, self.batch_shapes = A.rect_batch_shapes(
                shapes_wh, batch_size, img_size, stride, pad)
            self.im_files = [self.im_files[i] for i in order]
            self.label_files = [self.label_files[i] for i in order]
            self.labels = [self.labels[i] for i in order]
        self.batch_index = np.floor(np.arange(n) / batch_size).astype(int)

        # ---- RAM / disk cache (reference dataloaders.py:577-595) --------- #
        # disk entries sit beside each image, keyed by img_size (a rerun at
        # another --imgsz must not reuse stale arrays)
        self.cache = ImageCache(
            cache, n, self._load_resize,
            [f + f".resized{img_size}.npz" for f in self.im_files])

    # ------------------------------------------------------------------ #
    def __len__(self):
        return len(self.im_files)

    @staticmethod
    def _image_shape(path: str) -> Tuple[int, int]:
        """(h, w) without decoding full pixels where possible."""
        if path.endswith(".npy"):
            return tuple(np.load(path, mmap_mode="r").shape[:2])
        from PIL import Image

        with Image.open(path) as im:
            w, h = im.size
        return h, w

    def _load_resize(self, i: int):
        """Load + max-side resize to img_size
        (reference dataloaders.py:736-751)."""
        im = load_image_file(self.im_files[i])
        h0, w0 = im.shape[:2]
        r = self.img_size / max(h0, w0)
        if r != 1:
            im = resize_bilinear(im, int(np.ceil(h0 * r)),
                                 int(np.ceil(w0 * r)))
        return im.astype(np.float32), (h0, w0)

    def load_image(self, i: int) -> Tuple[np.ndarray, Tuple[int, int]]:
        return self.cache.load(i)

    # ------------------------------------------------------------------ #
    def _mosaic_load(self, i):
        im, _ = self.load_image(i)
        return im, im.shape[:2]

    def _mosaic_labels(self, i):
        return self.labels[i]

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (img [H, W, 3] float32 RGB, labels [n, 5] cls-xywhn)."""
        hyp, rng = self.hyp, self.rng
        if self.augment and rng.rand() < hyp.mosaic:
            mos = A.mosaic9 if rng.rand() < hyp.mosaic9 else A.mosaic4
            k = 8 if mos is A.mosaic9 else 3
            idxs = [index] + list(rng.choice(self.indices, k))
            rng.shuffle(idxs)
            img, labels = mos(self._mosaic_load, self._mosaic_labels, idxs,
                              self.img_size, rng, hyp)
            if rng.rand() < hyp.mixup:
                idxs2 = list(rng.choice(self.indices, k + 1))
                img2, labels2 = mos(self._mosaic_load, self._mosaic_labels,
                                    idxs2, self.img_size, rng, hyp)
                img, labels = A.mixup(img, labels, img2, labels2, rng)
        else:
            img, (h0, w0) = self.load_image(index)
            h, w = img.shape[:2]
            shape = (self.batch_shapes[self.batch_index[index]]
                     if self.rect else self.img_size)
            # 114-gray border, the yolov3 dataloader fill (dataloaders.py
            # letterbox default) — matches the mosaic canvas FILL so train
            # and val see the same border statistics.  (The AdaptiveISP
            # reference's own dataset letterboxes BLACK, dataset.py:90 —
            # ISPDataset keeps that.)
            img, ratio, pad = letterbox(img, shape, scaleup=self.augment,
                                        color=(114 / 255,) * 3)
            labels = self.labels[index].copy()
            if labels.size:
                labels[:, 1:] = A.xywhn2xyxy(
                    labels[:, 1:], ratio[0] * w, ratio[1] * h,
                    padw=pad[0], padh=pad[1])
            if self.augment:
                img, labels = A.random_perspective(
                    img, labels, rng, degrees=hyp.degrees,
                    translate=hyp.translate, scale=hyp.scale,
                    shear=hyp.shear, perspective=hyp.perspective)

        if labels.size:
            labels = labels.copy()
            labels[:, 1:5] = A.xyxy2xywhn(
                labels[:, 1:5], w=img.shape[1], h=img.shape[0], clip=True,
                eps=1e-3)

        if self.augment:
            if self.extra_augment is not None:
                # pixel-only transforms: boxes are untouched (the
                # reference's Albumentations hook, augmentations.py:49-52)
                img = self.extra_augment(img, rng)
            img = A.augment_hsv(img, rng, hyp.hsv_h, hyp.hsv_s, hyp.hsv_v)
            if rng.rand() < hyp.flipud:
                img, labels = A.flip_ud(img, labels)
            if rng.rand() < hyp.fliplr:
                img, labels = A.flip_lr(img, labels)

        return np.ascontiguousarray(img, np.float32), labels.astype(
            np.float32)

    # ------------------------------------------------------------------ #
    def collate(self, indices: Sequence[int], t_max: int = 64):
        """Fixed-shape batch: (images [B, H, W, 3], targets [B, T, 5],
        tmask [B, T])."""
        imgs, tgts, masks = [], [], []
        for i in indices:
            img, lb = self[int(i)]
            t = np.zeros((t_max, 5), np.float32)
            m = np.zeros((t_max,), bool)
            n = min(len(lb), t_max)
            if n:
                t[:n] = lb[:n]
                m[:n] = True
            imgs.append(img)
            tgts.append(t)
            masks.append(m)
        return (np.stack(imgs), np.stack(tgts), np.stack(masks))

    def epoch_batches(self, shuffle: bool = True, t_max: int = 64,
                      shard_rank: int = 0, shard_count: int = 1):
        """Yield full batches for one epoch (drops the ragged tail).

        shard_rank / shard_count: per-host sharding (DistributedSampler's
        role): each host reads a disjoint strided slice of the epoch order,
        shuffled alike on every host.  API parity with the JAX package:
        no trainer of the port passes them (a data-parallel trainer reads
        the global batch and keeps its rows)."""
        order = self.indices.copy()
        if shuffle and not self.rect:
            self.rng.shuffle(order)
        bs = self.batch_size
        if shard_count > 1 and self.rect:
            # a rect batch letterboxes to its bucket's shape, so it needs
            # consecutive indices: whole batches go round robin instead
            for k in range(len(order) // bs):
                if k % shard_count == shard_rank:
                    yield self.collate(order[k * bs:(k + 1) * bs],
                                       t_max=t_max)
            return
        if shard_count > 1:
            order = order[shard_rank::shard_count]
        for k in range(len(order) // bs):
            yield self.collate(order[k * bs:(k + 1) * bs], t_max=t_max)
