"""Dataset layer: file-list datasets with letterbox and label parity, and
the batch feeder of the replay pools (port of
``adaptiveisp_tpu/data/datasets.py``).

One dataset class with a ``source`` option:
  "raw"        sRGB image -> host unprocess -> synthetic RAW
  "raw16"      "raw" through a uint16 sensor round-trip
  "normalize"  RAW-ish image, /255 only (the LOD layout)
  "rod"        .npy HDR, 99th-percentile normalisation
and ``high_res``, which adds ``im_hr``: the max-side-capped frame before the
letterbox, for rendering at full resolution.  ``split`` cuts one file list
into train and validation views.  ``cache_images`` ("ram" or "disk") keeps
the decoded, resized images (:mod:`.image_cache`).
:class:`BatchFeeder` walks the dataset in shuffled epochs behind a
:class:`~adaptiveisp_tpu_torch.data.prefetch.Prefetcher` thread, or a
per-host strided slice of them (``shard_rank`` / ``shard_count``).

Images load via PIL; pixels leave as NHWC float32 in [0, 1].  The random
draws (the dataset's ``rng``, the feeder's ``RandomState(seed)``) are the
JAX package's, in its order.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from adaptiveisp_tpu_torch.data import raw_np
from adaptiveisp_tpu_torch.data.image_cache import ImageCache
from adaptiveisp_tpu_torch.data.labels import (
    img2label_paths,
    img2label_paths_rod,
    load_labels,
)
from adaptiveisp_tpu_torch.data.letterbox import letterbox, resize_bilinear
from adaptiveisp_tpu_torch.data.prefetch import Prefetcher
from adaptiveisp_tpu_torch.data.sources import (
    load_image_file,
    parse_image_list,
)
from adaptiveisp_tpu_torch.detect.boxes import xywhn2xyxy, xyxy2xywhn

# get_batch decodes images on a small thread pool (PIL decode and the native
# csrc resize release the GIL, so the pool scales with host cores; on a
# 1-core host it is a wash, never a loss); the random unprocess draws stay
# SERIAL in index order so the host-twin draw-order parity (data/raw_np.py)
# holds
DECODE_THREADS = 4

class ISPDataset:
    """File-list dataset with letterbox + label transform parity."""

    def __init__(self, path: str, img_size: int = 512, source: str = "raw",
                 high_res: bool = False, add_noise: bool = False,
                 brightness_range=None, noise_level=None,
                 use_linear: bool = False, limit: int = -1,
                 train: bool = True, seed: int = 0, cache_images=None,
                 cache_threads: int = 8):
        self.img_size = img_size
        self.source = source
        self.high_res = high_res
        self.add_noise = add_noise
        self.brightness_range = brightness_range
        self.noise_level = noise_level
        self.use_linear = use_linear
        self.train = train
        # train-mode unprocess randomness: a dataset-local stream, not the
        # global np.random (which a prefetching thread would share)
        self.rng = np.random.RandomState(seed)
        self._preload: dict = {}

        self.im_files = parse_image_list(path)
        if limit > 0:
            self.im_files = self.im_files[:limit]
        if not self.im_files:
            raise FileNotFoundError(f"No images found under {path}")
        label_fn = img2label_paths_rod if source == "rod" else img2label_paths
        self.label_files = label_fn(self.im_files)
        cache = os.path.join(
            os.path.dirname(self.label_files[0]) or ".",
            f".adaptiveisp_labels_{len(self.im_files)}.cache")
        self.labels = load_labels(self.im_files, self.label_files, cache)
        # positions -> file indices (a subset view after split())
        self.indices = np.arange(len(self.im_files))

        # decoded-image cache: "disk" entries are keyed by a digest of the
        # full path and by img_size, so same-named images of two
        # directories, or a rerun at another size, never share an entry
        disk = None
        if cache_images == "disk":
            import hashlib

            cdir = os.path.join(os.path.dirname(self.im_files[0]) or ".",
                                ".adaptiveisp_im_cache")
            os.makedirs(cdir, exist_ok=True)
            disk = [os.path.join(
                cdir, os.path.splitext(os.path.basename(f))[0] + "_"
                + hashlib.sha1(os.path.abspath(f).encode()).hexdigest()[:10]
                + f"_{img_size}.npz") for f in self.im_files]
        self.cache = ImageCache(cache_images, len(self.im_files),
                                self._decode_resized, disk, cache_threads)

    def __len__(self):
        return len(self.indices)

    # ---------------------------------------------------------------- #
    def _decode_resized(self, index: int):
        """Load + resize longest side to img_size (reference load_image)."""
        img = load_image_file(self.im_files[index])
        h0, w0 = img.shape[:2]
        r = self.img_size / max(h0, w0)
        if r != 1:
            img = resize_bilinear(img, int(round(h0 * r)), int(round(w0 * r)))
        return np.ascontiguousarray(img, np.float32), (h0, w0)

    def _load_one(self, index: int):
        img, hw0 = self.cache.load(index)
        return img, hw0, img.shape[:2]

    def __getitem__(self, index: int):
        index = int(self.indices[index])
        pre = self._preload.pop(index, None)   # decoded by get_batch's pool
        img, (h0, w0), (h, w) = pre if pre is not None else \
            self._load_one(index)

        if self.source in ("raw", "raw16"):
            if not self.train:
                # deterministic per-image seed from the filename stem
                # (reference dataset.py:83-86); stable digest fallback,
                # not hash(), which is salted per process
                stem = os.path.splitext(os.path.split(
                    self.im_files[index])[1])[0]
                try:
                    seed = int(stem)
                except ValueError:
                    import zlib

                    seed = zlib.crc32(stem.encode()) % (2 ** 31)
                rng = np.random.RandomState(seed)
            else:
                rng = self.rng
            img, _ = raw_np.unprocess_wo_mosaic(
                img, self.add_noise, self.brightness_range,
                self.noise_level, self.use_linear, rng=rng)
            if self.source == "raw16":
                # uint16 sensor round-trip (the reference's RAWV2 variant)
                img = (np.round(img * 65535.0).astype(np.uint16)
                       .astype(np.float32) / 65535.0)
        elif self.source == "rod":
            # HDR .npy: normalise by the 99th percentile
            # (reference dataset.py:1196-1219)
            p99 = np.percentile(img, 99)
            img = np.clip(img / max(p99, 1e-8), 0.0, 1.0).astype(np.float32)
        # "normalize": already /255 from the loader

        full_res = img if self.high_res else None
        img, ratio, pad = letterbox(img, self.img_size, scaleup=False)
        shapes = (h0, w0), ((h / h0, w / w0), pad)

        labels = self.labels[index].copy()
        if labels.size:
            labels[:, 1:] = xywhn2xyxy(labels[:, 1:], ratio[0] * w,
                                       ratio[1] * h, padw=pad[0], padh=pad[1])
            labels[:, 1:5] = xyxy2xywhn(labels[:, 1:5], w=img.shape[1],
                                        h=img.shape[0], clip=True, eps=1e-3)

        labels_out = np.zeros((len(labels), 6), np.float32)
        if len(labels):
            labels_out[:, 1:] = labels

        out = {
            "im": img.astype(np.float32),           # HWC [0,1]
            "label": labels_out,
            "path": self.im_files[index],
            "shape": shapes,
        }
        if self.high_res:
            out["im_hr"] = full_res.astype(np.float32)
        return out

    # ---------------------------------------------------------------- #
    def get_batch(self, indices: List[int]):
        uniq = list(dict.fromkeys(int(self.indices[i]) for i in indices))
        if len(uniq) > 1 and self.cache.mode != "ram":
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(min(DECODE_THREADS, len(uniq))) as ex:
                loaded = list(ex.map(self._load_one, uniq))
            # entries are POPPED on use: duplicate positions re-load their
            # own copy, so no two records share a mutable array
            self._preload = dict(zip(uniq, loaded))
        try:
            records = [self[i] for i in indices]
        finally:
            self._preload = {}
        return collate(records)

    def split(self, n_val: int, seed: int = 0):
        """Random train/val split of one file list (the reference's
        create_train_val_dataloader_real, dataloader.py:205-277): two views
        sharing the image and label lists with disjoint sorted index sets;
        the validation view is in eval mode."""
        import copy

        order = np.random.RandomState(seed).permutation(len(self.im_files))
        train, val = copy.copy(self), copy.copy(self)
        train.indices = np.sort(order[n_val:])
        val.indices = np.sort(order[:n_val])
        val.train = False
        return train, val


def collate(records):
    """Stack a list of record dicts into batch arrays + lists.

    Labels get their image-index column set (reference
    replay_memory.py:9-15 / collate_fn)."""
    ims = np.stack([r["im"] for r in records], 0)
    labels = []
    for i, r in enumerate(records):
        lb = r["label"].copy()
        lb[:, 0] = i
        labels.append(lb)
    paths = [r["path"] for r in records]
    shapes = [r["shape"] for r in records]
    out = {"im": ims, "label": labels, "path": paths, "shape": shapes}
    if "im_hr" in records[0]:
        out["im_hr"] = [r["im_hr"] for r in records]
    return out


class BatchFeeder:
    """Sequential-with-recycling batch source (the reference *Replay
    datasets' ``get_next_batch``, dataset.py:457-532, 563-573) with an async
    prefetch thread (util.py:153-201 equivalent)."""

    def __init__(self, dataset: ISPDataset, batch_size: int = 64,
                 seed: int = 0, shard_rank: int = 0, shard_count: int = 1):
        """shard_rank / shard_count: per-host sharding (DistributedSampler's
        role): each host reads a disjoint strided slice of the epoch order,
        shuffled with the same seed on every host.  API parity with the
        JAX package: no trainer of the port passes them (a data-parallel
        trainer reads the global batch and keeps its rows)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shard_rank = shard_rank
        self.shard_count = shard_count
        self.rng = np.random.RandomState(seed)
        self._order = self._new_order()
        self._cursor = 0
        self._prefetcher = Prefetcher(self._next_batch_sync)

    def _new_order(self):
        order = np.arange(len(self.dataset))
        self.rng.shuffle(order)
        if self.shard_count > 1:
            # the ragged tail goes first, so every host's slice has one
            # length and the hosts start the next permutation together
            usable = (len(order) // self.shard_count) * self.shard_count
            order = order[:usable][self.shard_rank::self.shard_count]
        return order

    def _next_indices(self, n):
        out = []
        while len(out) < n:
            if self._cursor >= len(self._order):
                self._order = self._new_order()
                self._cursor = 0
            out.append(int(self._order[self._cursor]))
            self._cursor += 1
        return out

    def _next_batch_sync(self):
        return self.dataset.get_batch(self._next_indices(self.batch_size))

    def next_batch(self):
        return self._prefetcher.get_next()

    def stop(self):
        self._prefetcher.stop()
