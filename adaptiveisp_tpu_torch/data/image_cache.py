"""RAM or disk cache of decoded, resized images, shared by ``ISPDataset``
(``cache_images``) and ``DetectorDataset`` (``cache``); the reference's
image caching (dataloaders.py:577-595) as the JAX package's two datasets
implement it.

"ram" keeps every resized float32 image in memory and hands out copies;
"disk" writes each one once as ``.npz`` (the image and its original
(h0, w0)) under a path the dataset chooses, keyed by the image size, and
reads it back at every load.  The cache is filled on a thread pool when the
dataset is built (PIL decode and the resize release the GIL).
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

MODES = ("ram", "disk")


class ImageCache:
    """``load(i) -> (image [h, w, 3] float32, (h0, w0))`` through the cache;
    ``decode(i)`` gives the same pair from the file.  ``mode`` None (or
    "none") caches nothing."""

    def __init__(self, mode, n: int,
                 decode: Callable[[int], Tuple[np.ndarray, Tuple[int, int]]],
                 disk_paths: Optional[Sequence[str]] = None,
                 threads: int = 8):
        if mode in (None, False, "none"):
            mode = None
        elif mode not in MODES:
            raise ValueError(f"image cache must be None/'ram'/'disk', "
                             f"got {mode!r}")
        self.mode = mode
        self.decode = decode
        self._ram: List = [None] * n
        self._disk = list(disk_paths) if disk_paths is not None else None
        if mode == "disk" and self._disk is None:
            raise ValueError("a disk cache needs disk_paths")
        if mode:
            from multiprocessing.pool import ThreadPool

            with ThreadPool(max(1, threads)) as tp:
                tp.map(self._warm, range(n))

    def _warm(self, i: int):
        if self.mode == "ram":
            self._ram[i] = self.decode(i)
        elif not os.path.isfile(self._disk[i]):
            img, hw = self.decode(i)
            tmp = self._disk[i] + f".tmp{os.getpid()}"
            np.savez(tmp, img=img, h0w0=np.int32(hw))
            os.replace(tmp + ".npz", self._disk[i])

    def load(self, i: int) -> Tuple[np.ndarray, Tuple[int, int]]:
        if self.mode == "ram":
            img, hw = self._ram[i]
            return img.copy(), tuple(int(v) for v in hw)
        if self.mode == "disk":
            with np.load(self._disk[i]) as z:
                return z["img"], tuple(int(v) for v in z["h0w0"])
        img, hw = self.decode(i)
        return img, tuple(int(v) for v in hw)
