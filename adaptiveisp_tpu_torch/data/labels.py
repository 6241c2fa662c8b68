"""Label files in YOLO txt format, and their cache (port of
``adaptiveisp_tpu/data/labels.py``).

One ``.txt`` per image with rows ``cls x y w h`` (normalised xywh).  The
parsed labels are cached in a NumPy ``.cache`` file keyed by a hash of the
label files; the format and version string are the JAX package's, so a
cache written by either package reads the same in the other.
"""

from __future__ import annotations

import hashlib
import os
from typing import List

import numpy as np

CACHE_VERSION = "adaptiveisp-tpu-0.1"


def img2label_paths(img_paths: List[str]) -> List[str]:
    """images/ -> labels/, .ext -> .txt (reference dataloaders.py:456-459)."""
    sa, sb = f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}"
    return [sb.join(p.rsplit(sa, 1)).rsplit(".", 1)[0] + ".txt"
            for p in img_paths]


def img2label_paths_rod(img_paths: List[str]) -> List[str]:
    """ROD layout (reference dataset.py:934-937)."""
    sa, sb = f"{os.sep}raws{os.sep}", f"{os.sep}labels{os.sep}"
    return [sb.join(p.rsplit(sa, 1)).rsplit(".", 1)[0] + ".txt"
            for p in img_paths]


def files_hash(paths: List[str]) -> str:
    h = hashlib.md5()
    total = 0
    for p in paths:
        try:
            total += os.path.getsize(p)
        except OSError:
            pass
    h.update(str(total).encode())
    h.update("".join(paths).encode())
    return h.hexdigest()


def verify_label(lb: np.ndarray, nc: int | None = None) -> np.ndarray:
    """Validity checks from the reference verifier
    (dataloaders.py:998+, dataset.py:1106-1156)."""
    if lb.size == 0:
        return np.zeros((0, 5), np.float32)
    assert lb.ndim == 2 and lb.shape[1] == 5, f"labels require 5 columns: {lb.shape}"
    assert (lb >= 0).all(), "negative label values"
    assert (lb[:, 1:] <= 1).all(), "non-normalized or out-of-bounds coordinates"
    # de-duplicate identical rows
    _, idx = np.unique(lb, axis=0, return_index=True)
    if len(idx) < len(lb):
        lb = lb[np.sort(idx)]
    if nc is not None:
        assert lb[:, 0].max() < nc, "label class exceeds nc"
    return lb.astype(np.float32)


def read_label_file(path: str) -> np.ndarray:
    if not os.path.isfile(path):
        return np.zeros((0, 5), np.float32)
    with open(path) as f:
        rows = [ln.split() for ln in f.read().strip().splitlines() if ln]
    if not rows:
        return np.zeros((0, 5), np.float32)
    return verify_label(np.asarray(rows, dtype=np.float32))


def load_labels(img_files: List[str], label_files: List[str],
                cache_path: str | None = None) -> List[np.ndarray]:
    """Parse all label files with .cache-style invalidation."""
    if cache_path is not None and os.path.isfile(cache_path):
        try:
            cache = np.load(cache_path, allow_pickle=True).item()
            if (cache.get("version") == CACHE_VERSION
                    and cache.get("hash") == files_hash(label_files)):
                return cache["labels"]
        except Exception:
            pass
    labels = [read_label_file(p) for p in label_files]
    if cache_path is not None:
        try:
            np.save(cache_path, {
                "version": CACHE_VERSION,
                "hash": files_hash(label_files),
                "labels": labels,
            })
            if not cache_path.endswith(".npy"):
                os.replace(cache_path + ".npy", cache_path)
        except Exception:
            pass
    return labels



