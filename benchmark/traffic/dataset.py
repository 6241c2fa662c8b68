"""A seeded image folder for a training mix: the scenes of ``scenes.py``
written as 8-bit PNGs under ``images/`` and YOLO text labels under
``labels/``, as LOD's ``normalize`` source reads them.  It lives under the
run's ``TMPDIR`` and is removed when the run ends."""

from __future__ import annotations

import os
import shutil
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from benchmark.traffic.scenes import make_scenes


def data_root(tag: str) -> Path:
    return Path(os.environ.get("TMPDIR") or tempfile.gettempdir()) / (
        f"adaptiveisp-bench-{tag}")


def write_png(path: Path, rgb: np.ndarray) -> None:
    """An 8-bit RGB PNG at zlib level 1 (OpenCV, which lets the writer
    threads run at once, where it is installed)."""
    try:
        import cv2
    except ImportError:
        from PIL import Image

        Image.fromarray(rgb).save(path, compress_level=1)
        return
    cv2.imwrite(str(path), np.ascontiguousarray(rgb[..., ::-1]),
                [cv2.IMWRITE_PNG_COMPRESSION, 1])


def write_dataset(root: Path, n: int, height: int, width: int, seed: int,
                  device, params=None, chunk: int = 32) -> Path:
    """Writes ``n`` scenes and labels under ``root`` (emptied first);
    returns the image folder."""
    shutil.rmtree(root, ignore_errors=True)
    images, labels = root / "images", root / "labels"
    images.mkdir(parents=True)
    labels.mkdir()
    gen = torch.Generator()
    gen.manual_seed(int(seed))

    def save(args):
        i, arr, lab = args
        write_png(images / f"{i:05d}.png", arr)
        with open(labels / f"{i:05d}.txt", "w") as f:
            for c, x, y, w, h in lab:
                f.write(f"{int(c)} {x:.6f} {y:.6f} {w:.6f} {h:.6f}\n")

    with ThreadPoolExecutor(8) as pool:
        for a in range(0, n, chunk):
            b = min(n, a + chunk)
            sub = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
            scenes, labs = make_scenes(b - a, height, width, sub, device,
                                       params)
            u8 = (scenes * 255.0).round().clamp(0, 255).to(torch.uint8)
            u8 = u8.cpu().numpy()
            list(pool.map(save, [(a + i, np.ascontiguousarray(u8[i]),
                                  labs[i]) for i in range(b - a)]))
    return images
