"""Streaming inference sources: images, video files, live streams (port of
``adaptiveisp_tpu/data/sources.py``, host code only).

Plain host-side iterators: the device never sees variable frame rates, only
fixed-shape batches downstream.  Every source yields (name, frame, meta)
where frame is HWC RGB float32 in [0, 1] and meta carries {"kind", "index",
"total", "fps", "src"}; name is unique per frame (video frames get a
`:fNNNNNN` suffix) so per-frame artifacts never collide.

:func:`load_image_file` and :func:`parse_image_list` are this module's own
copies of the helpers in the JAX package's ``data/datasets.py`` and
``data/labels.py``.
"""

from __future__ import annotations

import os
import threading
import time
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".m4v", ".mpg", ".mpeg",
              ".wmv", ".webm", ".gif")
STREAM_PREFIXES = ("rtsp://", "rtmp://", "http://", "https://", "tcp://")

Frame = Tuple[str, np.ndarray, dict]


IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".npy",
              ".webp")


def load_image_file(path: str) -> np.ndarray:
    """Read an image file to HWC RGB float32 in [0, 1]."""
    if path.endswith(".npy"):
        arr = np.load(path).astype(np.float32)
        if arr.ndim == 2:
            arr = arr[:, :, None].repeat(3, axis=2)
        return arr
    from PIL import Image

    with Image.open(path) as im:
        if im.mode != "RGB":
            im = im.convert("RGB")
        return np.asarray(im, dtype=np.float32) / 255.0


def parse_image_list(path: str) -> List[str]:
    """Resolve a dataset path: a directory of images (recursive), a .txt
    listing (relative lines against the listing's directory), or a glob."""
    p = Path(path)
    if p.is_dir():
        files = sorted(str(f) for f in p.rglob("*")
                       if f.suffix.lower() in IMAGE_EXTS)
    elif p.is_file() and p.suffix == ".txt":
        base = p.parent
        files = []
        for line in p.read_text().strip().splitlines():
            line = line.strip()
            if not line:
                continue
            f = Path(line)
            if not f.is_absolute():
                f = base / line
            files.append(str(f))
    else:
        import glob as _glob

        files = sorted(_glob.glob(path, recursive=True))
    return files


class ImageSource:
    """Folder / .txt list / glob / single image file."""

    def __init__(self, source: str):
        if os.path.isfile(source) and not source.endswith(".txt"):
            self.files = [source]
        else:
            self.files = parse_image_list(source)
        if not self.files:
            raise FileNotFoundError(f"no images found for {source!r}")
        # artifact names: basenames, disambiguated with parent-dir prefixes
        # when a recursive listing repeats a filename (a/img.png and
        # b/img.png must not overwrite each other's artifacts)
        names = [os.path.split(p)[1] for p in self.files]
        if len(set(names)) != len(names):
            seen = {}
            for i, (p, n) in enumerate(zip(self.files, names)):
                if names.count(n) > 1:
                    parent = os.path.basename(os.path.dirname(p))
                    names[i] = f"{parent}_{n}" if parent else n
                key = names[i]
                if key in seen:  # still colliding: index-suffix
                    names[i] = f"{i}_{key}"
                seen[names[i]] = True
        self.names = names

    def __len__(self):
        return len(self.files)

    def __iter__(self) -> Iterator[Frame]:
        for i, path in enumerate(self.files):
            yield (self.names[i], load_image_file(path),
                   {"kind": "image", "index": i, "total": len(self.files),
                    "fps": 0.0, "src": path})


class VideoSource:
    """Frames of one video file, with the `--vid-stride` frame skip."""

    def __init__(self, path: str, vid_stride: int = 1):
        import cv2

        self.path = path
        self.stride = max(1, int(vid_stride))
        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise IOError(f"cannot open video {path!r}")
        self.fps = float(self.cap.get(cv2.CAP_PROP_FPS) or 0.0)
        self.frames = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)

    def __len__(self):
        # iteration emits frames 0, stride, 2*stride, ... -> ceil
        return max(-(-self.frames // self.stride), 0)

    def __iter__(self) -> Iterator[Frame]:
        import cv2

        base = os.path.split(self.path)[1]
        stem = os.path.splitext(base)[0]
        idx = 0
        emitted = 0
        while True:
            ok, bgr = self.cap.read()
            if not ok:
                break
            if idx % self.stride == 0:
                rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
                rgb = rgb.astype(np.float32) / 255.0
                yield (f"{stem}:f{idx:06d}", rgb,
                       {"kind": "video", "index": idx, "total": self.frames,
                        "fps": self.fps, "src": self.path})
                emitted += 1
            idx += 1
        self.cap.release()


class StreamSource:
    """Live stream (webcam index / RTSP / HTTP) with latest-frame semantics:
    a daemon thread keeps reading so the consumer always gets the freshest
    frame."""

    def __init__(self, source: str, max_frames: Optional[int] = None,
                 vid_stride: int = 1):
        import cv2

        self.src = int(source) if source.isnumeric() else source
        self.cap = cv2.VideoCapture(self.src)
        if not self.cap.isOpened():
            raise IOError(f"cannot open stream {source!r}")
        self.fps = float(self.cap.get(cv2.CAP_PROP_FPS) or 30.0)
        self.max_frames = max_frames
        self.stride = max(1, int(vid_stride))
        self._frame = None
        self._count = 0
        self._running = True
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._reader, daemon=True)
        self._thread.start()

    def _reader(self):
        n = 0
        while self._running and self.cap.isOpened():
            ok = self.cap.grab()
            if not ok:
                self._running = False
                break
            n += 1
            if n % self.stride:
                continue
            ok, bgr = self.cap.retrieve()
            if ok:
                with self._lock:
                    self._frame = bgr
                    self._count += 1

    def stop(self):
        self._running = False
        self._thread.join(timeout=2)
        self.cap.release()

    def __iter__(self) -> Iterator[Frame]:
        import cv2

        served = 0
        last_seen = 0
        try:
            while self._running or self._frame is not None:
                if self.max_frames is not None and served >= self.max_frames:
                    break
                with self._lock:
                    frame, count = self._frame, self._count
                if frame is None or count == last_seen:
                    if not self._running:
                        break
                    time.sleep(1.0 / max(self.fps, 1.0))
                    continue
                last_seen = count
                rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                rgb = rgb.astype(np.float32) / 255.0
                yield (f"stream:{served:06d}", rgb,
                       {"kind": "stream", "index": served, "total": -1,
                        "fps": self.fps, "src": str(self.src)})
                served += 1
        finally:
            self.stop()


def open_source(source: str, vid_stride: int = 1,
                max_frames: Optional[int] = None):
    """Dispatch a --source string to the right loader:

      * webcam index ("0"), rtsp/rtmp/http url, or a .streams file -> live
      * a video file (by extension) -> frame iterator
      * anything else (file / dir / glob / .txt list) -> images
    """
    s = str(source)
    if s.endswith(".streams") and os.path.isfile(s):
        urls = [u.strip() for u in open(s).read().splitlines() if u.strip()]
        sources, opened = [], []
        try:
            for u in urls:
                src = StreamSource(u, max_frames=max_frames,
                                   vid_stride=vid_stride)
                opened.append(src)
                sources.append(src)
        except Exception:
            # one unreachable URL must not leak the already-started
            # readers' threads/captures
            for src in opened:
                try:
                    src.stop()
                except Exception:
                    pass
            raise
        return sources
    if s.isnumeric() or s.lower().startswith(STREAM_PREFIXES):
        return StreamSource(s, max_frames=max_frames, vid_stride=vid_stride)
    if os.path.splitext(s)[1].lower() in VIDEO_EXTS:
        return VideoSource(s, vid_stride=vid_stride)
    return ImageSource(s)
