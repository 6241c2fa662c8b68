"""The native host preprocessing library, built for this host (port of
``adaptiveisp_tpu/data/native.py``).

``csrc/preprocess.cpp`` (cv2-compatible bilinear resize and the letterbox
fill and paste) is compiled at first use with ``g++ -O3 -march=native``
into ``build/native/libpreprocess-<source hash>-<host key>.so`` at the
repository root and loaded with ``ctypes``.  The host key hashes the
target options ``-march=native`` expands to on this host, so a library
built on another CPU is never loaded here (an instruction this CPU lacks
would kill the process, not raise).  The committed ``csrc/libpreprocess.so``
is never loaded.  Where no library can be built, callers take the NumPy
path, which :func:`backend` reports.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
SRC = _REPO_ROOT / "csrc" / "preprocess.cpp"
BUILD_DIR = _REPO_ROOT / "build" / "native"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-march=native", "-pthread")

_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def host_key() -> str:
    """Digest of the target options ``g++ -march=native`` selects here."""
    out = subprocess.run(
        ["g++", "-march=native", "-Q", "--help=target"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return hashlib.sha256(out.encode()).hexdigest()[:12]


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libpreprocess-{digest}-{host_key()}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *FLAGS, str(SRC), "-o", tmp], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, out)  # atomic: a concurrent build sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib():
    """The loaded library, built on first use; None where g++ or the
    source is missing or the build fails."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.SubprocessError):
            return None
        i64 = ctypes.c_int64
        fp = ctypes.POINTER(ctypes.c_float)
        lib.resize_bilinear_f32.argtypes = [fp, i64, i64, i64, fp, i64, i64]
        lib.resize_bilinear_f32.restype = None
        lib.paste_f32.argtypes = [fp, i64, i64, i64, fp, i64, i64, i64, i64]
        lib.paste_f32.restype = None
        lib.fill_f32.argtypes = [fp, i64, i64, i64, fp]
        lib.fill_f32.restype = None
        _LIB = lib
        return _LIB


def backend() -> str:
    """``native`` when the library is loaded, else ``numpy``."""
    return "native" if get_lib() is not None else "numpy"


def _fp(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def resize_bilinear_native(im: np.ndarray, out_h: int, out_w: int):
    """Native resize of an HWC image; None when the library is absent."""
    lib = get_lib()
    if lib is None:
        return None
    im = np.ascontiguousarray(im, dtype=np.float32)
    h, w, c = im.shape
    out = np.empty((out_h, out_w, c), np.float32)
    lib.resize_bilinear_f32(_fp(im), h, w, c, _fp(out), out_h, out_w)
    return out


def fill_paste_native(src: np.ndarray, out_h: int, out_w: int,
                      top: int, left: int, color):
    """An [out_h, out_w, C] canvas filled with ``color`` with ``src`` pasted
    at (top, left), the letterbox's pad step; None when the library is
    absent."""
    lib = get_lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, np.float32)
    h, w, c = src.shape
    out = np.empty((out_h, out_w, c), np.float32)
    col = np.ascontiguousarray(np.broadcast_to(
        np.asarray(color, np.float32), (c,)))
    lib.fill_f32(_fp(out), out_h, out_w, c, _fp(col))
    lib.paste_f32(_fp(src), h, w, c, _fp(out), out_h, out_w, top, left)
    return out
