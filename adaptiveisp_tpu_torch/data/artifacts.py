"""Artifact resolution and download utilities (port of
``adaptiveisp_tpu/data/artifacts.py``; standard library only).

``resolve_artifact`` looks for a file locally first: the name as a path,
then its basename under the given directories, ``$ADAPTIVEISP_ARTIFACTS``
(``:``-separated), the artifact cache and the working directory.  Only a
URL with ``download=True`` is fetched (into the cache); an unknown name
raises with the places searched.  ``load_detector(weights=name)`` resolves
with ``download=False``.
"""

from __future__ import annotations

import os
import shutil
import urllib.parse
import urllib.request
from pathlib import Path
from typing import Iterable, Optional, Sequence

DEFAULT_CACHE = os.path.join(
    os.path.expanduser("~"), ".cache", "adaptiveisp_tpu")


def artifact_cache() -> str:
    """The local artifact cache root (override: $ADAPTIVEISP_CACHE)."""
    return os.environ.get("ADAPTIVEISP_CACHE", DEFAULT_CACHE)


def is_url(s, check: bool = False) -> bool:
    """True if ``s`` parses as a URL; ``check=True`` also opens it."""
    try:
        s = str(s)
        r = urllib.parse.urlparse(s)
        if not (r.scheme and (r.netloc or r.scheme == "file")):
            return False
        if check:
            with urllib.request.urlopen(s) as resp:
                return getattr(resp, "status", 200) == 200
        return True
    except Exception:
        return False


def url_getsize(url: str) -> int:
    """Downloadable size in bytes, -1 if unknown (reference
    downloads.py:33-36): a HEAD request's content-length."""
    req = urllib.request.Request(url, method="HEAD")
    try:
        with urllib.request.urlopen(req) as resp:
            return int(resp.headers.get("content-length", -1))
    except Exception:
        return -1


def safe_download(file, url: str, url2: Optional[str] = None,
                  min_bytes: float = 1.0, retries: int = 3,
                  error_msg: str = "") -> str:
    """Stream ``url`` to ``file``; fall back to ``url2``; remove partial
    files below ``min_bytes``."""
    file = Path(file)
    file.parent.mkdir(parents=True, exist_ok=True)
    last_err: Optional[Exception] = None
    for attempt in range(max(1, retries)):
        src = url if attempt == 0 or url2 is None else url2
        try:
            with urllib.request.urlopen(src) as resp, open(file, "wb") as f:
                shutil.copyfileobj(resp, f)
            if file.exists() and file.stat().st_size >= min_bytes:
                return str(file)
        except Exception as e:  # noqa: BLE001 - retry, then report
            last_err = e
        if file.exists():
            file.unlink()  # partial download
    raise FileNotFoundError(
        f"download of '{url}' to '{file}' failed or produced "
        f"< {min_bytes} bytes. {error_msg}") from last_err


def resolve_artifact(name, search_dirs: Sequence[str] = (),
                     download: bool = True) -> str:
    """Resolve an artifact name, path or URL to a local file path (the
    search order of the module docstring)."""
    s = str(name).strip().replace("'", "")
    p = Path(s)
    if p.is_file():
        return str(p)

    base = Path(urllib.parse.unquote(s)).name.split("?")[0]
    roots: list = list(search_dirs)
    roots += [d for d in os.environ.get(
        "ADAPTIVEISP_ARTIFACTS", "").split(":") if d]
    roots += [artifact_cache(), "."]
    for root in roots:
        cand = Path(root) / base
        if cand.is_file():
            return str(cand)

    if is_url(s):
        if not download:
            raise FileNotFoundError(
                f"'{base}' not found locally and download=False")
        return safe_download(Path(artifact_cache()) / base, s)

    raise FileNotFoundError(
        f"artifact '{s}' not found. Looked for '{base}' in: "
        f"{[str(r) for r in roots]}. Stage the file in one of these "
        f"locations or set $ADAPTIVEISP_ARTIFACTS.")


def download(urls: Iterable[str], dir=".", unzip: bool = True,
             delete: bool = False, retries: int = 3) -> list:
    """Sequential batch download with optional archive extraction (a
    dataset YAML's ``download:`` key)."""
    dir = Path(dir)
    dir.mkdir(parents=True, exist_ok=True)
    out = []
    for url in ([urls] if isinstance(urls, str) else list(urls)):
        f = dir / (Path(urllib.parse.unquote(str(url))).name.split("?")[0])
        if not f.is_file():
            safe_download(f, str(url), retries=retries)
        if unzip and f.suffix in (".zip", ".tar", ".gz", ".tgz"):
            if f.suffix == ".zip":
                import zipfile

                with zipfile.ZipFile(f) as z:
                    z.extractall(dir)
            else:
                import tarfile

                with tarfile.open(f) as t:
                    t.extractall(dir)
            if delete:
                f.unlink()
        out.append(str(f))
    return out
