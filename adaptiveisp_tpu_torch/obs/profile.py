"""The validator's timing buckets (port of ``Profile`` and
``speed_report`` from ``adaptiveisp_tpu/obs/profile.py``).

``Profile`` is the reference's accumulating context timer
(utils/general.py:173-191); with ``sync=True`` it waits for the card
(``torch.cuda.synchronize``) on entry and exit, so a bucket holds the
device work it launched.  On the CPU there is nothing to wait for.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch


class Profile(contextlib.ContextDecorator):
    """Accumulating timer; ``with p: ...`` adds to ``p.t`` (seconds)."""

    def __init__(self, sync: bool = False):
        self.t = 0.0
        self.n = 0
        self.sync = sync

    def _sync(self):
        if self.sync and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def __enter__(self):
        self._sync()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.dt = time.perf_counter() - self.start
        self.t += self.dt
        self.n += 1
        return False


def speed_report(profiles: Dict[str, Profile], images: int) -> str:
    """ms per image of each bucket (reference val_adaptiveisp.py:411-415
    format)."""
    parts = [f"{1000 * p.t / max(images, 1):.1f}ms {name}"
             for name, p in profiles.items()]
    return "Speed: " + ", ".join(parts) + " per image"
