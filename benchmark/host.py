"""The host side of a measured window.

:class:`Watch` is entered just before a window opens and left once it has
closed.  It times every pause of Python's garbage collector in between, and,
where the traffic mix's ``host`` parameters set ``gc_freeze``, it first
collects and freezes every object that set-up made (``gc.freeze``), so that
the collector's full passes in the window scan only what the window itself
made; leaving thaws them again, before the run frees the program's state.
What it saw goes to standard error.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict, List, Tuple


class Watch:
    def __init__(self, params: Dict = None):
        self.freeze = bool((params or {}).get("gc_freeze", False))
        self.pauses: List[Tuple[int, float]] = []
        self.frozen = 0
        self._t = None

    def _callback(self, phase: str, info: Dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.pauses.append((int(info["generation"]),
                                time.perf_counter() - self._t))
            self._t = None

    def __enter__(self) -> "Watch":
        if self.freeze:
            gc.collect()
            gc.freeze()
            self.frozen = gc.get_freeze_count()
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self._callback)
        if self.freeze:
            gc.unfreeze()

    def report(self) -> None:
        by_gen = [sum(1 for g, _ in self.pauses if g == k) for k in range(3)]
        full = [s for g, s in self.pauses if g == 2]
        print(f"gc in window: frozen={self.frozen} "
              f"collections={by_gen[0]}/{by_gen[1]}/{by_gen[2]} "
              f"pause_s={sum(s for _, s in self.pauses):.4f} "
              f"full_pause_s={sum(full):.4f} "
              f"max_pause_s={max((s for _, s in self.pauses), default=0.0):.4f}",
              file=sys.stderr, flush=True)


class Timed:
    """Wraps one method of an object in place, counting its calls and the
    seconds spent in them (``feeder.next_batch``: the main thread's waits
    for decoded images)."""

    def __init__(self, obj, method: str):
        self.obj, self.method = obj, method
        self.call = getattr(obj, method)
        self.calls, self.seconds = 0, 0.0
        setattr(obj, method, self._timed)

    def _timed(self, *args, **kwargs):
        t = time.perf_counter()
        try:
            return self.call(*args, **kwargs)
        finally:
            self.calls += 1
            self.seconds += time.perf_counter() - t

    def reading(self) -> Tuple[int, float]:
        return self.calls, self.seconds
