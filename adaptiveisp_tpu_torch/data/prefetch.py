"""Single-worker background prefetcher (port of
``adaptiveisp_tpu/data/prefetch.py``): one daemon thread keeps one result
ready; ``get_next`` blocks until it is.  Its owner calls ``stop()``.
"""

from __future__ import annotations

import queue
import threading


class Prefetcher:
    def __init__(self, fn, depth: int = 1):
        self._fn = fn
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            try:
                item = self._fn()
            except Exception as e:  # surface worker errors to the consumer
                item = e
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def get_next(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def stop(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
