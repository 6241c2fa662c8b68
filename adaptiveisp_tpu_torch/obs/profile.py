"""Profiling: the validator's timing buckets, traces and the cost of a call
(port of ``adaptiveisp_tpu/obs/profile.py``).

``Profile`` is the reference's accumulating context timer
(utils/general.py:173-191); with ``sync=True`` it waits for the card
(``torch.cuda.synchronize``) on entry and exit, so a bucket holds the
device work it launched.  On the CPU there is nothing to wait for.
``trace`` writes a ``torch.profiler`` Chrome trace that ``obs/trace.py``
reads; ``profile_fn`` is the FLOP and memory count of one call.

``span`` and ``count`` are the program's own instrumentation, live only
while a ``torch.profiler`` records: ``span(name)`` is then a
``record_function`` scope, on the trace's clock beside the kernels (an idle
stretch of the card sits under the span of the layer whose host code left
it idle), and ``count(name)`` adds to ``COUNTS``.  Otherwise a span is one
shared no-op and a count does nothing; whether a profiler runs is the only
switch.  ``host_read.<layer>`` counts each call of that layer at which the
host waits for the card's stream (``host_read.upload.<layer>``: a blocking
upload from pageable memory, which waits for the stream before it copies).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict

import torch

_profiling = torch.autograd._profiler_enabled

# counts of the last traced stretch, by name (``count``)
COUNTS: Dict[str, int] = {}


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str):
    """A ``record_function(name)`` scope while the profiler records, else
    the shared no-op."""
    if _profiling():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to ``COUNTS[name]`` while the profiler records."""
    if _profiling():
        COUNTS[name] = COUNTS.get(name, 0) + n


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


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (the host, and the card when there
    is one; shapes recorded, FLOPs counted), written as a Chrome trace
    ``trace.json`` into ``log_dir``, where ``obs.trace.trace_op_table``
    reads it.  The trace also carries each operation's FLOPs (an argument
    ``flops``), which the profiler counts but does not write.  ``COUNTS``
    starts empty and is written beside it as ``counts.json``."""
    from torch.profiler import ProfilerActivity, profile

    COUNTS.clear()
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, record_shapes=True,
                   with_flops=True)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(path)
        flops = {e.id: e.flops for e in prof.events() if e.flops}
        with open(path) as f:
            data = json.load(f)
        for e in data["traceEvents"]:
            n = flops.get((e.get("args") or {}).get("External id"))
            if n and e.get("cat") == "cpu_op":
                e["args"]["flops"] = n
        with open(path, "w") as f:
            json.dump(data, f)
        with open(os.path.join(log_dir, "counts.json"), "w") as f:
            json.dump(COUNTS, f, indent=1, sort_keys=True)


def _tensor_bytes(tree) -> float:
    from torch.utils._pytree import tree_flatten

    return float(sum(t.numel() * t.element_size()
                     for t in tree_flatten(tree)[0]
                     if isinstance(t, torch.Tensor)))


def profile_fn(fn, *args, **kwargs) -> Dict[str, float]:
    """FLOPs and memory of one eager call of ``fn`` (the reference's
    ``torch_utils.profile()`` analogue): ``flops`` and ``bytes_accessed``
    from ``obs.roofline.cost_of``, ``argument_bytes`` and ``output_bytes``
    of the call's tensors, and on the card ``temp_bytes``: the peak of
    ``torch.cuda.max_memory_allocated`` during the call above what was
    allocated before it, less the outputs."""
    from adaptiveisp_tpu_torch.obs.roofline import cost_of

    on_card = torch.cuda.is_available() and torch.cuda.is_initialized()
    if on_card:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    box = {}

    def call():
        box["out"] = fn(*args, **kwargs)

    cost = cost_of(call)
    out = {"flops": cost["flops"], "bytes_accessed": cost["bytes"],
           "argument_bytes": _tensor_bytes((args, kwargs)),
           "output_bytes": _tensor_bytes(box["out"])}
    if on_card:
        torch.cuda.synchronize()
        out["temp_bytes"] = float(max(
            0, torch.cuda.max_memory_allocated() - before
            - out["output_bytes"]))
    return out
