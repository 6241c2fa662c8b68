"""A traced stretch of a run: ``torch.profiler`` over a few units inside a
``bench_window`` annotation, written as a Chrome trace to a fixed path in
the checkout, read back with the frozen trace parser (``trace.py``) and
deleted.

The summary gives the window's length and the device's busy time (the union
of kernels, copies and fills inside it), time and count by kernel name, the
longest idle stretches of the device labelled by the host operation under
way, and, when asked, device time by the program's ``record_function``
scopes.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Dict, List, Optional

import torch

from benchmark.roofline import trace as frozen

WINDOW = "bench_window"
TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "bench_trace"


class Recorder:
    """``with Recorder(name) as rec: <units>`` then ``rec.summary()``."""

    def __init__(self, name: str, components: Optional[Dict] = None):
        self.dir = TRACE_DIR / name
        self.components = components
        self._summary = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        shutil.rmtree(self.dir, ignore_errors=True)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.card = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU]
        if self.card:
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self.scope = record_function(WINDOW)
        self.scope.__enter__()
        return self

    def __exit__(self, *exc):
        if self.card:
            torch.cuda.synchronize()
        self.scope.__exit__(*exc)
        self.prof.__exit__(*exc)
        if exc[0] is None:
            path = self.dir / "trace.json"
            self.prof.export_chrome_trace(str(path))
            try:
                self._summary = summarize(str(self.dir), self.components)
            finally:
                shutil.rmtree(self.dir, ignore_errors=True)
        return False

    def summary(self) -> Dict:
        return self._summary


def _union(intervals: List[tuple]) -> List[tuple]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def summarize(trace_dir: str, components: Optional[Dict] = None) -> Dict:
    events = frozen._load_events(frozen.find_trace_files(trace_dir))
    windows = [e for e in events if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
    if not windows:
        raise RuntimeError("the trace has no bench_window annotation")
    win = max(windows, key=lambda e: e["dur"])
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    device = [e for e in events if e.get("cat") in frozen.DEVICE_CATEGORIES
              and w0 <= e["ts"] < w1]
    busy = _union([(e["ts"], min(e["ts"] + e["dur"], w1)) for e in device])
    by_name: Dict[str, List[float]] = {}
    for e in device:
        row = by_name.setdefault(e["name"], [0, 0.0])
        row[0] += 1
        row[1] += e["dur"] * 1e-6
    host = frozen._Thread([e for e in events
                           if (e.get("pid"), e.get("tid"))
                           == (win.get("pid"), win.get("tid"))
                           and e.get("cat") in ("cpu_op", "user_annotation",
                                                "cuda_runtime",
                                                "cuda_driver")])
    gaps, prev = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > prev:
            chain = [e["name"] for e in host.enclosing((prev + a) / 2)
                     if e["name"] != WINDOW]
            gaps.append((chain[-1] if chain else "host (between operations)",
                         (a - prev) * 1e-6))
        prev = max(prev, b)
    out = {"window_s": win["dur"] * 1e-6,
           "busy_s": sum(b - a for a, b in busy) * 1e-6,
           "kernels": sum(1 for e in device if e.get("cat") == "kernel"),
           "by_name": by_name, "gaps": gaps}
    if components is not None:
        table = frozen.trace_op_table(trace_dir)
        out["components"] = frozen.component_breakdown(table, components)
    return out


def breakdown(summary: Dict, top: int = 10) -> Dict:
    """The device operations that took most time and the idle time by what
    the host was doing, ``top`` of each, in seconds."""
    ops = sorted(((n, v[1]) for n, v in summary["by_name"].items()),
                 key=lambda x: -x[1])[:top]
    idle: Dict[str, float] = {}
    for label, secs in summary["gaps"]:
        idle[label] = idle.get(label, 0.0) + secs
    gaps = sorted(idle.items(), key=lambda x: -x[1])[:top]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n[:120], s] for n, s in gaps]}


def kernel_seconds(summary: Dict, needle: str):
    """(launches, device seconds) of the kernels whose name holds
    ``needle``."""
    count, secs = 0, 0.0
    for name, (n, s) in summary["by_name"].items():
        if needle in name:
            count += n
            secs += s
    return count, secs
