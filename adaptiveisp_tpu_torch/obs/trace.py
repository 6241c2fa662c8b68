"""Trace parsing: device time attributed to the code's own scopes (port of
``adaptiveisp_tpu/obs/trace.py``).

The JAX package reads the device plane of a ``jax.profiler`` XSpace, whose
ops carry the ``named_scope`` path.  The port reads the Chrome-trace JSON
that ``torch.profiler`` writes (``obs.profile.trace``) and rebuilds that
path: a kernel's correlation id leads to its launch on the host
(``cudaLaunchKernel`` and the like), the launch to the innermost aten
operation around it on that thread, and that operation to the
``record_function`` scopes around it (``train/step.py`` names them as
JAX's ``named_scope``s).  A backward operation runs on the autograd
engine's thread, outside those scopes; it carries the ``Sequence number``
and ``Fwd thread id`` of the forward operation that recorded it, so it is
given that operation's scopes and each component holds forward plus
backward, as JAX's transposes keep their scope.

The profiler records no bytes per operation, so ``bytes`` is 0; ``flops``
are the profiler's own counts (``with_flops``: matrix products and
convolutions of the forward; ``obs.profile.trace`` writes them into the
trace), given to the first kernel each operation launched.
"""

from __future__ import annotations

import bisect
import glob
import json
import os
from typing import Dict, List, Optional, Sequence

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_SCOPES = ("cpu_op", "user_annotation")


def find_trace_files(trace_dir: str) -> List[str]:
    """The Chrome-trace JSON files under ``trace_dir``."""
    return sorted(glob.glob(os.path.join(trace_dir, "**", "*.json"),
                            recursive=True))


class _Thread:
    """One host thread's operations and scopes, properly nested: each
    event's parent is the innermost one around it."""

    def __init__(self, events):
        self.events = sorted(events, key=lambda e: (e["ts"], -e["dur"]))
        self.starts = [e["ts"] for e in self.events]
        self.index = {id(e): i for i, e in enumerate(self.events)}
        self.parent: List[int] = []
        stack: List[int] = []
        for i, e in enumerate(self.events):
            while stack and not _contains(self.events[stack[-1]], e["ts"],
                                          e["ts"] + e["dur"]):
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def _chain(self, i: int) -> List[Dict]:
        out = []
        while i >= 0:
            out.append(self.events[i])
            i = self.parent[i]
        return out[::-1]

    def enclosing(self, ts: float) -> List[Dict]:
        """The events around ``ts``, outermost first."""
        i = bisect.bisect_right(self.starts, ts) - 1
        while i >= 0 and not _contains(self.events[i], ts, ts):
            i = self.parent[i]
        return self._chain(i)

    def chain_of(self, e) -> List[Dict]:
        """``e`` and the events around it, outermost first."""
        return self._chain(self.index[id(e)])

    def within(self, e) -> List[Dict]:
        """``e`` and the events inside it."""
        i = self.index[id(e)]
        end = e["ts"] + e["dur"]
        j = bisect.bisect_right(self.starts, end)
        return [o for o in self.events[i:j]
                if _contains(e, o["ts"], o["ts"] + o["dur"])]


def _contains(e, start: float, end: float) -> bool:
    return e["ts"] <= start and end <= e["ts"] + e["dur"]


def _args(e) -> Dict:
    return e.get("args") or {}


def _load_events(paths) -> List[Dict]:
    """The complete events of the Chrome traces among ``paths`` (other JSON
    files beside them, such as ``obs.profile.trace``'s ``counts.json``,
    hold none)."""
    events = []
    for path in paths:
        with open(path) as f:
            data = json.load(f)
        trace = (data.get("traceEvents", []) if isinstance(data, dict)
                 else data)
        events += [e for e in trace if e.get("ph") == "X" and "ts" in e]
    for e in events:
        e["ts"], e["dur"] = float(e["ts"]), float(e.get("dur", 0.0))
    return events


def trace_op_table(trace_dir: str,
                   categories: Sequence[str] = DEVICE_CATEGORIES
                   ) -> List[Dict]:
    """Aggregate a trace's device events (kernels, copies, fills).

    Returns one row per distinct (name, scope path): {name, tf_op,
    category, duration_ps (summed over occurrences), flops (per
    occurrence), bytes, count}, longest first.  ``tf_op`` holds the
    ``record_function`` scopes, outermost first, joined by ``/``.  A trace
    of the CPU alone has no device events: pass ``categories=("cpu_op",)``
    for one row per outermost aten operation instead."""
    paths = find_trace_files(trace_dir)
    if not paths:
        raise FileNotFoundError(f"no trace .json under {trace_dir}")
    events = _load_events(paths)
    host: Dict = {}
    for e in events:
        if e.get("cat") in _HOST_SCOPES:
            host.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    threads = {k: _Thread(v) for k, v in host.items()}
    launches = {_args(e)["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in _args(e)}
    # forward operations by (thread, sequence number); the threads that
    # recorded forward operations, in order of their first event (the
    # profiler numbers threads in the order they first record)
    forward, fwd_threads = {}, []
    for key, th in sorted(threads.items(),
                          key=lambda kv: kv[1].starts[0]):
        for e in th.events:
            a = _args(e)
            if e.get("cat") == "cpu_op" and "Sequence number" in a \
                    and not a.get("Fwd thread id"):
                forward.setdefault((key, a["Sequence number"]), e)
                if key not in fwd_threads:
                    fwd_threads.append(key)

    def scopes_of(chain) -> List[Dict]:
        """The scopes of a chain of host events, those of the forward
        operation when the innermost recorded operation is a backward
        one."""
        for e in reversed(chain):
            a = _args(e)
            fwd_tid = a.get("Fwd thread id")
            if e.get("cat") != "cpu_op" or not fwd_tid:
                continue
            seq = a.get("Sequence number")
            cands = [k for k in fwd_threads if (k, seq) in forward]
            if len(cands) > 1 and fwd_tid <= len(fwd_threads):
                cands = [fwd_threads[fwd_tid - 1]]
            if cands and (cands[0], seq) in forward:
                f = forward[(cands[0], seq)]
                return threads[cands[0]].chain_of(f)
            break
        return chain

    def host_chain(e) -> List[Dict]:
        """The host events around the place where ``e`` was issued: its
        launch for a device event, itself for a host one."""
        launch = launches.get(_args(e).get("correlation"))
        src = launch if launch is not None else e
        th = threads.get((src.get("pid"), src.get("tid")))
        if th is None:
            return []
        if src is e and id(e) in th.index:
            return th.chain_of(e)
        return th.enclosing(src["ts"])

    selected = [e for e in events if e.get("cat") in categories]
    chains = {id(e): host_chain(e) for e in selected}
    host_rows = tuple(categories) == ("cpu_op",)
    if host_rows:   # outermost operations only
        selected = [e for e in selected if len(
            [o for o in chains[id(e)] if o.get("cat") == "cpu_op"]) == 1]
    # each operation's FLOPs go to the first event it issued (a host row:
    # its own and those of the operations inside it)
    flops_of: Dict[int, float] = {}
    seen_ops = set()
    for e in sorted(selected, key=lambda e: e["ts"]):
        ops = chains[id(e)]
        if host_rows:
            ops = threads[(e.get("pid"), e.get("tid"))].within(e)
        total = 0.0
        for o in ops:
            if o.get("cat") == "cpu_op" and id(o) not in seen_ops \
                    and _args(o).get("flops"):
                seen_ops.add(id(o))
                total += float(_args(o)["flops"])
        flops_of[id(e)] = total

    rows: Dict = {}
    for e in selected:
        path = "/".join(s["name"] for s in scopes_of(chains[id(e)])
                        if s.get("cat") == "user_annotation")
        row = rows.setdefault((e["name"], path), {
            "name": e["name"], "tf_op": path, "category": e.get("cat", ""),
            "duration_ps": 0, "flops": 0.0, "bytes": 0, "count": 0})
        row["duration_ps"] += int(round(e["dur"] * 1e6))
        row["flops"] += flops_of[id(e)]
        row["count"] += 1
    for row in rows.values():   # per occurrence, as JAX's rows
        row["flops"] /= row["count"]
    return sorted(rows.values(), key=lambda r: -r["duration_ps"])


# the train step's record_function components (train/step.py); a backward
# operation takes its forward operation's scope, so each bucket is fwd+bwd
TRAIN_STEP_COMPONENTS = {
    "agent_fwd": ("agent_fwd",),
    "yolo_retouch": ("yolo_retouch",),
    "yolo_input": ("yolo_input",),
    "value_net": ("value_net",),
    "optimizer": ("optimizer",),
}


def component_breakdown(table: Sequence[Dict],
                        components: Optional[Dict] = None) -> Dict[str, Dict]:
    """Bucket the op table by scope-substring match on tf_op.

    Returns {component: {ms, flops, bytes, pct, achieved_tflops}} plus an
    'other' bucket and a 'total' row.  Percentages are of total device time.
    """
    components = components or TRAIN_STEP_COMPONENTS
    out = {k: {"ps": 0, "flops": 0, "bytes": 0} for k in components}
    out["other"] = {"ps": 0, "flops": 0, "bytes": 0}
    for row in table:
        dest = "other"
        for comp, keys in components.items():
            if any(k in row["tf_op"] for k in keys):
                dest = comp
                break
        out[dest]["ps"] += row["duration_ps"]
        out[dest]["flops"] += row["flops"] * row["count"]
        out[dest]["bytes"] += row["bytes"] * row["count"]
    total_ps = sum(v["ps"] for v in out.values()) or 1
    result = {}
    for comp, v in out.items():
        secs = v["ps"] * 1e-12
        result[comp] = {
            "ms": round(v["ps"] * 1e-9, 3),
            "pct": round(100.0 * v["ps"] / total_ps, 1),
            "gflops": round(v["flops"] / 1e9, 2),
            "achieved_tflops": (round(v["flops"] / secs / 1e12, 2)
                                if v["ps"] else 0.0),
            "achieved_gbs": (round(v["bytes"] / secs / 1e9, 1)
                             if v["ps"] else 0.0),
        }
    result["total"] = {
        "ms": round(total_ps * 1e-9, 3), "pct": 100.0,
        "gflops": round(sum(v["flops"] for v in out.values()) / 1e9, 2),
        "achieved_tflops": round(
            sum(v["flops"] for v in out.values()) / (total_ps * 1e-12)
            / 1e12, 2),
        "achieved_gbs": round(
            sum(v["bytes"] for v in out.values()) / (total_ps * 1e-12)
            / 1e9, 1),
    }
    return result
