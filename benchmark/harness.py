"""The benchmark's cell runner, driven by ``BENCHMARK.json``.

A run of one cell: find the cell, its configuration file
(``configs/<config>.json``), its traffic mix (``traffic/<traffic>.json``,
whose ``kind`` names the driver, ``drivers/<kind>.py``) and the per-layer
metrics that list it (``metrics/<name>.py``, one reader each); check the
cards; let the driver set up, warm up, measure for ``--seconds`` and check
its outputs against the plain reference; then print the compared numbers on
standard error and one JSON line on standard output.  Nothing here knows a
configuration, a mix or a metric by name.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "adaptiveisp_tpu")
EXIT_NO_CARD, EXIT_BAD_CELL, EXIT_FORBIDDEN = 3, 4, 5


def cache_env(root: Path = ROOT) -> Dict[str, str]:
    """Fixed build and kernel cache directories inside the checkout (the
    port's nvcc libraries already go to ``build/kernels``)."""
    build = root / "build"
    return {"TORCH_EXTENSIONS_DIR": str(build / "torch_extensions"),
            "TRITON_CACHE_DIR": str(build / "triton"),
            "TORCHINDUCTOR_CACHE_DIR": str(build / "inductor"),
            "CUDA_CACHE_PATH": str(build / "nv_compute_cache")}


def load_benchmark(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module from a file whose name may hold dots (a metric's name)."""
    name = "benchmark_metric_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _listed(entry: Dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


@dataclasses.dataclass
class Cell:
    """Everything one run of a cell reads, found by name."""

    name: str
    entry: Dict
    config: Dict
    traffic: Dict
    driver: Any
    end_to_end: List[Dict]
    per_layer: List[Dict]


def find_cell(bench: Dict, name: str, root: Path = ROOT) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    entry = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    config = load_json(root / cfg_entry["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json")
    driver = importlib.import_module(f"benchmark.drivers.{traffic['kind']}")
    return Cell(name, entry, config, traffic, driver,
                [m for m in bench["end_to_end"] if _listed(m, name)],
                [m for m in bench["per_layer"] if _listed(m, name)])


def metric_reader(name: str) -> Callable:
    return load_module(BENCH_DIR / "metrics" / f"{name}.py").read


@dataclasses.dataclass
class Outcome:
    """What a driver hands back.  ``end_to_end`` holds the cell's
    end-to-end values by name, ``layer`` what the per-layer readers read
    (spans, counters, the device trace), ``checks`` the compared numbers
    as (name, value, limit): correct when each value is at most its
    limit."""

    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    checks: List[tuple]
    device: Dict[str, Any]
    layer: Dict[str, Any] = dataclasses.field(default_factory=dict)
    breakdown: Optional[Dict] = None


def forbidden_modules() -> List[str]:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def result_line(cell: Cell, out: Outcome, trace: bool) -> Dict:
    checks = {name: {"value": value, "limit": limit}
              for name, value, limit in out.checks}
    correct = bool(out.checks) and out.failed == 0 and all(
        value is not None and value <= limit
        for _, value, limit in out.checks)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = metric_reader(m["name"])(out.layer)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out.end_to_end[m["name"]],
                                  "unit": m["unit"]}
    line = {"correct": correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": out.device}
    if trace and out.breakdown is not None:
        line["breakdown"] = out.breakdown
    line["checks"] = checks
    return line


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, started: float) -> int:
    args = parse_args(argv)
    try:
        cell = find_cell(load_benchmark(), args.workload)
    except (KeyError, FileNotFoundError, ModuleNotFoundError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return EXIT_BAD_CELL
    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return EXIT_NO_CARD
    out = cell.driver.run(cell, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), started=started,
                          device=torch.device("cuda"))
    found = forbidden_modules()
    if found:
        print("benchmark: forbidden modules loaded: " + ", ".join(found),
              file=sys.stderr)
        return EXIT_FORBIDDEN
    line = result_line(cell, out, bool(args.trace))
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct = {line['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def set_cache_env() -> None:
    os.environ.update(cache_env())


def process_age() -> float:
    """Seconds since this process started (Linux ``/proc``), so that set-up
    counts the interpreter's start too."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
