"""Shared pieces of the benchmark's own tests (run from the repository
root: ``python -m pytest benchmark/tests``)."""

import copy
import os
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

# tiny sizes of each traffic kind for a CPU run of a cell
TINY = {
    "infer": dict(batch=2, imgsz=64, pool_images=4, warmup_units=1,
                  check_units=1, check_from_first=2, trace_units=1),
    "train": dict(batch=2, imgsz=64, dataset_images=8, frame=[64, 96],
                  trace_iters=1),
}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def bench():
    return harness.load_benchmark()


def tiny_cell(name: str, tmp_path=None):
    """The cell as BENCHMARK.json has it, at CPU-sized shapes."""
    cell = harness.find_cell(harness.load_benchmark(), name)
    tr = dict(copy.deepcopy(cell.traffic), **TINY[cell.traffic["kind"]])
    if tr["kind"] == "train":
        tr["config_overrides"] = dict(tr["config_overrides"],
                                      replay_memory_size=8)
    cell.traffic = tr
    if tmp_path is not None:
        os.environ["TMPDIR"] = str(tmp_path)
    return cell


def run_tiny(cell, seconds=1.0, trace=False, seed=2 ** 31 + 7):
    import time

    out = cell.driver.run(cell, seed=seed, seconds=seconds, trace=trace,
                          started=time.perf_counter(),
                          device=torch.device("cpu"))
    return harness.result_line(cell, out, trace)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
