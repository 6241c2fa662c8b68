"""Each fault that a cell's timed path can have, planted underneath a run
on the CPU (``benchmark/faults.py``), makes ``correct`` come out false (the
look for a card is skipped; the rest of the run is driven as on the
card)."""

import pytest
from conftest import run_tiny, tiny_cell

from benchmark import faults


@pytest.mark.parametrize("fault", sorted(faults.INFER))
@pytest.mark.parametrize("name", ["infer.default.b16", "infer.fast.b16"])
def test_inference_faults_are_caught(name, fault):
    with faults.INFER[fault]():
        line = run_tiny(tiny_cell(name))
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_training_faults_are_caught(tmp_path, fault):
    with faults.TRAIN[fault]():
        line = run_tiny(tiny_cell("train.default.b16", tmp_path))
    assert line["correct"] is False, line["checks"]
