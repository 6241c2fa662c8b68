"""The port and the plain reference agree at a tiny size on the CPU, for
every cell's driver."""

import pytest
from conftest import run_tiny, tiny_cell


@pytest.mark.parametrize("name", ["infer.default.b16", "infer.fast.b16"])
def test_served_inference_matches_the_reference(name):
    line = run_tiny(tiny_cell(name))
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    for c in line["checks"].values():
        assert c["value"] == 0.0


def test_training_matches_the_reference(tmp_path):
    line = run_tiny(tiny_cell("train.default.b16", tmp_path))
    assert line["correct"] is True, line["checks"]
    assert line["checks"]["grad_rel"]["value"] < 1e-6
    assert line["attempted"] > 0
    assert not list(tmp_path.iterdir())   # the image folder is removed
