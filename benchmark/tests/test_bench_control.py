"""The control (the plain reference one precision below the configuration:
TF32 for float32 with TF32 off) put in the program's place comes out not
correct, at a size a test run holds, and so does the training cell's
planted fault; the program at the same size comes out correct.  Needs the
card."""

import copy

import pytest

from benchmark import control, harness
from benchmark.reference import compare

SMALL = {
    "infer": dict(batch=4, imgsz=256, pool_images=16, warmup_units=1,
                  check_units=2, check_from_first=4),
    "train": dict(batch=4, imgsz=256, dataset_images=16, frame=[256, 384]),
}


def _cell(name):
    cell = harness.find_cell(harness.load_benchmark(), name)
    tr = dict(copy.deepcopy(cell.traffic), **SMALL[cell.traffic["kind"]])
    if tr["kind"] == "train":
        tr["config_overrides"] = dict(tr["config_overrides"],
                                      replay_memory_size=16)
    cell.traffic = tr
    return cell


def _correct(cell, numbers):
    limits = harness.load_json(harness.BENCH_DIR / "limits"
                               / f"{cell.name}.json")["limits"]
    return all(v is not None and v <= lim
               for _, v, lim in compare.to_checks(numbers, limits))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["infer.default.b16", "infer.fast.b16"])
@pytest.mark.parametrize("seed", [21, 22, 23])
def test_inference_control_is_not_correct(cuda_device, name, seed):
    cell = _cell(name)
    prog = control.readings(cell, seed, "program", cuda_device)
    ctrl = control.readings(cell, seed, "control", cuda_device)
    assert _correct(cell, prog["numbers"]), prog
    assert not _correct(cell, ctrl["numbers"]), ctrl


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [21, 22, 23])
def test_training_control_is_not_correct(cuda_device, tmp_path, monkeypatch,
                                         seed):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    cell = _cell("train.default.b16")
    prog, ctrl, fault = control.train_readings(
        cell, seed, cuda_device, ["control", "half_batch_ref"], [])
    assert _correct(cell, prog["numbers"]), prog
    assert not _correct(cell, ctrl["numbers"]), ctrl
    assert not _correct(cell, fault["numbers"]), fault
