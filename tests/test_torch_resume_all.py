"""``python -m adaptiveisp_tpu_torch.resume_all``: the port's counterpart of
``tools/resume_all.py`` (whose JAX behaviour ``tests/test_resume.py``
pins), on the port's ``last.pt`` checkpoints.

Fake runs (a ``torch.save``d ``last.pt`` beside an ``opt.yaml``): only the
unfinished one is found; finished runs, unreadable checkpoints and runs
without ``opt.yaml`` are skipped; the command is rebuilt from ``opt.yaml``
flag by flag, as JAX's.  ``--dry-run`` prints and launches nothing, and a
real relaunch runs once per run.  Then a real two-epoch run of
``detect.train_loop`` on the CPU, cut back to its epoch-0 checkpoint, is
relaunched by the tool in a fresh process and ends on the uninterrupted
run's last.pt, bit for bit (one torch thread on both sides).
"""

import os
import shutil
import subprocess
import sys

import pytest
import torch
import yaml

from adaptiveisp_tpu_torch import resume_all
from test_torch_detector_training import _write_set
from torch_suite import cheap_xla, one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fake_run(root, name, epoch, epochs, **opt):
    d = root / name
    d.mkdir(parents=True)
    torch.save({"epoch": epoch, "model": {}, "best_fitness": 0.1},
               d / "last.pt")
    with open(d / "opt.yaml", "w") as f:
        yaml.safe_dump(dict({"data": "imgs", "epochs": epochs, "imgsz": 64,
                             "batch_size": 4, "spec": "yolov3-tiny",
                             "save_dir": str(d), "plots": True,
                             "multi_scale": False, "seed": 0, "dp": 2,
                             "tp": 0, "cache": "none", "freeze": [1, 3],
                             "hyp": None, "weights": "w.pt", "evolve": None,
                             "resume": "old.pt", "device": "cuda"}, **opt),
                       f, sort_keys=False)
    return d


def test_find_resumable_and_resume_command(tmp_path):
    run_a = _fake_run(tmp_path, "run_a", epoch=1, epochs=4)   # resumable
    _fake_run(tmp_path, "run_b", epoch=3, epochs=4)           # finished
    (tmp_path / "run_c").mkdir()                              # no ckpt
    bad = _fake_run(tmp_path, "run_d", epoch=0, epochs=4)
    (bad / "last.pt").write_bytes(b"not a checkpoint")        # unreadable
    lone = tmp_path / "run_e"                                 # no opt.yaml
    lone.mkdir()
    torch.save({"epoch": 0}, lone / "last.pt")

    found = list(resume_all.find_resumable(tmp_path))
    assert len(found) == 1
    last, opt = found[0]
    assert last == run_a / "last.pt" and opt["epochs"] == 4

    cmd = resume_all.resume_command(last, opt)
    assert cmd[:3] == [sys.executable, "-m",
                       "adaptiveisp_tpu_torch.detect.train_loop"]
    assert cmd[-2:] == ["--resume", str(last)]
    joined = " ".join(cmd)
    for part in ("--data imgs", "--epochs 4", "--batch-size 4",
                 "--spec yolov3-tiny", "--plots", "--dp 2", "--tp 0",
                 "--freeze 1 3", "--device cuda", f"--save-dir {run_a}"):
        assert part in joined, part
    for gone in ("--multi-scale", "--hyp", "--weights", "--evolve",
                 "old.pt"):
        assert gone not in joined, gone


def test_main_dry_run_and_launches(tmp_path, capsys, monkeypatch):
    _fake_run(tmp_path, "run_a", epoch=0, epochs=3)
    _fake_run(tmp_path, "run_b", epoch=2, epochs=3)
    _fake_run(tmp_path, "run_c", epoch=1, epochs=3, device="cpu")
    ran = []
    monkeypatch.setattr(subprocess, "run",
                        lambda cmd, **kw: ran.append(("run", cmd)))

    class Proc:
        def __init__(self, cmd, **kw):
            ran.append(("popen", cmd))

        def wait(self):
            ran.append(("wait", None))

    monkeypatch.setattr(subprocess, "Popen", Proc)
    cmds = resume_all.main([str(tmp_path), "--dry-run"])
    assert len(cmds) == 2 and ran == []
    out = capsys.readouterr().out.splitlines()
    assert out == [" ".join(c) for c in cmds]
    assert "--device cpu" in out[1] and "run_c" in out[1]
    assert resume_all.main([str(tmp_path)]) == cmds
    assert ran == [("run", c) for c in cmds]
    ran.clear()
    resume_all.main([str(tmp_path), "--parallel"])
    assert ran == [("popen", c) for c in cmds] + [("wait", None)] * 2
    capsys.readouterr()
    assert resume_all.main([str(tmp_path / "run_b")]) == []
    assert "no resumable runs" in capsys.readouterr().out


def test_relaunch_continues_a_cpu_run(tmp_path, monkeypatch):
    """A two-epoch run cut back to epoch 0, relaunched by the tool's own
    subprocess, ends where the uninterrupted run ended."""
    from adaptiveisp_tpu_torch.detect import train_loop as tl

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    stub = tmp_path / "stub"
    (stub / "tensorflow").mkdir(parents=True)
    (stub / "tensorflow" / "__init__.py").write_text(
        "raise ImportError('not here')\n")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join([str(stub), REPO]))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    train = _write_set(tmp_path / "data" / "train", 8, 1)
    val = _write_set(tmp_path / "data" / "val", 4, 2)
    save = tmp_path / "runs" / "exp"
    flags = lambda: (torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark,
                     torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
    before = flags()
    tl.main(["--data", train, "--val-data", val, "--spec", "yolov3-tiny",
             "--nc", "2", "--imgsz", "64", "--batch-size", "4", "--epochs",
             "2", "--device", "cpu", "--save-dir", str(save),
             "--save-period", "1", "--noautoanchor", "--deterministic"])
    assert flags() == before   # pinned for the run only
    whole = torch.load(save / "last.pt", weights_only=False)
    assert whole["epoch"] == 1
    shutil.copy(save / "epoch0.pt", save / "last.pt")
    cmds = resume_all.main([str(tmp_path / "runs")])
    assert len(cmds) == 1 and "--device cpu" in " ".join(cmds[0])
    assert "--deterministic" in cmds[0]
    again = torch.load(save / "last.pt", weights_only=False)
    assert again["epoch"] == 1 and again["step"] == whole["step"]
    for part in ("model", "ema"):
        assert set(again[part]) == set(whole[part])
        for k, v in whole[part].items():
            assert torch.equal(again[part][k], v), f"{part} {k}"
    assert list(resume_all.find_resumable(tmp_path / "runs")) == []
