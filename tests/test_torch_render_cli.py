"""The port's render CLI (``python -m adaptiveisp_tpu_torch.render_isp``) on
``--device cpu`` against the JAX package's ``render_pipeline``, its stage
parsing and config errors, and the port's independence from JAX.

The CLI saves 8-bit PNGs floored from [0, 1] (``save_img``), so a saved
pixel is within 1/255 of the rendered value, as in
``tests/test_render_cli.py``.  ``--pipe 2`` (two gloo ranks) writes the
PNGs of ``--pipe 0``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from adaptiveisp_tpu_torch import render_isp
from adaptiveisp_tpu_torch.config import Config
from torch_suite import (  # noqa: F401
    cheap_xla, one_torch_thread, ranks_time_limit)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PNG_ATOL = 1.0 / 255 + 2e-5   # the PNG floor plus the chain's tolerance


def _write_imgs(d, n, h=24, w=40, seed=0):
    rng = np.random.RandomState(seed)
    os.makedirs(d, exist_ok=True)
    arrs = []
    for i in range(n):
        a = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        Image.fromarray(a).save(os.path.join(d, f"im{i}.png"))
        arrs.append(a.astype(np.float32) / 255.0)
    return arrs


def _read_out(out_dir, n):
    outs = []
    for i in range(n):
        with Image.open(os.path.join(out_dir, f"im{i}.png")) as im:
            outs.append(np.asarray(im, np.float32) / 255.0)
    return outs


def test_stage_parsing_and_config_errors(tmp_path, monkeypatch):
    cfg = Config()
    name, p = render_isp.parse_stage(cfg, "improved_wb:0.1,0.2,0.3")
    assert name == "improved_wb" and p.shape == (3,)
    assert render_isp.parse_stage(cfg, "tone:" + ",".join(["1"] * 8))[
        1].shape == (8,)
    with pytest.raises(ValueError):          # wrong parameter count
        render_isp.parse_stage(cfg, "exposure:0.1,0.2")
    with pytest.raises(KeyError):            # unknown filter
        render_isp.parse_stage(cfg, "nonexistent:1.0")
    bad = tmp_path / "script.yaml"
    bad.write_text("name: exposure\n")
    with pytest.raises(ValueError, match="YAML list"):
        render_isp.load_script(cfg, str(bad))
    (tmp_path / "not_a_port_cfg.py").write_text("cfg = {'curve_steps': 8}\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    with pytest.raises(TypeError, match="adaptiveisp_tpu_torch"):
        render_isp.load_cfg("not_a_port_cfg")
    (tmp_path / "port_cfg.py").write_text(
        "from adaptiveisp_tpu_torch.config import Config\n"
        "cfg = Config(curve_steps=4)\n")
    assert render_isp.load_cfg("port_cfg").curve_steps == 4
    with pytest.raises(SystemExit):          # no stages
        render_isp.main(["--source", str(tmp_path), "--device", "cpu",
                         "--out", str(tmp_path / "o")])


def test_render_cli_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a GPU")
    _write_imgs(tmp_path / "imgs", 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        render_isp.main(["--source", str(tmp_path / "imgs"),
                         "--out", str(tmp_path / "out"),
                         "--stage", "exposure:0.1"])


def test_render_cli_matches_jax_render(tmp_path):
    """Three frames in batches of 2 through --stage flags, then the same
    frames through a YAML script split by a denoise stage, each against
    JAX's ``render_pipeline`` of the frame."""
    import jax
    import jax.numpy as jnp

    from adaptiveisp_tpu.config import Config as JConfig
    from adaptiveisp_tpu.ops.bank import render_pipeline

    arrs = _write_imgs(tmp_path / "imgs", 3)
    flags = [("exposure", [0.4]), ("gamma", [0.8]), ("sharpen", [1.5])]
    script = [("exposure", [0.3]), ("improved_wb", [1.05, 0.95, 1.0]),
              ("denoise", [0.3]), ("gamma", [0.9]), ("sharpen", [0.7]),
              ("saturation_plus", [0.6])]
    with open(tmp_path / "chain.yaml", "w") as f:
        yaml.safe_dump([{"name": n, "params": p} for n, p in script], f)
    runs = {
        "flags": (flags, ["--stage", "exposure:0.4", "--stage", "gamma:0.8",
                          "--stage", "sharpen:1.5"]),
        "script": (script, ["--script", str(tmp_path / "chain.yaml")]),
    }
    jcfg = JConfig()
    for label, (stages, args) in runs.items():
        out_dir = render_isp.main(["--source", str(tmp_path / "imgs"),
                                   "--out", str(tmp_path / label),
                                   "--batch", "2", "--device", "cpu", *args])
        jst = [(n, jnp.asarray([p], jnp.float32)) for n, p in stages]
        ref = jax.jit(lambda x: render_pipeline(jcfg, x, jst))
        for a, g in zip(arrs, _read_out(out_dir, 3)):
            want = np.clip(np.asarray(ref(jnp.asarray(a[None])))[0], 0, 1)
            assert np.abs(want - g).max() <= PNG_ATOL, label


def test_render_cli_pipe_equals_single_process(tmp_path, ranks_time_limit):
    """``render_isp --pipe 2 --window 4 --device cpu`` (two gloo ranks,
    a chain with denoise, 6 frames in microbatches of 2) writes the PNGs
    of ``--pipe 0``; a stage count that differs from --pipe is refused."""
    rng = np.random.RandomState(4)
    src = tmp_path / "imgs"
    src.mkdir()
    for i in range(6):
        Image.fromarray((rng.rand(24, 40, 3) * 255).astype(np.uint8)).save(
            src / f"im{i}.png")
    stages = ["--stage", "exposure:0.3", "--stage", "denoise:0.4"]
    common = ["--source", str(src), "--device", "cpu", "--exist-ok",
              *stages]
    single = render_isp.main(common + ["--out", str(tmp_path / "single"),
                                       "--batch", "2"])
    assert render_isp.main(common + [
        "--out", str(tmp_path / "pipe"), "--pipe", "2", "--window", "4",
        "--batch", "2"]) is None
    names = sorted(os.listdir(single))
    assert names == sorted(os.listdir(tmp_path / "pipe")) and len(names) == 6
    for n in names:
        with Image.open(os.path.join(single, n)) as a, \
                Image.open(tmp_path / "pipe" / n) as b:
            assert np.array_equal(np.asarray(a), np.asarray(b)), n
    with pytest.raises(SystemExit):
        render_isp.main(common + ["--out", str(tmp_path / "bad"),
                                  "--pipe", "3"])


def test_port_imports_no_jax():
    """Every module of the port, imported in a fresh interpreter, pulls in
    neither jax nor any module of the JAX package, and no module refuses
    a parallel axis naming the parallelism queue (P15): sp, ep, pp and tp
    are ported."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import adaptiveisp_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'adaptiveisp_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'adaptiveisp_tpu.')) "
        "or m == 'adaptiveisp_tpu')\n"
        "new = {'adaptiveisp_tpu_torch.' + n for n in ("
        "'data.augment', 'data.detector_dataset', 'data.image_cache', "
        "'detect.autoanchor', 'detect.autobatch', 'detect.train_detector', "
        "'detect.train_loop', 'obs.callbacks', 'obs.loggers', 'nn_init', "
        "'detect.activations', 'detect.ensemble', 'data.artifacts', "
        "'serve.rest', 'detect_cli', 'raw.bayer', 'raw.unprocess', "
        "'detect.segment', 'data.segment_dataset', 'classify', "
        "'detect.export', 'detect.export_tf', 'export_cli', "
        "'serve.triton', 'obs.roofline', 'obs.trace', 'train.mesh', "
        "'parallel', 'tensor_parallel', 'ops.ep', 'ops.pp', "
        "'resume_all')}\n"
        "assert new <= set(names), sorted(new - set(names))\n"
        "print(len(names), bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    count, bad = res.stdout.split(" ", 1)
    assert int(count) >= 70 and bad.strip() == "[]", res.stdout
    port = os.path.join(REPO, "adaptiveisp_tpu_torch")
    refusals = sorted(
        os.path.relpath(os.path.join(d, f), port)
        for d, _, files in os.walk(port) for f in files
        if f.endswith(".py")
        and "P15" in open(os.path.join(d, f)).read())
    assert refusals == [], refusals
