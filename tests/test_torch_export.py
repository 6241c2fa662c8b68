"""The port's export against the JAX package's.

The detector's ``torch.export`` program (``.pt2``) against JAX's StableHLO
artifact on the micro spec of ``tests/test_export_cli.py`` (the weights
cross over through ``convert``); the port's ``variables`` file read by
JAX's ``convert_yolo_state_dict`` into flax; a rollout with denoise
exported, saved and reloaded, one registered ``nlm_gray`` node a step;
the export CLI (``pt2``, ``variables``, ``--validate``, TF formats warned
and skipped, per-format isolation).  Everything on the CPU at 64 px.
"""

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from adaptiveisp_tpu.detect import export as jex
from adaptiveisp_tpu.detect.convert import convert_yolo_state_dict
from adaptiveisp_tpu.detect.model import DetectionModel as JModel
from adaptiveisp_tpu.detect.model import decode_predictions as jdecode
from adaptiveisp_tpu_torch import api
from adaptiveisp_tpu_torch import export_cli
from adaptiveisp_tpu_torch.config import Config
from adaptiveisp_tpu_torch.convert import yolo_from_flax
from adaptiveisp_tpu_torch.detect import export as ex
from adaptiveisp_tpu_torch.detect import export_tf
from adaptiveisp_tpu_torch.detect.model import decode_predictions
from adaptiveisp_tpu_torch.eval.rollout import no_pipeline, rollout
from test_export_cli import MICRO_SPEC
from torch_suite import cheap_xla, one_torch_thread  # noqa: F401

SIZE = 64
NLM_OP = "adaptiveisp_tpu_torch.nlm_gray.default"


def _seeded_variables(seed):
    """Seeded numpy flax variables of the micro detector over the shapes
    its ``init`` declares (no init compile)."""
    shapes = jax.eval_shape(lambda k: JModel(spec=MICRO_SPEC).init(
        {"params": k}, jnp.zeros((1, SIZE, SIZE, 3)), train=False),
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name.endswith(("['scale']", "['var']")):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.randn(*s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _images(seed, n=1):
    return np.random.RandomState(seed).rand(n, SIZE, SIZE, 3).astype(
        np.float32)


def _graph_nodes(program):
    return [n for gm in program.graph_module.modules()
            if isinstance(gm, torch.fx.GraphModule)
            for n in gm.graph.nodes if n.op == "call_function"]


def test_detector_pt2_matches_jax_stablehlo(tmp_path):
    v = _seeded_variables(31)
    jpath = jex.export_detector(JModel(spec=MICRO_SPEC), v,
                                str(tmp_path / "det.stablehlo"), imgsz=SIZE,
                                spec=MICRO_SPEC)
    model = api.load_detector(spec=MICRO_SPEC, device="cpu", state_dict=(
        yolo_from_flax(v["params"], v["batch_stats"], MICRO_SPEC))).model
    path = ex.export_detector(model, str(tmp_path / "det.pt2"), imgsz=SIZE,
                              spec=MICRO_SPEC)
    x = _images(3)
    want = np.asarray(jex.load_stablehlo(jpath).call(jnp.asarray(x)))
    with torch.no_grad():
        got = ex.load_program(path).module()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_variables_file_loads_into_flax(tmp_path):
    """The port's ``variables`` file (its own seeded weights) through JAX's
    ``convert_yolo_state_dict``: JAX's decoded output equals the port's."""
    model = api.load_detector(spec=MICRO_SPEC, seed=4, device="cpu").model
    path = ex.save_variables(model, str(tmp_path / "det.vars.pt"))
    sd = {k: v.numpy() for k, v in ex.load_variables(path).items()}
    params, stats = convert_yolo_state_dict(sd)
    x = _images(5, n=2)
    want = jdecode(JModel(spec=MICRO_SPEC).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        train=False), MICRO_SPEC)
    with torch.no_grad():
        got = decode_predictions(model(torch.from_numpy(x)), MICRO_SPEC)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_rollout_with_denoise_exports_one_nlm_node_a_step(tmp_path):
    """A 2-step rollout over (exposure, denoise), the agent biased to pick
    denoise: exported, saved and reloaded, it holds one ``nlm_gray`` node a
    step and none of the plain chain's rolls, and equals the eager
    rollout."""
    cfg = Config(filters=("exposure", "denoise"), filters_runtime=(1.7, 2.0))
    sd = api.load_adaptive_isp(None, cfg, SIZE, device="cpu").agent \
        .state_dict()
    sd["fc2.bias"] = sd["fc2.bias"] + torch.tensor([0.0, 8.0])
    agent = api.load_adaptive_isp(None, cfg, SIZE, 2, device="cpu",
                                  state_dict=sd).agent
    path = ex.export_adaptive_isp(cfg, agent, str(tmp_path / "isp.pt2"),
                                  imgsz=SIZE, steps=2, batch=2)
    program = ex.load_program(path)
    targets = [str(n.target) for n in _graph_nodes(program)]
    assert targets.count(NLM_OP) == 2
    assert not any("roll" in t for t in targets)
    rng = np.random.RandomState(6)
    x = torch.from_numpy(_images(7, n=2))
    z = torch.from_numpy(rng.randn(2, 2, cfg.z_dim).astype(np.float32))
    s = torch.zeros(2, cfg.num_state_dim)
    with torch.no_grad():
        got = program.module()(x, z, s)
    want = rollout(agent, x, z, s, no_pipeline(2))
    assert want.selected.tolist() == [[1, 1], [1, 1]]
    for g, w in zip(got, (want.image, want.states, want.selected)):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)


@pytest.fixture()
def spec_yaml(tmp_path):
    p = tmp_path / "micro.yaml"
    p.write_text(yaml.dump(MICRO_SPEC))
    return str(p)


def test_cli_pt2_variables_validate_and_tf_skipped(spec_yaml, tmp_path,
                                                   capsys):
    out = tmp_path / "exp"
    rc = export_cli.main([
        "--cpu", "--model", "detector", "--spec", spec_yaml, "--imgsz",
        str(SIZE), "--include", "pt2", "variables", "saved_model", "tflite",
        "--half", "--validate", "--out", str(out)])
    assert rc == 0
    assert (out / "detector.pt2").is_file()
    assert (out / "detector.vars.pt").is_file()
    text = capsys.readouterr().out
    assert "skipping ['saved_model', 'tflite', 'tflite-fp16']" in text
    assert "max|d|=0.00e+00" in text and "export complete" in text
    for fn in (export_tf.export_saved_model, export_tf.export_tflite):
        with pytest.raises(NotImplementedError, match="pt2"):
            fn(None, (), str(tmp_path / "x"))


def test_cli_per_format_isolation(spec_yaml, tmp_path, capsys, monkeypatch):
    """A format that fails leaves the others exported (the reference
    isolates formats the same way, export.py:617-660)."""
    def broken(*a, **k):
        raise RuntimeError("export broke")

    monkeypatch.setattr(ex, "export_detector", broken)
    out = tmp_path / "exp"
    rc = export_cli.main([
        "--cpu", "--spec", spec_yaml, "--imgsz", str(SIZE), "--include",
        "pt2", "variables", "--out", str(out)])
    assert rc == 1
    assert (out / "detector.vars.pt").is_file()
    assert not (out / "detector.pt2").exists()
    text = capsys.readouterr().out
    assert "FAIL" in text and "export broke" in text
    assert "export had failures" in text
