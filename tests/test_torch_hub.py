"""The port's inference surface against the JAX package's: ``Detector``'s
AutoShape call on mixed sources, ``Detections``' accessors, the REST server
(with and without the adaptive ISP), the NMS ensemble, the hub
constructors and the detect CLI on a folder and a short video.

One seeded detector (the 2-level mini spec, flax weights from seeded numpy
over ``jax.eval_shape``) is written as a ``.pkl`` that both packages'
``load_detector(weights=...)`` read; the agent (the 8-filter fast roster)
is a weights-only pickle both read.  Boxes agree within 1e-2 px, classes
exactly, confidences within 1e-5.
"""

import functools
import io
import json
import os
import pickle
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import adaptiveisp_tpu.config as jconfig_mod
import adaptiveisp_tpu.detect.model as jmodel_mod
import adaptiveisp_tpu.eval.rollout as jrollout_mod
from adaptiveisp_tpu import api as japi
from adaptiveisp_tpu.detect.ensemble import DetectorEnsemble as JEnsemble
from adaptiveisp_tpu.policy.agent import Agent as JAgent
from adaptiveisp_tpu.serve.rest import DetectionServer as JServer
from adaptiveisp_tpu_torch import api, detect_cli
from adaptiveisp_tpu_torch.detect.ensemble import DetectorEnsemble
from adaptiveisp_tpu_torch.detect.spec import named_specs
from adaptiveisp_tpu_torch.serve.rest import ROUTE, DetectionServer
from configs.config_fast_filters import cfg as JFAST

from adaptiveisp_tpu_torch.configs.config_fast_filters import cfg as FAST
from torch_suite import cheap_xla, one_torch_thread  # noqa: F401

SIZE = 64
BOX_ATOL, CONF_ATOL = 1e-2, 1e-5
MINI_SPEC = {
    "nc": 8,
    "anchors": [[10, 14, 23, 27, 37, 58], [81, 82, 135, 169, 344, 319]],
    "backbone": [
        [-1, 1, "Conv", [8, 3, 2]],
        [-1, 1, "Conv", [16, 3, 2]],
        [-1, 1, "Conv", [16, 3, 2]],
        [-1, 1, "Bottleneck", [16]],
        [-1, 1, "Conv", [32, 3, 2]],
    ],
    "head": [
        [-1, 1, "Conv", [32, 3, 2]],
        [[4, 5], 1, "Detect", ["nc", "anchors"]],
    ],
}
MINI_SPEC_B = {**MINI_SPEC, "backbone": MINI_SPEC["backbone"][:3] + [
    [-1, 1, "Conv", [16, 3, 1]], MINI_SPEC["backbone"][4]]}
NMS = dict(conf_thres=0.2)


def _seeded_variables(module, args, seed):
    """Seeded numpy flax variables over the shapes ``module.init`` declares:
    kernels normal with variance 1 / fan-in, BatchNorm scales and
    variances in [0.5, 1.5], other parameters normal with scale 0.1."""
    shapes = jax.eval_shape(lambda k: module.init(
        {"params": k, "dropout": k}, *args, train=False),
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name.endswith("['scale']") or name.endswith("['var']"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.randn(*s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _detector_pkl(path, spec, seed):
    v = _seeded_variables(jmodel_mod.DetectionModel(spec=spec),
                          (jnp.zeros((1, SIZE, SIZE, 3)),), seed)
    with open(path, "wb") as f:
        pickle.dump(v, f)
    return str(path)


@pytest.fixture(scope="module", autouse=True)
def _cheaper_jax():
    """JAX's loaders build their detector with ``create_detector``, an
    eager init whose variables the weights file replaces: skip that init.
    JAX's server and CLI each jit the same rollout (equal agent modules,
    5 steps): compile it once.  Only costs change, not results."""
    def build(key, spec=None, nc=None, imgsz=256, dtype=None):
        return jmodel_mod.DetectionModel(spec=spec, nc=nc, dtype=dtype), None

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmodel_mod, "create_detector", build)
        mp.setattr(jrollout_mod, "jit_rollout",
                   functools.lru_cache(jrollout_mod.jit_rollout))
        yield


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("hub")
    agent = _seeded_variables(
        JAgent(cfg=JFAST), (jnp.zeros((1, SIZE, SIZE, 3)),
                            jnp.zeros((1, JFAST.z_dim)),
                            jnp.zeros((1, JFAST.num_state_dim)), 0.0), 41)
    with open(root / "agent.pkl", "wb") as f:
        pickle.dump({"iter": 0, "agent_model": agent}, f)
    rng = np.random.RandomState(7)
    imgs = root / "images"
    imgs.mkdir()
    for i, (h, w) in enumerate([(48, 64), (64, 40), (57, 57)]):
        Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(
            imgs / f"im{i}.png")
    return {"root": root, "images": imgs,
            "det": _detector_pkl(root / "det.pkl", MINI_SPEC, 31),
            "det_b": _detector_pkl(root / "det_b.pkl", MINI_SPEC_B, 32),
            "agent": str(root / "agent.pkl")}


@pytest.fixture(scope="module")
def detectors(files):
    return (japi.load_detector(weights=files["det"], spec=MINI_SPEC),
            api.load_detector(weights=files["det"], spec=MINI_SPEC,
                              device="cpu"))


def _same_rows(got, want):
    """Detection rows [n, 6]: boxes within 1e-2 px, confidences 1e-5,
    classes exactly."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and got.shape[0] > 0
    np.testing.assert_allclose(got[:, :4], want[:, :4], atol=BOX_ATOL,
                               rtol=0)
    np.testing.assert_allclose(got[:, 4], want[:, 4], atol=CONF_ATOL, rtol=0)
    np.testing.assert_array_equal(got[:, 5], want[:, 5])


def _dict_rows(dicts):
    return np.array([[d["xmin"], d["ymin"], d["xmax"], d["ymax"],
                      d["confidence"], d["class"]] for d in dicts])


def test_autoshape_mixed_sources(detectors, files):
    """A path, a PIL image, a uint8 and a float array through
    ``Detector.__call__``: letterbox, detect, boxes in each original's
    pixels, as JAX's."""
    jdet, det = detectors
    rng = np.random.RandomState(3)
    path = str(files["images"] / "im0.png")
    sources = [path, Image.open(files["images"] / "im1.png"),
               rng.randint(0, 256, (30, 50, 3), np.uint8),
               rng.rand(40, 60, 3).astype(np.float32)]
    got = det(sources, size=SIZE, **NMS)
    want = jdet(sources, size=SIZE, **NMS)
    assert len(got) == 4 and got.paths == want.paths
    for g, w in zip(got.xyxy, want.xyxy):
        _same_rows(g, w)
    for g, w in zip(got.ims, want.ims):
        np.testing.assert_array_equal(g, w)
    assert repr(got) == repr(want)


def test_detections_accessors(detectors, files, tmp_path):
    """``to_dicts``, ``render``, ``save``, ``crop`` and ``__repr__`` on the
    same rows as JAX's Detections."""
    _, det = detectors
    res = det(str(files["images"] / "im2.png"), size=SIZE, **NMS)
    want = japi.Detections(res.ims, res.xyxy, res.names, res.paths)
    assert res.to_dicts() == want.to_dicts() and repr(res) == repr(want)
    for g, w in zip(res.render(), want.render()):
        np.testing.assert_array_equal(g, w)
    saved = res.save(str(tmp_path / "port"))
    assert [os.path.basename(p) for p in saved] == [
        os.path.basename(p) for p in want.save(str(tmp_path / "jax"))]
    crops = res.crop(str(tmp_path / "crops"))
    wcrops = want.crop()
    assert len(crops) == len(wcrops) == len(os.listdir(tmp_path / "crops"))
    for c, w in zip(crops, wcrops):
        assert c["cls"] == w["cls"] and c["conf"] == w["conf"]
        np.testing.assert_array_equal(c["im"], w["im"])


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{ROUTE}",
                                 data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _png(path):
    buf = io.BytesIO()
    Image.open(path).save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("with_isp", [False, True], ids=["plain", "isp"])
def test_rest_server_matches_jax(detectors, files, with_isp):
    """The port's server on port 0 against JAX's on the same PNG and
    weights: the same JSON (rows within the tolerances), ``/healthz``, 400
    for a body that is not an image, 404 elsewhere.  With the ISP the
    letterboxed image goes through the agent's 5-step rollout first."""
    jdet, det = detectors
    isp = jisp = None
    if with_isp:
        isp = api.load_adaptive_isp(files["agent"], cfg=FAST, device="cpu")
        jisp = japi.AdaptiveISP(JFAST, JAgent(cfg=JFAST), pickle.load(
            open(files["agent"], "rb"))["agent_model"])
    srv = DetectionServer(det, port=0, size=SIZE, conf_thres=0.2,
                          isp=isp).start()
    jsrv = JServer(jdet, port=0, size=SIZE, conf_thres=0.2,
                   isp=jisp).start()
    try:
        for name in ("im0.png", "im1.png"):
            body = _png(files["images"] / name)
            code, got = _post(srv.port, body)
            jcode, want = _post(jsrv.port, body)
            assert code == jcode == 200
            assert [d["name"] for d in got] == [d["name"] for d in want]
            _same_rows(_dict_rows(got), _dict_rows(want))
        assert _post(srv.port, b"not an image")[0] == 400
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"status": "ok"}
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/other",
                                   timeout=30)
    finally:
        srv.stop()
        jsrv.stop()


def test_ensemble_matches_jax(files):
    """Two members of different specs: candidates concatenated before one
    NMS, as JAX's ``DetectorEnsemble``."""
    weights, specs = [files["det"], files["det_b"]], [MINI_SPEC, MINI_SPEC_B]
    det = api.load_detector(weights=weights, spec=specs, device="cpu")
    jdet = japi.load_detector(weights=weights, spec=specs)
    assert isinstance(det.model, DetectorEnsemble)
    assert isinstance(jdet.model, JEnsemble)
    assert len(det.model) == 2 and det.model.stride == jdet.model.stride
    x = np.random.RandomState(4).rand(2, SIZE, SIZE, 3).astype(np.float32)
    d, n = det.detect(x, **NMS)
    jd, jn = jdet.detect(x, **NMS)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    for i in range(2):
        _same_rows(d[i, :int(n[i])].numpy(), np.asarray(jd)[i, :int(jn[i])])
    with pytest.raises(ValueError):
        api.load_detector(weights=weights, spec=specs, device="cpu",
                          augment=True)
    with pytest.raises(ValueError):
        api.load_detector(weights=weights, spec=[MINI_SPEC], device="cpu")


def test_hub_constructors_and_custom(files, monkeypatch):
    """Each hub constructor builds its named spec (classes other than 80
    override the head's width); ``custom`` loads a weights file."""
    calls = []
    monkeypatch.setattr(api, "load_detector",
                        lambda **kw: calls.append(kw) or kw)
    names = ["yolov3", "yolov3_tiny", "yolov3_spp", "yolov5n", "yolov5s",
             "yolov5m", "yolov5l", "yolov5x", "yolov5n6", "yolov5s6",
             "yolov5m6", "yolov5l6", "yolov5x6"]
    for n in names:
        kw = getattr(api, n)(classes=3)
        assert kw["spec"] == named_specs()[n.replace("_", "-")]
        assert kw["nc"] == 3 and kw["weights"] is None
    assert getattr(api, "yolov5s")()["nc"] is None
    monkeypatch.undo()
    det = api.yolov3_tiny(classes=3, device="cpu")
    assert det.model.model[-1].m[0].out_channels == 3 * 8
    custom = api.custom(files["det"], spec=MINI_SPEC, device="cpu")
    x = torch.rand(1, SIZE, SIZE, 3)
    ref = api.load_detector(weights=files["det"], spec=MINI_SPEC,
                            device="cpu")
    with torch.no_grad():
        for a, b in zip(custom.model(x), ref.model(x)):
            assert torch.equal(a, b)


def _video(path, n=3):
    import cv2

    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 5,
                         (56, 40))
    rng = np.random.RandomState(9)
    for _ in range(n):
        vw.write(rng.randint(0, 256, (40, 56, 3), np.uint8))
    vw.release()
    return str(path)


def _labels(d):
    return {f: np.loadtxt(os.path.join(d, f), ndmin=2)
            for f in sorted(os.listdir(d)) if f.endswith(".txt")}


@pytest.mark.parametrize("case", ["folder_isp", "video"])
def test_detect_cli_matches_jax(files, tmp_path, monkeypatch, case):
    """``detect_cli.main`` of both packages on a folder of PNGs with the
    agent's rollout (``--isp_weights``), and on a short video: the same
    label files (rows within the tolerances, columns x1 y1 x2 y2 conf
    cls), the same annotated images and crops saved."""
    import detect_cli as jcli

    # both CLIs build the default detector spec and Config(): point them at
    # the mini spec and the fast roster
    monkeypatch.setattr(jmodel_mod, "YOLOV3_SPEC", MINI_SPEC)
    monkeypatch.setattr(api, "YOLOV3_SPEC", MINI_SPEC)
    monkeypatch.setattr(jconfig_mod, "Config", lambda: JFAST)
    monkeypatch.setattr(detect_cli, "Config", lambda: FAST)
    monkeypatch.setattr("adaptiveisp_tpu.policy.agent.create_agent_state",
                        lambda cfg, key, **kw: (JAgent(cfg=cfg), None))
    source = (str(files["images"]) if case == "folder_isp"
              else _video(tmp_path / "clip.avi"))
    common = ["--source", source, "--weights", files["det"], "--imgsz",
              str(SIZE), "--conf_thres", "0.2", "--save_txt", "--save_img",
              "--save_crop", "--exist_ok"]
    if case == "folder_isp":
        common += ["--isp_weights", files["agent"]]
    out = detect_cli.main(common + ["--save_dir", str(tmp_path / "port"),
                                    "--device", "cpu"])
    jcli.main(common + ["--save_dir", str(tmp_path / "jax")])
    got, want = _labels(out), _labels(tmp_path / "jax")
    assert sorted(got) == sorted(want) and len(got) == 3
    for k in got:
        _same_rows(got[k], want[k])
    for sub in ("", "crops"):
        assert sorted(os.listdir(os.path.join(out, sub))) == sorted(
            os.listdir(tmp_path / "jax" / sub))


def test_feature_visualization_matches_jax(files, tmp_path):
    """``--visualize``'s maps: ``capture_features`` (forward hooks) against
    flax's ``capture_intermediates`` on the same weights and image: the
    same stage files, the saved maps within 1e-4."""
    from adaptiveisp_tpu.obs.plots import feature_visualization as jviz
    from adaptiveisp_tpu_torch.obs.plots import (
        capture_features,
        feature_visualization,
    )

    with open(files["det"], "rb") as f:
        v = pickle.load(f)
    x = np.random.RandomState(5).rand(1, SIZE, SIZE, 3).astype(np.float32)
    _, state = jmodel_mod.DetectionModel(spec=MINI_SPEC).apply(
        v, jnp.asarray(x), train=False, capture_intermediates=True,
        mutable=["intermediates"])
    det = api.load_detector(weights=files["det"], spec=MINI_SPEC,
                            device="cpu")
    got = feature_visualization(capture_features(det.model,
                                                 torch.from_numpy(x)),
                                str(tmp_path / "port"), n=8)
    want = jviz(state["intermediates"], str(tmp_path / "jax"), n=8)
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want] and len(got) == 6
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.load(g[:-4] + ".npy"),
                                   np.load(w[:-4] + ".npy"), atol=1e-4)


def test_loaders_take_jax_positional_order():
    """The loaders start with JAX's parameters in JAX's order, so JAX's
    positional calls mean the same (``imgsz`` is checked, a torch module
    needs no shape); the package root re-exports the two hub loaders."""
    import inspect

    import adaptiveisp_tpu
    import adaptiveisp_tpu_torch

    for name in ("load_adaptive_isp", "load_value", "load_detector"):
        want = list(inspect.signature(getattr(japi, name)).parameters)
        got = list(inspect.signature(getattr(api, name)).parameters)
        assert got[:len(want)] == want, (name, got, want)
    isp = api.load_adaptive_isp(None, FAST, 64, 2, 0, device="cpu")
    assert isp.steps == 2 and isp.cfg is FAST
    with pytest.raises(ValueError, match="imgsz"):
        api.load_adaptive_isp(None, FAST, 0, device="cpu")
    value = api.load_value(FAST, 64, 3, device="cpu")
    torch.testing.assert_close(
        value.state_dict(), api.load_value(FAST, seed=3,
                                           device="cpu").state_dict(),
        rtol=0, atol=0)
    for name in ("load_adaptive_isp", "load_detector"):
        assert name in adaptiveisp_tpu_torch.__all__
        assert name in adaptiveisp_tpu.__all__
    root = adaptiveisp_tpu_torch.load_adaptive_isp(None, FAST, 64, 2,
                                                   device="cpu")
    assert root.steps == 2
    det = adaptiveisp_tpu_torch.load_detector(spec=MINI_SPEC, device="cpu")
    assert isinstance(det, api.Detector)
