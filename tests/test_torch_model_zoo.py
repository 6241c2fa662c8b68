"""The port's detection layer zoo and named specs against the JAX package.

Every spec of ``named_specs()`` builds in the port with JAX's parameter
count (JAX's through ``jax.eval_shape``, the port's on the meta device).
Small specs that hold every new layer and activation, and ``yolov5n``, run
at 64 px with JAX's weights carried over by ``yolo_from_flax`` (seeded
numpy over ``jax.eval_shape``, non-trivial BatchNorm statistics): the raw
head outputs agree within 1e-4.  The port's ``state_dict()`` goes back
through JAX's ``convert_yolo_state_dict`` into the same flax tree and the
same outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptiveisp_tpu.detect.convert import convert_yolo_state_dict
from adaptiveisp_tpu.detect.layers import contract as jcontract
from adaptiveisp_tpu.detect.layers import expand as jexpand
from adaptiveisp_tpu.detect.model import DetectionModel as JDetectionModel
from adaptiveisp_tpu.detect.model import decode_predictions as jdecode
from adaptiveisp_tpu.detect.model import (
    initialize_detect_biases as j_init_biases,
)
from adaptiveisp_tpu.detect.model import model_strides as jstrides
from adaptiveisp_tpu.detect.spec import named_specs as j_named_specs
from adaptiveisp_tpu_torch.convert import yolo_from_flax
from adaptiveisp_tpu_torch.detect.layers import contract, expand
from adaptiveisp_tpu_torch.detect.model import (
    DetectionModel,
    decode_predictions,
    initialize_detect_biases,
    model_strides,
)
from adaptiveisp_tpu_torch.detect.spec import load_spec, named_specs
from torch_suite import cheap_xla, one_torch_thread  # noqa: F401

IMG = 64
ATOL = 1e-4
ANCHORS2 = [[10, 14, 23, 27, 37, 58], [81, 82, 135, 169, 344, 319]]

# Focus stem, C3, C3x, BottleneckCSP, SPPF, Upsample, Concat, 2 levels
CSP_SPEC = {
    "nc": 3, "depth_multiple": 0.67, "width_multiple": 0.25,
    "anchors": ANCHORS2,
    "backbone": [
        [-1, 1, "Focus", [32, 3]],
        [-1, 1, "Conv", [64, 3, 2]],
        [-1, 3, "C3", [64]],
        [-1, 1, "Conv", [64, 3, 2]],
        [-1, 2, "C3x", [64]],
        [-1, 1, "BottleneckCSP", [64]],
        [-1, 1, "SPPF", [64, 5]],
    ],
    "head": [
        [-1, 1, "Conv", [64, 3, 2]],
        [-1, 1, "Upsample", [None, 2, "nearest"]],
        [[-1, 6], 1, "Concat", [1]],
        [-1, 2, "C3", [64, False]],
        [[10, 7], 1, "Detect", ["nc", "anchors"]],
    ],
}
# the Ghost family, DWConv, CrossConv, C3SPP, SPP, Contract / Expand
GHOST_SPEC = {
    "nc": 2, "anchors": ANCHORS2, "activation": "hardswish",
    "backbone": [
        [-1, 1, "Conv", [8, 3, 2]],
        [-1, 1, "GhostConv", [16, 3, 2]],
        [-1, 1, "C3Ghost", [16]],
        [-1, 1, "GhostBottleneck", [16, 3, 2]],
        [-1, 2, "DWConv", [16, 3, 1]],
        [-1, 1, "CrossConv", [16, 3, 1, 1, 1.0, True]],
        [-1, 1, "C3SPP", [16, [3, 5]]],
        [-1, 1, "Contract", [2]],
        [-1, 1, "SPP", [32, [3, 5]]],
        [-1, 1, "Expand", [2]],
    ],
    "head": [
        [-1, 1, "Conv", [16, 3, 2]],
        [[9, 10], 1, "Detect", ["nc", "anchors"]],
    ],
}
# C3TR (the transformer) under mish
TR_SPEC = {
    "nc": 2, "anchors": ANCHORS2, "activation": "mish",
    "backbone": [
        [-1, 1, "Conv", [8, 3, 2]],
        [-1, 1, "Conv", [16, 3, 2]],
        [-1, 1, "Conv", [16, 3, 2]],
        [-1, 2, "C3TR", [16]],
        [-1, 1, "Conv", [32, 3, 2]],
    ],
    "head": [
        [-1, 1, "Conv", [32, 3, 2]],
        [[4, 5], 1, "Detect", ["nc", "anchors"]],
    ],
}


def act_spec(act):
    return {"nc": 2, "anchors": ANCHORS2[:1], "activation": act,
            "backbone": [[-1, 1, "Conv", [8, 3, 2]],
                         [-1, 1, "Conv", [16, 3, 2]],
                         [-1, 1, "Conv", [16, 3, 2]]],
            "head": [[[2], 1, "Detect", ["nc", "anchors"]]]}


ACTS = ["silu", "hardswish", "mish", "leaky_relu", "relu", "relu6",
        "hardsigmoid", "identity", "frelu", "aconc", "meta_aconc"]
PARAM_ACTS = {"frelu", "aconc", "meta_aconc"}


def _seeded(spec, seed, img=IMG):
    """Seeded numpy flax variables over the shapes ``init`` declares:
    kernels normal with variance 1 / fan-in, BatchNorm scales in [0.5,
    1.5], statistics in [0.5, 1.5], other parameters normal, scale 0.1."""
    model = JDetectionModel(spec=spec)
    shapes = jax.eval_shape(lambda k: model.init(
        {"params": k}, jnp.zeros((1, img, img, 3)), train=False),
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name.endswith("['scale']"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.randn(*s.shape) * 0.1).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes["params"])
    stats = jax.tree_util.tree_map(
        lambda s: rng.uniform(0.5, 1.5, s.shape).astype(np.float32),
        shapes.get("batch_stats", {}))
    return model, {"params": params, "batch_stats": stats}


def _image(seed=0, n=2):
    return np.random.RandomState(seed).rand(n, IMG, IMG, 3).astype(np.float32)


def _port(spec, variables):
    m = DetectionModel(spec)
    m.load_state_dict(yolo_from_flax(variables["params"],
                                     variables["batch_stats"], spec))
    return m.eval()


def _compare(spec, seed):
    jmodel, variables = _seeded(spec, seed)
    x = _image(seed)
    apply = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))
    want = apply(variables, jnp.asarray(x))
    port = _port(spec, variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)
    return apply, variables, port, x, got


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("name", sorted(j_named_specs()))
def test_named_spec_parameter_count(name):
    """Every spec of JAX's ``named_specs()`` is in the port's, builds, and
    has JAX's parameter count and strides."""
    spec = named_specs()[name]
    assert spec == j_named_specs()[name]
    shapes = jax.eval_shape(lambda k: JDetectionModel(spec=spec).init(
        {"params": k}, jnp.zeros((1, 128, 128, 3)), train=False),
        jax.random.PRNGKey(0))
    want = sum(int(np.prod(s.shape))
               for s in jax.tree_util.tree_leaves(shapes["params"]))
    with torch.device("meta"):
        model = DetectionModel(spec)
    assert sum(p.numel() for p in model.parameters()) == want
    assert model_strides(spec) == jstrides(spec)


@pytest.mark.parametrize("spec", [CSP_SPEC, GHOST_SPEC, TR_SPEC],
                         ids=["csp", "ghost", "transformer"])
def test_zoo_forward_and_round_trip(spec):
    """Raw head outputs against JAX's with JAX's weights; the port's
    ``state_dict()`` through JAX's ``convert_yolo_state_dict`` gives back
    the same flax tree and, run in JAX, the port's outputs; decoding
    agrees."""
    apply, variables, port, x, got = _compare(spec, 3)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    params, stats = convert_yolo_state_dict(sd)
    assert _flat(params).keys() == _flat(variables["params"]).keys()
    for k, v in _flat(params).items():
        np.testing.assert_array_equal(v, _flat(variables["params"])[k])
    for k, v in _flat(stats).items():
        np.testing.assert_array_equal(v, _flat(variables["batch_stats"])[k])
    back = apply({"params": params, "batch_stats": stats}, jnp.asarray(x))
    for g, w in zip(got, back):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)
    np.testing.assert_allclose(
        decode_predictions(got, spec).numpy(),
        np.asarray(jdecode(back, spec)), atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("act", ACTS)
def test_activation_forward(act):
    """Each activation of the zoo as the spec-level override, parameterized
    ones with their own parameters carried across."""
    _, variables, port, _, _ = _compare(act_spec(act), 5)
    has_act = any("['act']" in k for k in _flat(variables["params"]))
    assert has_act == (act in PARAM_ACTS)


def test_yolov5n_forward():
    """The smallest named YOLOv5 (C3, SPPF, the 6x6 stem, width 0.25,
    depth 0.33) at 64 px."""
    _compare(named_specs()["yolov5n"], 7)


def test_contract_expand_match_jax():
    x = np.random.RandomState(1).rand(2, 8, 6, 12).astype(np.float32)
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    c = contract(t, 2)
    np.testing.assert_array_equal(c.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jcontract(jnp.asarray(x), 2)))
    e = expand(t, 2)
    np.testing.assert_array_equal(e.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jexpand(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(expand(c, 2).numpy(), t.numpy())


def test_initialize_detect_biases_matches_jax():
    """The focal prior on the Detect biases, with and without class
    frequencies, on the port's state_dict as JAX's on its tree."""
    spec = named_specs()["yolov5n"]
    _, variables = _seeded(spec, 9)
    sd = yolo_from_flax(variables["params"], variables["batch_stats"], spec)
    det = len(spec["backbone"]) + len(spec["head"]) - 1
    cf = np.arange(1, 81, dtype=np.float64)
    for kw in ({}, {"cf": cf}):
        got = initialize_detect_biases(sd, spec, imgsz=320, **kw)
        want = j_init_biases(variables, spec, imgsz=320, **kw)
        for lvl in range(3):
            np.testing.assert_allclose(
                got[f"model.{det}.m.{lvl}.bias"].numpy(),
                np.asarray(want["params"][f"l{det}"][f"m{lvl}"]["bias"]),
                rtol=0, atol=1e-6)
    assert not torch.equal(got[f"model.{det}.m.0.bias"],
                           sd[f"model.{det}.m.0.bias"])


def test_load_spec_yaml_aliases(tmp_path):
    """A YAML in ultralytics' spellings (``nn.Upsample``, an ``activation``
    expression, ``anchors: 3``) loads to the JAX loader's dict."""
    from adaptiveisp_tpu.detect.spec import load_spec as j_load_spec

    text = """
nc: 4
activation: nn.LeakyReLU(0.1)
anchors: 3
backbone:
  - [-1, 1, Conv, [16, 3, 2]]
  - [-1, 1, Conv, [32, 3, 2]]
head:
  - [-1, 1, nn.Upsample, [None, 2, nearest]]
  - [[-1, 0], 1, Concat, [1]]
  - [[1, 3], 1, Detect, [nc, anchors]]
"""
    p = tmp_path / "m.yaml"
    p.write_text(text)
    got = load_spec(str(p))
    assert got == j_load_spec(str(p))
    assert got["activation"] == "leaky_relu"
    assert got["head"][0][2] == "Upsample" and len(got["anchors"]) == 2
    with torch.device("meta"):
        DetectionModel(got)
