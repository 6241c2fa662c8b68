"""Fresh networks of the port start from the JAX package's initial
distributions.

The JAX package declares no initializer, so flax's defaults hold: every
``nn.Conv`` / ``nn.Dense`` kernel lecun_normal (a normal truncated at two
standard deviations, rescaled to variance 1 / fan_in) and every bias zero.
For the agent (``Config()``), the critic, YOLOv3-tiny and a zoo spec
(C3TR's attention, MetaAconC), built by JAX's ``create_*`` functions (under
``jax.jit``, at a small image size) and by the port's constructors: every
weight with at least 2048 entries has std * sqrt(fan_in) in [0.95, 1.05]
and max |w| * sqrt(fan_in) <= 2 / 0.8796 (the truncation), every conv and
linear bias is zero, and BatchNorm starts at scale 1 and bias 0.
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn as nn

import adaptiveisp_tpu.policy.agent as jagent_mod
from adaptiveisp_tpu.config import Config as JConfig
from adaptiveisp_tpu.detect.model import create_detector
from adaptiveisp_tpu.policy.agent import create_agent_state
from adaptiveisp_tpu.policy.value import create_value_state
from adaptiveisp_tpu_torch.config import Config
from adaptiveisp_tpu_torch.detect.activations import MetaAconC
from adaptiveisp_tpu_torch.detect.layers import MultiheadAttention
from adaptiveisp_tpu_torch.detect.model import DetectionModel
from adaptiveisp_tpu_torch.detect.spec import YOLOV3_TINY_SPEC
from adaptiveisp_tpu_torch.policy.agent import Agent
from adaptiveisp_tpu_torch.policy.value import Value
from test_torch_nlm import cheap_xla, one_torch_thread  # noqa: F401

MIN_ENTRIES = 2048
STD_RANGE = (0.95, 1.05)
MAX_SCALED = 2.0 / 0.87962566103423978 + 1e-3
ZOO_SPEC = {
    "nc": 4, "anchors": [[10, 14, 23, 27, 37, 58]], "activation": "meta_aconc",
    "backbone": [[-1, 1, "Conv", [32, 3, 2]],
                 [-1, 1, "Conv", [64, 3, 2]],
                 [-1, 1, "C3TR", [128]]],
    "head": [[[2], 1, "Detect", ["nc", "anchors"]]],
}
NETS = ["agent", "value", "yolov3-tiny", "zoo"]


def _jax(name, key):
    cfg = JConfig()
    if name == "agent":
        return create_agent_state(cfg, key, image_size=16)[1]
    if name == "value":
        return create_value_state(cfg, key, image_size=16)[1]
    spec = YOLOV3_TINY_SPEC if name == "yolov3-tiny" else ZOO_SPEC
    return create_detector(key, spec=spec, imgsz=32)[1]


def _port(name):
    torch.manual_seed(3)
    if name == "agent":
        return Agent(Config())
    if name == "value":
        return Value(Config())
    return DetectionModel(YOLOV3_TINY_SPEC if name == "yolov3-tiny"
                          else ZOO_SPEC)


@pytest.fixture(scope="module")
def jax_params():
    """JAX's variables; the agent's init traces its forward, whose render
    holds no parameters: it is replaced by the identity while tracing
    (only the cost changes)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jagent_mod.bank, "render_blend",
                   lambda cfg, x, *a, **k: x)
        return {name: jax.jit(lambda k, n=name: _jax(n, k))(
            jax.random.PRNGKey(i)) for i, name in enumerate(NETS)}


def _check_kernel(label, w, fan_in):
    w = np.asarray(w, np.float64)
    scaled = np.sqrt(fan_in)
    assert STD_RANGE[0] <= w.std() * scaled <= STD_RANGE[1], (
        label, w.std() * scaled)
    assert np.abs(w).max() * scaled <= MAX_SCALED, label


@pytest.mark.parametrize("name", NETS)
def test_jax_initial_distributions(jax_params, name):
    """The reference: flax's defaults in the JAX package's networks."""
    checked = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            jax_params[name]["params"]):
        key, a = jax.tree_util.keystr(path), np.asarray(leaf)
        if key.endswith("['kernel']") and a.size >= MIN_ENTRIES:
            _check_kernel(key, a, np.prod(a.shape[:-1]))
            checked += 1
        elif key.endswith("['bias']"):
            assert not a.any(), key
        elif key.endswith("['scale']"):
            assert (a == 1).all(), key
    assert checked > 0


@pytest.mark.parametrize("name", NETS)
def test_port_initial_distributions(name):
    """The port's constructors draw the same distributions: lecun_normal
    kernels (the attention's joint in-projection too), zero biases,
    BatchNorm at 1 / 0, MetaAconC's p1 / p2 normal(1)."""
    model = _port(name)
    checked = 0
    for mname, m in model.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            if m.weight.numel() >= MIN_ENTRIES:
                _check_kernel(mname, m.weight.detach(), m.weight[0].numel())
                checked += 1
            if m.bias is not None:
                assert not m.bias.any(), mname
        elif isinstance(m, nn.BatchNorm2d):
            assert (m.weight == 1).all() and not m.bias.any(), mname
        elif isinstance(m, MultiheadAttention):
            w = m.in_proj_weight.detach()
            _check_kernel(mname, w, w.shape[1])
            assert not m.in_proj_bias.any()
            checked += 1
        elif isinstance(m, MetaAconC):
            p = torch.cat([m.p1.flatten(), m.p2.flatten()]).detach()
            assert 0.8 < float(p.std()) < 1.2, mname
    assert checked > 0
