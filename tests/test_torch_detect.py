"""The port's detector, decode and NMS against the JAX package.

Full YOLOv3 (Darknet-53 + 3-level head) and YOLOv3-tiny with the same flax
weights on both sides: the flax tree is seeded numpy over the shapes the JAX
model declares (``jax.eval_shape`` of its init), carried across with
``convert.yolo_from_flax``.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptiveisp_tpu.detect import boxes as jboxes
from adaptiveisp_tpu.detect import model as jmodel
from adaptiveisp_tpu.detect.convert import convert_yolo_state_dict
from adaptiveisp_tpu.detect.nms import non_max_suppression as jnms
from adaptiveisp_tpu_torch.convert import yolo_from_flax
from adaptiveisp_tpu_torch.detect import boxes as tboxes
from adaptiveisp_tpu_torch.detect import model as tmodel
from adaptiveisp_tpu_torch.detect.nms import non_max_suppression
from adaptiveisp_tpu_torch.detect.spec import YOLOV3_SPEC, YOLOV3_TINY_SPEC
from test_torch_nlm import cheap_xla, one_torch_thread  # noqa: F401


def flax_yolo_variables(spec, seed):
    """Seeded flax variables (numpy) of the JAX DetectionModel for spec."""
    model = jmodel.DetectionModel(spec=spec)
    shapes = jax.eval_shape(lambda k: model.init(
        {"params": k}, jnp.zeros((1, 64, 64, 3), jnp.float32), train=False),
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) * np.sqrt(1.0 / fan_in)).astype(
                np.float32)
        if name.endswith("['scale']") or name.endswith("['var']"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.randn(*s.shape) * 0.1).astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def yolov3():
    jm, v = flax_yolo_variables(YOLOV3_SPEC, 3)
    # the weights below replace flax's initial distributions (6 s of
    # truncated normals for 62 M parameters)
    with mock.patch.object(tmodel, "flax_init_", lambda m: m):
        port = tmodel.DetectionModel(YOLOV3_SPEC)
    port.load_state_dict(yolo_from_flax(v["params"], v["batch_stats"],
                                        YOLOV3_SPEC))
    return jm, v, port.eval()


def test_yolov3_state_dict_roundtrip_222_leaves(yolov3):
    """The port's state_dict() through convert_yolo_state_dict gives back the
    identical flax tree: 222 parameter leaves (+ BatchNorm statistics)."""
    _, v, port = yolov3
    assert len(jax.tree_util.tree_leaves(v["params"])) == 222
    sd = {k: t.numpy() for k, t in port.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    params, stats = convert_yolo_state_dict(sd)
    want = jax.tree_util.tree_flatten_with_path(
        {"p": v["params"], "s": v["batch_stats"]})[0]
    got = {jax.tree_util.keystr(k): x for k, x in
           jax.tree_util.tree_flatten_with_path({"p": params, "s": stats})[0]}
    assert len(got) == len(want)
    for k, x in want:
        np.testing.assert_array_equal(got[jax.tree_util.keystr(k)], x,
                                      err_msg=jax.tree_util.keystr(k))


def test_yolov3_head_and_decode_match_jax(yolov3):
    jm, v, port = yolov3
    x = np.random.RandomState(4).rand(2, 64, 64, 3).astype(np.float32)
    raw_j = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        v, jnp.asarray(x))
    with torch.no_grad():
        raw_t = port(torch.from_numpy(x))
    assert [tuple(r.shape) for r in raw_t] == [r.shape for r in raw_j]
    # 75 float32 conv layers in another summation order
    for r_t, r_j in zip(raw_t, raw_j):
        np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-4,
                                   atol=1e-4)
    dec_t = tmodel.decode_predictions(raw_t, YOLOV3_SPEC)
    dec_j = jmodel.decode_predictions(raw_j, YOLOV3_SPEC)
    np.testing.assert_allclose(dec_t.numpy(), np.asarray(dec_j), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("spec", [YOLOV3_SPEC, YOLOV3_TINY_SPEC],
                         ids=["yolov3", "tiny"])
def test_strides_and_anchors_match_jax(spec):
    assert tmodel.model_strides(spec) == jmodel.model_strides(spec)
    for a_t, a_j in zip(tmodel.anchors_in_grid_units(spec),
                        jmodel.anchors_in_grid_units(spec)):
        np.testing.assert_array_equal(a_t, a_j)


def test_tiny_forward_matches_jax_and_bf16_stays_close():
    jm, v = flax_yolo_variables(YOLOV3_TINY_SPEC, 5)
    sd = yolo_from_flax(v["params"], v["batch_stats"], YOLOV3_TINY_SPEC)
    port = tmodel.DetectionModel(YOLOV3_TINY_SPEC)
    port.load_state_dict(sd)
    x = np.random.RandomState(6).rand(2, 64, 64, 3).astype(np.float32)
    raw_j = jm.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        raw_t = port.eval()(torch.from_numpy(x))
        half = tmodel.DetectionModel(YOLOV3_TINY_SPEC, dtype=torch.bfloat16)
        half.load_state_dict(sd)
        raw_h = half.eval()(torch.from_numpy(x))
    for r_t, r_j, r_h in zip(raw_t, raw_j, raw_h):
        np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-4,
                                   atol=1e-4)
        assert r_h.dtype == torch.float32
        # bf16 keeps ~3 significant digits through 13 convs
        err = (r_h - r_t).abs().max() / r_t.abs().max()
        assert float(err) < 0.05, float(err)


def _decoded(seed, n=2, n_box=400, nc=80):
    """Decoded-prediction-like rows with boxes clustered around a few
    centres, so suppression has work to do."""
    rng = np.random.RandomState(seed)
    centres = rng.uniform(40, 600, (n, 6, 2))
    pick = rng.randint(0, 6, (n, n_box))
    xy = np.take_along_axis(centres, pick[..., None], 1) + rng.randn(
        n, n_box, 2) * 6
    wh = rng.uniform(20, 90, (n, n_box, 2))
    obj = rng.uniform(0, 1, (n, n_box, 1))
    cls = rng.uniform(0, 1, (n, n_box, nc)) ** 3
    return np.concatenate([xy, wh, obj, cls], -1).astype(np.float32)


_NMS_CASES = {
    "multi_label": dict(conf_thres=0.001, iou_thres=0.6, multi_label=True),
    "single_label": dict(conf_thres=0.25, iou_thres=0.45),
    "agnostic_classes": dict(conf_thres=0.1, iou_thres=0.5, agnostic=True,
                             classes=(0, 3, 5), max_det=50),
}


@pytest.mark.parametrize("case", sorted(_NMS_CASES))
def test_nms_matches_jax(case):
    kw = _NMS_CASES[case]
    pred = _decoded(11)
    det_j, n_j = jnms(jnp.asarray(pred), **kw)
    det_t, n_t = non_max_suppression(torch.from_numpy(pred), **kw)
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    assert int(n_t.min()) > 0
    det_j = np.asarray(det_j)
    np.testing.assert_allclose(det_t[..., :4].numpy(), det_j[..., :4],
                               atol=1e-4)
    np.testing.assert_allclose(det_t[..., 4].numpy(), det_j[..., 4],
                               atol=1e-6)
    np.testing.assert_array_equal(det_t[..., 5].numpy(), det_j[..., 5])


def test_nms_ties_go_to_the_lower_index():
    """Equal scores on boxes that never overlap keep the lower candidate
    index first (a stable sort).  JAX's CPU top-k leaves the order of equal
    scores unspecified, so this pins the port's own rule."""
    n_box, nc = 120, 4
    gx, gy = np.meshgrid(np.arange(12) * 50.0 + 25, np.arange(10) * 50.0 + 25)
    pred = np.zeros((1, n_box, 5 + nc), np.float32)
    pred[0, :, 0], pred[0, :, 1] = gx.ravel(), gy.ravel()
    pred[0, :, 2:4] = 20.0
    rng = np.random.RandomState(13)
    pred[0, :, 4] = rng.choice([0.5, 0.75, 1.0], n_box)
    pred[0, :, 5:] = rng.choice([0.25, 0.5], (n_box, nc))
    det, n = non_max_suppression(torch.from_numpy(pred), conf_thres=0.1,
                                 max_det=30)
    conf = pred[0, :, 5:] * pred[0, :, 4:5]
    order = np.argsort(-conf.max(1), kind="stable")[:30]
    assert int(n[0]) == 30
    np.testing.assert_array_equal(det[0, :, 0].numpy(),
                                  pred[0, order, 0] - 10.0)
    np.testing.assert_array_equal(det[0, :, 5].numpy(),
                                  conf[order].argmax(1).astype(np.float32))


def test_box_utils_match_jax():
    rng = np.random.RandomState(12)
    b = np.concatenate([rng.uniform(0, 50, (7, 2)),
                        rng.uniform(1, 20, (7, 2))], 1).astype(np.float32)
    xyxy = np.array(jboxes.xywh2xyxy(jnp.asarray(b)))
    np.testing.assert_allclose(tboxes.xywh2xyxy(torch.from_numpy(b)).numpy(),
                               xyxy)
    np.testing.assert_allclose(
        tboxes.box_iou(torch.from_numpy(xyxy[:3]),
                       torch.from_numpy(xyxy)).numpy(),
        np.asarray(jboxes.box_iou(jnp.asarray(xyxy[:3]), jnp.asarray(xyxy))),
        atol=1e-6)
