"""The port's segmentation stack against the JAX package's, on the CPU.

A tiny 2-level spec at 64 px with its Segment head (``nm`` 4, ``npr`` 16,
prototypes at 16 x 16, so ``mask_ratio`` 4), batch 2, weights from seeded
NumPy over ``jax.eval_shape`` (no init compile); each JAX reference is built
once.  Tolerances:
  * ``resize`` against ``jax.image.resize`` (bilinear up, down with
    antialiasing, mixed; nearest at whole and fractional ratios), the mask
    helpers and the head's forward: 1e-5 absolute (float32 sums in another
    order); nearest, crops, contours and segments exactly;
  * NMS with mask coefficients (plain and multi-label): exactly, on
    candidates without ties;
  * the mask loss, its components and its gradients with respect to the
    predictions and the prototypes: 1e-5 relative;
  * ``SegmentDataset`` batches (letterbox, flips, ``copy_paste``): targets,
    masks and validity exactly, images to 1e-6 (each package's resize);
  * three ``SegmentTrainer`` steps from the same weights: the loss to 1e-5
    relative, kernels and BatchNorm weights to 1e-6, biases and statistics
    to 1e-4 (as ``tests/test_torch_detector_training.py`` says why), and the
    box and mask mAP of the epoch's validation within 0.01;
  * the predict CLI's polygon files exactly and its overlays to one 8-bit
    level.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from adaptiveisp_tpu.data import segment_dataset as jsd
from adaptiveisp_tpu.detect import loss as jloss
from adaptiveisp_tpu.detect import segment as jseg
from adaptiveisp_tpu.detect import train_detector as jtd
from adaptiveisp_tpu.detect.convert import convert_yolo_state_dict
from adaptiveisp_tpu.detect.model import DetectionModel as DetectionModelJ
from adaptiveisp_tpu.detect.model import anchors_in_grid_units as janchors
from adaptiveisp_tpu.detect.model import decode_predictions as jdecode
from adaptiveisp_tpu.detect.nms import non_max_suppression as jnms
from adaptiveisp_tpu.obs import plots as jplots
from adaptiveisp_tpu_torch.convert import yolo_from_flax
from adaptiveisp_tpu_torch.data import segment_dataset as sd_mod
from adaptiveisp_tpu_torch.detect import loss
from adaptiveisp_tpu_torch.detect import segment as seg
from adaptiveisp_tpu_torch.detect import train_detector as td
from adaptiveisp_tpu_torch.detect.model import (
    DetectionModel,
    anchors_in_grid_units,
    decode_predictions,
)
from adaptiveisp_tpu_torch.detect.nms import non_max_suppression
from adaptiveisp_tpu_torch.obs import plots
from test_torch_nlm import cheap_xla, one_torch_thread  # noqa: F401

SIZE, NM, NPR = 64, 4, 16
DET_SPEC = {
    "nc": 3,
    "anchors": [[10, 14, 23, 27, 37, 58], [30, 30, 50, 40, 60, 60]],
    "backbone": [
        [-1, 1, "Conv", [8, 3, 2]],
        [-1, 1, "Conv", [16, 3, 2]],
        [-1, 1, "Conv", [16, 3, 2]],   # 2: /8
        [-1, 1, "Conv", [16, 3, 2]],   # 3: /16
    ],
    "head": [[[2, 3], 1, "Detect", ["nc", "anchors"]]],
}
SPEC = seg.seg_spec_from(DET_SPEC, nm=NM, npr=NPR)
LOSS_HYP = dict(box=0.05, obj=0.7, cls=0.25)
SHAPES = [(64, 48), (48, 64), (64, 64), (40, 64), (64, 56), (56, 40)]



def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _write_set(root, n, seed, shapes=SHAPES):
    """n PNGs of varied shape, 1-3 polygon instances of classes 0-2 each."""
    rng = np.random.RandomState(seed)
    os.makedirs(f"{root}/images")
    os.makedirs(f"{root}/labels")
    for i in range(n):
        h, w = shapes[i % len(shapes)]
        im = 0.4 + rng.rand(h, w, 3) * 0.2
        rows = []
        for _ in range(1 + i % 3):
            c = rng.randint(0, 3)
            cx, cy = rng.uniform(0.3, 0.7, 2)
            k = rng.randint(3, 7)
            ang = np.sort(rng.uniform(0, 2 * np.pi, k))
            rad = rng.uniform(0.12, 0.3, k)
            pts = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)],
                           1).clip(0.01, 0.99)
            poly = [(x * w, y * h) for x, y in pts]
            pil = Image.new("L", (w, h), 0)
            ImageDraw.Draw(pil).polygon(poly, fill=1, outline=1)
            im[np.asarray(pil) > 0] = ((0.9, 0.1, 0.1), (0.1, 0.9, 0.1),
                                       (0.1, 0.1, 0.9))[c]
            rows.append(f"{c} " + " ".join(f"{v:.5f}" for v in pts.ravel())
                        + "\n")
        Image.fromarray((im * 255).astype(np.uint8)).save(
            f"{root}/images/im{i:03d}.png")
        open(f"{root}/labels/im{i:03d}.txt", "w").write("".join(rows))
    return f"{root}/images"


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """Each package reads its own copy of the same train and val files."""
    root = tmp_path_factory.mktemp("seg")
    return {who: (_write_set(root / who / "train", 6, 1),
                  _write_set(root / who / "val", 4, 2))
            for who in ("jax", "port")}


def _fill(shapes, seed=0):
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


@pytest.fixture(scope="module")
def jmodel():
    """The JAX segmentation model with seeded NumPy weights."""
    model = DetectionModelJ(spec=SPEC)
    shapes = jax.eval_shape(lambda k: model.init(
        {"params": k}, jnp.zeros((1, SIZE, SIZE, 3)), train=False),
        jax.random.PRNGKey(0))
    return model, _fill(shapes)


def _port_model(variables):
    m = DetectionModel(SPEC)
    m.load_state_dict(yolo_from_flax(variables["params"],
                                     variables["batch_stats"], SPEC))
    return m


# --------------------------------------------------------------------------- #
# resize and the mask helpers
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("method,src,dst", [
    ("bilinear", (16, 16), (64, 64)),      # the masks' whole-ratio upsample
    ("bilinear", (40, 56), (23, 31)),      # shrink: antialiased
    ("bilinear", (16, 20), (37, 9)),       # up one axis, down the other
    ("nearest", (16, 16), (64, 64)),
    ("nearest", (40, 56), (23, 90)),       # fractional ratios
])
def test_resize_matches_jax_image_resize(method, src, dst):
    x = np.random.RandomState(0).rand(3, *src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (3, *dst),
                                       method=method))
    got = seg.resize(torch.from_numpy(x), dst, method).numpy()
    if method == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_crop_mask_and_mask_iou_match_jax():
    rng = np.random.RandomState(1)
    masks = rng.rand(4, 16, 16).astype(np.float32)
    boxes = np.array([[2.0, 2.0, 6.5, 5.0], [0.0, 0.0, 16.0, 16.0],
                      [7.5, 3.2, 7.9, 15.0], [-3.0, 4.0, 9.0, 20.0]],
                     np.float32)
    np.testing.assert_array_equal(
        seg.crop_mask(torch.from_numpy(masks), torch.from_numpy(boxes)),
        np.asarray(jseg.crop_mask(jnp.asarray(masks), jnp.asarray(boxes))))
    a = (rng.rand(5, 64) > 0.5).astype(np.float32)
    b = (rng.rand(3, 64) > 0.4).astype(np.float32)
    np.testing.assert_allclose(
        seg.mask_iou(torch.from_numpy(a), torch.from_numpy(b)),
        np.asarray(jseg.mask_iou(jnp.asarray(a), jnp.asarray(b))),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("upsample", [True, False])
def test_process_mask_matches_jax(upsample):
    rng = np.random.RandomState(2)
    proto = rng.randn(16, 16, NM).astype(np.float32)
    coeffs = (rng.randn(3, NM) * 3).astype(np.float32)
    boxes = np.array([[8.0, 8.0, 40.0, 41.5], [0.0, 0.0, 64.0, 64.0],
                      [47.3, 30.0, 64.0, 63.0]], np.float32)
    args = (proto, coeffs, boxes)
    want = np.asarray(jseg.process_mask(*map(jnp.asarray, args), (64, 64),
                                        upsample=upsample, binarize=False))
    got = seg.process_mask(*map(torch.from_numpy, args), (64, 64),
                           upsample=upsample, binarize=False).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    binj = np.asarray(jseg.process_mask(*map(jnp.asarray, args), (64, 64),
                                        upsample=upsample))
    bint = seg.process_mask(*map(torch.from_numpy, args), (64, 64),
                            upsample=upsample).numpy()
    clear = np.abs(want - 0.5) > 1e-5     # away from the threshold
    np.testing.assert_array_equal(bint[clear], binj[clear])


@pytest.mark.parametrize("ratio_pad", [None, ((0.5, 0.5), (0.0, 9.5))])
def test_scale_image_matches_jax(ratio_pad):
    masks = np.random.RandomState(3).rand(64, 64, 2).astype(np.float32)
    want = jseg.scale_image((64, 64), masks, (45, 64), ratio_pad)
    got = seg.scale_image((64, 64), masks, (45, 64), ratio_pad)
    assert got.shape == want.shape == (45, 64, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_find_contours_and_segments_match_jax():
    rng = np.random.RandomState(4)
    masks = np.zeros((4, 24, 24), np.float32)
    masks[0, 3:9, 4:15] = 1
    masks[0, 12:20, 2:6] = 1                  # two components
    masks[1] = rng.rand(24, 24) > 0.6         # ragged blobs
    masks[2, 10, 10] = 1                      # a single pixel
    for strategy in ("largest", "concat"):
        want = jseg.masks_to_segments(masks, strategy)
        got = seg.masks_to_segments(masks, strategy)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for m in masks:
        for g, w in zip(seg.find_contours(m), jseg.find_contours(m)):
            np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------------------- #
# the head, NMS with coefficients, the loss
# --------------------------------------------------------------------------- #
def test_segment_head_forward_decode_and_state_dict(jmodel):
    """Segment row: (preds, proto) and the decode (mask coefficients raw)
    match JAX; the port's state_dict() through convert_yolo_state_dict is
    JAX's tree, the Proto tower included."""
    model, v = jmodel
    port = _port_model(v).eval()
    sd = {k: t.numpy() for k, t in port.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    assert any(".proto.cv3.conv.weight" in k for k in sd)
    params, stats = convert_yolo_state_dict(sd)
    want = jax.tree_util.tree_flatten_with_path(
        {"p": v["params"], "s": v["batch_stats"]})[0]
    got = {jax.tree_util.keystr(k): x for k, x in
           jax.tree_util.tree_flatten_with_path({"p": params, "s": stats})[0]}
    assert len(got) == len(want)
    for k, x in want:
        np.testing.assert_array_equal(got[jax.tree_util.keystr(k)], x)

    x = np.random.RandomState(5).rand(2, SIZE, SIZE, 3).astype(np.float32)
    pj, protoj = jax.jit(lambda v, x: model.apply(v, x, train=False))(
        v, jnp.asarray(x))
    with torch.no_grad():
        pt, protot = port(torch.from_numpy(x))
    assert protot.shape == (2, 16, 16, NM)
    np.testing.assert_allclose(protot, protoj, rtol=0, atol=1e-5)
    for a, b in zip(pt, pj):
        assert a.shape[-1] == 5 + 3 + NM
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    np.testing.assert_allclose(decode_predictions(pt, SPEC),
                               jdecode(pj, SPEC), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("multi_label", [False, True])
def test_nms_with_mask_coefficients_matches_jax(multi_label):
    rng = np.random.RandomState(6)
    n, m, nc = 2, 300, 3
    xy = rng.uniform(5, 59, (n, m, 2))
    wh = rng.uniform(4, 30, (n, m, 2))
    conf = rng.uniform(0, 1, (n, m, 1 + nc))
    coef = rng.randn(n, m, NM)
    pred = np.concatenate([xy, wh, conf, coef], -1).astype(np.float32)
    kw = dict(conf_thres=0.2, iou_thres=0.45, max_det=40,
              multi_label=multi_label)
    dj, nj, cj = jnms(jnp.asarray(pred), nm=NM, **kw)
    dt, nt, ct = non_max_suppression(torch.from_numpy(pred), nm=NM, **kw)
    assert int(nt.min()) > 5
    np.testing.assert_array_equal(nt, nj)
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(ct, cj)
    if multi_label:   # the segmentation wrapper is multi-label NMS
        d2, _, c2 = seg.non_max_suppression_seg(
            torch.from_numpy(pred), nm=NM, conf_thres=0.2, iou_thres=0.45,
            max_det=40)
        np.testing.assert_array_equal(d2, dt)
        np.testing.assert_array_equal(c2, ct)


def _loss_inputs(seed=7, n=2, t=5):
    rng = np.random.RandomState(seed)
    preds = [rng.randn(n, h, h, 3, 5 + 3 + NM).astype(np.float32)
             for h in (8, 4)]
    proto = rng.randn(n, 16, 16, NM).astype(np.float32)
    targets = np.zeros((n, t, 5), np.float32)
    targets[..., 0] = rng.randint(0, 3, (n, t))
    targets[..., 1:3] = rng.uniform(0.2, 0.8, (n, t, 2))
    targets[..., 3:5] = rng.uniform(0.1, 0.5, (n, t, 2))
    tmask = np.zeros((n, t), bool)
    tmask[0, :3] = tmask[1, :5] = True
    gt = (rng.rand(n, t, 16, 16) > 0.5).astype(np.float32)
    return preds, proto, targets, tmask, gt


def test_mask_loss_and_gradients_match_jax():
    preds, proto, targets, tmask, gt = _loss_inputs()
    anchors = janchors(SPEC)
    hyp_j, hyp_t = jloss.LossHyp(**LOSS_HYP), loss.LossHyp(**LOSS_HYP)

    def jfn(p, pr):
        total, comps = jseg.batch_seg_loss(p, pr, jnp.asarray(targets),
                                           jnp.asarray(tmask),
                                           jnp.asarray(gt), anchors, hyp_j)
        return total, comps

    (jt, jc), (jgp, jgpr) = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(
        [jnp.asarray(p) for p in preds], jnp.asarray(proto))
    pt = [torch.from_numpy(p).requires_grad_() for p in preds]
    prt = torch.from_numpy(proto).requires_grad_()
    total, comps = seg.batch_seg_loss(
        pt, prt, torch.from_numpy(targets), torch.from_numpy(tmask),
        torch.from_numpy(gt), anchors_in_grid_units(SPEC), hyp_t)
    total.backward()
    assert _rel(float(total.detach()), float(jt)) < 1e-5
    assert float(comps["seg"]) > 0
    for k in ("box", "obj", "cls", "seg"):
        assert _rel(float(comps[k]), float(jc[k])) < 1e-5, k
    for g, w in zip(pt, jgp):
        assert _rel(g.grad, w) < 1e-5
    assert _rel(prt.grad, jgpr) < 1e-5

    # one image alone is that image's term of the batch (JAX's vmap)
    totals, per = seg.seg_loss_batch(
        [torch.from_numpy(p) for p in preds], torch.from_numpy(proto),
        torch.from_numpy(targets), torch.from_numpy(tmask),
        torch.from_numpy(gt), anchors_in_grid_units(SPEC), hyp_t)
    assert _rel(float(totals.mean()) * 2, float(jt)) < 1e-5
    one_t, one_c = seg.per_image_seg_loss(
        [torch.from_numpy(p[1]) for p in preds], torch.from_numpy(proto[1]),
        torch.from_numpy(targets[1]), torch.from_numpy(tmask[1]),
        torch.from_numpy(gt[1]), anchors_in_grid_units(SPEC), hyp_t)
    assert float(one_t) == pytest.approx(float(totals[1]), rel=1e-6)
    assert float(one_c["seg"]) == pytest.approx(float(per["seg"][1]),
                                                rel=1e-6)


def test_mask_ratio_mismatch_raises():
    preds, proto, targets, tmask, gt = _loss_inputs()
    with pytest.raises(ValueError, match="prototype resolution"):
        seg.batch_seg_loss(
            [torch.from_numpy(p) for p in preds], torch.from_numpy(proto),
            torch.from_numpy(targets), torch.from_numpy(tmask),
            torch.from_numpy(gt[..., :8, :8]), anchors_in_grid_units(SPEC),
            loss.LossHyp())


# --------------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------------- #
def test_parse_polygon_labels_and_polygon2mask(sets):
    lab = sets["port"][0].replace("images", "labels") + "/im002.txt"
    got, want = sd_mod.parse_polygon_labels(lab), jsd.parse_polygon_labels(
        lab)
    assert len(got) == len(want) == 3
    for (c, p), (cj, pj) in zip(got, want):
        assert c == cj
        np.testing.assert_array_equal(p, pj)
    poly = np.array([[1.5, 2.0], [14.2, 3.3], [9.0, 15.7]], np.float32)
    np.testing.assert_array_equal(sd_mod.polygon2mask((16, 16), poly),
                                  jsd.polygon2mask((16, 16), poly))


@pytest.mark.parametrize("augment", [False, True])
def test_segment_dataset_batches_match_jax(sets, augment):
    """Two epochs of batches, with flips and copy-paste when augmenting:
    every draw in JAX's order."""
    kw = dict(img_size=SIZE, batch_size=2, augment=augment, mask_ratio=4,
              fliplr=0.5, copy_paste=0.5 if augment else 0.0, seed=3)
    dj = jsd.SegmentDataset(sets["jax"][0], **kw)
    dt = sd_mod.SegmentDataset(sets["port"][0], **kw)
    np.testing.assert_array_equal(np.concatenate(dt.labels),
                                  np.concatenate(dj.labels))
    instances = sum(len(i) for i in dt.instances)
    valid = []
    for _ in range(2):
        n = 0
        for bt, bj in zip(dt.epoch_batches(t_max=8),
                          dj.epoch_batches(t_max=8)):
            np.testing.assert_allclose(bt[0], bj[0], rtol=0, atol=1e-6)
            for a, b in zip(bt[1:], bj[1:]):
                np.testing.assert_array_equal(a, b)
            n += int(bt[2].sum())
        valid.append(n)
    # copy-paste adds instances; without it every label is one target
    assert (max(valid) > instances) if augment else valid == [instances] * 2


def test_plot_images_and_masks_matches_jax(sets, tmp_path):
    ds = sd_mod.SegmentDataset(sets["port"][0], img_size=SIZE, batch_size=4)
    ims, targets, tmask, masks = next(ds.epoch_batches(shuffle=False))
    rows = np.asarray([[i, *t] for i in range(4) for t in targets[i][tmask[i]]],
                      np.float32)
    a = plots.plot_images_and_masks(ims, rows, masks, tmask=tmask,
                                    fname=str(tmp_path / "t.png"))
    b = jplots.plot_images_and_masks(ims, rows, masks, tmask=tmask,
                                     fname=str(tmp_path / "j.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(a)),
                                  np.asarray(Image.open(b)))


# --------------------------------------------------------------------------- #
# the trainer: three steps and the epoch's box + mask validation
# --------------------------------------------------------------------------- #
TRAIN_CFG = dict(epochs=1, batch_size=2, lr0=0.05, warmup_epochs=1.0)


def _datasets(pkg, paths):
    kw = dict(img_size=SIZE, batch_size=2, mask_ratio=4)
    return (pkg.SegmentDataset(paths[0], augment=True, copy_paste=0.5,
                               seed=0, **kw),
            pkg.SegmentDataset(paths[1], augment=False, **kw))


@pytest.fixture(scope="module")
def fits(sets, jmodel, tmp_path_factory):
    model, variables = jmodel
    jtr = jseg.SegmentTrainer(model, variables, SPEC,
                              *_datasets(jsd, sets["jax"]),
                              cfg=jtd.DetTrainConfig(**TRAIN_CFG),
                              hyp=jloss.LossHyp(**LOSS_HYP), nm=NM)
    jhist = jtr.fit()
    save = str(tmp_path_factory.mktemp("segfit") / "run")
    tr = seg.SegmentTrainer(_port_model(variables), SPEC,
                            *_datasets(sd_mod, sets["port"]),
                            cfg=td.DetTrainConfig(**TRAIN_CFG),
                            hyp=loss.LossHyp(**LOSS_HYP), nm=NM,
                            save_dir=save, loggers=False, device="cpu")
    hist = tr.fit()
    return jtr, jhist, tr, hist, save


def _step_tol(key):
    return 1e-4 if key.endswith(("bias", "running_mean",
                                 "running_var")) else 1e-6


def test_segment_trainer_three_steps_match_jax(fits, jmodel):
    jtr, jhist, tr, hist, save = fits
    js = jax.device_get(jtr.state)
    assert int(js.step) == tr.state.step == 3
    assert _rel(hist[0].loss, jhist[0].loss) < 1e-5
    want = yolo_from_flax(js.params, js.batch_stats, SPEC)
    got = tr.model.state_dict()
    start = yolo_from_flax(jmodel[1]["params"], jmodel[1]["batch_stats"],
                           SPEC)
    assert max(_rel(got[k], start[k]) for k in want
               if "running" not in k) > 1e-3     # the steps moved them
    for k, v in want.items():
        if "num_batches" not in k:
            assert _rel(got[k], v) < _step_tol(k), k
    ema = yolo_from_flax(js.ema.params, js.batch_stats, SPEC)
    for k, v in tr.state.ema.params.items():
        assert _rel(v, ema[k]) < _step_tol(k), k
    assert sorted(f for f in os.listdir(save) if f.endswith(".pt")) == [
        "best.pt", "last.pt"]


def test_segment_trainer_validation_matches_jax(fits):
    """validate_segmenter's box and mask mAP after the epoch, and the flat
    per-epoch row every logging sink receives."""
    jtr, jhist, tr, hist, save = fits
    m, jm = hist[0].metrics, jhist[0].metrics
    for part in ("box", "mask"):
        for k in ("map50", "map", "precision", "recall"):
            assert abs(m[part][k] - jm[part][k]) < 0.01, (part, k)
    assert abs(hist[0].fitness - jhist[0].fitness) < 0.01
    assert hist[0].lr == pytest.approx(jhist[0].lr, abs=1e-7)
    assert (list(tr._flat_metrics(hist[0]))
            == list(jtr._flat_metrics(jhist[0])))
    with open(os.path.join(save, "results.csv")) as f:
        assert len(f.read().splitlines()) == 2


def test_validate_segmenter_matches_jax(sets, jmodel):
    """The validator on the seeded weights, each package's own val set."""
    model, v = jmodel
    _, vj = _datasets(jsd, sets["jax"])
    _, vt = _datasets(sd_mod, sets["port"])
    want = jseg.validate_segmenter(model, v, vj, SPEC, nm=NM)
    got = seg.validate_segmenter(_port_model(v), vt, SPEC, nm=NM)
    for part in ("box", "mask"):
        for k in ("map50", "map"):
            assert got[part][k] == pytest.approx(want[part][k], abs=1e-6)
    assert got["fitness"] == pytest.approx(want["fitness"], abs=1e-6)


# --------------------------------------------------------------------------- #
# the CLIs
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def spec_and_weights(jmodel, tmp_path_factory):
    """The base spec as YAML and a JAX-style checkpoint pickle."""
    import pickle

    import yaml

    root = tmp_path_factory.mktemp("segcli")
    spec_path = root / "tiny.yaml"
    spec_path.write_text(yaml.safe_dump(DET_SPEC))
    wpath = root / "w.pkl"
    with open(wpath, "wb") as f:
        pickle.dump({"model": jax.device_get(jmodel[1])}, f)
    return str(spec_path), str(wpath)


def test_segment_predict_cli_files_match_jax(spec_and_weights, tmp_path,
                                             monkeypatch):
    """Square frames: a letterbox border is constant, so its cells score
    exactly alike and NMS would keep a tie-break's pick.  JAX's
    ``create_detector`` is an eager init whose variables the weights file
    replaces: skipped."""
    from adaptiveisp_tpu.detect import model as jmodel_mod

    monkeypatch.setattr(jmodel_mod, "create_detector", lambda key, spec=None,
                        nc=None, imgsz=256, dtype=None: (
        jmodel_mod.DetectionModel(spec=spec, nc=nc, dtype=dtype), None))
    spec_path, wpath = spec_and_weights
    src = _write_set(tmp_path / "src", 2, 5, shapes=[(SIZE, SIZE)])
    argv = ["--source", src, "--spec", spec_path, "--nm", str(NM),
            "--npr", str(NPR), "--imgsz", str(SIZE), "--weights", wpath,
            "--conf_thres", "0.3", "--save_txt"]
    jseg.main(argv + ["--save_dir", str(tmp_path / "j")])
    out = seg.main(argv + ["--save_dir", str(tmp_path / "t"),
                           "--device", "cpu"])
    assert len(out) == 2 and sum(len(r["det"]) for r in out) > 3
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t"))
    assert any(n.endswith(".txt") for n in names)
    for n in names:
        a, b = tmp_path / "t" / n, tmp_path / "j" / n
        if n.endswith(".txt"):
            assert a.read_text() == b.read_text(), n
        else:
            d = np.abs(np.asarray(Image.open(a), np.int16)
                       - np.asarray(Image.open(b), np.int16))
            assert d.max() <= 1, n


def test_segment_train_cli(sets, spec_and_weights, jmodel, tmp_path,
                           monkeypatch):
    """One epoch of ``train`` on the CPU writes the run's files (TensorBoard
    made unimportable: here it imports TensorFlow), and ``--validate-only``
    on the JAX checkpoint gives ``validate_segmenter``'s metrics on those
    weights, which ``test_validate_segmenter_matches_jax`` holds to JAX's."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    spec_path, wpath = spec_and_weights
    common = ["--spec", spec_path, "--nm", str(NM), "--npr", str(NPR),
              "--imgsz", str(SIZE), "--batch-size", "2"]
    hist = seg.train_main(["--data", sets["port"][0], "--val-data",
                           sets["port"][1], "--epochs", "1", "--save-dir",
                           str(tmp_path / "run"), "--device", "cpu"]
                          + common)
    assert len(hist) == 1 and np.isfinite(hist[0].loss)
    files = set(os.listdir(tmp_path / "run"))
    assert {"best.pt", "last.pt", "opt.yaml", "hyp.yaml",
            "results.csv"} <= files
    got = seg.train_main(["--data", sets["port"][1], "--validate-only",
                          "--weights", wpath, "--device", "cpu"] + common)
    _, vt = _datasets(sd_mod, sets["port"])
    want = seg.validate_segmenter(_port_model(jmodel[1]), vt, SPEC, nm=NM)
    for part in ("box", "mask"):
        assert got[part]["map"] == want[part]["map"]
    # the port's own checkpoint reads back into --validate-only
    again = seg.train_main(["--data", sets["port"][1], "--validate-only",
                            "--weights", str(tmp_path / "run" / "last.pt"),
                            "--device", "cpu"] + common)
    assert np.isfinite(again["fitness"])
