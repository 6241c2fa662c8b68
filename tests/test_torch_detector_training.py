"""The port's detector training against the JAX package's, on the CPU.

The learning gate's tiny 2-level ``SPEC`` at 64 px, inputs from seeded
NumPy, one JAX reference of each kind built once per module (its
``DetectorTrainer`` compiles its step once; the 3-step and 2-epoch checks
share it).  Tolerances:
  * train-mode BatchNorm (the repaired layer): outputs and running
    statistics to 1e-5 relative; ``nn.BatchNorm2d``'s unbiased running
    variance misses by 3e-3 at these sizes;
  * ``batch_loss`` and its gradient with respect to the predictions: 1e-5
    relative;
  * augmentations and ``DetectorDataset`` batches (mosaic, mixup, rect,
    RAM and disk caches): labels exactly, images to 1e-6 (the resize
    library of each package);
  * autoanchor, hyp mutation, parent selection, evolution: exactly;
  * the warmup optimizer's lr and momentum per step: 1e-7; its parameters
    after 110 updates of seeded gradients: 1e-6 relative;
  * three train steps from the same weights: the loss to 1e-5 relative,
    conv kernels and BatchNorm weights (parameters and EMA) to 1e-6, biases
    and BatchNorm statistics to 1e-4.  Those are float32 sums over every
    position of the batch (8 x 32 x 32 at the first layer): the batch mean
    and variance, and the bias gradients, whose cancelling terms magnify
    the summation order's error (XLA's order is not ATen's), then scaled
    by the warmup bias lr 0.1.  Measured: loss 1.4e-6, kernels 1.6e-7,
    biases and statistics up to 4.2e-5, after the first step already 2.3e-5;
  * a 2-epoch ``fit`` (each package's own datasets): losses 1e-4 relative,
    lr 1e-7, mAP within 0.01.
Then the port alone: the checkpoint resumed bit for bit, ``strip_optimizer``,
and the CLI for one epoch on a toy hyp YAML with ``--device cpu``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from adaptiveisp_tpu.data import augment as jaug
from adaptiveisp_tpu.data import datasets as jdatasets
from adaptiveisp_tpu.data import detector_dataset as jdd
from adaptiveisp_tpu.detect import autoanchor as janchor
from adaptiveisp_tpu.detect import hyp as jhyp
from adaptiveisp_tpu.detect import loss as jloss
from adaptiveisp_tpu.detect import train_detector as jtd
from adaptiveisp_tpu.detect import train_loop as jtl
from adaptiveisp_tpu.detect.model import DetectionModel as DetectionModelJ
from adaptiveisp_tpu_torch.convert import yolo_from_flax
from adaptiveisp_tpu_torch.data import augment as aug
from adaptiveisp_tpu_torch.data import datasets
from adaptiveisp_tpu_torch.data import detector_dataset as dd
from adaptiveisp_tpu_torch.detect import autoanchor
from adaptiveisp_tpu_torch.detect import hyp
from adaptiveisp_tpu_torch.detect import loss
from adaptiveisp_tpu_torch.detect import train_detector as td
from adaptiveisp_tpu_torch.detect import train_loop as tl
from adaptiveisp_tpu_torch.detect.model import DetectionModel
from test_torch_nlm import cheap_xla, one_torch_thread  # noqa: F401

SIZE = 64
SPEC = {   # tests/test_rl_learning_gate.py's
    "nc": 2,
    "anchors": [[20, 20, 30, 30, 40, 40], [24, 36, 36, 24, 48, 48]],
    "backbone": [
        [-1, 1, "Conv", [8, 3, 2]],
        [-1, 1, "Conv", [16, 3, 2]],
        [-1, 1, "Conv", [32, 3, 2]],
        [-1, 1, "Conv", [32, 3, 2]],
    ],
    "head": [[[2, 3], 1, "Detect", ["nc", "anchors"]]],
}
LOSS_HYP = dict(box=0.05, obj=0.7, cls=0.25)
SHAPES = [(64, 48), (48, 64), (64, 64), (40, 64), (64, 56), (56, 40)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _write_set(root, n, seed):
    """n PNGs of varied shape, 1-3 boxes of classes 0/1 each."""
    rng = np.random.RandomState(seed)
    os.makedirs(f"{root}/images")
    os.makedirs(f"{root}/labels")
    for i in range(n):
        h, w = SHAPES[i % len(SHAPES)]
        im = 0.5 + rng.rand(h, w, 3) * 0.3
        rows = []
        for _ in range(1 + i % 3):
            bw, bh = rng.randint(10, 30, 2)
            x0, y0 = rng.randint(0, w - bw), rng.randint(0, h - bh)
            c = rng.randint(0, 2)
            im[y0:y0 + bh, x0:x0 + bw] = (0.9, 0.1, 0.1) if c else (0.1,
                                                                     0.2, 0.9)
            rows.append(f"{c} {(x0 + bw / 2) / w:.5f} {(y0 + bh / 2) / h:.5f}"
                        f" {bw / w:.5f} {bh / h:.5f}\n")
        Image.fromarray((im * 255).astype(np.uint8)).save(
            f"{root}/images/im{i:03d}.png")
        open(f"{root}/labels/im{i:03d}.txt", "w").write("".join(rows))
    return f"{root}/images"


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """Each package reads its own copy of the same train and val files."""
    root = tmp_path_factory.mktemp("det")
    out = {}
    for who in ("jax", "port"):
        out[who] = (_write_set(root / who / "train", 16, 1),
                    _write_set(root / who / "val", 8, 2))
    return out


@pytest.fixture(scope="module")
def jmodel():
    """The JAX detector with seeded NumPy weights over ``jax.eval_shape``
    (no init compile): kernels at fan-in scale, BN scales in [0.5, 1.5],
    other parameters and the statistics' means normal with scale 0.1,
    variances in [0.5, 1.5]."""
    model = DetectionModelJ(spec=SPEC)
    shapes = jax.eval_shape(lambda k: model.init(
        {"params": k}, jnp.zeros((1, SIZE, SIZE, 3)), train=False),
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name.endswith(("['scale']", "['var']")):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.randn(*s.shape) * 0.1).astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(fill, shapes)


def _port_model(variables):
    m = DetectionModel(SPEC)
    m.load_state_dict(yolo_from_flax(variables["params"],
                                     variables["batch_stats"], SPEC))
    return m


def _as_sd(params, batch_stats):
    return yolo_from_flax(params, batch_stats, SPEC)


# --------------------------------------------------------------------------- #
def test_bn_train_forward_matches_flax(jmodel):
    """The repaired layer: one train-mode forward of the tiny detector at
    batch 2 (4 x 4 cells at the last level, so the unbiased variance is
    32/31 of the biased one)."""
    model, variables = jmodel
    x = np.random.RandomState(3).rand(2, SIZE, SIZE, 3).astype(np.float32)
    want, mut = model.apply(variables, jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
    port = _port_model(variables).train()
    got = port(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert _rel(g.detach(), w) < 1e-5
    sd = port.state_dict()
    new = _as_sd(variables["params"], mut["batch_stats"])
    for k, v in new.items():
        if "running" in k:
            assert _rel(sd[k], v) < 1e-5, k


@pytest.mark.parametrize("nl", [2, 3])
def test_batch_loss_and_input_gradient(nl):
    rng = np.random.RandomState(nl)
    n, na, no, t = 3, 3, 7, 6
    shapes = [(8, 8), (4, 4), (2, 2)][:nl]
    preds = [rng.randn(n, h, w, na, no).astype(np.float32) for h, w in shapes]
    targets = np.zeros((n, t, 5), np.float32)
    targets[..., 0] = rng.randint(0, 2, (n, t))
    targets[..., 1:3] = rng.uniform(0.1, 0.9, (n, t, 2))
    targets[..., 3:5] = rng.uniform(0.05, 0.6, (n, t, 2))
    tmask = rng.rand(n, t) < 0.7
    tmask[1] = False   # an image without boxes
    anchors = [np.asarray(a, np.float32) / s for a, s in zip(
        [[[1.2, 1.6], [2.0, 3.7], [4.1, 2.9]]] * nl, (1, 2, 4))]
    hyp_kw = dict(LOSS_HYP, label_smoothing=0.1)

    def jfn(ps):
        return jloss.batch_loss(ps, jnp.asarray(targets), jnp.asarray(tmask),
                                anchors, jloss.LossHyp(**hyp_kw))

    (jtotal, jcomps), jgrads = jax.jit(jax.value_and_grad(
        jfn, has_aux=True))([jnp.asarray(p) for p in preds])
    tp = [torch.tensor(p, requires_grad=True) for p in preds]
    total, comps = loss.batch_loss(tp, torch.from_numpy(targets),
                                   torch.from_numpy(tmask), anchors,
                                   loss.LossHyp(**hyp_kw))
    total.backward()
    assert _rel(total.detach(), jtotal) < 1e-5
    assert _rel(comps, jcomps) < 1e-5
    for g, w in zip(tp, jgrads):
        assert _rel(g.grad, w) < 1e-5


# --------------------------------------------------------------------------- #
def _labels(rng, n, w, h):
    xy = rng.uniform(0.2, 0.8, (n, 2)) * [w, h]
    wh = rng.uniform(8, 20, (n, 2))
    return np.concatenate([rng.randint(0, 2, (n, 1)), xy - wh / 2,
                           xy + wh / 2], 1).astype(np.float32)


def test_augment_functions_match_jax():
    rng = np.random.RandomState(0)
    im = rng.rand(48, 64, 3).astype(np.float32)
    im2 = rng.rand(48, 64, 3).astype(np.float32)
    lb = _labels(rng, 4, 64, 48)
    same = lambda f, g, *a, **k: (f(*a, np.random.RandomState(5), **k),
                                  g(*a, np.random.RandomState(5), **k))
    got, want = same(aug.augment_hsv, jaug.augment_hsv, im, hgain=0.1,
                     sgain=0.6, vgain=0.4)
    assert np.abs(got - want).max() == 0
    (gi, gl), (wi, wl) = same(aug.mixup, jaug.mixup, im, lb, im2, lb[:2])
    assert np.array_equal(gi, wi) and np.array_equal(gl, wl)
    for flip in ("flip_lr", "flip_ud"):
        xywhn = np.array([[1, 0.3, 0.4, 0.1, 0.2]], np.float32)
        g, w = getattr(aug, flip)(im, xywhn), getattr(jaug, flip)(im, xywhn)
        assert all(np.array_equal(a, b) for a, b in zip(g, w))
    assert np.array_equal(aug.box_candidates(lb[:, 1:].T, lb[:, 1:].T * 0.9),
                          jaug.box_candidates(lb[:, 1:].T,
                                              lb[:, 1:].T * 0.9))
    assert np.array_equal(aug.bbox_ioa(lb[0, 1:], lb[:, 1:]),
                          jaug.bbox_ioa(lb[0, 1:], lb[:, 1:]))
    m = np.array([[1.1, 0.2, -3.0], [0.1, 0.9, 4.0], [1e-4, -2e-4, 1.0]])
    assert np.abs(aug.warp_image(im, m, 40, 70)
                  - jaug.warp_image(im, m, 40, 70)).max() < 1e-6
    kw = dict(degrees=10, translate=0.1, scale=0.3, shear=5,
              perspective=1e-4, border=(-8, -8))
    (gi, gl), (wi, wl) = same(aug.random_perspective,
                              jaug.random_perspective, im, lb.copy(), **kw)
    assert np.abs(gi - wi).max() < 1e-6 and np.array_equal(gl, wl)
    extra = dict(p_blur=1, p_median=1, p_gray=1, p_clahe=1)
    g = aug.ExtraAugment(**extra)(im, np.random.RandomState(1))
    w = jaug.ExtraAugment(**extra)(im, np.random.RandomState(1))
    assert np.abs(g - w).max() < 1e-6
    segs = [np.array([[x1, y1], [x2, y1], [x2, y2], [x1, y2]], np.float32)
            for _, x1, y1, x2, y2 in lb]
    gi, gl, gs = aug.copy_paste(im, lb.copy(), list(segs), 1.0,
                                np.random.RandomState(5))
    wi, wl, ws = jaug.copy_paste(im, lb.copy(), list(segs), 1.0,
                                 np.random.RandomState(5))
    assert np.array_equal(gi, wi) and np.array_equal(gl, wl)
    assert len(gs) == len(ws) > len(segs)
    order, shapes = aug.rect_batch_shapes(
        np.array(SHAPES, np.float64)[:, ::-1], 4, 64)
    jorder, jshapes = jaug.rect_batch_shapes(
        np.array(SHAPES, np.float64)[:, ::-1], 4, 64)
    assert np.array_equal(order, jorder) and np.array_equal(shapes, jshapes)
    hyp9 = jdd.AugHyp(degrees=5, shear=2)
    srcs = [rng.rand(*SHAPES[i % 6], 3).astype(np.float32) for i in range(9)]
    labs = [np.array([[i % 2, 0.5, 0.5, 0.3, 0.4]], np.float32)
            for i in range(9)]
    load = lambda i: (srcs[i], srcs[i].shape[:2])
    for name in ("mosaic4", "mosaic9"):
        (gi, gl), (wi, wl) = same(getattr(aug, name), getattr(jaug, name),
                                  load, labs.__getitem__, list(range(9)), 64,
                                  hyp=hyp9)
        assert np.abs(gi - wi).max() < 1e-6 and np.array_equal(gl, wl)


CASES = {
    "mosaic_mixup": dict(augment=True, hyp=dict(mosaic=1.0, mosaic9=0.5,
                                                mixup=0.5, degrees=5,
                                                flipud=0.5)),
    "rect": dict(augment=True, rect=True, batch_size=4),
    "val_rect_ram": dict(augment=False, rect=True, cache="ram"),
    "disk": dict(augment=True, cache="disk", single_cls=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_detector_dataset_batches_match_jax(sets, case):
    kw = dict(CASES[case])
    h = kw.pop("hyp", {})
    kw.setdefault("batch_size", 8)
    got = dd.DetectorDataset(sets["port"][0], img_size=SIZE, seed=3, nc=2,
                             hyp=dd.AugHyp(**h), **kw)
    want = jdd.DetectorDataset(sets["jax"][0], img_size=SIZE, seed=3, nc=2,
                               hyp=jdd.AugHyp(**h), **kw)
    for _ in range(2):   # two epochs: the random stream carries over
        for g, w in zip(got.epoch_batches(t_max=16),
                        want.epoch_batches(t_max=16)):
            assert np.abs(g[0] - w[0]).max() < 1e-6
            assert np.array_equal(g[1], w[1]) and np.array_equal(g[2], w[2])
    if kw.get("cache") == "disk":
        assert all(os.path.isfile(p) for p in got.cache._disk)
    # a host's shard: JAX's strided slice (whole batches round robin
    # with rect); its first batch
    g, w = (next(ds.epoch_batches(t_max=16, shard_rank=1, shard_count=2))
            for ds in (got, want))
    assert np.abs(g[0] - w[0]).max() < 1e-6
    assert np.array_equal(g[1], w[1]) and np.array_equal(g[2], w[2])


@pytest.mark.parametrize("mode", ["ram", "disk"])
def test_isp_dataset_cache_matches_jax(sets, mode):
    kw = dict(img_size=48, source="raw", brightness_range=(0.1, 1.0),
              train=True, seed=4)
    got = datasets.ISPDataset(sets["port"][1], cache_images=mode, **kw)
    want = jdatasets.ISPDataset(sets["jax"][1], cache_images=mode, **kw)
    plain = datasets.ISPDataset(sets["port"][1], **kw)
    for idx in ([0, 3, 5], [7, 7, 1]):
        g, w, p = got.get_batch(idx), want.get_batch(idx), plain.get_batch(idx)
        assert np.abs(g["im"] - w["im"]).max() < 1e-6
        assert np.array_equal(g["im"], p["im"])
        assert all(np.array_equal(a, b) for a, b in zip(g["label"],
                                                         w["label"]))
    if mode == "disk":
        cdir = os.path.join(sets["port"][1], ".adaptiveisp_im_cache")
        assert len(os.listdir(cdir)) == len(got.im_files)


def test_autoanchor_matches_jax():
    rng = np.random.RandomState(0)
    wh = np.exp(rng.randn(200, 2) * 0.5 + 3.0)
    anchors = np.array([[10, 13], [16, 30], [33, 23], [30, 61], [62, 45],
                        [59, 119]], np.float64)
    assert autoanchor.anchor_metric(wh, anchors) == janchor.anchor_metric(
        wh, anchors)
    lv = [anchors[3:], anchors[:3]]
    assert all(np.array_equal(a, b) for a, b in zip(
        autoanchor.check_anchor_order(lv, [8, 16]),
        janchor.check_anchor_order(lv, [8, 16])))
    assert np.array_equal(autoanchor.kmean_anchors(wh, n=6, iters=20),
                          janchor.kmean_anchors(wh, n=6, iters=20))
    got = autoanchor.check_anchors(wh, anchors * 4)
    want = janchor.check_anchors(wh, anchors * 4)
    assert got[1:] == want[1:] and got[2] and np.array_equal(got[0], want[0])
    labels = [np.array([[0, .5, .5, .1, .1], [1, .2, .2, .1, .1]]),
              np.zeros((0, 5)), np.array([[1, .5, .5, .2, .2]])]
    cw = autoanchor.labels_to_class_weights(labels, 3)
    assert np.array_equal(cw, janchor.labels_to_class_weights(labels, 3))
    assert np.array_equal(autoanchor.labels_to_image_weights(labels, 3, cw),
                          janchor.labels_to_image_weights(labels, 3, cw))


# --------------------------------------------------------------------------- #
def _find_hparams(state, out=None):
    """Every inject_hyperparams state in an optax state, in tree order."""
    out = [] if out is None else out
    if hasattr(state, "hyperparams") and hasattr(state, "inner_state"):
        out.append(state.hyperparams)
        return out
    if isinstance(state, dict):
        for k in sorted(state):
            _find_hparams(state[k], out)
    elif isinstance(state, (tuple, list)):
        for s in state:
            _find_hparams(s, out)
    elif hasattr(state, "inner_states"):
        _find_hparams(dict(state.inner_states), out)
    elif hasattr(state, "inner_state"):
        _find_hparams(state.inner_state, out)
    return out


OPT_CASES = {
    "sgd_cos": dict(),
    "sgd_linear_freeze": dict(cos_lr=False, freeze=(0, 2)),
    "adam_cos": dict(optimizer="Adam"),
    "adamw_linear": dict(optimizer="AdamW", cos_lr=False),
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_warmup_optimizer_matches_optax(jmodel, case):
    """lr and momentum of each group at each of 110 updates (warmup of
    max(round(0.5 * 30), 100) = 100 updates, then lf), and the parameters
    after them, from the same seeded gradients."""
    _, variables = jmodel
    cfg_kw = dict(epochs=4, lr0=0.02, warmup_epochs=0.5, **OPT_CASES[case])
    spe, steps = 30, 110
    tx, _ = jtl.make_warmup_optimizer(jtd.DetTrainConfig(**cfg_kw), spe)
    params = variables["params"]
    ostate = tx.init(params)
    update = jax.jit(tx.update)
    factory, _ = tl.make_warmup_optimizer(td.DetTrainConfig(**cfg_kw), spe)
    model = _port_model(variables)
    opt = factory(model)
    named = dict(model.named_parameters())
    rng = np.random.RandomState(0)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    groups = {"bias": "bias", "kernel": "kernel", "norm": "norm"}
    for t in range(steps):
        grads = jax.tree_util.tree_unflatten(treedef, [
            rng.randn(*np.shape(x)).astype(np.float32) * 0.1
            for x in leaves])
        upd, ostate = update(grads, ostate, params)
        params = optax.apply_updates(params, upd)
        gsd = _as_sd(grads, variables["batch_stats"])
        for k, p in named.items():
            p.grad = gsd[k].clone()
        opt.step()
        # optax's group order: bias, kernel, norm (sorted keys)
        hps = _find_hparams(ostate)
        for name, hp in zip(sorted(groups), hps):
            lr_fn, mom_fn = opt.schedules[name]
            assert abs(float(lr_fn(t)) - float(hp["learning_rate"])) < 1e-7
            if "momentum" in hp:
                assert abs(float(mom_fn(t)) - float(hp["momentum"])) < 1e-7
    want = _as_sd(params, variables["batch_stats"])
    start = _as_sd(variables["params"], variables["batch_stats"])
    for k, p in named.items():
        assert _rel(p.detach(), want[k]) < 1e-6, k
        if OPT_CASES[case].get("freeze") and k.startswith(("model.0.",
                                                            "model.2.")):
            assert torch.equal(p.detach(), start[k])


def test_plain_optimizer_ema_and_fusion_match_jax(jmodel):
    """``make_detector_optimizer`` (Nesterov SGD, decay on kernels, cosine
    lr with warmup) over 12 updates of seeded gradients, ``one_cycle``,
    the EMA's ramped decay, and ``fuse_conv_bn`` (HWIO against OIHW)."""
    _, variables = jmodel
    cfg_kw = dict(epochs=3, lr0=0.05, warmup_epochs=0.5)
    tx, jlr = jtd.make_detector_optimizer(jtd.DetTrainConfig(**cfg_kw), 4)
    factory, lr = td.make_detector_optimizer(td.DetTrainConfig(**cfg_kw), 4)
    params = variables["params"]
    ostate, update = tx.init(params), jax.jit(tx.update)
    ema = jtd.ema_init(params)
    model = _port_model(variables)
    opt, pema = factory(model), td.ModelEMA(model, tau=3.0)
    named = dict(model.named_parameters())
    rng = np.random.RandomState(1)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    for t in range(12):
        assert abs(float(lr(t)) - float(jlr(t))) < 1e-7
        grads = jax.tree_util.tree_unflatten(treedef, [
            rng.randn(*np.shape(x)).astype(np.float32) for x in leaves])
        upd, ostate = update(grads, ostate, params)
        params = optax.apply_updates(params, upd)
        ema = jtd.ema_update(ema, params, tau=3.0)
        gsd = _as_sd(grads, variables["batch_stats"])
        for k, p in named.items():
            p.grad = gsd[k].clone()
        opt.step()
        pema.update(model)
    want = _as_sd(params, variables["batch_stats"])
    want_ema = _as_sd(ema.params, variables["batch_stats"])
    for k, p in named.items():
        assert _rel(p.detach(), want[k]) < 1e-6, k
        assert _rel(pema.params[k], want_ema[k]) < 1e-6, k
    f, jf = td.one_cycle(1.0, 0.1, 30), jtd.one_cycle(1.0, 0.1, 30)
    assert [f(x) for x in range(31)] == [jf(x) for x in range(31)]
    bn = variables["batch_stats"]["l1"]["bn"]
    pk = variables["params"]["l1"]
    w, b = td.fuse_conv_bn(*(torch.from_numpy(np.asarray(a)) for a in (
        np.transpose(pk["conv"]["kernel"], (3, 2, 0, 1)), pk["bn"]["scale"],
        pk["bn"]["bias"], bn["mean"], bn["var"])))
    jw, jb = jtd.fuse_conv_bn(pk["conv"]["kernel"], pk["bn"]["scale"],
                              pk["bn"]["bias"], bn["mean"], bn["var"])
    assert _rel(w, np.transpose(np.asarray(jw), (3, 2, 0, 1))) < 1e-6
    assert _rel(b, jb) < 1e-6


# --------------------------------------------------------------------------- #
TRAIN_CFG = dict(epochs=2, batch_size=8, lr0=0.05, warmup_epochs=1.0)


@pytest.fixture(scope="module")
def jax_runs(sets, jmodel):
    """The JAX trainer: 3 steps on fixed batches from its start, then (from
    the same start) a 2-epoch fit on its own datasets."""
    model, variables = jmodel
    tds = jdd.DetectorDataset(sets["jax"][0], img_size=SIZE, batch_size=8,
                              augment=True, nc=2, seed=0)
    vds = jdd.DetectorDataset(sets["jax"][1], img_size=SIZE, batch_size=8,
                              augment=False, nc=2)
    tr = jtl.DetectorTrainer(model, variables, SPEC, tds, vds,
                             cfg=jtd.DetTrainConfig(**TRAIN_CFG),
                             hyp=jloss.LossHyp(**LOSS_HYP), loggers=False)
    start = tr.state
    feed = jdd.DetectorDataset(sets["jax"][0], img_size=SIZE, batch_size=8,
                               augment=True, nc=2, seed=7)
    batches = [*feed.epoch_batches(t_max=16),
               next(feed.epoch_batches(t_max=16))]   # 2 + 1 of 2 epochs
    state, losses = start, []
    for b in batches:
        state, out = tr.step_fn(state, *(jnp.asarray(a) for a in b))
        losses.append(float(out["loss"]))
    steps = dict(batches=batches, losses=losses,
                 state=jax.device_get(state))
    tr.state = start
    history = tr.fit()
    return steps, history


def _port_trainer(sets, variables, **kw):
    tds = dd.DetectorDataset(sets["port"][0], img_size=SIZE, batch_size=8,
                             augment=True, nc=2, seed=0)
    vds = dd.DetectorDataset(sets["port"][1], img_size=SIZE, batch_size=8,
                             augment=False, nc=2)
    return tl.DetectorTrainer(_port_model(variables), SPEC, tds, vds,
                              cfg=td.DetTrainConfig(**TRAIN_CFG),
                              hyp=loss.LossHyp(**LOSS_HYP), loggers=False,
                              device="cpu", **kw)


def _step_tol(key):
    """Kernels (conv and BatchNorm weights) 1e-6; biases and BatchNorm
    statistics 1e-4, as the module docstring says."""
    return 1e-4 if key.endswith(("bias", "running_mean",
                                 "running_var")) else 1e-6


def test_three_train_steps_match_jax(jax_runs, jmodel, sets):
    steps, _ = jax_runs
    tr = _port_trainer(sets, jmodel[1])
    state, losses = tr.state, []
    for b in steps["batches"]:
        state, out = tr.step_fn(state, *(torch.from_numpy(a) for a in b))
        losses.append(float(out["loss"]))
    js = steps["state"]
    assert _rel(losses, steps["losses"]) < 1e-5
    want = _as_sd(js.params, js.batch_stats)
    got = tr.model.state_dict()
    start = _as_sd(jmodel[1]["params"], jmodel[1]["batch_stats"])
    moved = max(_rel(got[k], start[k]) for k in want if "running" not in k)
    assert moved > 1e-3      # the steps moved the weights
    for k, v in want.items():
        if "num_batches" not in k:
            assert _rel(got[k], v) < _step_tol(k), k
    ema = _as_sd(js.ema.params, js.batch_stats)
    for k, v in state.ema.params.items():
        assert _rel(v, ema[k]) < _step_tol(k), k
    assert state.ema.updates == int(js.ema.updates) == 3 == state.step


@pytest.fixture(scope="module")
def port_fit(sets, jmodel, tmp_path_factory):
    save = str(tmp_path_factory.mktemp("fit") / "run")
    tr = _port_trainer(sets, jmodel[1], save_dir=save)
    return tr, tr.fit(), save


def test_fit_history_matches_jax(jax_runs, port_fit):
    _, jhist = jax_runs
    _, hist, save = port_fit
    assert [h.epoch for h in hist] == [h.epoch for h in jhist] == [0, 1]
    assert _rel([h.loss for h in hist], [h.loss for h in jhist]) < 1e-4
    for h, j in zip(hist, jhist):
        assert abs(h.lr - j.lr) < 1e-7
        assert abs(h.metrics["map50"] - j.metrics["map50"]) < 0.01
        assert abs(h.fitness - j.fitness) < 0.01
    assert sorted(f for f in os.listdir(save) if f.endswith(".pt")) == [
        "best.pt", "last.pt"]
    with open(os.path.join(save, "results.csv")) as f:
        assert len(f.read().splitlines()) == 3


def test_checkpoint_resume_is_exact(port_fit, sets, jmodel, tmp_path):
    """last.pt resumed into a fresh trainer: every tensor, the optimizer's
    state and count, the EMA, the step and the data stream equal; one more
    epoch from each equal bit for bit."""
    tr, _, save = port_fit
    ck = tl.load_detector_checkpoint(os.path.join(save, "last.pt"))
    assert {"epoch", "best_fitness", "model", "ema", "updates", "fitness",
            "opt_state", "step", "spec_anchors", "nc"} <= set(ck)
    assert ck["epoch"] == 1 and ck["step"] == tr.state.step == 4
    # the checkpoint's weights load as plain detector weights
    from adaptiveisp_tpu_torch.train_isp import load_yolo_weights

    DetectionModel(SPEC).load_state_dict(load_yolo_weights(
        os.path.join(save, "best.pt"), SPEC))
    fresh = _port_trainer(sets, jmodel[1])
    assert fresh.resume(os.path.join(save, "last.pt")) == 2
    for (k, a), b in zip(tr.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert all(torch.equal(tr.state.ema.params[k], v)
               for k, v in fresh.state.ema.params.items())
    a, b = tr.state.optimizer.state_dict(), fresh.state.optimizer.state_dict()
    assert a["count"] == b["count"] and all(
        torch.equal(x["trace"], y["trace"])
        for x, y in zip(a["state"].values(), b["state"].values()))
    # one thread: a multi-threaded CPU kernel may sum in another order
    # from run to run on a loaded host (1e-9 apart)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        la, lb = tr.train_epoch(2), fresh.train_epoch(2)
    finally:
        torch.set_num_threads(threads)
    assert la == lb
    assert all(torch.equal(x, y) for x, y in zip(
        tr.model.state_dict().values(), fresh.model.state_dict().values()))
    out = tl.strip_optimizer(os.path.join(save, "last.pt"),
                             str(tmp_path / "stripped.pt"))
    st = tl.load_detector_checkpoint(out)
    assert st["epoch"] == -1 and "opt_state" not in st and "ema" not in st
    assert torch.equal(st["model"]["model.0.conv.weight"],
                       ck["ema"]["model.0.conv.weight"])


def test_hyp_evolution_matches_jax(tmp_path):
    base = dict(hyp.DEFAULT_HYP, lr0=0.02)
    for seed in range(3):
        a = hyp.mutate_hyp(base, np.random.RandomState(seed))
        assert a == jhyp.mutate_hyp(base, np.random.RandomState(seed))
    rows = [(0.1 * i, hyp.mutate_hyp(base, np.random.RandomState(i)))
            for i in range(7)]
    assert hyp.select_parent(rows, np.random.RandomState(2)) == \
        jhyp.select_parent(rows, np.random.RandomState(2))

    def fitness(h):   # synthetic: peaks at lr0 0.03, momentum 0.9
        return float(1 - abs(h["lr0"] - 0.03) - abs(h["momentum"] - 0.9))

    got = hyp.evolve_detector(fitness, 6, str(tmp_path / "p"), base, 1,
                              plot=False)
    want = jhyp.evolve_detector(fitness, 6, str(tmp_path / "j"), base, 1,
                                plot=False)
    assert got["history"] == want["history"]
    assert got["best_hyp"] == want["best_hyp"]
    for f in ("evolve.csv", "hyp_evolve.yaml"):
        assert open(tmp_path / "p" / f).read() == open(
            tmp_path / "j" / f).read()
    # a rerun resumes from evolve.csv
    more = hyp.evolve_detector(fitness, 2, str(tmp_path / "p"), base, 1,
                               plot=False)
    assert len(more["history"]) == 8


def test_train_loop_cli_one_epoch(sets, tmp_path, monkeypatch):
    """``main`` on a toy hyp YAML with --device cpu: the run directory, a
    best.pt that loads as detector weights, --batch-size -1 off the card,
    --tp 2 (two gloo ranks, each holding half of every divisible layer)
    writing the single process's last.pt within JAX's tensor-parallel
    bound (2e-3 relative, 2e-5 absolute), resume, and --dp beyond the
    visible cards refused.  The ranks find a stub ``tensorflow`` (an
    ImportError) first on the path: TensorBoard would import TensorFlow."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    stub = tmp_path / "stub" / "tensorflow"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("raise ImportError('not here')\n")
    monkeypatch.syspath_prepend(str(stub.parent))
    hyp_yaml = tmp_path / "hyp.yaml"
    hyp_yaml.write_text("lr0: 0.02\nmosaic: 0.5\nwarmup_epochs: 0.5\n")
    save = str(tmp_path / "run")
    args = ["--data", sets["port"][0], "--val-data", sets["port"][1],
            "--spec", "yolov3-tiny", "--nc", "2", "--imgsz", "64",
            "--epochs", "1", "--hyp", str(hyp_yaml), "--device", "cpu",
            "--save-dir", save, "--cache", "ram"]
    hist = tl.main(args + ["--batch-size", "-1"])
    assert len(hist) == 1 and np.isfinite(hist[0].loss)
    assert {"best.pt", "last.pt", "opt.yaml", "hyp.yaml",
            "results.csv"} <= set(os.listdir(save))
    from adaptiveisp_tpu_torch.detect.spec import resolve_spec
    from adaptiveisp_tpu_torch.train_isp import load_yolo_weights

    spec = dict(resolve_spec("yolov3-tiny"), nc=2)
    DetectionModel(spec).load_state_dict(
        load_yolo_weights(os.path.join(save, "best.pt"), spec))
    tp_save = str(tmp_path / "run_tp")
    tp_args = [a if a != save else tp_save for a in args]
    assert tl.main(tp_args + ["--batch-size", "16", "--tp", "2"]) is None
    want, got = (torch.load(os.path.join(d, "last.pt"), weights_only=False)
                 for d in (save, tp_save))
    assert got["epoch"] == want["epoch"] == 0
    for part in ("model", "ema"):
        assert set(got[part]) == set(want[part])
        for k, v in want[part].items():
            np.testing.assert_allclose(got[part][k].numpy(), v.numpy(),
                                       rtol=2e-3, atol=2e-5,
                                       err_msg=f"{part} {k}")
    again = tl.main(args + ["--batch-size", "8", "--epochs", "2",
                            "--resume", os.path.join(save, "last.pt")])
    assert [h.epoch for h in again] == [1]
    with pytest.raises(RuntimeError, match="CUDA"):
        tl.main(args + ["--dp", "2", "--device", "cuda"])
