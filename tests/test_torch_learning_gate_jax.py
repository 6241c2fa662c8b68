"""The learning gate's parts against JAX's arc, from the same weights
(marked slow; CPU).

``tests/test_torch_learning_gate.py`` trains its detector from the port's
own seed.  This file takes JAX's detector instead (``_pretrain_detector`` of
``tests/test_rl_learning_gate.py``, 110 epochs) and holds the port's
evaluation and fixed-pipeline machinery against JAX's on it: bright mAP,
degraded raw mAP, and the optimised fixed pipeline's loss and mAP, each
within 0.01.  Then the port's ``DetectorTrainer`` runs from JAX's initial
detector weights beside JAX's, and the largest relative weight difference
is printed after 1, 2, 5, 10, 20 and 40 epochs; over the first 10 epochs
(60 steps) it stays under 1e-3.  Finally the port's trained detector's
fixed pipeline is printed beside JAX's.  Numbers print with ``-s``:

    python -m pytest -p no:cacheprovider -m slow \\
        tests/test_torch_learning_gate_jax.py -s
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_rl_learning_gate as J
import test_torch_learning_gate as P
from adaptiveisp_tpu.config import Config as JConfig
from adaptiveisp_tpu.data.datasets import ISPDataset as JISPDataset
from adaptiveisp_tpu.data.datasets import collate as jcollate
from adaptiveisp_tpu.data.detector_dataset import AugHyp as JAugHyp
from adaptiveisp_tpu.data.detector_dataset import (
    DetectorDataset as JDetectorDataset,
)
from adaptiveisp_tpu.detect.loss import LossHyp as JLossHyp
from adaptiveisp_tpu.detect.loss import pad_targets as jpad_targets
from adaptiveisp_tpu.detect.model import anchors_in_grid_units as janchors
from adaptiveisp_tpu.detect.model import create_detector
from adaptiveisp_tpu.detect.train_detector import (
    DetTrainConfig as JDetTrainConfig,
)
from adaptiveisp_tpu.detect.train_loop import DetectorTrainer as JTrainer
from adaptiveisp_tpu.detect.train_loop import (
    validate_detector as jvalidate_detector,
)
from adaptiveisp_tpu.train.fixed_pipeline import (
    optimize_fixed_pipeline as joptimize,
)
from adaptiveisp_tpu_torch.config import Config
from adaptiveisp_tpu_torch.convert import yolo_from_flax
from adaptiveisp_tpu_torch.data.datasets import ISPDataset, collate
from adaptiveisp_tpu_torch.data.detector_dataset import (
    AugHyp,
    DetectorDataset,
)
from adaptiveisp_tpu_torch.detect.loss import LossHyp, pad_targets
from adaptiveisp_tpu_torch.detect.model import (
    DetectionModel,
    anchors_in_grid_units,
)
from adaptiveisp_tpu_torch.detect.train_detector import DetTrainConfig
from adaptiveisp_tpu_torch.detect.train_loop import (
    DetectorTrainer,
    validate_detector,
)
from adaptiveisp_tpu_torch.train.fixed_pipeline import (
    optimize_fixed_pipeline,
)

CFG_KW = dict(replay_memory_size=32, print_freq=200, summary_freq=10**9,
              val_freq=10**9, save_model_freq=10**9)
AUG = dict(mosaic=0.0, mixup=0.0, fliplr=0.5, hsv_h=0.01, hsv_s=0.2,
           hsv_v=0.2, translate=0.05, scale=0.2)
HYP = dict(box=0.05, obj=0.7, cls=0.25)
TRAIN = dict(epochs=110, batch_size=8, lr0=0.01, warmup_epochs=1.0)
DRIFT_EPOCHS = (1, 2, 5, 10, 20, 40)


def _batches(ds, coll, pad, to):
    """The gate's fixed-pipeline batches (train set, RandomState(0))."""
    order = np.random.RandomState(0).permutation(len(ds))
    out = []
    for s in range(0, len(order) - 7, 8):
        b = coll([ds[i] for i in order[s:s + 8]])
        t, m = pad(b["label"], 8)
        out.append(tuple(to(a) for a in (b["im"], t, m)))
    return out


def _port_detector(sd):
    m = DetectionModel(J.SPEC)
    m.load_state_dict(sd)
    return m.eval().requires_grad_(False)


def _port_fixed(det, root):
    cfg = Config(**CFG_KW)
    train = ISPDataset(f"{root}/images/train", img_size=J.SIZE,
                       source="raw", train=True, brightness_range=J.BRI)
    val = ISPDataset(f"{root}/images/val", img_size=J.SIZE, source="raw",
                     train=False, brightness_range=J.BRI)
    stages, _, hist = optimize_fixed_pipeline(
        cfg, P.FIVE_STAGES, det, anchors_in_grid_units(J.SPEC),
        _batches(train, collate, pad_targets, torch.from_numpy),
        hyp=LossHyp(**HYP), lr=3e-2, steps=250, verbose=False)
    return ([hist[0], min(hist)], P._map_plain_images(det, val),
            P._map_plain_images(det, val, render_stages=stages, cfg=cfg))


@pytest.fixture(scope="module")
def arc(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gate_jax"))
    J._build_data(root)
    res = {}
    jmodel, jvars, _ = J._pretrain_detector(root)
    jvars = jax.device_get(jvars)
    jvds = JDetectorDataset(f"{root}/images/val", img_size=J.SIZE,
                            batch_size=8, augment=False, nc=2)
    vds = DetectorDataset(f"{root}/images/val", img_size=J.SIZE,
                          batch_size=8, augment=False, nc=2)
    det = _port_detector(yolo_from_flax(jvars["params"],
                                        jvars["batch_stats"], J.SPEC))
    res["bright"] = (jvalidate_detector(jmodel, jvars, jvds,
                                        J.SPEC)["map50"],
                     validate_detector(det, vds, J.SPEC)["map50"])

    jcfg = JConfig(**CFG_KW)
    jtrain = JISPDataset(f"{root}/images/train", img_size=J.SIZE,
                         source="raw", train=True, brightness_range=J.BRI)
    jval = JISPDataset(f"{root}/images/val", img_size=J.SIZE, source="raw",
                       train=False, brightness_range=J.BRI)
    jstages, _, jhist = joptimize(
        jcfg, P.FIVE_STAGES, jmodel, jvars, janchors(J.SPEC),
        _batches(jtrain, jcollate, jpad_targets, jnp.asarray),
        hyp=JLossHyp(**HYP), lr=3e-2, steps=250, verbose=False)
    jraw = J._map_plain_images(jmodel, jvars, jval)
    jfixed = J._map_plain_images(jmodel, jvars, jval, render_stages=jstages,
                                 cfg=jcfg)
    loss, raw, fixed = _port_fixed(det, root)
    res["fixed_loss"] = ([jhist[0], min(jhist)], loss)
    res["raw"], res["fixed"] = (jraw, raw), (jfixed, fixed)

    # the port's detector training beside JAX's, from JAX's initial weights
    model, v0 = create_detector(jax.random.PRNGKey(0), spec=J.SPEC,
                                imgsz=J.SIZE)
    jtr = JTrainer(model, v0, J.SPEC, JDetectorDataset(
        f"{root}/images/train", img_size=J.SIZE, batch_size=8, augment=True,
        nc=2, seed=0, hyp=JAugHyp(**AUG)), None,
        cfg=JDetTrainConfig(**TRAIN), hyp=JLossHyp(**HYP), loggers=False)
    v0 = jax.device_get(v0)
    tr = DetectorTrainer(
        _port_detector(yolo_from_flax(v0["params"], v0["batch_stats"],
                                      J.SPEC)).requires_grad_(True),
        J.SPEC, DetectorDataset(f"{root}/images/train", img_size=J.SIZE,
                                batch_size=8, augment=True, nc=2, seed=0,
                                hyp=AugHyp(**AUG)),
        vds, cfg=DetTrainConfig(**TRAIN), hyp=LossHyp(**HYP),
        loggers=False, device="cpu")
    res["drift"], done = [], 0
    for total in DRIFT_EPOCHS + (TRAIN["epochs"],):
        for e in range(done, total):
            jl, pl = jtr.train_epoch(e), tr.train_epoch(e)
        done = total
        s = jax.device_get(jtr.state)
        want = yolo_from_flax(s.params, s.batch_stats, J.SPEC)
        got = tr.model.state_dict()
        res["drift"].append({
            "epochs": total, "steps": total * 6, "loss": [jl, pl],
            "max_rel": max(float((got[k] - v).abs().max()
                                 / (v.abs().max() + 1e-12))
                           for k, v in want.items()
                           if "num_batches" not in k)})
    port_det = _port_detector(tr.ema_state_dict())
    res["port_trained"] = {
        "bright": validate_detector(port_det, vds, J.SPEC)["map50"]}
    (res["port_trained"]["fixed_loss"], res["port_trained"]["raw"],
     res["port_trained"]["fixed"]) = _port_fixed(port_det, root)
    print("\nLEARNING GATE, JAX AGAINST PORT:", json.dumps(res))
    return res


@pytest.mark.slow
def test_evaluation_and_fixed_pipeline_match_jax_on_its_detector(arc):
    for key in ("bright", "raw", "fixed"):
        jv, pv = arc[key]
        assert abs(jv - pv) < 0.01, (key, jv, pv)
    (j0, jn), (p0, pn) = arc["fixed_loss"]
    assert abs(j0 - p0) < 0.01 and abs(jn - pn) < 0.01


@pytest.mark.slow
def test_detector_training_tracks_jax_from_its_weights(arc):
    early = [d for d in arc["drift"] if d["epochs"] <= 10]
    assert early and max(d["max_rel"] for d in early) < 1e-3
    for d in early:
        assert abs(d["loss"][0] - d["loss"][1]) < 1e-4 * abs(d["loss"][0])
