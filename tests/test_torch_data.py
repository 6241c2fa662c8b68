"""The port's host data layer and mAP against the JAX package.

Exactly, on the same seeded arrays: the NumPy box helpers, ``compute_ap``,
``ap_per_class``, ``process_batch``, ``ConfusionMatrix`` and ``summarize``;
the hyp split; the dataset definitions.  The same toy set of PNGs (two
sizes, so the letterbox pads both ways), in a separate copy of the files
for each package, goes through each package's ``ISPDataset`` (sources
``normalize`` and ``raw``, whose unprocess draws from the dataset's random
stream) and ``BatchFeeder``: images to 1e-6 (each package resizes with its
own build of ``csrc/preprocess.cpp``), labels exactly.  The host
``ReplayMemory`` gives the same feeds and states over three
``replace_memory`` calls, and the device pool the same slots, images,
cached losses and states over five rounds of sample and write-back.  Also the port's label cache against JAX's, its
native library against the NumPy path, the metric writer's JSONL output
(TensorBoard made unimportable) and the trajectory strip.
"""

import json
import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from adaptiveisp_tpu.config import Config as JConfig
from adaptiveisp_tpu.data import datasets as jdatasets
from adaptiveisp_tpu.data import labels as jlabels
from adaptiveisp_tpu.data.dataset_config import check_dataset as jcheck
from adaptiveisp_tpu.data.letterbox import resize_bilinear as jresize
from adaptiveisp_tpu.data.replay import ReplayMemory as JReplayMemory
from adaptiveisp_tpu.detect import boxes as jboxes
from adaptiveisp_tpu.detect import hyp as jhyp
from adaptiveisp_tpu.detect import metrics as jmetrics
from adaptiveisp_tpu.obs import logging as jlogging
from adaptiveisp_tpu.obs.visualize import trajectory_strip as jstrip
from adaptiveisp_tpu_torch.config import Config
from adaptiveisp_tpu_torch.data import datasets as tdatasets
from adaptiveisp_tpu_torch.data import labels as tlabels
from adaptiveisp_tpu_torch.data import letterbox as tletterbox
from adaptiveisp_tpu_torch.data import native
from adaptiveisp_tpu_torch.data.dataset_config import check_dataset
from adaptiveisp_tpu_torch.data.replay import ReplayMemory
from adaptiveisp_tpu_torch.data.sources import parse_image_list
from adaptiveisp_tpu_torch.detect import boxes as tboxes
from adaptiveisp_tpu_torch.detect import hyp as thyp
from adaptiveisp_tpu_torch.detect import metrics as tmetrics
from adaptiveisp_tpu_torch.obs import logging as tlogging
from adaptiveisp_tpu_torch.obs.visualize import trajectory_strip
from torch_suite import cheap_xla, one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IOUV = np.linspace(0.5, 0.95, 10)


def _boxes(rng, n, size=64.0):
    xy = rng.uniform(0, size * 0.8, (n, 2))
    wh = rng.uniform(2, size * 0.4, (n, 2))
    return np.concatenate([xy, xy + wh], 1)


def _eval_stats(seed=0, n_images=6, nc=5):
    """Per image: labels [M, 5] (cls, xyxy) and detections [N, 6] (xyxy,
    conf, cls): a jittered copy of each label, an exact copy of the first
    (IoU 1), four far boxes, one confidence tied, some classes wrong."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_images):
        m = rng.randint(1, 6)
        lab = np.concatenate([rng.randint(0, nc, (m, 1)), _boxes(rng, m)], 1)
        near = lab[:, 1:] + rng.uniform(-4, 4, (m, 4))
        far = _boxes(rng, 4)
        xyxy = np.concatenate([near, lab[:1, 1:], far], 0)
        conf = rng.uniform(0.01, 1.0, (len(xyxy), 1))
        conf[-1] = conf[0]
        cls = np.concatenate([lab[:, :1], lab[:1, :1],
                              rng.randint(0, nc, (4, 1))], 0)
        flip = rng.rand(len(cls)) < 0.2   # some wrong classes
        cls[flip] = (cls[flip] + 1) % nc
        out.append((np.concatenate([xyxy, conf, cls], 1), lab))
    return out


def test_box_helpers_match_jax():
    rng = np.random.RandomState(1)
    xywhn = rng.uniform(0.05, 0.95, (7, 4)).astype(np.float32)
    for args in ((640, 480), (640, 480, 3.0, 10.5)):
        np.testing.assert_array_equal(tboxes.xywhn2xyxy(xywhn, *args),
                                      jboxes.xywhn2xyxy(xywhn, *args))
    xyxy = _boxes(rng, 7, 80.0) - 8
    for kw in ({}, {"clip": True, "eps": 1e-3}):
        np.testing.assert_array_equal(tboxes.xyxy2xywhn(xyxy, 64, 48, **kw),
                                      jboxes.xyxy2xywhn(xyxy, 64, 48, **kw))
    b2 = _boxes(rng, 5, 80.0)
    np.testing.assert_array_equal(tboxes.box_iou_np(xyxy, b2),
                                  jboxes.box_iou_np(xyxy, b2))
    for rp in (None, ((0.5, 0.5), (3.0, 7.0))):
        np.testing.assert_array_equal(
            tboxes.scale_boxes((64, 64), xyxy, (100, 140), rp),
            jboxes.scale_boxes((64, 64), xyxy, (100, 140), rp))
    xyxy32 = xyxy.astype(np.float32)
    np.testing.assert_array_equal(
        tboxes.xyxy2xywh(torch.from_numpy(xyxy32)).numpy(),
        np.asarray(jboxes.xyxy2xywh(jnp.asarray(xyxy32))))


def test_metrics_match_jax(tmp_path):
    """process_batch, ap_per_class, compute_ap, the confusion matrix and
    summarize, each exactly; the port's summarize also draws its curves."""
    stats_t, stats_j = [], []
    cm_t, cm_j = tmetrics.ConfusionMatrix(5), jmetrics.ConfusionMatrix(5)
    for det, lab in _eval_stats():
        c_t = tmetrics.process_batch(det, lab, IOUV)
        c_j = jmetrics.process_batch(det, lab, IOUV)
        np.testing.assert_array_equal(c_t, c_j)
        assert c_t.any() and not c_t.all()
        stats_t.append((c_t, det[:, 4], det[:, 5], lab[:, 0]))
        stats_j.append((c_j, det[:, 4], det[:, 5], lab[:, 0]))
        cm_t.process_batch(det, lab)
        cm_j.process_batch(det, lab)
    cm_t.process_batch(None, lab)
    cm_j.process_batch(None, lab)
    np.testing.assert_array_equal(cm_t.matrix, cm_j.matrix)
    for a, b in zip(cm_t.tp_fp(), cm_j.tp_fp()):
        np.testing.assert_array_equal(a, b)

    cat = [np.concatenate(x, 0) for x in zip(*stats_t)]
    for a, b in zip(tmetrics.ap_per_class(*cat), jmetrics.ap_per_class(*cat)):
        np.testing.assert_array_equal(a, b)
    r = np.sort(np.random.RandomState(2).rand(20))
    p = np.random.RandomState(3).rand(20)
    for a, b in zip(tmetrics.compute_ap(r, p), jmetrics.compute_ap(r, p)):
        np.testing.assert_array_equal(a, b)

    names = {i: f"c{i}" for i in range(5)}
    got = tmetrics.summarize(stats_t, names=names, plot_dir=str(tmp_path))
    want = jmetrics.summarize(stats_j, names=names)
    assert got == want and 0 < got["map"] < got["map50"] < 1
    assert sorted(os.listdir(tmp_path)) == [
        "F1_curve.png", "PR_curve.png", "P_curve.png", "R_curve.png"]
    empty = [(np.zeros((0, 10), bool), np.zeros(0), np.zeros(0),
              np.zeros(0))]
    assert tmetrics.summarize(empty) == jmetrics.summarize(empty)


def test_hyp_split_matches_jax(tmp_path):
    path = tmp_path / "hyp.yaml"
    path.write_text("box: 0.07\ncls: 0.3\nobj: 0.8\nfl_gamma: 1.5\n")
    got, want = thyp.load_hyp(str(path)), jhyp.load_hyp(str(path))
    assert got == want
    cfg_t, loss_t, aug_t = thyp.split_hyp(got, nl=2, nc=8, imgsz=320)
    cfg_j, loss_j, aug_j = jhyp.split_hyp(want, nl=2, nc=8, imgsz=320)
    assert vars(loss_t) == vars(loss_j)
    assert vars(aug_t) == vars(aug_j)
    assert vars(cfg_t) == vars(cfg_j)
    path.write_text("boxx: 1.0\n")
    with pytest.raises(KeyError):
        thyp.load_hyp(str(path))


def test_check_dataset_matches_jax(tmp_path):
    path = tmp_path / "toy.yaml"
    path.write_text(yaml.safe_dump({
        "path": str(tmp_path), "train": "images", "val": "val.txt",
        "names": ["a", "b", "c"], "source": "normalize"}))
    got = check_dataset(str(path))
    assert got == jcheck(str(path))
    assert got["nc"] == 3 and got["train"] == str(tmp_path / "images")
    for name in ("lod", "coco", "rod"):
        assert check_dataset(name) == jcheck(name)
    with pytest.raises(FileNotFoundError):
        check_dataset(str(tmp_path / "missing.yaml"))


def _toy_set(root, n=10, seed=33, rod=False):
    """n PNGs (48x80 and 72x40, so the letterbox pads both ways) with 0 to
    3 YOLO boxes each, one image without a label file.  ``rod``: HDR .npy
    frames under raws/ instead (the ROD layout)."""
    rng = np.random.RandomState(seed)
    im_dir = root / ("raws" if rod else "images")
    im_dir.mkdir(parents=True)
    (root / "labels").mkdir()
    for i in range(n):
        h, w = (48, 80) if i % 2 else (72, 40)
        if rod:
            np.save(im_dir / f"{i}.npy",
                    (rng.rand(h, w, 3) ** 3 * 40.0).astype(np.float32))
        else:
            Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
                im_dir / f"{i}.png")
        if i == n - 1:
            continue
        k = i % 4
        rows = np.concatenate([rng.randint(0, 8, (k, 1)),
                               rng.uniform(0.3, 0.7, (k, 2)),
                               rng.uniform(0.05, 0.3, (k, 2))], 1)
        (root / "labels" / f"{i}.txt").write_text(
            "".join(" ".join(f"{v:.6f}" for v in r) + "\n" for r in rows))
    return str(im_dir)


def _same_record(a, b):
    np.testing.assert_allclose(a["im"], b["im"], rtol=0, atol=1e-6)
    assert len(a["label"]) == len(b["label"])
    for la, lb in zip(a["label"], b["label"]):
        np.testing.assert_array_equal(la, lb)
    assert [os.path.basename(p) for p in a["path"]] == \
        [os.path.basename(p) for p in b["path"]]
    assert a["shape"] == b["shape"]


@pytest.mark.parametrize("source", ["normalize", "raw", "rod"])
def test_dataset_and_feeder_match_jax(tmp_path, source):
    dir_t = _toy_set(tmp_path / "port", rod=source == "rod")
    dir_j = _toy_set(tmp_path / "jax", rod=source == "rod")
    kw = dict(img_size=64, source=source, train=True,
              brightness_range=(0.1, 0.3) if source == "raw" else None,
              add_noise=source == "raw")
    ds_t = tdatasets.ISPDataset(dir_t, **kw)
    ds_j = jdatasets.ISPDataset(dir_j, **kw)
    assert len(ds_t) == len(ds_j) == 10
    for lt, lj in zip(ds_t.labels, ds_j.labels):
        np.testing.assert_array_equal(lt, lj)
    _same_record(tdatasets.collate([ds_t[i] for i in range(4)]),
                 jdatasets.collate([ds_j[i] for i in range(4)]))
    # threaded decode, serial draws; then the prefetching feeder
    _same_record(ds_t.get_batch([5, 2, 2, 7]), ds_j.get_batch([5, 2, 2, 7]))
    f_t = tdatasets.BatchFeeder(ds_t, batch_size=4, seed=3)
    f_j = jdatasets.BatchFeeder(ds_j, batch_size=4, seed=3)
    try:
        for _ in range(4):   # 16 records: past the first epoch
            _same_record(f_t.next_batch(), f_j.next_batch())
    finally:
        f_t.stop()
        f_j.stop()


def test_label_cache_reads_across_packages(tmp_path):
    """A cache JAX wrote reads the same in the port, and the port's own
    cache round-trips."""
    im_dir = _toy_set(tmp_path)
    files = parse_image_list(im_dir)
    assert files == jlabels.parse_image_list(im_dir)
    lab_files = tlabels.img2label_paths(files)
    cache = str(tmp_path / "labels.cache")
    want = jlabels.load_labels(files, lab_files, cache)
    assert os.path.isfile(cache)
    for a, b in zip(tlabels.load_labels(files, lab_files, cache), want):
        np.testing.assert_array_equal(a, b)
    own = str(tmp_path / "own.cache")
    first = tlabels.load_labels(files, lab_files, own)
    for a, b in zip(jlabels.load_labels(files, lab_files, own), first):
        np.testing.assert_array_equal(a, b)


def test_native_library_and_numpy_path(monkeypatch):
    """The port builds csrc/preprocess.cpp for this host under
    build/native (never the committed .so), and its resize agrees with the
    NumPy path and with JAX's to 1e-6."""
    assert native.backend() == "native"
    path = native.library_path()
    assert path.exists() and path.parent.name == "native"
    assert path.parent.parent.name == "build"
    im = np.random.RandomState(4).rand(37, 53, 3).astype(np.float32)
    got = tletterbox.resize_bilinear(im, 64, 91)
    np.testing.assert_allclose(got, jresize(im, 64, 91), rtol=0, atol=1e-6)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert native.backend() == "numpy"
    np.testing.assert_allclose(tletterbox.resize_bilinear(im, 64, 91), got,
                               rtol=0, atol=1e-6)
    out, ratio, pad = tletterbox.letterbox(im, 64)
    assert out.shape == (64, 64, 3) and pad == (0.0, 9.5)


def _feeds_equal(a, b):
    np.testing.assert_allclose(a["im"], b["im"], rtol=0, atol=1e-6)
    for k in ("state", "z"):
        np.testing.assert_array_equal(a[k], b[k])
    for la, lb in zip(a["label"], b["label"]):
        np.testing.assert_array_equal(la, lb)
    assert [os.path.basename(p) for p in a["path"]] == \
        [os.path.basename(p) for p in b["path"]]


def test_host_replay_sequence_matches_jax(tmp_path):
    """Feeds, states, noise and pool statistics over three
    replace_memory calls; the states run past the length limit, so the
    over-length keep draws."""
    kw = dict(replay_memory_size=6, maximum_trajectory_length=2)
    cfg, jcfg = Config(**kw), JConfig(**kw)
    ds_t = tdatasets.ISPDataset(_toy_set(tmp_path / "port"), img_size=64,
                                source="normalize")
    ds_j = jdatasets.ISPDataset(_toy_set(tmp_path / "jax"), img_size=64,
                                source="normalize")
    rm_t = ReplayMemory(cfg, ds_t, 2, feeder_batch=4, seed=5)
    rm_j = JReplayMemory(jcfg, ds_j, 2, feeder_batch=4, seed=5)
    try:
        for it in range(3):
            ft = rm_t.get_feed_dict_and_states(2)
            fj = rm_j.get_feed_dict_and_states(2)
            _feeds_equal(ft, fj)
            states = ft["state"].copy()
            states[:, 2] += 1 + it
            states[0, 1] = float(it == 1)   # one trajectory stops
            for rm, f in ((rm_t, ft), (rm_j, fj)):
                rm.replace_memory(list(f["im"] * 0.9), f["label"], f["path"],
                                  f["shape"], list(states))
            assert rm_t.stats() == rm_j.stats()
            assert len(rm_t.pool) == 6
    finally:
        rm_t.stop()
        rm_j.stop()


def test_device_replay_sequence_matches_jax(tmp_path):
    """The device pool against JAX's over five rounds of sample and
    write-back with crafted outcomes: steps advancing, a stopped
    trajectory, over-length ones (the keep draw), a diverged batch, and a
    batch that stops every sampled slot.  Slots, states, noise, pool
    images, cached losses and slot metadata agree after every round; the
    refreshes consume the decoded leftovers in the same order."""
    import jax.numpy as jnp

    from adaptiveisp_tpu.data.replay_device import (
        DeviceReplayMemory as JDeviceReplayMemory,
    )
    from adaptiveisp_tpu_torch.data.replay_device import DeviceReplayMemory

    kw = dict(replay_memory_size=6, maximum_trajectory_length=2)
    cfg, jcfg = Config(**kw), JConfig(**kw)

    def loss_t(images, labels):   # a per-image "loss" of image and labels
        n = torch.tensor([[float(len(lb))] for lb in labels])
        return images.mean(dim=(1, 2, 3))[:, None] + n

    def loss_j(images, labels):
        n = jnp.asarray([[float(len(lb))] for lb in labels])
        return jnp.mean(images, axis=(1, 2, 3))[:, None] + n

    ds_t = tdatasets.ISPDataset(_toy_set(tmp_path / "port"), img_size=64,
                                source="normalize")
    ds_j = jdatasets.ISPDataset(_toy_set(tmp_path / "jax"), img_size=64,
                                source="normalize")
    pt = DeviceReplayMemory(cfg, ds_t, 2, feeder_batch=4, seed=3,
                            device="cpu", loss_fn=loss_t)
    pj = JDeviceReplayMemory(jcfg, ds_j, 2, feeder_batch=4, seed=3,
                             loss_fn=loss_j)

    def same_pool():
        np.testing.assert_array_equal(pt.states, pj.states)
        np.testing.assert_allclose(pt.images.numpy(), np.asarray(pj.images),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(pt.loss_in.numpy(),
                                   np.asarray(pj.loss_in), rtol=0, atol=1e-6)
        assert [os.path.basename(m["path"]) for m in pt.meta] == \
            [os.path.basename(m["path"]) for m in pj.meta]

    try:
        same_pool()
        for rnd in range(5):
            st, sj = pt.sample(2), pj.sample(2)
            np.testing.assert_array_equal(st[0], sj[0])
            np.testing.assert_allclose(st[1].numpy(), np.asarray(sj[1]),
                                       rtol=0, atol=1e-6)
            for a, b in zip(st[2:4] + st[6:], sj[2:4] + sj[6:]):
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)
            np.testing.assert_allclose(pt.sampled_loss(st[0]).numpy(),
                                       np.asarray(pj.sampled_loss(sj[0])),
                                       rtol=0, atol=1e-6)
            new = st[2].copy()
            new[:, 2] += 1 + rnd
            if rnd == 1:
                new[0, 1] = 1.0
            if rnd == 4:
                new[:, 1] = 1.0
            rloss = st[1].mean(dim=(1, 2, 3))[:, None] * 2
            pt.replace(st[0], st[1] * 0.9, new, diverged=rnd == 3,
                       retouch_loss=rloss)
            pj.replace(sj[0], sj[1] * 0.9, new, diverged=rnd == 3,
                       retouch_loss=jnp.asarray(rloss.numpy()))
            same_pool()
        assert pt.refreshes >= 4 and pt.fresh_images >= 4
        assert pt.stats() == pj.stats()
    finally:
        pt.stop()
        pj.stop()


def test_metric_writer_jsonl_without_tensorboard(tmp_path, monkeypatch):
    """TensorBoard unimportable: JSONL only, one object a scalar; images
    go to PNGs.  make_image_grid and the trajectory strip equal JAX's."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    w = tlogging.MetricWriter(str(tmp_path / "logs"))
    assert w.tb is None
    w.scalars({"reward": 0.5, "agent_loss": -1.25}, 3)
    w.image("val/0", np.full((8, 8, 3), 0.5, np.float32), 3)
    w.close()
    rows = [json.loads(ln) for ln in
            (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [(r["tag"], r["value"], r["step"]) for r in rows] == [
        ("reward", 0.5, 3), ("agent_loss", -1.25, 3)]
    assert (tmp_path / "logs" / "val_0_3.png").exists()
    imgs = np.random.RandomState(6).rand(4, 5, 7, 3).astype(np.float32)
    np.testing.assert_array_equal(tlogging.make_image_grid(imgs),
                                  jlogging.make_image_grid(imgs))
    steps = [imgs[i] for i in range(4)]
    pdfs = list(np.random.RandomState(7).dirichlet(np.ones(10), 3))
    np.testing.assert_allclose(trajectory_strip(steps, pdfs, [2, -1, 9]),
                               jstrip(steps, pdfs, [2, -1, 9]),
                               rtol=0, atol=1e-6)
    log = tmp_path / "tee.log"
    tee = tlogging.Tee(str(log))
    try:
        print("tee line")
    finally:
        tee.close()
    assert log.read_text() == "tee line\n"


def test_port_sources_import_no_jax():
    """No module of the port, and not chip_smoke.py, has an import of jax
    or of the JAX package (a grep over the sources)."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|adaptiveisp_tpu)(\.|\s|$)",
                     re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(REPO, "adaptiveisp_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 40
    assert {os.path.join(REPO, "adaptiveisp_tpu_torch", n) for n in (
        "resume_all.py", "ops/denoise.py", "data/letterbox.py")} <= set(files)
    bad = [f for f in files if pat.search(open(f).read())]
    assert bad == []
