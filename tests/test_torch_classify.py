"""The port's classifier against the JAX package's, on the CPU.

A tiny 3-row backbone spec at 64 px (the classify CLI's default, YOLOv3-tiny,
at 32 px for the CLI), 3 classes, batch 2, dropout 0 (flax's dropout draws
cannot be reproduced), weights from seeded NumPy over ``jax.eval_shape``
carried across by ``convert.classifier_from_flax``; each package reads its
own copy of the same class folders.  Tolerances:
  * the forward (eval and train mode, with and without ``cutoff``): 1e-5
    absolute;
  * each optimizer (SGD, Adam, AdamW, RMSProp) against optax over five
    updates from the same seeded gradients: 1e-6 relative per tensor;
  * three train steps per optimizer on the same batches: accuracy exactly;
    with SGD the loss and the parameters and their EMA to 1e-6
    relative per tensor (measured 7.4e-7); with Adam, AdamW and RMSProp the
    loss to 1e-4 and the tensors to 1e-3 (measured 2e-5 to 3.6e-4, varying
    run to run): they divide each gradient by its own running magnitude,
    so an element whose gradient is small moves by about lr whatever its
    size, and the float32 noise of its sum (1e-8 absolute, summed in
    another order by XLA than by ATen) shows at that scale;
  * ``FolderDataset`` batches: labels exactly, images to 1e-6;
  * ``ClassifierTrainer.fit`` for two epochs: losses to 1e-4 relative,
    top-1 and top-5 exactly; ``predict`` probabilities to 1e-4 (after two
    Adam epochs; measured 1.4e-5);
    ``apply_classifier`` exactly; the CLI's ``--validate-only`` exactly.
"""

import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from adaptiveisp_tpu import classify as jcls
from adaptiveisp_tpu.detect.spec import YOLOV3_TINY_SPEC as JTINY
from adaptiveisp_tpu_torch import classify as cls
from adaptiveisp_tpu_torch.convert import classifier_from_flax
from adaptiveisp_tpu_torch.detect import segment as seg
from torch_suite import cheap_xla, one_torch_thread  # noqa: F401

SIZE, NC = 64, 3
SPEC = {
    "nc": 2,
    "anchors": [[10, 14, 23, 27, 37, 58]],
    "backbone": [
        [-1, 1, "Conv", [8, 3, 2]],
        [-1, 1, "Bottleneck", [8]],
        [-1, 1, "Conv", [16, 3, 2]],
        [-1, 1, "Conv", [16, 3, 2]],
    ],
    "head": [],
}
COLORS = [(0.9, 0.2, 0.1), (0.1, 0.8, 0.2), (0.2, 0.2, 0.9)]



def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _write_folders(root, n, seed):
    """n images per class, a colour per class over noise, 40-72 px."""
    rng = np.random.RandomState(seed)
    for ci in range(NC):
        d = root / f"c{ci}"
        d.mkdir(parents=True)
        for i in range(n):
            h, w = rng.randint(40, 72, 2)
            im = rng.rand(h, w, 3) * 0.4
            im += np.asarray(COLORS[ci]) * rng.uniform(0.3, 0.6)
            Image.fromarray((im.clip(0, 1) * 255).astype(np.uint8)).save(
                d / f"{i}.png")
    return str(root)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("cls")
    return {who: (_write_folders(root / who / "train", 4, 0),
                  _write_folders(root / who / "val", 2, 1))
            for who in ("jax", "port")}


def _fill(shapes, seed):
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


def _jax_classifier(spec=SPEC, cutoff=None, size=SIZE, seed=0):
    model = jcls.ClassificationModel(spec=spec, nc=NC, cutoff=cutoff)
    shapes = jax.eval_shape(lambda k: model.init(
        {"params": k}, jnp.zeros((1, size, size, 3)), train=False),
        jax.random.PRNGKey(0))
    return model, _fill(shapes, seed)


def _port(variables, spec=SPEC, cutoff=None):
    m = cls.ClassificationModel(spec=spec, nc=NC, cutoff=cutoff)
    m.load_state_dict(classifier_from_flax(
        variables["params"], variables["batch_stats"], spec, cutoff))
    return m


@pytest.fixture(scope="module")
def jmodel():
    return _jax_classifier()


@pytest.mark.parametrize("cutoff", [None, 3])
def test_classifier_forward_matches_jax(cutoff):
    model, v = _jax_classifier(cutoff=cutoff, seed=1)
    port = _port(v, cutoff=cutoff)
    k = 3 if cutoff else 4
    assert f"model.{k}.conv.conv.weight" in port.state_dict()
    assert f"model.{k}.linear.weight" in port.state_dict()
    x = np.random.RandomState(2).rand(2, SIZE, SIZE, 3).astype(np.float32)
    want, (want_t, _) = jax.jit(lambda v, x: (
        model.apply(v, x, train=False),
        model.apply(v, x, train=True, mutable=["batch_stats"])))(
        v, jnp.asarray(x))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with torch.no_grad():
        got_t = port.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got_t, want_t, rtol=0, atol=1e-5)


def test_folder_dataset_matches_jax(data):
    dj = jcls.FolderDataset(data["jax"][0], img_size=SIZE, augment=True,
                            seed=4)
    dt = cls.FolderDataset(data["port"][0], img_size=SIZE, augment=True,
                           seed=4)
    assert dt.classes == dj.classes == ["c0", "c1", "c2"]
    assert len(dt) == len(dj) == 12
    for _ in range(2):
        for (it, lt), (ij, lj) in zip(dt.epoch_batches(5),
                                      dj.epoch_batches(5)):
            np.testing.assert_array_equal(lt, lj)
            np.testing.assert_allclose(it, ij, rtol=0, atol=1e-6)


def _tx(cfg, total):
    """JAX's ClassifierTrainer optimizer, as its constructor builds it."""
    import optax

    sched = optax.cosine_decay_schedule(cfg.lr0, total, alpha=cfg.lrf)
    if cfg.optimizer == "AdamW":
        return optax.adamw(sched, b1=cfg.momentum, b2=0.999,
                           weight_decay=cfg.weight_decay)
    inner = {"Adam": lambda: optax.adam(sched, b1=cfg.momentum, b2=0.999),
             "RMSProp": lambda: optax.rmsprop(sched, momentum=cfg.momentum),
             "SGD": lambda: optax.sgd(sched, momentum=cfg.momentum,
                                      nesterov=True)}[cfg.optimizer]()
    return optax.chain(optax.add_decayed_weights(cfg.weight_decay), inner)


OPTS = ["SGD", "Adam", "AdamW", "RMSProp"]


def _cfgs(opt):
    cfg = jcls.ClsTrainConfig(batch_size=2, lr0=0.01, weight_decay=5e-3,
                              optimizer=opt, label_smoothing=0.1,
                              ema_decay=0.9)
    return cfg, cls.ClsTrainConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("opt", OPTS)
def test_optimizer_updates_match_optax(jmodel, opt):
    """Five updates from the same seeded gradients: optax's arithmetic."""
    import optax

    _, v = jmodel
    cfg, tcfg = _cfgs(opt)
    tx = _tx(cfg, 5)
    port = _port(v)
    topt = cls.make_classifier_optimizer(tcfg, 5)(port)
    named = dict(port.named_parameters())
    params, st = v["params"], tx.init(v["params"])
    update = jax.jit(lambda g, s, p: (lambda u, s2: (
        optax.apply_updates(p, u), s2))(*tx.update(g, s, p)))
    rng = np.random.RandomState(8)
    for _ in range(5):
        grads = jax.tree_util.tree_map(
            lambda p: (rng.randn(*p.shape) * 0.1).astype(np.float32), params)
        params, st = update(grads, st, params)
        gsd = classifier_from_flax(grads, v["batch_stats"], SPEC)
        for k, p in named.items():
            p.grad = gsd[k].clone()
        topt.step()
    want = classifier_from_flax(params, v["batch_stats"], SPEC)
    for k, p in named.items():
        assert _rel(p.detach(), want[k]) < 1e-6, k


@pytest.mark.parametrize("opt", OPTS)
def test_three_steps_per_optimizer_match_jax(jmodel, opt):
    model, v = jmodel
    cfg, tcfg = _cfgs(opt)
    tx = _tx(cfg, 3)
    jstep = jax.jit(jcls.make_classifier_train_step(model, cfg, tx))
    state = (v["params"], v["batch_stats"], tx.init(v["params"]),
             jcls.ema_init(v["params"]), jnp.asarray(0, jnp.int32))
    port = _port(v)
    tstate = cls.ClsTrainState(port, cls.make_classifier_optimizer(
        tcfg, 3)(port), cls.ModelEMA(port, tcfg.ema_decay))
    tstep = cls.make_classifier_train_step(tcfg)
    tol = 1e-6 if opt == "SGD" else 1e-3
    rng = np.random.RandomState(5)
    for i in range(3):
        x = rng.rand(2, SIZE, SIZE, 3).astype(np.float32)
        y = rng.randint(0, NC, 2).astype(np.int32)
        state, jout = jstep(state, jnp.asarray(x), jnp.asarray(y),
                            jax.random.PRNGKey(i))
        tstate, out = tstep(tstate, torch.from_numpy(x),
                            torch.from_numpy(y).long())
        assert _rel(float(out["loss"]), float(jout["loss"])) < max(tol / 10,
                                                                   1e-6)
        assert float(out["acc"]) == float(jout["acc"])
    want = classifier_from_flax(state[0], state[1], SPEC)
    got = port.state_dict()
    start = classifier_from_flax(v["params"], v["batch_stats"], SPEC)
    assert max(_rel(got[k], start[k]) for k in want
               if "running" not in k and "num_b" not in k) > 1e-2
    for k, w in want.items():
        if "num_batches" not in k:
            assert _rel(got[k], w) < tol, k
    ema = classifier_from_flax(state[3].params, state[1], SPEC)
    for k, w in tstate.ema.params.items():
        assert _rel(w, ema[k]) < tol, k


@pytest.fixture(scope="module")
def fits(data, jmodel, tmp_path_factory):
    """Both trainers, two epochs from the same weights on their own data."""
    model, v = jmodel
    cfg = dict(epochs=2, batch_size=4, lr0=0.02, optimizer="Adam")
    kw = dict(img_size=SIZE, augment=True, seed=2)
    jtr = jcls.ClassifierTrainer(
        model, v, jcls.FolderDataset(data["jax"][0], **kw),
        jcls.FolderDataset(data["jax"][1], img_size=SIZE),
        cfg=jcls.ClsTrainConfig(**cfg))
    jhist = jtr.fit()
    save = str(tmp_path_factory.mktemp("clsfit") / "run")
    tr = cls.ClassifierTrainer(
        _port(v), cls.FolderDataset(data["port"][0], **kw),
        cls.FolderDataset(data["port"][1], img_size=SIZE),
        cfg=cls.ClsTrainConfig(**cfg), save_dir=save, device="cpu")
    return jtr, jhist, tr, tr.fit(), save


def test_classifier_trainer_fit_matches_jax(fits):
    jtr, jhist, tr, hist, save = fits
    assert [h["epoch"] for h in hist] == [h["epoch"] for h in jhist] == [0, 1]
    assert _rel([h["loss"] for h in hist], [h["loss"] for h in jhist]) < 1e-4
    for h, j in zip(hist, jhist):
        assert (h["top1"], h["top5"]) == (j["top1"], j["top5"])
    assert hist[-1]["top5"] == 1.0      # three classes
    assert tr.best_acc == jtr.best_acc
    assert {"best.pt", "last.pt", "results.csv"} <= set(os.listdir(save))
    with open(os.path.join(save, "results.csv")) as f:
        assert f.readline().strip() == "epoch,loss,top1,top5,seconds"
    ck = torch.load(os.path.join(save, "last.pt"), weights_only=False)
    assert ck["classes"] == ["c0", "c1", "c2"] and "ema" in ck


def test_predict_and_apply_classifier_match_jax(fits):
    jtr, _, tr, _, _ = fits
    jv = {"params": jax.device_get(jtr.state[0]),
          "batch_stats": jax.device_get(jtr.state[1])}
    port = tr.model
    ims = np.random.RandomState(6).rand(3, SIZE, SIZE, 3).astype(np.float32)
    want = jcls.predict(jtr.model, jv, ims, ["a", "b", "c"], top_k=2)
    got = cls.predict(port, ims, ["a", "b", "c"], top_k=2)
    for g, w in zip(got, want):
        assert [c for c, _ in g] == [c for c, _ in w]
        np.testing.assert_allclose([p for _, p in g], [p for _, p in w],
                                   rtol=0, atol=1e-4)
    # second stage over detections: boxes near the edges and inside
    rng = np.random.RandomState(7)
    images = [rng.rand(90, 120, 3).astype(np.float32),
              rng.rand(70, 50, 3).astype(np.float32)]
    dets = [np.array([[5, 6, 40, 50, 0.9, 0], [60, 20, 119, 89, 0.8, 1],
                      [30, 30, 45, 60, 0.7, 2], [0, 0, 10, 10, 0.6, 1]],
                     np.float32), np.zeros((0, 6), np.float32)]
    jfn = jax.jit(lambda x: jtr.model.apply(jv, x, train=False))
    want = jcls.apply_classifier(dets, images, jfn, imgsz=SIZE)
    with torch.no_grad():
        got = cls.apply_classifier(
            dets, images, lambda x: port.eval()(torch.from_numpy(x)),
            imgsz=SIZE)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_classify_cli_matches_jax(data, tmp_path, monkeypatch):
    """``--validate-only`` on a JAX checkpoint pickle (the default
    YOLOv3-tiny backbone) gives JAX's top-1 / top-5; one epoch of training
    writes the run's files.  JAX's ``create_classifier`` is an eager init
    whose variables the pickle replaces: skipped."""
    monkeypatch.setattr(jcls, "create_classifier", lambda key, spec=None,
                        nc=10, imgsz=224, cutoff=None, dropout=0.0: (
        jcls.ClassificationModel(spec=spec, nc=nc, cutoff=cutoff,
                                 dropout=dropout), None))
    model, v = _jax_classifier(spec=JTINY, size=32, seed=3)
    wpath = tmp_path / "w.pkl"
    with open(wpath, "wb") as f:
        pickle.dump({"model": jax.device_get(v)}, f)
    root = tmp_path / "ds"
    os.makedirs(root)
    os.symlink(data["port"][0], root / "train")
    os.symlink(data["port"][1], root / "val")
    argv = ["--data", str(root), "--imgsz", "32", "--batch-size", "2"]
    want = jcls.main(argv + ["--validate-only", "--weights", str(wpath)])
    got = cls.main(argv + ["--validate-only", "--weights", str(wpath),
                           "--device", "cpu"])
    assert (got["top1"], got["top5"]) == (want["top1"], want["top5"])
    hist = cls.main(argv[:-1] + ["4", "--epochs", "1", "--save-dir",
                            str(tmp_path / "run"), "--device", "cpu",
                            "--optimizer", "RMSProp"])
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    assert {"best.pt", "last.pt", "results.csv"} <= set(
        os.listdir(tmp_path / "run"))
    again = cls.main(argv + ["--validate-only", "--weights",
                             str(tmp_path / "run" / "best.pt"),
                             "--device", "cpu"])
    assert 0 <= again["top1"] <= 1


@pytest.mark.parametrize("which", ["classify", "segment_train"])
def test_dp_exits_naming_p15(which, tmp_path):
    """--dp N on the card (the default device) with no card visible
    raises before any rank starts: no fallback to the CPU or to gloo."""
    main = cls.main if which == "classify" else seg.train_main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--data", str(tmp_path), "--dp", "2"])


def test_dropout_follows_the_trainer_seed(data, monkeypatch):
    """The head's dropout draws from the trainer's generator, seeded from
    ``seed`` (JAX's dropout key): two runs with dropout 0.5 and one seed
    give equal weights, another seed other weights; ``classify.main``
    passes ``--seed`` on."""
    init = cls.create_classifier(spec=SPEC, nc=NC, dropout=0.5, seed=0,
                                 device="cpu").state_dict()

    def run(seed):
        model = cls.create_classifier(spec=SPEC, nc=NC, dropout=0.5,
                                      device="cpu")
        model.load_state_dict(init)
        tr = cls.ClassifierTrainer(
            model, cls.FolderDataset(data["port"][0], img_size=SIZE,
                                     augment=True, seed=2),
            cfg=cls.ClsTrainConfig(epochs=1, batch_size=4, lr0=0.02),
            device="cpu", seed=seed)
        tr.fit()
        return tr.model.state_dict()

    a, b, c = run(5), run(5), run(6)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert any(not torch.equal(a[k], c[k]) for k in a)

    seen = {}

    class Recorder:
        best_acc = 0.0

        def __init__(self, *args, **kw):
            seen.update(kw)

        def fit(self):
            return []

    monkeypatch.setattr(cls, "ClassifierTrainer", Recorder)
    cls.main(["--data", data["port"][0], "--imgsz", "32", "--device", "cpu",
              "--dropout", "0.5", "--seed", "7", "--save-dir", ""])
    assert seen["seed"] == 7
