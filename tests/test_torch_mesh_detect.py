"""The port's data parallelism for the detector, segmentation and
classifier trainers and the datasets' shards, against the JAX package's
``make_mesh(2)`` runs, on the CPU.

Two gloo ranks start once for the module (``torch_mesh_ranks.py``) and take
the first step of each trainer on their rows of one batch, one torch
thread each.  JAX's side: each trainer built with ``mesh=make_mesh(2)`` on
conftest's virtual CPU devices (weights from seeded NumPy over
``jax.eval_shape``, the tiny specs and toy sets of
``test_torch_detector_training.py``, ``test_torch_segment.py`` and
``test_torch_classify.py``), one step on the sharded batch.  Tolerances
are JAX's own for its sharded detector step
(``tests/test_detector_training.py:389-392``): the loss to 2e-4 relative,
every tensor of the model and its EMA to 2e-3 relative and 2e-5 absolute.
The detector batch gives the two ranks different target counts (rank 1
keeps one target), so the loss's divisors and BatchNorm's statistics must
be the global batch's: the ranks' step is also held against the port's
single-process step at the global batch, the loss to 1e-6 relative and the
tensors to 1e-5 absolute.  The shard orders (``BatchFeeder``,
``DetectorDataset.epoch_batches`` with and without ``rect``,
``SegmentDataset.epoch_batches``) equal JAX's exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptiveisp_tpu import classify as jcls
from adaptiveisp_tpu.data import datasets as jdatasets
from adaptiveisp_tpu.data import detector_dataset as jdd
from adaptiveisp_tpu.data import segment_dataset as jsd
from adaptiveisp_tpu.detect import loss as jloss
from adaptiveisp_tpu.detect import segment as jseg
from adaptiveisp_tpu.detect import train_detector as jtd
from adaptiveisp_tpu.detect import train_loop as jtl
from adaptiveisp_tpu.detect.model import DetectionModel as DetectionModelJ
from adaptiveisp_tpu.train import mesh as jmesh
from adaptiveisp_tpu_torch import classify as cls
from adaptiveisp_tpu_torch.convert import classifier_from_flax, yolo_from_flax
from adaptiveisp_tpu_torch.data import datasets
from adaptiveisp_tpu_torch.data import detector_dataset as dd
from adaptiveisp_tpu_torch.data import segment_dataset as sd_mod
from adaptiveisp_tpu_torch.detect import train_detector as td
from adaptiveisp_tpu_torch.detect import train_loop as tl
from adaptiveisp_tpu_torch.detect.loss import LossHyp
from adaptiveisp_tpu_torch.detect.model import DetectionModel
from test_torch_classify import NC as CLS_NC
from test_torch_classify import SPEC as CLS_SPEC
from test_torch_classify import _jax_classifier, _write_folders
from test_torch_detector_training import LOSS_HYP
from test_torch_detector_training import SPEC as DET_SPEC
from test_torch_detector_training import _write_set as det_write_set
from torch_suite import cheap_xla, one_torch_thread  # noqa: F401
from test_torch_segment import NM
from test_torch_segment import SPEC as SEG_SPEC
from test_torch_segment import _fill
from test_torch_segment import _write_set as seg_write_set
import torch_mesh_ranks

SIZE = 64
DET_CFG = dict(epochs=1, batch_size=8, lr0=0.05, warmup_epochs=1.0)
SEG_CFG = dict(epochs=1, batch_size=4, lr0=0.05, warmup_epochs=1.0)
CLS_CFG = dict(epochs=1, batch_size=8, lr0=0.02, optimizer="SGD")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _jax_detector(spec, seed):
    model = DetectionModelJ(spec=spec)
    shapes = jax.eval_shape(lambda k: model.init(
        {"params": k}, jnp.zeros((1, SIZE, SIZE, 3)), train=False),
        jax.random.PRNGKey(0))
    return model, _fill(shapes, seed)


def _close(got, want, rtol=2e-3, atol=2e-5, what=""):
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=rtol,
                                   atol=atol, err_msg=f"{what} {k}")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's two ranks (started first) and JAX's three mesh steps,
    computed while the ranks run."""
    root = tmp_path_factory.mktemp("mesh_detect")
    mesh = jmesh.make_mesh(2)
    inputs, jax_side = {}, {}

    # detector: rank 1's four images keep one target between them
    det_data = det_write_set(root / "det", 8, 1)
    jm, jv = _jax_detector(DET_SPEC, 0)
    images, targets, tmask = next(dd.DetectorDataset(
        det_data, img_size=SIZE, batch_size=8, augment=False,
        nc=2).epoch_batches(shuffle=False, t_max=16))
    tmask = tmask.copy()
    tmask[4:] = False
    tmask[5, 0] = True
    inputs["det"] = dict(spec=DET_SPEC, size=SIZE, data=det_data,
                         batch=[images, targets, tmask], cfg=DET_CFG,
                         hyp=LOSS_HYP,
                         weights=yolo_from_flax(jv["params"],
                                                jv["batch_stats"], DET_SPEC))
    jax_side["det"] = (jm, jv)

    # segmentation
    seg_data = seg_write_set(root / "seg", 4, 1)
    jm, jv = _jax_detector(SEG_SPEC, 1)
    inputs["seg"] = dict(spec=SEG_SPEC, size=SIZE, data=seg_data,
                         batch=list(next(sd_mod.SegmentDataset(
                             seg_data, img_size=SIZE, batch_size=4,
                             augment=False, mask_ratio=4)
                             .epoch_batches(shuffle=False))),
                         cfg=SEG_CFG, hyp=LOSS_HYP, nm=NM, mask_ratio=4,
                         weights=yolo_from_flax(jv["params"],
                                                jv["batch_stats"], SEG_SPEC))
    jax_side["seg"] = (jm, jv)

    # classifier (dropout 0: flax's draws cannot be reproduced)
    cls_data = _write_folders(root / "cls", 3, 1)
    jm, jv = _jax_classifier()
    inputs["cls"] = dict(spec=CLS_SPEC, nc=CLS_NC, size=SIZE, data=cls_data,
                         batch=list(next(cls.FolderDataset(
                             cls_data, img_size=SIZE)
                             .epoch_batches(8, shuffle=False))),
                         cfg=CLS_CFG,
                         weights=classifier_from_flax(
                             jv["params"], jv["batch_stats"], CLS_SPEC))
    jax_side["cls"] = (jm, jv)
    torch.save(inputs, root / "inputs.pt")
    ranks = torch_mesh_ranks.launch(root, "det_scenarios")

    out = {}
    jm, jv = jax_side["det"]
    jtr = jtl.DetectorTrainer(
        jm, jv, DET_SPEC, jdd.DetectorDataset(det_data, img_size=SIZE,
                                              batch_size=8, augment=False,
                                              nc=2),
        cfg=jtd.DetTrainConfig(**DET_CFG), hyp=jloss.LossHyp(**LOSS_HYP),
        loggers=False, mesh=mesh)
    st, res = jtr.step_fn(jtr.state, *jmesh.shard_batch(
        mesh, tuple(jnp.asarray(a) for a in inputs["det"]["batch"])))
    st = jax.device_get(st)
    out["det"] = dict(loss=float(res["loss"]),
                      model=yolo_from_flax(st.params, st.batch_stats,
                                           DET_SPEC),
                      ema=yolo_from_flax(st.ema.params, st.batch_stats,
                                         DET_SPEC))
    jm, jv = jax_side["seg"]
    jtr = jseg.SegmentTrainer(
        jm, jv, SEG_SPEC, jsd.SegmentDataset(seg_data, img_size=SIZE,
                                             batch_size=4, augment=False,
                                             mask_ratio=4),
        cfg=jtd.DetTrainConfig(**SEG_CFG), hyp=jloss.LossHyp(**LOSS_HYP),
        nm=NM, mesh=mesh)
    st, res = jtr.step_fn(jtr.state, *jmesh.shard_batch(
        mesh, tuple(jnp.asarray(a) for a in inputs["seg"]["batch"])))
    st = jax.device_get(st)
    out["seg"] = dict(loss=float(res["loss"]),
                      model=yolo_from_flax(st.params, st.batch_stats,
                                           SEG_SPEC),
                      ema=yolo_from_flax(st.ema.params, st.batch_stats,
                                         SEG_SPEC))
    jm, jv = jax_side["cls"]
    jtr = jcls.ClassifierTrainer(jm, jv, jcls.FolderDataset(
        cls_data, img_size=SIZE), cfg=jcls.ClsTrainConfig(**CLS_CFG),
        mesh=mesh)
    st, res = jtr.step_fn(jtr.state, *jmesh.shard_batch(
        mesh, tuple(jnp.asarray(a) for a in inputs["cls"]["batch"])),
        jax.random.PRNGKey(0))
    st = jax.device_get(st)
    out["cls"] = dict(loss=float(res["loss"]),
                      model=classifier_from_flax(st[0], st[1], CLS_SPEC),
                      ema=classifier_from_flax(st[3].params, st[1],
                                               CLS_SPEC))
    return dict(jax=out, ranks=ranks(), inputs=inputs)


def _check_against_jax(runs, part):
    want = runs["jax"][part]
    for rank in runs["ranks"]:
        got = rank[part]
        assert _rel(float(got["loss"]), want["loss"]) < 2e-4
        _close(got["model"], want["model"], what=f"{part} model")
        ema = {k: v for k, v in want["ema"].items() if k in got["ema"]}
        _close(got["ema"], ema, what=f"{part} ema")
    r0, r1 = runs["ranks"]
    for k, v in r0[part]["model"].items():   # one replica on every rank
        assert torch.equal(v, r1[part]["model"][k]), k


def test_dp_detector_step_matches_jax(runs):
    _check_against_jax(runs, "det")


def test_dp_detector_step_equals_single_process(runs):
    """Rank 0 holds 4 images and their targets, rank 1 one target: with
    per-rank divisors or BatchNorm statistics the two-rank step would
    differ from the single-process step at the global batch."""
    d = runs["inputs"]["det"]
    model = DetectionModel(DET_SPEC)
    model.load_state_dict(d["weights"])
    tds = dd.DetectorDataset(d["data"], img_size=SIZE, batch_size=8,
                             augment=False, nc=2)
    tr = tl.DetectorTrainer(model, DET_SPEC, tds,
                            cfg=td.DetTrainConfig(**DET_CFG),
                            hyp=LossHyp(**LOSS_HYP), loggers=False,
                            device="cpu")
    state, out = tr.step_fn(tr.state, *(torch.from_numpy(a)
                                        for a in d["batch"]))
    assert int(d["batch"][2][:4].sum()) > 4 * int(d["batch"][2][4:].sum())
    for rank in runs["ranks"]:
        got = rank["det"]
        assert _rel(float(got["loss"]), float(out["loss"])) < 1e-6
        _close(got["model"], state.model.state_dict(), rtol=0, atol=1e-5,
               what="det model")
        _close(got["ema"], state.ema.params, rtol=0, atol=1e-5,
               what="det ema")


def test_dp_fit_follows_rank_0_validation(runs):
    """Each rank's own validation would disagree (rank 1 would skip two
    best.pt saves and stop early): rank 0 alone validates, and every rank
    logs its fitness, saves with it and runs all three epochs."""
    want = list(torch_mesh_ranks.LOCAL_FITNESS[0])
    for part in ("det", "cls"):
        got = [r["fit"][part] for r in runs["ranks"]]
        assert [g["fitness"] for g in got] == [want, want], part
        assert [g["calls"] for g in got] == [3, 0], part
    assert [r["fit"]["det"]["best_epoch"] for r in runs["ranks"]] == [2, 2]
    assert [r["fit"]["cls"]["best_acc"] for r in runs["ranks"]] == [0.3, 0.3]


def test_dp_segment_step_matches_jax(runs):
    _check_against_jax(runs, "seg")


def test_dp_classifier_step_matches_jax(runs):
    _check_against_jax(runs, "cls")


class _Indices:
    """A dataset whose batches are their indices."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def get_batch(self, indices):
        return list(indices)


def test_shard_orders_match_jax():
    """BatchFeeder (the ragged tail dropped before the strided slice, over
    three epochs), DetectorDataset.epoch_batches (strided, or whole
    batches round robin with rect) and SegmentDataset.epoch_batches."""
    for rank in (0, 1):
        got = datasets.BatchFeeder(_Indices(11), batch_size=3, seed=4,
                                   shard_rank=rank, shard_count=2)
        want = jdatasets.BatchFeeder(_Indices(11), batch_size=3, seed=4,
                                     prefetch=False, shard_rank=rank,
                                     shard_count=2)
        try:
            assert ([got.next_batch() for _ in range(6)]
                    == [want.next_batch() for _ in range(6)])
        finally:
            got.stop()
        for rect in (False, True):
            dsets = []
            for mod in (dd, jdd):
                ds = mod.DetectorDataset.__new__(mod.DetectorDataset)
                ds.indices = np.arange(13)
                ds.rng = np.random.RandomState(2)
                ds.rect, ds.batch_size = rect, 2
                ds.collate = lambda idx, t_max: list(idx)
                dsets.append(ds)
            for _ in range(2):
                assert (list(dsets[0].epoch_batches(shard_rank=rank,
                                                    shard_count=2))
                        == list(dsets[1].epoch_batches(shard_rank=rank,
                                                       shard_count=2)))
        dsets = []
        for mod in (sd_mod, jsd):
            ds = mod.SegmentDataset.__new__(mod.SegmentDataset)
            ds.im_files = [""] * 13
            ds.rng = np.random.RandomState(3)
            ds.batch_size = 2
            ds.collate = lambda idx, t_max: list(idx)
            dsets.append(ds)
        assert (list(dsets[0].epoch_batches(shard_rank=rank, shard_count=2))
                == list(dsets[1].epoch_batches(shard_rank=rank,
                                               shard_count=2)))
