"""The port's tensor-parallel detector training (tp) and 2-D meshes
against the JAX package's on the CPU.

Four gloo ranks start once for the module (``torch_axes_ranks.py``) and
train one step of ``DetectorTrainer`` over ``make_mesh_dp_tp(2, 2)`` with
``tests/test_tp.py``'s SPEC (8- and 16-wide convs, a 21-wide Detect that
stays whole) at 96 px, one torch thread each, while JAX's trainer takes
the same step over its own (2 x 2) mesh on conftest's virtual CPU
devices: the loss to 2e-4 relative and every tensor of the gathered model
and EMA to 2e-3 / 2e-5 (JAX's bound, here on every parameter, not the
first four); each rank holds half of every divisible tensor; the
checkpoint holds whole tensors and a resume under the same mesh takes
the rank's blocks back bit for bit.  Then the channel rule against
JAX's ``tp_leaf_sharding`` on the converted layout, oversubscription,
the ranks' places on a grid, and the row blocks of the spatial axis.
The module has fewer tests than ``test_pallas_nlm.py``, so a tier-1 run
starts it after that file, beside it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from adaptiveisp_tpu.data.detector_dataset import (
    DetectorDataset as JDetectorDataset,
)
from adaptiveisp_tpu.detect import loss as jloss
from adaptiveisp_tpu.detect import train_detector as jtd
from adaptiveisp_tpu.detect import train_loop as jtl
from adaptiveisp_tpu.detect.model import DetectionModel as JDetectionModel
from adaptiveisp_tpu.train import mesh as jmesh
from adaptiveisp_tpu_torch import parallel
from adaptiveisp_tpu_torch import tensor_parallel as tp_lib
from adaptiveisp_tpu_torch.convert import yolo_from_flax
from adaptiveisp_tpu_torch.data.detector_dataset import DetectorDataset
from adaptiveisp_tpu_torch.detect.model import DetectionModel
from adaptiveisp_tpu_torch.train import mesh as mesh_lib
from torch_suite import cheap_xla, one_torch_thread  # noqa: F401
from test_torch_segment import _fill
import torch_axes_ranks

SPEC = {   # tests/test_tp.py's
    "nc": 2,
    "anchors": [[10, 14, 23, 27, 37, 58],
                [81, 82, 135, 169, 344, 319]],
    "backbone": [[-1, 1, "Conv", [8, 3, 2]],
                 [-1, 1, "Conv", [16, 3, 2]],
                 [-1, 1, "Conv", [16, 3, 2]],
                 [-1, 1, "Conv", [16, 3, 2]],
                 [-1, 1, "Conv", [16, 3, 2]]],
    "head": [[[3, 4], 1, "Detect", ["nc", "anchors"]]],
}
TP_SIZE, TP_BATCH = 96, 4
TP_CFG = dict(epochs=1, batch_size=TP_BATCH, lr0=0.05, warmup_epochs=1.0)
TP_HYP = dict(box=0.05, obj=0.7, cls=0.25)


def _shapes_set(root):
    """tests/test_tp.py's set: one bright rectangle an image, class =
    colour."""
    img_dir, lbl_dir = root / "images", root / "labels"
    img_dir.mkdir(parents=True)
    lbl_dir.mkdir()
    rng = np.random.RandomState(0)
    for i in range(8):
        im = rng.rand(TP_SIZE, TP_SIZE, 3).astype(np.float32) * 0.15
        cls = i % 2
        w, h = rng.randint(30, 60), rng.randint(30, 60)
        x0, y0 = rng.randint(0, TP_SIZE - w), rng.randint(0, TP_SIZE - h)
        im[y0:y0 + h, x0:x0 + w] = [(1.0, 0.1, 0.1), (0.1, 0.2, 1.0)][cls]
        Image.fromarray((im * 255).astype(np.uint8)).save(
            img_dir / f"im{i:03d}.png")
        (lbl_dir / f"im{i:03d}.txt").write_text(
            f"{cls} {(x0 + w / 2) / TP_SIZE:.6f} {(y0 + h / 2) / TP_SIZE:.6f}"
            f" {w / TP_SIZE:.6f} {h / TP_SIZE:.6f}\n")
    return str(img_dir)


def _jax_detector():
    model = JDetectionModel(spec=SPEC)
    shapes = jax.eval_shape(lambda k: model.init(
        {"params": k}, jnp.zeros((1, TP_SIZE, TP_SIZE, 3)), train=False),
        jax.random.PRNGKey(0))
    return model, _fill(shapes, 3)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' outputs (started first) and JAX's step over its
    (2 x 2) mesh, computed while the ranks run."""
    root = tmp_path_factory.mktemp("tp")
    data = _shapes_set(root / "shapes")
    jm, jv = _jax_detector()
    batch = list(next(DetectorDataset(
        data, img_size=TP_SIZE, batch_size=TP_BATCH, augment=False,
        nc=2).epoch_batches(shuffle=False)))
    torch.save(dict(tp=dict(
        spec=SPEC, size=TP_SIZE, data=data, batch=batch, cfg=TP_CFG,
        hyp=TP_HYP, weights=yolo_from_flax(jv["params"], jv["batch_stats"],
                                           SPEC))), root / "inputs.pt")
    ranks = torch_axes_ranks.launch(root, "tp_scenarios")

    mesh = jmesh.make_mesh_dp_tp(2, 2)
    jtr = jtl.DetectorTrainer(
        jm, jv, SPEC, JDetectorDataset(data, img_size=TP_SIZE,
                                       batch_size=TP_BATCH, augment=False,
                                       nc=2),
        cfg=jtd.DetTrainConfig(**TP_CFG), hyp=jloss.LossHyp(**TP_HYP),
        loggers=False, mesh=mesh)
    st, res = jtr.step_fn(jtr.state, *jmesh.shard_batch(
        mesh, tuple(jnp.asarray(a) for a in batch)))
    st = jax.device_get(st)
    want = dict(loss=float(res["loss"]),
                model=yolo_from_flax(st.params, st.batch_stats, SPEC),
                ema=yolo_from_flax(st.ema.params, st.batch_stats, SPEC))
    return dict(ranks=ranks(), want=want, root=root)


def _close(got, want, what):
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w),
                                   rtol=2e-3, atol=2e-5,
                                   err_msg=f"{what} {k}")


def test_tp_detector_step_matches_jax(runs):
    want = runs["want"]
    for r in runs["ranks"]:
        got = r["tp"]
        assert abs(float(got["loss"]) - want["loss"]) <= 2e-4 * abs(
            want["loss"])
        _close(got["model"], want["model"], "model")
        assert set(got["ema"]) == {n for n, _ in DetectionModel(
            SPEC).named_parameters()}
        _close(got["ema"], {k: want["ema"][k] for k in got["ema"]}, "ema")


def test_tp_ranks_hold_their_blocks(runs):
    """Every tensor whose output-channel width divides by 2 is held half
    on each rank (parameters, BatchNorm statistics, optimizer moments);
    Detect's 21-wide convs are whole."""
    model = DetectionModel(SPEC)
    whole = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    for r in runs["ranks"]:
        local = r["tp"]["local"]
        for k, shape in whole.items():
            split = bool(shape) and shape[0] % 2 == 0
            want = (shape[0] // 2,) + shape[1:] if split else shape
            assert local[k] == want, k
        b = r["tp"]["bytes_after"]
        assert b["params"] == b["optimizer"]
        n_whole = sum(p.numel() for p in model.parameters()) * 4
        n_detect = sum(p.numel() for n, p in model.named_parameters()
                       if n.startswith("model.5.")) * 4
        assert b["params"] == (n_whole - n_detect) // 2 + n_detect


def test_tp_checkpoint_is_whole_and_resumes(runs):
    """last.pt holds whole tensors, the gathered step's, which load into a
    model without a mesh; a trainer on the same mesh resumes from it to
    the same blocks, optimizer moments included."""
    ckpt = torch.load(runs["root"] / "tp_ckpt" / "last.pt",
                      weights_only=False)
    got = runs["ranks"][0]["tp"]
    DetectionModel(SPEC).load_state_dict(ckpt["model"])
    for k, v in ckpt["model"].items():
        assert torch.equal(v, got["model"][k]), k
    assert {len(v) for st in ckpt["opt_state"]["state"].values()
            for v in st.values()} <= {len(v) for v in got["model"].values()
                                      if v.ndim}
    assert all(r["tp"]["resumed_equal"] for r in runs["ranks"])


def test_tp_leaf_sharding_matches_jax_on_converted_layout():
    """JAX's rule (the last, output-channel dimension of every flax leaf
    split over 'model' when it divides) and the port's (the first
    dimension of the converted tensor) name the same tensors and the same
    dimension: a flax leaf holding its index along JAX's split dimension
    converts to a tensor holding it along the port's."""
    jm = jmesh.make_mesh_dp_tp(2, 2)
    mesh = parallel.Mesh(0, 4, torch.device("cpu"),
                         axis_names=("data", "model"), shape=(2, 2),
                         coords=(0, 0), groups=(None, None))
    _, shapes = _jax_detector()

    def mark(s):
        spec = jmesh.tp_leaf_sharding(jm, np.zeros(s.shape)).spec
        if not spec:
            return np.full(s.shape, -1.0, np.float32)
        assert spec[-1] == jmesh.MODEL_AXIS and len(spec) == len(s.shape)
        return np.broadcast_to(np.arange(s.shape[-1], dtype=np.float32),
                               s.shape).copy()

    marked = jax.tree_util.tree_map(mark, shapes)
    conv = yolo_from_flax(marked["params"], marked["batch_stats"], SPEC)
    specs = tp_lib.tp_state_sharding(mesh, DetectionModel(SPEC))
    assert set(conv) <= set(specs)
    for k, v in conv.items():
        if k.endswith("num_batches_tracked"):   # no flax counterpart
            assert specs[k] == ()
            continue
        assert specs[k] == tp_lib.tp_leaf_sharding(mesh, v), k
        if specs[k]:
            assert specs[k] == (mesh_lib.MODEL_AXIS,) + (None,) * (
                v.ndim - 1)
            index = torch.arange(v.shape[0], dtype=torch.float32)
            assert torch.equal(v, index.reshape((-1,) + (1,) * (v.ndim - 1))
                               .expand_as(v)), k
        else:
            assert bool((v == -1).all()), k
    assert tp_lib.tp_leaf_sharding(mesh, torch.zeros(())) == ()
    assert tp_lib.tp_leaf_sharding(mesh, torch.zeros(21, 16, 1, 1)) == ()


def test_oversubscription_refused(runs):
    """A grid of more ranks than the group (in a 4-rank group, and in one
    process without a group) raises as JAX's makers do."""
    for r in runs["ranks"]:
        assert r["oversubscribed"] == "mesh 4x2 needs 8 ranks, have 4"
    with pytest.raises(ValueError, match="needs 16 ranks, have 1"):
        mesh_lib.make_mesh_2d(4, 4, device="cpu")


def test_mesh_axes_place_ranks_as_jax():
    """Rank r of a (2 x 3) grid sits at (r // 3, r % 3), as
    ``np.array(devs).reshape(2, 3)`` places JAX's devices; its subgroups'
    ranks in coordinate order."""
    devs = np.arange(6).reshape(2, 3)
    for r in range(6):
        d, a = divmod(r, 3)
        m = parallel.Mesh(r, 6, torch.device("cpu"),
                          axis_names=("data", "pipe"), shape=(2, 3),
                          coords=(d, a), groups=(None, None))
        assert devs[m.data_rank, m.axis_rank("pipe")] == r
        assert m.axis_ranks("pipe") == list(devs[d])
        assert m.axis_ranks("data") == list(devs[:, a])
        assert (m.data_size, m.axis_size("pipe")) == (2, 3)
    one = parallel.Mesh(1, 2, torch.device("cpu"))
    assert (one.shape, one.coords, one.data_rank) == ((2,), (1,), 1)


def test_row_blocks_and_mask_grid():
    """Rows split in blocks of ceil(H / n), the last ones shorter, as
    GSPMD pads an uneven dimension; with masking on, a block's mask is
    drawn on the whole frame's grid, so a pointwise filter on rows
    [lo, hi) equals those rows of the frame's render (no halo, so no
    collective)."""
    from adaptiveisp_tpu_torch.config import Config
    from adaptiveisp_tpu_torch.ops import bank

    assert [parallel.row_bounds(341, 2, i) for i in range(2)] == [
        (0, 171), (171, 341)]
    assert [parallel.row_bounds(10, 4, i) for i in range(4)] == [
        (0, 3), (3, 6), (6, 9), (9, 10)]
    cfg = Config(masking=True)
    mesh = parallel.Mesh(1, 3, torch.device("cpu"),
                         axis_names=("data", "spatial"), shape=(1, 3),
                         coords=(0, 1), groups=(None, None))
    rng = np.random.RandomState(5)
    img = torch.from_numpy(rng.rand(2, 20, 12, 3).astype(np.float32))
    mask = torch.from_numpy(rng.randn(2, 6).astype(np.float32))
    params = torch.from_numpy(rng.rand(2, 1).astype(np.float32))
    rows = parallel.Rows(mesh, 20)
    lo, hi = rows.bounds
    spec = bank.get_spec(cfg, "exposure")
    want = bank.apply_one(cfg, spec, img, params, mask)[:, lo:hi]
    got = bank.apply_one(cfg, spec, img[:, lo:hi], params, mask, rows=rows)
    assert (lo, hi) == (7, 14)
    assert torch.equal(got, want)
