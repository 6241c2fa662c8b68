"""The port's evaluation surface against the JAX package.

One JAX reference per module, with the ``config_fast_filters`` roster (no
NLM) and the 2-level mini detector of ``tests/test_trainer_validator.py``:
seeded flax variables over ``jax.eval_shape`` (no init compile), carried to
the port with ``convert.*_from_flax``.  Each package reads its own copy of a
toy set of 64 x 64 PNGs with YOLO labels.  Held against JAX:
  * merge-NMS on tie-free predictions (counts exactly; boxes to 1e-6
    relative, a few float32 ulps at 100 px: the weighted means sum in
    another order), one image inside and one outside the
    1 < candidates < 3000 gate;
  * TTA ``forward_augment`` (1e-4, and 1e-5 relative on pixel boxes);
  * ``detections_to_coco`` / ``save_predictions``: equal JSON;
  * the dataset's ``high_res``, ``limit``, ``raw16`` and ``split``: exact;
  * the agent's high-res slot, both renders (1e-5);
  * ``run_validation`` free (batch 2, blend) and forced (batch 1, switch,
    ``save_txt``), and with ``save_hybrid`` + ``single_cls``: records
    exactly, mAP50 and mAP within 0.01, the same artifacts with the same
    contents;
  * ``run_hr_validation`` from a JAX weights-only pickle: frames before
    PNG quantisation within 1e-4, the same early stops;
  * ``val_isp``'s flags against the root ``val_isp.parse_args``, and
    ``val_isp.main`` on the JAX pickle selecting JAX's filters;
  * ``train_isp --task val`` writing ``run_hr_validation``'s frames.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import val_isp as root_val_isp
from adaptiveisp_tpu.config import TrainConfig as JTrainConfig
from adaptiveisp_tpu.data.datasets import ISPDataset as JISPDataset
from adaptiveisp_tpu.data.datasets import collate as jcollate
from adaptiveisp_tpu.detect.nms import non_max_suppression as jnms
from adaptiveisp_tpu.detect.tta import forward_augment as jforward_augment
from adaptiveisp_tpu.eval import coco_json as jcoco
from adaptiveisp_tpu.eval import hr_render as jhr
from adaptiveisp_tpu.eval.validator import run_validation as jrun_validation
from adaptiveisp_tpu.policy.agent import Agent as JAgent
from adaptiveisp_tpu.train import checkpoint as jckpt
from adaptiveisp_tpu.train.step import TrainState as JTrainState
from adaptiveisp_tpu_torch import train_isp, val_isp
from adaptiveisp_tpu_torch.config import TrainConfig
from adaptiveisp_tpu_torch.configs.config_fast_filters import cfg as FAST
from adaptiveisp_tpu_torch.convert import agent_from_flax, yolo_from_flax
from adaptiveisp_tpu_torch.data.datasets import ISPDataset, collate
from adaptiveisp_tpu_torch.detect.model import DetectionModel
from adaptiveisp_tpu_torch.detect.nms import non_max_suppression
from adaptiveisp_tpu_torch.detect.tta import forward_augment
from adaptiveisp_tpu_torch.eval import coco_json
from adaptiveisp_tpu_torch.eval import hr_render
from adaptiveisp_tpu_torch.eval.validator import run_validation
from adaptiveisp_tpu_torch.obs.plots import plot_val_study
from adaptiveisp_tpu_torch.policy.agent import Agent
from configs.config_fast_filters import cfg as JFAST
from test_torch_detect import flax_yolo_variables
from torch_suite import (  # noqa: F401
    cheap_xla, one_torch_thread, ranks_time_limit)

MINI_SPEC = {   # tests/test_trainer_validator.py's
    "nc": 8,
    "anchors": [[10, 14, 23, 27, 37, 58], [81, 82, 135, 169, 344, 319]],
    "backbone": [
        [-1, 1, "Conv", [8, 3, 2]],
        [-1, 1, "Conv", [16, 3, 2]],
        [-1, 1, "Conv", [16, 3, 2]],
        [-1, 1, "Bottleneck", [16]],
        [-1, 1, "Conv", [32, 3, 2]],
    ],
    "head": [
        [-1, 1, "Conv", [32, 3, 2]],
        [[4, 5], 1, "Detect", ["nc", "anchors"]],
    ],
}
FAST_CFG = "adaptiveisp_tpu_torch.configs.config_fast_filters"


def _toy_set(root, n=6, hw=(64, 64), seed=33):
    """n seeded PNGs of hw (h, w) with 1-3 YOLO boxes each."""
    rng = np.random.RandomState(seed)
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    for i in range(n):
        Image.fromarray((rng.rand(*hw, 3) * 255).astype(np.uint8)).save(
            root / "images" / f"{i}.png")
        k = 1 + i % 3
        rows = np.concatenate([rng.randint(0, 8, (k, 1)),
                               rng.uniform(0.3, 0.7, (k, 2)),
                               rng.uniform(0.1, 0.4, (k, 2))], 1)
        (root / "labels" / f"{i}.txt").write_text(
            "".join(" ".join(f"{v:.6f}" for v in r) + "\n" for r in rows))
    return str(root / "images")


def _seeded_agent_variables(seed=8):
    """Seeded flax Agent variables (numpy) of the fast roster: kernels
    normal with variance 1 / fan-in, BatchNorm scales and statistics in
    [0.5, 1.5], other parameters normal with scale 0.1."""
    jagent = JAgent(cfg=JFAST)
    shapes = jax.eval_shape(lambda k: jagent.init(
        {"params": k, "dropout": k}, jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((1, JFAST.z_dim)), jnp.zeros((1, JFAST.num_state_dim)),
        0.0, train=False), jax.random.PRNGKey(7))
    rng = np.random.RandomState(seed)

    def fill(path, a):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            fan_in = int(np.prod(a.shape[:-1]))
            return (rng.randn(*a.shape) / np.sqrt(fan_in)).astype(np.float32)
        if "batch_stats" in name or name.endswith("['scale']"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (rng.randn(*a.shape) * 0.1).astype(np.float32)

    return jagent, jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """Both packages' agent and detector on the same weights, a toy set
    (one copy each), its data YAML, and the JAX weights-only pickle."""
    root = tmp_path_factory.mktemp("eval")
    jagent, avars = _seeded_agent_variables()
    jyolo, yvars = flax_yolo_variables(MINI_SPEC, 11)
    agent = Agent(FAST)
    agent.load_state_dict(agent_from_flax(avars["params"],
                                          avars["batch_stats"], FAST))
    yolo = DetectionModel(MINI_SPEC)
    yolo.load_state_dict(yolo_from_flax(yvars["params"],
                                        yvars["batch_stats"], MINI_SPEC))
    pkl = str(root / "agent.pkl")
    jckpt.save_weights_only(pkl, JTrainState(
        avars["params"], avars["batch_stats"], None, {}, {}, None,
        np.int32(3)))
    data_t = _toy_set(root / "port")
    (root / "data.yaml").write_text(yaml.safe_dump({
        "path": str(root / "port"), "train": "images", "val": "images",
        "nc": 8, "source": "normalize"}))
    return dict(root=root, jagent=jagent, avars=avars, jyolo=jyolo,
                yvars=yvars, agent=agent.eval(), yolo=yolo.eval(), pkl=pkl,
                data_j=_toy_set(root / "jax"), data_t=data_t,
                yaml=str(root / "data.yaml"))


# ---------------------------------------------------------------- NMS, TTA

def _nms_predictions():
    """[2, 1200, 9] decoded predictions without exact score ties, boxes in
    four overlapping clusters: image 0 has 160 candidates above conf
    (merged), image 1 has 4800 (> 3000: not merged)."""
    rng = np.random.RandomState(5)
    n, nc = 1200, 4
    centres = rng.uniform(40, 200, (4, 2))
    imgs = []
    for spread in (2, 6):
        xy = centres[rng.randint(0, 4, n)] + rng.normal(0, spread, (n, 2))
        imgs.append(np.concatenate([xy, rng.uniform(20, 40, (n, 2)),
                                    rng.uniform(0.05, 0.95, (n, 1 + nc))],
                                   1))
    p = np.stack(imgs).astype(np.float32)
    p[0, 40:, 4] = 0.0005   # below conf: 40 boxes x 4 classes candidates
    return p


def test_merge_nms_matches_jax():
    p = _nms_predictions()
    kw = dict(conf_thres=0.001, iou_thres=0.6, max_det=300, max_nms=4096,
              multi_label=True, merge=True)
    dj, nj = jnms(jnp.asarray(p), **kw)
    dt, nt = non_max_suppression(torch.from_numpy(p), **kw)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert 0 < nt[0] < 160 and nt[1] > 10
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6,
                               atol=1e-6)
    # merging moved image 0's boxes; image 1 (4800 candidates) kept its own
    plain, n_plain = non_max_suppression(torch.from_numpy(p), **{
        **kw, "merge": False})
    assert n_plain[0] > nt[0]
    assert torch.equal(plain[1], dt[1])


def test_tta_forward_augment_matches_jax(stack):
    x = np.random.RandomState(3).rand(2, 64, 96, 3).astype(np.float32)
    want = jax.jit(lambda v, xi: jforward_augment(
        lambda a: stack["jyolo"].apply(v, a, train=False), xi, MINI_SPEC))(
        stack["yvars"], jnp.asarray(x))
    with torch.no_grad():
        got = forward_augment(stack["yolo"], torch.from_numpy(x), MINI_SPEC)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


def test_coco_json_matches_jax(tmp_path):
    rng = np.random.RandomState(4)
    det = np.concatenate([rng.uniform(0, 300, (5, 4)),
                          rng.uniform(0, 1, (5, 1)),
                          rng.randint(0, 80, (5, 1))], 1).astype(np.float32)
    assert coco_json.COCO80_TO_91 == jcoco.COCO80_TO_91
    for path in ("images/000000397133.jpg", "images/night_07.png"):
        for cmap in (None, coco_json.COCO80_TO_91):
            got = coco_json.detections_to_coco(path, det, class_map=cmap)
            assert got == jcoco.detections_to_coco(path, det, class_map=cmap)
        assert coco_json.detections_to_coco(path, det[:0]) == []
    recs = coco_json.detections_to_coco("images/7.png", det)
    a = coco_json.save_predictions(recs, str(tmp_path / "t"))
    b = jcoco.save_predictions(recs, str(tmp_path / "j"))
    assert open(a).read() == open(b).read()
    if coco_json.pycocotools_eval(a, a) is None:   # pycocotools absent
        assert jcoco.pycocotools_eval(b, b) is None


# ------------------------------------------------------------- the dataset

@pytest.mark.parametrize("source", ["raw16", "normalize"])
def test_dataset_high_res_limit_split_match_jax(tmp_path, source):
    """64 x 48 frames (no resize, so both packages' images are exact):
    ``im_hr`` is the unpadded frame, ``im`` its letterbox."""
    kw = dict(img_size=64, source=source, high_res=True, limit=5,
              train=False)
    dt = ISPDataset(_toy_set(tmp_path / "t", hw=(48, 64)), **kw)
    dj = JISPDataset(_toy_set(tmp_path / "j", hw=(48, 64)), **kw,
                     cache_labels=False)
    assert len(dt) == len(dj) == 5
    for i in range(5):
        rt, rj = dt[i], dj[i]
        assert rt["im_hr"].shape == (48, 64, 3) and rt["im"].shape == (
            64, 64, 3)
        for k in ("im", "im_hr", "label"):
            np.testing.assert_array_equal(rt[k], rj[k], err_msg=k)
        assert rt["shape"] == rj["shape"]
    bt, bj = collate([dt[0], dt[3]]), jcollate([dj[0], dj[3]])
    for a, b in zip(bt["im_hr"], bj["im_hr"]):
        np.testing.assert_array_equal(a, b)
    (tt, vt), (tj, vj) = dt.split(2, seed=1), dj.split(2, seed=1)
    for a, b in ((tt, tj), (vt, vj)):
        np.testing.assert_array_equal(a.indices, b.indices)
        for i in range(len(b)):
            np.testing.assert_array_equal(a[i]["im"], b[i]["im"])
    assert not vt.train and tt.train == dt.train
    assert sorted(np.concatenate([tt.indices, vt.indices])) == list(range(5))
    np.testing.assert_array_equal(
        vt.get_batch([0, 1])["im"], np.stack([vj[0]["im"], vj[1]["im"]]))


# ------------------------------------------------------------------ agent

@pytest.mark.parametrize("render", ["switch", "blend"])
def test_agent_high_res_slot_matches_jax(stack, render):
    rng = np.random.RandomState(9)
    x = rng.uniform(0.02, 0.98, (1, 64, 64, 3)).astype(np.float32)
    hr = rng.uniform(0.02, 0.98, (1, 75, 101, 3)).astype(np.float32)
    z = rng.rand(1, FAST.z_dim).astype(np.float32)
    st = np.zeros((1, FAST.num_state_dim), np.float32)
    out_j = jax.jit(lambda v, a, b, c, d: stack["jagent"].apply(
        v, a, b, c, 1.0, train=False, high_res=d, render=render))(
        stack["avars"], *map(jnp.asarray, (x, z, st, hr)))
    with torch.no_grad():
        out = stack["agent"](*map(torch.from_numpy, (x, z, st)), 1.0,
                             train=False, high_res=torch.from_numpy(hr),
                             render=render)
    assert out[4].shape == hr.shape
    np.testing.assert_allclose(out[4].numpy(), np.asarray(out_j[4]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(out_j[0]),
                               rtol=0, atol=1e-5)


# -------------------------------------------------------------- validator

RUNS = {
    # tests/test_trainer_validator.py:70 and :91, tests/test_val_modes.py
    "free": dict(steps=3, batch_size=2, max_images=4, save_image=True,
                 save_param=True, plots=True),
    "forced": dict(steps=2, batch_size=1, max_images=2, pipeline=[0, 7],
                   save_txt=True, save_conf=True, conf_thres=0.1),
    "hybrid_single_cls": dict(steps=2, batch_size=1, max_images=2,
                              save_hybrid=True, single_cls=True,
                              save_txt=True),
}


@pytest.fixture(scope="module")
def jax_runs(stack, tmp_path_factory):
    """JAX's run_validation for each mode, run once (each call compiles):
    mode -> (result, save_dir)."""
    root, cache = tmp_path_factory.mktemp("jax_val"), {}

    def run(mode):
        if mode not in cache:
            ds = JISPDataset(stack["data_j"], img_size=64,
                             source="normalize", train=False,
                             cache_labels=False)
            out = root / mode
            cache[mode] = (jrun_validation(
                JFAST, stack["jagent"], stack["avars"], stack["jyolo"],
                stack["yvars"], ds, save_dir=str(out), yolo_spec=MINI_SPEC,
                **RUNS[mode]), out)
        return cache[mode]

    return run


def _numbers(path):
    return [[float(v) for v in ln.split()]
            for ln in open(path).read().splitlines()]


@pytest.mark.parametrize("mode", sorted(RUNS))
def test_run_validation_matches_jax(stack, jax_runs, tmp_path, mode):
    kw = dict(RUNS[mode], yolo_spec=MINI_SPEC)
    dt = ISPDataset(stack["data_t"], img_size=64, source="normalize",
                    train=False)
    rj, dir_j = jax_runs(mode)
    rt = run_validation(FAST, stack["agent"], stack["yolo"], dt,
                        save_dir=str(tmp_path / "t"), **kw)
    assert rt["records"] == rj["records"]
    assert len(rt["records"]) == kw["max_images"]
    if mode == "forced":
        assert all(seq == [0, 7] for _, seq in rt["records"])
    for k in ("map50", "map", "precision", "recall"):
        assert abs(rt[k] - rj[k]) < 0.01, (k, rt[k], rj[k])
    if mode == "hybrid_single_cls":
        assert rt["map50"] > 0.95
    assert rt["speed"].startswith("Speed: ") and rt["speed"].endswith(
        "ms post per image")
    assert rt["wall_ms_per_img"] > 0

    files_t = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "t")
                     for d, _, fs in os.walk(tmp_path / "t") for f in fs)
    files_j = sorted(os.path.relpath(os.path.join(d, f), dir_j)
                     for d, _, fs in os.walk(dir_j) for f in fs)
    assert files_t == files_j and "records.txt" in files_t
    for rel in files_t:
        a, b = tmp_path / "t" / rel, dir_j / rel
        if rel.endswith(".txt"):
            if rel == "records.txt":
                assert a.read_text() == b.read_text()
                continue
            na, nb = _numbers(a), _numbers(b)
            if mode == "hybrid_single_cls":
                # the ground-truth rows all score 1.0: JAX's top-k leaves
                # the order of those ties open, the port's sort is stable
                na, nb = sorted(na), sorted(nb)
            assert [r[0] for r in na] == [r[0] for r in nb], rel
            np.testing.assert_allclose(np.asarray(na).reshape(-1),
                                       np.asarray(nb).reshape(-1),
                                       rtol=0, atol=2e-4, err_msg=rel)
        elif rel.endswith(".json"):
            ja, jb = json.load(open(a)), json.load(open(b))
            assert list(ja) == list(jb) and ja["pipeline"] == jb["pipeline"]
            for key in ja:
                np.testing.assert_allclose(ja[key], jb[key], rtol=0,
                                           atol=1e-4, err_msg=key)
        elif rel.startswith("img_results"):
            ia = np.asarray(Image.open(a), np.int16)
            ib = np.asarray(Image.open(b), np.int16)
            assert np.abs(ia - ib).max() <= 1, rel


def test_validator_rejects_mesh(stack):
    ds = ISPDataset(stack["data_t"], img_size=64, source="normalize",
                    train=False)
    with pytest.raises(TypeError, match="make_mesh"):
        run_validation(FAST, stack["agent"], stack["yolo"], ds,
                       mesh=object())


# ------------------------------------------------------- hr_render, CLIs

def _capture_frames(monkeypatch, module):
    frames = {}

    def save(img, path):
        frames[os.path.relpath(path, os.path.dirname(os.path.dirname(
            path)))] = np.asarray(img)

    monkeypatch.setattr(module, "save_img", save)
    return frames


def test_run_hr_validation_matches_jax(stack, tmp_path, monkeypatch):
    """128 x 96 frames capped to 64 x 48; test_steps 2 with 3 steps, so
    each trajectory stops after its second step.  The port reads the JAX
    package's weights-only pickle."""
    hr_dir = _toy_set(tmp_path / "hr", n=2, hw=(96, 128), seed=91)
    data = {"val": hr_dir, "source": "normalize"}
    # JAX's function builds its agent with an eager init (about 14 s of
    # small compiles) whose variables the pickle replaces, and applies it
    # op by op: its module here, applied under one jit (one frame shape)
    def jitted_agent(cfg, key, image_size, batch):
        agent = JAgent(cfg=cfg)
        fn = jax.jit(lambda v, x, z, s, hr: agent.apply(
            v, x, z, s, 1.0, train=False, high_res=hr))

        class Jitted:
            @staticmethod
            def apply(v, x, z, s, progress, train, high_res):
                assert progress == 1.0 and not train
                return fn(v, x, z, s, high_res)

        return Jitted, None

    monkeypatch.setattr(jhr, "create_agent_state", jitted_agent)
    frames_j = _capture_frames(monkeypatch, jhr)
    frames_t = _capture_frames(monkeypatch, hr_render)
    jhr.run_hr_validation(JFAST.replace(test_steps=2),
                          JTrainConfig(batch_size=1, imgsz=64), data,
                          stack["pkl"], str(tmp_path / "j"), steps=3)
    out = hr_render.run_hr_validation(
        FAST.replace(test_steps=2), TrainConfig(batch_size=1, imgsz=64),
        data, stack["pkl"], str(tmp_path / "t"), steps=3, device="cpu")
    assert out == str(tmp_path / "t" / "val-images")
    assert sorted(frames_t) == sorted(frames_j) == sorted(
        f"{d}/{i}.png" for d in ("step-0", "step-1", "all-step")
        for i in range(2))
    assert frames_t["step-0/0.png"].shape == (48, 64, 3)
    for k in frames_j:
        np.testing.assert_allclose(frames_t[k], frames_j[k], rtol=0,
                                   atol=1e-4, err_msg=k)


def test_train_isp_task_val_writes_hr_frames(stack, tmp_path, monkeypatch,
                                               ranks_time_limit):
    from adaptiveisp_tpu_torch.obs.logging import save_img as real_save_img

    frames_t = _capture_frames(monkeypatch, hr_render)
    train_isp.main(["--task", "val", "--data_cfg", stack["yaml"],
                    "--model_weights", stack["pkl"], "--cfg", FAST_CFG,
                    "--imgsz", "64", "--steps", "2", "--device", "cpu",
                    "--val_save_path", str(tmp_path / "val")])
    assert len(frames_t) == 3 * 6
    assert all(frames_t[f"step-1/{i}.png"].shape == (64, 64, 3)
               for i in range(6))
    # --spatial_shard 2: two gloo ranks, each frame's rows split between
    # them with halos; rank 0 writes the same PNGs
    assert train_isp.main([
        "--task", "val", "--data_cfg", stack["yaml"], "--model_weights",
        stack["pkl"], "--cfg", FAST_CFG, "--imgsz", "64", "--steps", "2",
        "--device", "cpu", "--spatial_shard", "2",
        "--val_save_path", str(tmp_path / "sp")]) is None
    for name, want in frames_t.items():
        os.makedirs(os.path.dirname(tmp_path / "png" / name), exist_ok=True)
        real_save_img(want, str(tmp_path / "png" / name))
        with Image.open(tmp_path / "sp" / "val-images" / name) as got, \
                Image.open(tmp_path / "png" / name) as ref:
            assert np.array_equal(np.asarray(got), np.asarray(ref)), name


def test_val_isp_flags_match_root():
    for argv in ([], ["--data", "lod", "--task", "study", "--save_hybrid",
                      "--single_cls", "--study_sizes", "64", "128"],
                 ["--pipeline", "4", "-1", "2", "--merge", "--augment",
                  "--half", "--max_nms", "30000", "--save_json",
                  "--anno_json", "a.json", "--profile", "--task", "speed"]):
        want = vars(root_val_isp.parse_args(argv))
        got = vars(val_isp.parse_args(argv))
        assert got.pop("device") == "cuda"
        assert got == want


def test_val_isp_main_on_a_jax_pickle(stack, jax_runs, tmp_path, capsys):
    """The JAX package's weights-only pickle through the port's CLI (full
    YOLOv3 with seeded random weights at 64 px): the same filter sequences
    as JAX's ``run_validation`` with the same agent; artifacts written."""
    rj, _ = jax_runs("free")
    res = val_isp.main([
        "--data", stack["yaml"], "--isp_weights", stack["pkl"],
        "--cfg", FAST_CFG, "--imgsz", "64", "--batch_size", "2",
        "--steps", "3", "--max_images", "4", "--device", "cpu",
        "--weights", str(tmp_path / "none.pt"), "--project", str(tmp_path),
        "--name", "exp", "--save_json", "--save_txt", "--plots"])
    assert res["records"] == rj["records"]
    out = tmp_path / "exp"
    assert (out / "records.txt").exists() and (
        out / "predictions.json").exists()
    assert len(os.listdir(out / "labels")) == 4
    assert "Speed: " in capsys.readouterr().out


def test_plot_val_study(tmp_path):
    rows = np.array([[0.5, 0.4, 0.45, 0.30, 0.0, 5.0, 0.0, 5.0],
                     [0.6, 0.5, 0.55, 0.38, 0.0, 9.0, 0.0, 9.0]])
    np.savetxt(tmp_path / "study_lod_agent.txt", rows, fmt="%10.4g")
    shutil.copy(tmp_path / "study_lod_agent.txt", tmp_path / "study_b.txt")
    out = plot_val_study(str(tmp_path))
    assert out == str(tmp_path / "study.png") and os.path.getsize(out) > 0
