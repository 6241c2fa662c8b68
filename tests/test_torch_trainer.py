"""The port's ``Trainer`` against the JAX package's.

One JAX ``Trainer`` per module (built once: it compiles its step; its
networks start from seeded numpy over ``jax.eval_shape``, ``_seeded_inits``,
not its eager inits): the reduced ``config_fast_filters`` roster with
dropout off, the 2-level mini
detector of ``tests/test_trainer_validator.py`` in f32, 64 px, batch 2, a
pool of 8 slots on the device with cached rewards, on a toy set of 10 PNGs
with YOLO labels.  The port's ``Trainer`` (on the CPU) takes the same
agent, critic and detector weights through ``convert.*_from_flax``, and
each package reads its own copy of the files.  Held against JAX over 3
iterations: the sampled slots and their states exactly, ``history`` to
1e-4, the pool's images and cached losses after write-back to 1e-4, the
state matrix exactly, parameters to 3e-7 (1 % of one Adam step) and
BatchNorm statistics to 1e-4.  Then the port alone: the checkpoint at
``save_model_freq=2`` resumed into a fresh ``Trainer`` bit for bit
(parameters, statistics, both optimizers' moments and counts, the step),
one more step from both equal, the weights-only round trip, validation
trajectories, and ``train_isp.main`` for one step on a toy data YAML.
"""

import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from adaptiveisp_tpu.config import TrainConfig as JTrainConfig
from adaptiveisp_tpu.train import checkpoint as jckpt
from adaptiveisp_tpu.train.trainer import Trainer as JTrainer
from adaptiveisp_tpu_torch import train_isp
from adaptiveisp_tpu_torch.config import TrainConfig
from adaptiveisp_tpu_torch.configs.config_fast_filters import cfg as FAST
from adaptiveisp_tpu_torch.convert import (
    agent_from_flax,
    value_from_flax,
    yolo_from_flax,
)
from adaptiveisp_tpu_torch.detect.loss import pad_targets
from adaptiveisp_tpu_torch.detect.model import DetectionModel
from adaptiveisp_tpu_torch.policy.agent import Agent
from adaptiveisp_tpu_torch.train import checkpoint as ckpt
from adaptiveisp_tpu_torch.train.trainer import Trainer
from configs.config_fast_filters import cfg as JFAST
from test_torch_nlm import cheap_xla, one_torch_thread  # noqa: F401

KW = dict(replay_memory_size=8, val_freq=10 ** 9, save_model_freq=2,
          print_freq=1, summary_freq=1, dropout_keep_prob=1.0)
CFG, JCFG = FAST.replace(**KW), JFAST.replace(**KW)
TKW = dict(batch_size=2, epochs=1, imgsz=64, data_name="lod")
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
TRAINER_KW = dict(yolo_spec=MINI_SPEC, t_max=8, log=False,
                  yolo_dtype="float32", device_replay=True,
                  cached_reward=True)


def _toy_set(root, n=10, seed=33):
    rng = np.random.RandomState(seed)
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    for i in range(n):
        Image.fromarray((rng.rand(64, 64, 3) * 255).astype(np.uint8)).save(
            root / "images" / f"{i}.png")
        k = 1 + i % 3
        rows = np.concatenate([rng.randint(0, 8, (k, 1)),
                               rng.uniform(0.3, 0.7, (k, 2)),
                               rng.uniform(0.1, 0.4, (k, 2))], 1)
        (root / "labels" / f"{i}.txt").write_text(
            "".join(" ".join(f"{v:.6f}" for v in r) + "\n" for r in rows))
    return str(root / "images")


def _seeded(module, args, seed):
    """Seeded numpy flax variables over ``jax.eval_shape`` of
    ``module.init`` (no init compile): kernels normal with variance
    1 / fan-in, BatchNorm scales in [0.5, 1.5], other parameters normal
    with scale 0.1, statistics at init's (mean 0, variance 1)."""
    shapes = jax.eval_shape(lambda k: module.init(
        {"params": k, "dropout": k}, *args, train=False),
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def fill(path, a):
        name = jax.tree_util.keystr(path)
        if "batch_stats" in name:
            return (np.zeros if name.endswith("['mean']") else np.ones)(
                a.shape, np.float32)
        if name.endswith("['kernel']"):
            fan_in = int(np.prod(a.shape[:-1]))
            return (rng.randn(*a.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name.endswith("['scale']"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (rng.randn(*a.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _seeded_inits(monkeypatch):
    """JAX's Trainer builds its networks with eager ``init``s (about 20 s
    of small compiles on the CPU); the port takes whatever weights JAX
    starts from, so seeded ones over ``jax.eval_shape`` serve."""
    from adaptiveisp_tpu.detect.model import DetectionModel as JDetection
    from adaptiveisp_tpu.policy.agent import Agent as JAgent
    from adaptiveisp_tpu.policy.value import Value as JValue
    from adaptiveisp_tpu.train import trainer as jtrainer

    x = np.zeros((1, 64, 64, 3), np.float32)
    s = np.zeros((1, JCFG.num_state_dim), np.float32)

    def agent(cfg, key, image_size, batch):
        m = JAgent(cfg=cfg)
        return m, _seeded(m, (x, np.zeros((1, cfg.z_dim), np.float32), s,
                              0.0), 1)

    def value(cfg, key, image_size, batch):
        m = JValue(cfg=cfg)
        return m, _seeded(m, (x, s), 2)

    def detector(key, spec, imgsz):
        m = JDetection(spec=spec)
        return m, _seeded(m, (x,), 3)

    monkeypatch.setattr(jtrainer, "create_agent_state", agent)
    monkeypatch.setattr(jtrainer, "create_value_state", value)
    monkeypatch.setattr(jtrainer, "create_detector", detector)


def _record_samples(pool):
    """Wrap pool.sample to record each sampled (slots, states)."""
    seen, sample = [], pool.sample

    def recorded(n):
        out = sample(n)
        seen.append((np.array(out[0]), np.array(out[2])))
        return out

    pool.sample = recorded
    return seen


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both trainers after 3 iterations (it 0..2), with what they sampled."""
    root = tmp_path_factory.mktemp("trainer")
    monkeypatch = pytest.MonkeyPatch()
    _seeded_inits(monkeypatch)
    try:
        jtr = JTrainer(JCFG, JTrainConfig(**TKW), _toy_set(root / "jax"),
                       save_dir=str(root / "jexp"), **TRAINER_KW)
    finally:
        monkeypatch.undo()
    try:
        s0 = jax.device_get(jtr.state)
        yv = jax.device_get(jtr.yolo_vars)
        weights = dict(
            agent_state_dict=agent_from_flax(s0.agent_params,
                                             s0.agent_stats, CFG),
            value_state_dict=value_from_flax(s0.value_params,
                                             s0.value_stats, CFG),
            yolo_state_dict=yolo_from_flax(yv["params"], yv["batch_stats"],
                                           MINI_SPEC))
        data_t = _toy_set(root / "port")
        tr = Trainer(CFG, TrainConfig(**TKW), data_t,
                     save_dir=str(root / "texp"), device="cpu",
                     **TRAINER_KW, **weights)
        seen_j = _record_samples(jtr.device_replay)
        seen_t = _record_samples(tr.device_replay)
        jtr.train(max_steps=2)
        tr.train(max_steps=2)
        yield dict(jtr=jtr, tr=tr, seen_j=seen_j, seen_t=seen_t,
                   weights=weights, data_t=data_t, root=root)
    finally:
        jtr.close()
        if "tr" in locals():
            tr.close()


def _close_sd(got, want, atol, stats_atol=1e-4):
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(
            got[k].numpy(), w.numpy(), rtol=0,
            atol=stats_atol if "running" in k else atol, err_msg=k)


def test_three_iterations_match_jax(runs):
    jtr, tr = runs["jtr"], runs["tr"]
    assert len(runs["seen_t"]) == len(runs["seen_j"]) == 3
    for (it, st), (ij, sj) in zip(runs["seen_t"], runs["seen_j"]):
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(st, sj)
    assert tr.state.step == int(jax.device_get(jtr.state.step)) == 3
    assert tr.divergence_count == jtr.divergence_count
    assert len(tr.history) == len(jtr.history) == 3
    for ht, hj in zip(tr.history, jtr.history):
        assert ht.keys() == hj.keys()
        for k in hj:
            np.testing.assert_allclose(ht[k], hj[k], rtol=0, atol=1e-4,
                                       err_msg=k)
    pool_t, pool_j = tr.device_replay, jtr.device_replay
    np.testing.assert_array_equal(pool_t.states, pool_j.states)
    assert pool_t.states[:, 2].max() > 0   # trajectories were written back
    np.testing.assert_allclose(pool_t.images.numpy(),
                               np.asarray(pool_j.images), rtol=0, atol=1e-4)
    np.testing.assert_allclose(pool_t.loss_in.numpy(),
                               np.asarray(pool_j.loss_in), rtol=0,
                               atol=1e-4)
    assert [m["path"].split(os.sep)[-1] for m in pool_t.meta] == \
        [m["path"].split(os.sep)[-1] for m in pool_j.meta]
    sj = jax.device_get(jtr.state)
    _close_sd(tr.state.agent.state_dict(),
              agent_from_flax(sj.agent_params, sj.agent_stats, CFG), 3e-7)
    _close_sd(tr.state.value.state_dict(),
              value_from_flax(sj.value_params, sj.value_stats, CFG), 3e-7)
    assert ckpt.latest_step(tr.ckpt_dir) == jckpt.latest_step(jtr.ckpt_dir) == 2


def _batch(tr):
    idx, imgs, states, labels, *_, z = tr.device_replay.sample(2)
    targets, tmask = pad_targets(labels, tr.t_max)
    return (imgs,) + tuple(torch.from_numpy(a) for a in
                           (z, states, targets, tmask)) + (
        tr.device_replay.sampled_loss(idx),)


def test_resume_is_bit_for_bit_and_continues(runs):
    """The checkpoint of it 2 (step 3) into a fresh Trainer: every tensor
    of both networks and both optimizers, their update counts and the
    step equal; one more step from both on one batch gives equal metrics
    and parameters."""
    tr = runs["tr"]
    fresh = Trainer(CFG, TrainConfig(**TKW), runs["data_t"],
                    save_dir=str(runs["root"] / "resumed"), device="cpu",
                    **TRAINER_KW, **runs["weights"])
    try:
        assert fresh.state.step == 0
        fresh.resume(tr.ckpt_dir)
        want, got = ckpt.payload(tr.state), ckpt.payload(fresh.state)
        assert got["step"] == want["step"] == 3
        for part in ("agent", "value"):
            assert got[part].keys() == want[part].keys()
            for k in want[part]:
                assert torch.equal(got[part][k], want[part][k]), k
        for part in ("agent_opt", "value_opt"):
            assert got[part]["count"] == want[part]["count"] == 3
            assert got[part]["state"].keys() == want[part]["state"].keys()
            for i, st in want[part]["state"].items():
                for k in ("mu", "nu"):
                    assert torch.equal(got[part]["state"][i][k], st[k])
        batch = _batch(tr)
        outs = []
        for t in (tr, fresh):
            gen = torch.Generator().manual_seed(11)
            outs.append(t.train_step(t.state, batch, gen, 0.5))
        for k, v in outs[0].metrics.items():
            assert torch.equal(outs[1].metrics[k], v), k
        for a, b in zip(tr.state.agent.parameters(),
                        fresh.state.agent.parameters()):
            assert torch.equal(a, b)
        assert tr.state.step == fresh.state.step == 4
    finally:
        fresh.close()
    empty = runs["root"] / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(empty), fresh.state)


def test_weights_only_round_trip(runs):
    tr = runs["tr"]
    payload = ckpt.load_weights_only(
        os.path.join(tr.ckpt_dir, "weights_iter_2.pt"))
    assert sorted(payload) == ["agent_model", "iter", "value_model"]
    assert payload["iter"] == 3
    agent = Agent(CFG)
    agent.load_state_dict(payload["agent_model"])
    assert "NLM.fc_filter.weight" not in payload["agent_model"]
    assert "feature_extractor.layers.0.weight" in payload["agent_model"]
    path = runs["root"] / "w.pt"
    ckpt.save_weights_only(str(path), tr.state)
    back = ckpt.load_weights_only(str(path))
    for k, v in tr.state.value.state_dict().items():
        assert torch.equal(back["value_model"][k], v)


def test_validate_trajectories_writes_steps(runs, tmp_path):
    tr = runs["tr"]
    tr.val_feed = tr.replay.feeder.dataset.get_batch([0, 1])
    tr.validate_trajectories(it=7, max_images=1)
    files = set(os.listdir(tr.image_dir))
    assert {f"val0_iter7_step{i}.png" for i in range(CFG.test_steps)} <= files
    assert "val0_iter7_steps.png" in files
    assert tr.state.agent.training


def test_load_yolo_weights(runs, tmp_path):
    """A .pkl of flax variables through yolo_from_flax, a .pt state_dict
    as is, a missing file -> None."""
    jtr = runs["jtr"]
    yv = jax.tree_util.tree_map(np.asarray, jax.device_get(jtr.yolo_vars))
    pkl = tmp_path / "mini.pkl"
    pkl.write_bytes(pickle.dumps(yv))
    sd = train_isp.load_yolo_weights(str(pkl), MINI_SPEC)
    want = runs["weights"]["yolo_state_dict"]
    assert sd.keys() == want.keys()
    assert all(torch.equal(sd[k], want[k]) for k in want)
    pt = tmp_path / "mini.pt"
    torch.save({"model": DetectionModel(MINI_SPEC).state_dict()}, pt)
    DetectionModel(MINI_SPEC).load_state_dict(
        train_isp.load_yolo_weights(str(pt), MINI_SPEC))
    assert train_isp.load_yolo_weights(str(tmp_path / "no.pt"),
                                       MINI_SPEC) is None


def test_train_isp_cli_one_step(tmp_path, monkeypatch):
    """``python -m adaptiveisp_tpu_torch.train_isp --device cpu
    --max_steps 1`` on a toy data YAML (tiny detector, reduced roster):
    iterations 0 and 1 run; ``--task val`` renders the validation set at
    full resolution; ``--dp`` on a card that is not there refuses (no
    fallback); ``--yolo_spec`` takes the zoo's names."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.chdir(tmp_path)
    _toy_set(tmp_path / "toy")
    (tmp_path / "toy.yaml").write_text(yaml.safe_dump({
        "path": str(tmp_path / "toy"), "train": "images", "val": "images",
        "nc": 80, "source": "normalize"}))
    base = ["--data_cfg", str(tmp_path / "toy.yaml"), "--device", "cpu",
            "--imgsz", "64", "--batch_size", "2", "--yolo_spec",
            "yolov3-tiny", "--weights", "missing.pt", "--cfg",
            "adaptiveisp_tpu_torch.configs.config_fast_filters"]
    tr = train_isp.main(base + ["--task", "train_val", "--max_steps", "1"])
    assert tr.state.step == 2 and len(tr.history) == 2
    assert tr.val_feed is not None and len(tr.val_feed["im"]) == 8
    assert os.path.isdir(tmp_path / "experiments" / "lod-adaptiveisp")
    assert np.isfinite([h["agent_loss"] for h in tr.history]).all()
    out = train_isp.main(base + ["--task", "val", "--steps", "1",
                                 "--val_save_path", str(tmp_path / "val")])
    assert len(os.listdir(os.path.join(out, "step-0"))) == 10
    with pytest.raises(RuntimeError, match="CUDA"):
        train_isp.main(base + ["--dp", "2", "--device", "cuda"])
    # any spec of the zoo trains; a name that is neither a spec nor a file
    # raises
    spec_at = base.index("yolov3-tiny")
    tr = train_isp.main(base[:spec_at] + ["yolov5n"] + base[spec_at + 1:]
                        + ["--max_steps", "0"])
    assert tr.yolo_spec["width_multiple"] == 0.25 and tr.state.step == 1
    with pytest.raises(FileNotFoundError):
        train_isp.main(base[:spec_at] + ["yolov9"] + base[spec_at + 1:])
