"""The learning gate on the port: the agent learns (marked slow).

The arc of ``tests/test_rl_learning_gate.py`` with the port's modules, on
``cuda`` where ``torch.cuda.is_available()``, else on the CPU:

  1. train the tiny detector (``DetectorTrainer``, 110 epochs) on BRIGHT
     synthetic shapes                                       -> high mAP
  2. degrade the scenes through the host unprocess (inverse tonemap, gamma
     expansion, inverse CCM and gains, brightness 0.1-1.0x)  -> mAP falls
  3. train the RL ``Trainer`` (replay pool, penalties, 1e-5 clip) for 700
     steps against the frozen detector
  4. optimise the fixed 5-stage pipeline against the same detector and data

Gates, thresholds and data are the JAX test's (its CPU reference: bright
0.944, degraded raw 0.334, untrained agent 0.388, fixed pipeline 0.573,
trained agent 0.804).  The seeds are fixed; the detector, the agent and
the critic start from a seeded draw of flax's initial distributions
(``nn_init.flax_init_``), as the JAX package's networks do.  This file imports no JAX, so that it
runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m slow \\
        tests/test_torch_learning_gate.py -s
"""

import json
import os
import time

import numpy as np
import pytest
import torch

SIZE = 64
N_TRAIN, N_VAL = 48, 16
BRI = (0.1, 1.0)
RL_STEPS = 700

SPEC = {
    "nc": 2,
    "anchors": [[20, 20, 30, 30, 40, 40], [24, 36, 36, 24, 48, 48]],
    "backbone": [
        [-1, 1, "Conv", [8, 3, 2]],
        [-1, 1, "Conv", [16, 3, 2]],
        [-1, 1, "Conv", [32, 3, 2]],   # 2: /8
        [-1, 1, "Conv", [32, 3, 2]],   # 3: /16
    ],
    "head": [[[2, 3], 1, "Detect", ["nc", "anchors"]]],
}
FIVE_STAGES = ("exposure", "improved_wb", "ccm", "gamma", "sharpen")


def _device():
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    print(f"\nlearning gate on {dev}"
          + (f" ({torch.cuda.get_device_name(0)})" if dev == "cuda" else ""))
    return dev


def _build_data(root):
    from PIL import Image

    rng = np.random.RandomState(0)
    for split, n in (("train", N_TRAIN), ("val", N_VAL)):
        os.makedirs(f"{root}/images/{split}", exist_ok=True)
        os.makedirs(f"{root}/labels/{split}", exist_ok=True)
        for i in range(n):
            im = 0.55 + rng.rand(SIZE, SIZE, 3) * 0.25
            cls = i % 2
            w, h = rng.randint(22, 40, 2)
            x0, y0 = rng.randint(0, SIZE - w), rng.randint(0, SIZE - h)
            im[y0:y0 + h, x0:x0 + w] = ((0.95, 0.15, 0.1) if cls == 0
                                        else (0.1, 0.25, 0.95))
            Image.fromarray((im * 255).astype(np.uint8)).save(
                f"{root}/images/{split}/im{i:03d}.png")
            open(f"{root}/labels/{split}/im{i:03d}.txt", "w").write(
                f"{cls} {(x0 + w / 2) / SIZE:.5f} {(y0 + h / 2) / SIZE:.5f}"
                f" {w / SIZE:.5f} {h / SIZE:.5f}\n")


def _pretrain_detector(root, dev):
    from adaptiveisp_tpu_torch import api
    from adaptiveisp_tpu_torch.data.detector_dataset import (
        AugHyp,
        DetectorDataset,
    )
    from adaptiveisp_tpu_torch.detect.loss import LossHyp
    from adaptiveisp_tpu_torch.detect.train_detector import DetTrainConfig
    from adaptiveisp_tpu_torch.detect.train_loop import DetectorTrainer

    tds = DetectorDataset(f"{root}/images/train", img_size=SIZE,
                          batch_size=8, augment=True, nc=2, seed=0,
                          hyp=AugHyp(mosaic=0.0, mixup=0.0, fliplr=0.5,
                                     hsv_h=0.01, hsv_s=0.2, hsv_v=0.2,
                                     translate=0.05, scale=0.2))
    vds = DetectorDataset(f"{root}/images/val", img_size=SIZE,
                          batch_size=8, augment=False, nc=2)
    model = api.load_detector(spec=SPEC, seed=0, device=dev).model
    tr = DetectorTrainer(
        model, SPEC, tds, vds,
        cfg=DetTrainConfig(epochs=110, batch_size=8, lr0=0.01,
                           warmup_epochs=1.0),
        # at 64 px the (imgsz/640)^2 obj scaling crushes objectness; keep
        # obj near its unscaled weight, as the JAX gate does
        hyp=LossHyp(box=0.05, obj=0.7, cls=0.25), loggers=False,
        device=dev)
    tr.fit()
    return tr, vds


@torch.no_grad()
def _map_plain_images(yolo, dataset, render_stages=None, cfg=None):
    """Detector mAP50 on a dataset's images as they are (or through a
    fixed rendered pipeline): no agent."""
    from adaptiveisp_tpu_torch.data.datasets import collate
    from adaptiveisp_tpu_torch.detect.boxes import xywh2xyxy
    from adaptiveisp_tpu_torch.detect.metrics import process_batch, summarize
    from adaptiveisp_tpu_torch.detect.model import decode_predictions
    from adaptiveisp_tpu_torch.detect.nms import non_max_suppression
    from adaptiveisp_tpu_torch.ops import bank

    dev = next(yolo.parameters()).device
    stats = []
    iouv = np.linspace(0.5, 0.95, 10)
    for i in range(len(dataset)):
        b = collate([dataset[i]])
        img = torch.from_numpy(b["im"]).to(dev)
        if render_stages is not None:
            img = bank.render_pipeline(cfg, img, render_stages)
        dec = decode_predictions(yolo(img), SPEC)
        det, nv = non_max_suppression(dec, conf_thres=0.001, iou_thres=0.6,
                                      max_det=30, multi_label=True)
        d = det[0][:int(nv[0])].cpu().numpy()
        lab = b["label"][0][:, 1:].copy()
        gt = np.zeros((len(lab), 5), np.float32)
        if len(lab):
            gt[:, 0] = lab[:, 0]
            gt[:, 1:] = xywh2xyxy(torch.from_numpy(lab[:, 1:] * SIZE))
        stats.append((process_batch(d, gt, iouv), d[:, 4], d[:, 5],
                      gt[:, 0]))
    return summarize(stats)["map50"]


@pytest.fixture(scope="module")
def gate(tmp_path_factory):
    """Runs the whole arc once; the tests below assert single gates."""
    from adaptiveisp_tpu_torch.config import Config, TrainConfig
    from adaptiveisp_tpu_torch.data.datasets import ISPDataset, collate
    from adaptiveisp_tpu_torch.detect.loss import LossHyp, pad_targets
    from adaptiveisp_tpu_torch.detect.model import anchors_in_grid_units
    from adaptiveisp_tpu_torch.detect.train_loop import validate_detector
    from adaptiveisp_tpu_torch.eval.rollout import no_pipeline, rollout
    from adaptiveisp_tpu_torch.eval.validator import run_validation
    from adaptiveisp_tpu_torch.ops.cuda import build
    from adaptiveisp_tpu_torch.policy.states import get_initial_states
    from adaptiveisp_tpu_torch.train.fixed_pipeline import (
        optimize_fixed_pipeline,
    )
    from adaptiveisp_tpu_torch.train.trainer import Trainer

    dev = _device()
    wall, launches = {}, {}

    def count(part):
        """The hand-written kernels' launches since the last count (all 0
        on the CPU)."""
        launches[part] = dict(build.LAUNCHES)
        build.reset_launches()

    build.reset_launches()
    t0 = time.perf_counter()
    root = str(tmp_path_factory.mktemp("rl_gate"))
    _build_data(root)
    det_tr, bright_val = _pretrain_detector(root, dev)
    wall["detector_s"] = time.perf_counter() - t0
    count("detector")
    res = {"device": dev}
    res["map_bright"] = validate_detector(
        det_tr.ema_model(), bright_val, SPEC)["map50"]

    t0 = time.perf_counter()
    cfg = Config(replay_memory_size=32, print_freq=200, summary_freq=10**9,
                 val_freq=10**9, save_model_freq=10**9)
    tcfg = TrainConfig(batch_size=8, epochs=800, lr=3e-5, imgsz=SIZE,
                       data_name="coco", seed=0, bri_range=BRI)
    val_deg = ISPDataset(f"{root}/images/val", img_size=SIZE, source="raw",
                         train=False, brightness_range=BRI)
    train_deg = ISPDataset(f"{root}/images/train", img_size=SIZE,
                           source="raw", train=True, brightness_range=BRI)
    trainer = Trainer(cfg, tcfg, train_path=f"{root}/images/train",
                      save_dir=os.path.join(root, "run"),
                      yolo_state_dict=det_tr.ema_state_dict(), t_max=8,
                      data_source="raw", log=False, yolo_spec=SPEC,
                      yolo_dtype="float32", device=dev)

    def eval_agent():
        trainer.agent.eval()
        return run_validation(cfg, trainer.agent, trainer.yolo, val_deg,
                              steps=5, batch_size=1, yolo_spec=SPEC,
                              save_dir=None)["map50"]

    res["map_raw"] = _map_plain_images(trainer.yolo, val_deg)
    res["map_untrained"] = eval_agent()
    wall["evaluations_s"] = time.perf_counter() - t0
    count("raw_and_untrained")

    t0 = time.perf_counter()
    trainer.train(max_steps=RL_STEPS, print_freq=200)
    wall["rl_s"] = time.perf_counter() - t0
    count("rl")
    t0 = time.perf_counter()
    res["map_agent"] = eval_agent()
    res["history"] = trainer.history

    # realised rollout length of the trained agent under the early-exit
    # eval rollout (selected == -1 marks the steps after a stop)
    lengths = []
    rs = np.random.RandomState(1)
    for i in range(min(16, len(val_deg))):
        im = torch.from_numpy(val_deg[i]["im"][None]).to(trainer.device)
        noises = torch.from_numpy(
            rs.rand(5, 1, cfg.z_dim).astype(np.float32)).to(trainer.device)
        st = torch.from_numpy(
            get_initial_states(1, cfg.num_state_dim)).to(trainer.device)
        r = rollout(trainer.agent, im, noises, st, no_pipeline(5),
                    render="switch")
        lengths.append(int((r.selected[:, 0] != -1).sum()))
    res["realized_steps_mean"] = float(np.mean(lengths))
    res["realized_steps"] = lengths
    trainer.close()
    wall["evaluations_s"] += time.perf_counter() - t0
    count("agent_and_rollouts")

    # ---- fixed-pipeline baseline (the 70.1 row) ----
    t0 = time.perf_counter()
    hyp = LossHyp(box=0.05, obj=0.7, cls=0.25)
    rng = np.random.RandomState(0)
    order = rng.permutation(len(train_deg))
    batches = []
    for s in range(0, len(order) - 7, 8):
        b = collate([train_deg[i] for i in order[s:s + 8]])
        t, m = pad_targets(b["label"], 8)
        batches.append(tuple(torch.from_numpy(a).to(trainer.device)
                             for a in (b["im"], t, m)))
    stages, _, hist = optimize_fixed_pipeline(
        cfg, FIVE_STAGES, trainer.yolo, anchors_in_grid_units(SPEC),
        batches, hyp=hyp, lr=3e-2, steps=250, verbose=False)
    # best loss, not last: the returned stages are the best iterate's
    res["fixed_loss0"], res["fixed_lossN"] = hist[0], min(hist)
    res["map_fixed"] = _map_plain_images(trainer.yolo, val_deg,
                                         render_stages=stages, cfg=cfg)
    wall["fixed_s"] = time.perf_counter() - t0
    count("fixed")
    res["wall_s"], res["launches"] = wall, launches

    with open(os.path.join(root, "gate_results.json"), "w") as f:
        json.dump({k: v for k, v in res.items() if k != "history"}, f,
                  indent=2)
    print("\nRL LEARNING GATE:", json.dumps(
        {k: (round(v, 4) if isinstance(v, float) else v)
         for k, v in res.items() if k != "history"}))
    return res


@pytest.mark.slow
class TestLearningGate:
    def test_detector_pretrains_on_bright(self, gate):
        assert gate["map_bright"] > 0.8

    def test_degradation_collapses_map(self, gate):
        assert gate["map_raw"] < gate["map_bright"] - 0.25

    def test_reward_trends_up(self, gate):
        """Mean reward rises and the retouched detection loss falls below
        the input loss late in training."""
        h = gate["history"]
        assert len(h) >= RL_STEPS
        early_r = np.mean([s["reward"] for s in h[:50]])
        late_r = np.mean([s["reward"] for s in h[-150:]])
        assert late_r > early_r
        late_in = np.mean([s["detect_input_loss"] for s in h[-100:]])
        late_out = np.mean([s["detect_retouch_loss"] for s in h[-100:]])
        assert late_out < late_in

    def test_agent_beats_raw_input(self, gate):
        assert gate["map_agent"] > gate["map_raw"] + 0.2

    def test_agent_beats_untrained_policy(self, gate):
        assert gate["map_agent"] > gate["map_untrained"] + 0.2

    def test_agent_recovers_bright_performance(self, gate):
        assert gate["map_agent"] > 0.75

    def test_fixed_pipeline_baseline_is_real(self, gate):
        """The optimiser descends the detector loss (best iterate) and
        lifts mAP far above raw."""
        assert gate["fixed_lossN"] < gate["fixed_loss0"] - 0.2
        assert gate["map_fixed"] > gate["map_raw"] + 0.2

    def test_adaptive_matches_or_beats_fixed(self, gate):
        """The paper's headline comparison, with a wide margin."""
        assert gate["map_agent"] > gate["map_fixed"] + 0.1


@pytest.mark.slow
class TestRealizedRollout:
    def test_realized_rollout_length_recorded(self, gate):
        lengths = gate["realized_steps"]
        assert len(lengths) >= 8
        assert all(1 <= n <= 5 for n in lengths)
        assert 1.0 <= gate["realized_steps_mean"] <= 5.0
