"""Image classification on a detection spec's backbone (port of
``adaptiveisp_tpu/classify.py``).

    python -m adaptiveisp_tpu_torch.classify --data ROOT [--device cpu]

``ClassificationModel`` runs the backbone rows of any spec (``model.{i}.*``,
ultralytics' keys), then the Classify head at ``model.{k}`` (k = the number
of backbone rows kept): a 1x1 ConvBNAct to ``HEAD_WIDTH`` (``conv``), the
global mean, dropout and a dense layer (``linear``).  Training is
label-smoothed cross-entropy (optax's ``smooth_labels``: ``(1 - a) y +
a / nc``) with a cosine schedule, optax's SGD (Nesterov), Adam, AdamW or
RMSProp after a coupled weight decay on every parameter (AdamW's
decoupled), and the EMA of the parameters; evaluation pairs the EMA
parameters with the live BatchNorm statistics.  Runs on ``--device``
(``cuda`` by default).
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from adaptiveisp_tpu_torch import api
from adaptiveisp_tpu_torch.data.letterbox import resize_bilinear
from adaptiveisp_tpu_torch.data.sources import load_image_file
from adaptiveisp_tpu_torch.detect.layers import ConvBNAct
from adaptiveisp_tpu_torch.detect.model import DetectionModel
from adaptiveisp_tpu_torch.detect.spec import YOLOV3_TINY_SPEC
from adaptiveisp_tpu_torch.detect.train_detector import (
    DetectorOptimizer,
    EarlyStopping,
    ModelEMA,
)
from adaptiveisp_tpu_torch.nn_init import flax_init_
from adaptiveisp_tpu_torch.obs.plots import plots_available
from adaptiveisp_tpu_torch.policy.nets import dropout
from adaptiveisp_tpu_torch.train.optim import cosine_decay_schedule

HEAD_WIDTH = 1280  # efficientnet_b0's (the reference Classify head)


def trunk_spec(spec=None, cutoff: Optional[int] = None):
    """The backbone rows [:cutoff] of ``spec`` as a headless spec."""
    spec = spec or YOLOV3_TINY_SPEC
    rows = list(spec["backbone"])
    if cutoff is not None:
        rows = rows[:cutoff]
    return {"nc": spec.get("nc", 80),
            "depth_multiple": spec.get("depth_multiple", 1.0),
            "width_multiple": spec.get("width_multiple", 1.0),
            "anchors": spec["anchors"], "backbone": rows, "head": []}


class Classify(nn.Module):
    """1x1 ConvBNAct -> global mean -> dropout -> dense.  In train mode the
    dropout mask comes from ``generator`` (flax's ``dropout`` rng, as the
    agent's; needed when ``dropout > 0``)."""

    def __init__(self, c1: int, nc: int, dropout: float = 0.0):
        super().__init__()
        self.conv = ConvBNAct(c1, HEAD_WIDTH, 1, 1)
        self.dropout = dropout
        self.linear = nn.Linear(HEAD_WIDTH, nc)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        f = self.conv(x).mean(dim=(2, 3))
        if self.training:
            f = dropout(f, self.dropout, generator)
        return self.linear(f)


class ClassificationModel(nn.Module):
    """A spec's backbone + Classify head; NHWC images in, logits out."""

    def __init__(self, spec=None, nc: int = 10, cutoff: Optional[int] = None,
                 dropout: float = 0.0):
        super().__init__()
        trunk = DetectionModel(trunk_spec(spec, cutoff))
        self.froms = list(trunk.froms) + [-1]
        self.model = nn.ModuleList(
            list(trunk.model) + [Classify(trunk.channels[-1], nc, dropout)])
        flax_init_(self)

    def forward(self, x_nhwc, generator: Optional[torch.Generator] = None):
        """NHWC images -> logits; ``generator`` draws the head's dropout
        mask in train mode."""
        x = x_nhwc.permute(0, 3, 1, 2)
        outputs: List = []
        for frm, m in zip(self.froms, self.model):
            if isinstance(frm, int):
                inp = x if frm == -1 else outputs[frm]
            else:
                inp = [x if j == -1 else outputs[j] for j in frm]
            x = m(inp, generator) if isinstance(m, Classify) else m(inp)
            outputs.append(x)
        return x


def create_classifier(spec=None, nc: int = 10, cutoff: Optional[int] = None,
                      dropout: float = 0.0, seed: int = 0, device="cuda"):
    """A seeded ``ClassificationModel`` (flax's initial distributions) on
    ``device``."""
    model = api._seeded(seed, lambda: ClassificationModel(
        spec=spec, nc=nc, cutoff=cutoff, dropout=dropout))
    return model.to(api.resolve_device(device))


# --------------------------------------------------------------------------- #
# data: one directory per class (the ImageFolder layout)
# --------------------------------------------------------------------------- #
class FolderDataset:
    def __init__(self, root: str, img_size: int = 224, augment: bool = False,
                 seed: int = 0):
        self.classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        if not self.classes:
            raise FileNotFoundError(f"no class directories under {root}")
        self.samples: List[Tuple[str, int]] = []
        exts = (".png", ".jpg", ".jpeg", ".bmp")
        for ci, c in enumerate(self.classes):
            cdir = os.path.join(root, c)
            for f in sorted(os.listdir(cdir)):
                if f.lower().endswith(exts):
                    self.samples.append((os.path.join(cdir, f), ci))
        self.img_size = img_size
        self.augment = augment
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i: int):
        path, label = self.samples[i]
        im = resize_bilinear(load_image_file(path), self.img_size,
                             self.img_size)
        if self.augment and self.rng.rand() < 0.5:
            im = im[:, ::-1].copy()  # horizontal flip
        return im.astype(np.float32), label

    def epoch_batches(self, batch_size: int, shuffle: bool = True):
        order = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(order)
        for s in range(0, len(order) - batch_size + 1, batch_size):
            ims, labels = zip(*(self[int(i)]
                                for i in order[s:s + batch_size]))
            yield np.stack(ims, 0), np.asarray(labels, np.int32)


# --------------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ClsTrainConfig:
    epochs: int = 10
    batch_size: int = 64
    lr0: float = 0.001
    lrf: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 5e-5
    label_smoothing: float = 0.1
    ema_decay: float = 0.9999
    patience: int = 50
    optimizer: str = "SGD"  # SGD | Adam | AdamW | RMSProp


def smoothed_cross_entropy(logits, labels, label_smoothing: float):
    """Mean cross-entropy against ``(1 - a) onehot + a / nc`` (optax's
    ``smooth_labels``); with a = 0 the integer-label cross-entropy."""
    logp = F.log_softmax(logits.float(), dim=-1)
    if not label_smoothing:
        return -logp.gather(1, labels[:, None].long())[:, 0].mean()
    nc = logits.shape[-1]
    target = (F.one_hot(labels.long(), nc).float() * (1.0 - label_smoothing)
              + label_smoothing / nc)
    return -(target * logp).sum(-1).mean()


def make_classifier_optimizer(cfg: ClsTrainConfig, total_steps: int):
    """Factory ``model -> DetectorOptimizer`` of one group over every
    parameter: the cosine schedule from ``lr0`` to ``lr0 * lrf``, Adam's b1
    = ``momentum``."""
    sched = cosine_decay_schedule(cfg.lr0, max(total_steps, 1),
                                  alpha=cfg.lrf)
    lr = lambda t: torch.tensor(sched(t), dtype=torch.float32)  # noqa: E731
    mom = lambda t: torch.tensor(cfg.momentum,  # noqa: E731
                                 dtype=torch.float32)

    def factory(model):
        return DetectorOptimizer(
            [{"params": list(model.parameters()), "name": "all",
              "weight_decay": cfg.weight_decay, "frozen": False}],
            {"all": (lr, mom)}, kind=cfg.optimizer, b1=cfg.momentum,
            b2=0.999, hyper_f32=False)

    return factory


@dataclasses.dataclass
class ClsTrainState:
    model: nn.Module
    optimizer: DetectorOptimizer
    ema: ModelEMA
    step: int = 0
    generator: Optional[torch.Generator] = None   # the head's dropout


def make_classifier_train_step(cfg: ClsTrainConfig):
    """``step(state, images, labels) -> (state, {"loss", "acc"})``:
    train-mode forward, the smoothed loss, backward, the optimizer, the
    EMA; the metrics stay on the device."""

    def step(state: ClsTrainState, images, labels):
        model = state.model
        model.train()
        out = model(images, generator=state.generator)
        loss = smoothed_cross_entropy(out, labels, cfg.label_smoothing)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.ema.update(model)
        state.step += 1
        acc = (out.detach().argmax(-1) == labels).float().mean()
        return state, {"loss": loss.detach(), "acc": acc}

    return step


@torch.no_grad()
def topk_accuracy(model, ds: FolderDataset, batch_size: int):
    """Top-1 and top-5 of ``model`` (eval mode, on its device) over ``ds``
    in order."""
    dev = next(model.parameters()).device
    model.eval()
    top1 = top5 = n = 0
    for ims, labels in ds.epoch_batches(batch_size, shuffle=False):
        out = model(torch.from_numpy(ims).to(dev)).cpu().numpy()
        rank = np.argsort(-out, axis=-1, kind="stable")
        top1 += (rank[:, 0] == labels).sum()
        top5 += (rank[:, :5] == labels[:, None]).any(1).sum()
        n += len(labels)
    return {"top1": top1 / max(n, 1), "top5": top5 / max(n, 1)}


class ClassifierTrainer:
    """Epoch loop: train -> val top-1/top-5 on the EMA -> best/last ->
    early stop; ``results.csv`` per epoch.  ``model`` is moved to
    ``device`` and trained in place; the head's dropout draws from a
    generator on that device seeded from ``seed`` (JAX's dropout key), so
    two runs with one seed are equal."""

    def __init__(self, model, train_ds: FolderDataset,
                 val_ds: Optional[FolderDataset] = None,
                 cfg: Optional[ClsTrainConfig] = None,
                 save_dir: Optional[str] = None, mesh=None,
                 device="cuda", seed: int = 0):
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (data-parallel classifier training) waits for the "
                "parallelism queue (ROADMAP P15)")
        self.device = api.resolve_device(device)
        self.model = model.to(self.device)
        self.train_ds = train_ds
        self.val_ds = val_ds
        self.cfg = cfg or ClsTrainConfig()
        self.save_dir = save_dir
        steps_per_epoch = max(1, len(train_ds) // self.cfg.batch_size)
        tx = make_classifier_optimizer(self.cfg,
                                       self.cfg.epochs * steps_per_epoch)
        self.state = ClsTrainState(
            self.model, tx(self.model), ModelEMA(self.model,
                                                 self.cfg.ema_decay),
            generator=torch.Generator(device=self.device).manual_seed(seed))
        self.step_fn = make_classifier_train_step(self.cfg)
        self._eval_model = copy.deepcopy(self.model).eval()
        self.stopper = EarlyStopping(self.cfg.patience)
        self.best_acc = 0.0
        self.history: List[Dict] = []

    def ema_model(self):
        """The eval copy holding the EMA parameters and the live BatchNorm
        statistics."""
        self._eval_model.load_state_dict(self.state.ema.state_dict(
            self.model))
        return self._eval_model.eval()

    def validate(self) -> Dict[str, float]:
        return topk_accuracy(self.ema_model(), self.val_ds or self.train_ds,
                             self.cfg.batch_size)

    def _save(self, name: str):
        if self.save_dir is None:
            return
        os.makedirs(self.save_dir, exist_ok=True)
        cpu = lambda sd: {k: v.detach().cpu()  # noqa: E731
                          for k, v in sd.items()}
        payload = {"model": cpu(self.model.state_dict()),
                   "ema": cpu(self.state.ema.params),
                   "classes": self.train_ds.classes,
                   "best_acc": self.best_acc}
        path = os.path.join(self.save_dir, name)
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)

    def fit(self, epochs: Optional[int] = None):
        epochs = epochs or self.cfg.epochs
        for epoch in range(epochs):
            t0 = time.time()
            losses = []
            for ims, labels in self.train_ds.epoch_batches(
                    self.cfg.batch_size):
                self.state, out = self.step_fn(
                    self.state, torch.from_numpy(ims).to(self.device),
                    torch.from_numpy(labels).long().to(self.device))
                losses.append(out["loss"])
            metrics = self.validate()
            if metrics["top1"] >= self.best_acc:
                self.best_acc = metrics["top1"]
                self._save("best.pt")
            self._save("last.pt")
            loss = (float(torch.stack(losses).mean()) if losses
                    else float("nan"))
            self.history.append({"epoch": epoch, "loss": loss, **metrics,
                                 "seconds": time.time() - t0})
            self._append_csv(self.history[-1])
            if self.stopper(epoch, metrics["top1"]):
                break
        if self.save_dir is not None and self.history and plots_available():
            from adaptiveisp_tpu_torch.obs.plots import plot_results

            plot_results(os.path.join(self.save_dir, "results.csv"))
        return self.history

    def _append_csv(self, row: Dict):
        if self.save_dir is None:
            return
        os.makedirs(self.save_dir, exist_ok=True)
        path = os.path.join(self.save_dir, "results.csv")
        keys = [k for k, v in row.items()
                if isinstance(v, (int, float, np.integer, np.floating))]
        new = not os.path.exists(path)
        with open(path, "a") as f:
            if new:
                f.write(",".join(keys) + "\n")
            f.write(",".join(
                f"{row[k]:.6g}" if isinstance(row[k], (float, np.floating))
                else str(row[k]) for k in keys) + "\n")


@torch.no_grad()
def predict(model, images, classes: Sequence[str], top_k: int = 5):
    """Top-k (class, probability) per image; images NHWC float."""
    dev = next(model.parameters()).device
    model.eval()
    out = model(torch.as_tensor(np.asarray(images, np.float32)).to(dev)
                ).cpu().numpy()
    probs = np.exp(out - out.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    rank = np.argsort(-probs, axis=-1, kind="stable")[:, :top_k]
    return [[(classes[j], float(probs[i, j])) for j in rank[i]]
            for i in range(len(rank))]


def apply_classifier(detections, images, classify_fn, imgsz: int = 224):
    """Second-stage classifier gate over detections: square and pad each
    box (max side * 1.3 + 30 px), crop it from its image, resize to
    ``imgsz``, and keep the detections whose classifier argmax is the
    detector's class.

    detections: per image [n, 6] (xyxy, conf, cls); images: float
    [H, W, 3] in [0, 1]; classify_fn(batch [n, imgsz, imgsz, 3]) -> logits.
    """
    out = []
    for det, im in zip(detections, images):
        det = np.asarray(det)
        if det.size == 0:
            out.append(det.reshape(0, 6))
            continue
        cx = (det[:, 0] + det[:, 2]) / 2
        cy = (det[:, 1] + det[:, 3]) / 2
        side = np.maximum(det[:, 2] - det[:, 0],
                          det[:, 3] - det[:, 1]) * 1.3 + 30
        x1 = np.clip(cx - side / 2, 0, im.shape[1] - 1).astype(int)
        x2 = np.clip(cx + side / 2, 1, im.shape[1]).astype(int)
        y1 = np.clip(cy - side / 2, 0, im.shape[0] - 1).astype(int)
        y2 = np.clip(cy + side / 2, 1, im.shape[0]).astype(int)
        crops = np.stack([
            resize_bilinear(im[a:b, c:d], imgsz, imgsz)
            for a, b, c, d in zip(y1, y2, x1, x2)])
        logits = classify_fn(crops)
        if isinstance(logits, torch.Tensor):
            logits = logits.detach().cpu().numpy()
        pred = np.asarray(logits).argmax(-1)
        out.append(det[pred == det[:, 5].astype(int)])
    return out


def load_classifier_weights(path: str, spec=None,
                            cutoff: Optional[int] = None):
    """A classifier ``state_dict``: the port's checkpoint ``.pt`` (its
    ``model``) or the JAX package's ``.pkl`` (flax variables under
    ``model``, through ``convert.classifier_from_flax``)."""
    if path.endswith((".pkl", ".pickle")):
        import pickle

        from adaptiveisp_tpu_torch.convert import classifier_from_flax

        with open(path, "rb") as f:
            ckpt = pickle.load(f)
        v = ckpt["model"] if "model" in ckpt else ckpt
        return classifier_from_flax(v["params"], v["batch_stats"], spec,
                                    cutoff)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return ckpt["model"] if "model" in ckpt else ckpt


def main(argv=None):
    """``python -m adaptiveisp_tpu_torch.classify``: train a classifier on
    ``--data`` (``train/`` and optionally ``val/`` class folders, or the
    class folders themselves), or ``--validate-only`` for the top-1 / top-5
    of the loaded weights."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True,
                   help="root with train/ (and optionally val/) class dirs")
    p.add_argument("--imgsz", type=int, default=224)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lr0", type=float, default=0.001)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--optimizer", default="SGD",
                   choices=["SGD", "Adam", "AdamW", "RMSProp"])
    p.add_argument("--label-smoothing", type=float, default=0.1)
    p.add_argument("--decay", type=float, default=5e-5,
                   help="weight decay")
    p.add_argument("--cutoff", type=int, default=None,
                   help="backbone layer cutoff")
    p.add_argument("--save-dir", default="runs/train-cls")
    p.add_argument("--exist-ok", action="store_true",
                   help="write into --save-dir even if it exists "
                        "(default: auto-increment)")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel over N devices (not ported)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--weights", default=None,
                   help="checkpoint to load before training/validation: "
                        "the port's .pt or the JAX package's .pkl")
    p.add_argument("--validate-only", action="store_true",
                   help="report top-1/top-5 without training")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.dp:
        raise SystemExit(f"--dp {args.dp}: data-parallel classifier "
                         f"training is not ported yet (ROADMAP P15); run "
                         f"with --dp 0 on one device")

    train_root = os.path.join(args.data, "train")
    if not os.path.isdir(train_root):
        train_root = args.data
    train_ds = FolderDataset(train_root, img_size=args.imgsz, augment=True,
                             seed=args.seed)
    val_root = os.path.join(args.data, "val")
    val_ds = (FolderDataset(val_root, img_size=args.imgsz)
              if os.path.isdir(val_root) else None)

    model = create_classifier(nc=len(train_ds.classes), cutoff=args.cutoff,
                              dropout=args.dropout, seed=args.seed,
                              device=args.device)
    if args.weights:
        model.load_state_dict(load_classifier_weights(
            args.weights, cutoff=args.cutoff))
    cfg = ClsTrainConfig(epochs=args.epochs, batch_size=args.batch_size,
                         lr0=args.lr0, optimizer=args.optimizer,
                         label_smoothing=args.label_smoothing,
                         weight_decay=args.decay)
    if args.validate_only:
        # the loaded weights, not the EMA of an untrained state
        m = topk_accuracy(model, val_ds or train_ds, cfg.batch_size)
        n = len(val_ds or train_ds) // cfg.batch_size * cfg.batch_size
        print(f"top1 {m['top1']:.4f} top5 {m['top5']:.4f} ({n} images)")
        return m
    if args.save_dir:
        from adaptiveisp_tpu_torch.obs.logging import increment_path

        args.save_dir = increment_path(args.save_dir,
                                       exist_ok=args.exist_ok)
    trainer = ClassifierTrainer(model, train_ds, val_ds, cfg=cfg,
                                save_dir=args.save_dir, device=args.device,
                                seed=args.seed)
    history = trainer.fit()
    for h in history:
        print(f"epoch {h['epoch']}: loss {h['loss']:.4f} "
              f"top1 {h['top1']:.4f} top5 {h['top5']:.4f} "
              f"({h['seconds']:.1f}s)")
    print(f"best top1 {trainer.best_acc:.4f} -> {args.save_dir}/best.pt")
    return history


if __name__ == "__main__":
    main()
