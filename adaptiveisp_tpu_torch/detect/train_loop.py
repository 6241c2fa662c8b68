"""Epoch-level detector training and its CLI (port of
``adaptiveisp_tpu/detect/train_loop.py``).

    python -m adaptiveisp_tpu_torch.detect.train_loop --data IMAGES \\
        --val-data VAL --spec yolov3 --imgsz 640 --batch-size 16

The reference's fine-tune loop (yolov3/train.py:199-460): warmup with the
per-group bias-lr and momentum ramps, optional multi-scale, in-loop
validation on the EMA weights and fitness, best/last checkpoints,
EarlyStopping, image weights, hyperparameter evolution.

Three parameter groups as smart_optimizer: conv kernels (weight decay),
BatchNorm weights, and every bias (BatchNorm biases included, which take the
warmup bias lr).  Over ``nw = max(round(warmup_epochs * steps), 100)``
updates the bias lr falls from ``warmup_bias_lr`` to ``lr0 * lf`` while the
others rise from 0, and SGD's momentum rises from ``warmup_momentum``;
``lf`` is the cosine one-cycle (default) or the reference's linear decay.
Multi-scale draws from the stride-multiple sizes of 0.75, 1 and 1.25 times
the image size.  Checkpoints are ``torch.save`` dicts with the JAX
package's fields and ultralytics state-dict keys, plus the data streams'
random states so that a resume repeats the epochs it continues.  Runs on
``--device`` (``cuda`` by default).
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from adaptiveisp_tpu_torch import api
from adaptiveisp_tpu_torch.data.detector_dataset import DetectorDataset
from adaptiveisp_tpu_torch.detect.loss import LossHyp
from adaptiveisp_tpu_torch.detect.metrics import process_batch, summarize
from adaptiveisp_tpu_torch.detect.model import (
    anchors_in_grid_units,
    decode_predictions,
)
from adaptiveisp_tpu_torch.detect.nms import non_max_suppression
from adaptiveisp_tpu_torch.detect.train_detector import (
    DetectorOptimizer,
    DetTrainConfig,
    EarlyStopping,
    f32,
    init_detector_train_state,
    make_detector_train_step,
    param_groups,
)
from adaptiveisp_tpu_torch.obs.plots import plots_available
from adaptiveisp_tpu_torch import parallel
from adaptiveisp_tpu_torch import tensor_parallel as tp_lib

IOUV = np.linspace(0.5, 0.95, 10)


def fitness_of(metrics: Dict[str, float]) -> float:
    """0.1*mAP50 + 0.9*mAP (reference metrics.py:17-20)."""
    return 0.1 * metrics["map50"] + 0.9 * metrics["map"]


# --------------------------------------------------------------------------- #
# Optimizer: 3 parameter groups with the reference's warmup ramps
# --------------------------------------------------------------------------- #
def make_warmup_optimizer(cfg: DetTrainConfig, steps_per_epoch: int):
    """smart_optimizer groups with the train.py:291-302 warmup.

    cfg.optimizer picks SGD / Adam / AdamW (Adam betas (momentum, 0.999));
    cfg.cos_lr the cosine one-cycle or the linear lf; cfg.freeze zeroes the
    updates of the listed spec layer ids.  Returns (factory ``model ->
    optimizer``, the kernel and norm groups' lr schedule)."""
    nw = max(round(cfg.warmup_epochs * steps_per_epoch), 100)
    total_epochs = cfg.epochs

    def lf(step):
        epoch = step / steps_per_epoch
        if not cfg.cos_lr:  # linear: (1 - x/epochs) * (1 - lrf) + lrf
            return (1.0 - epoch / total_epochs) * (1.0 - cfg.lrf) + cfg.lrf
        return ((1 - torch.cos(epoch * np.pi / total_epochs)) / 2
                * (cfg.lrf - 1.0) + 1.0)

    def lr_main(step):
        step = f32(step)
        target = cfg.lr0 * lf(step)
        return target * torch.clamp(step / nw, 0.0, 1.0)

    def lr_bias(step):
        step = f32(step)
        target = cfg.lr0 * lf(step)
        frac = torch.clamp(step / nw, 0.0, 1.0)
        return cfg.warmup_bias_lr + (target - cfg.warmup_bias_lr) * frac

    def momentum(step):
        frac = torch.clamp(f32(step) / nw, 0.0, 1.0)
        return cfg.warmup_momentum + (cfg.momentum
                                      - cfg.warmup_momentum) * frac

    def factory(model):
        groups = param_groups(model, {"kernel": cfg.weight_decay},
                              cfg.freeze)
        return DetectorOptimizer(
            groups, {"kernel": (lr_main, momentum),
                     "norm": (lr_main, momentum),
                     "bias": (lr_bias, momentum)},
            kind=cfg.optimizer, b1=cfg.momentum, b2=0.999)

    return factory, lr_main


# --------------------------------------------------------------------------- #
# In-loop validation
# --------------------------------------------------------------------------- #
@torch.no_grad()
def validate_detector(model, dataset: DetectorDataset, spec,
                      conf_thres: float = 0.001, iou_thres: float = 0.6,
                      max_det: int = 300, max_nms: int = 4096,
                      max_batches: Optional[int] = None,
                      merge: bool = False, plots: bool = False,
                      save_dir: Optional[str] = None,
                      names=None) -> Dict[str, float]:
    """Validation pass of ``model`` (eval mode, on its own device): forward
    -> decode -> NMS -> matching -> mAP.  With plots=True (and a save_dir),
    also fills a ConfusionMatrix and writes its plot and the PR / F1 / P / R
    curves (matplotlib)."""
    dev = next(model.parameters()).device
    was_training = model.training
    model.eval()
    confusion = None
    if plots:
        from adaptiveisp_tpu_torch.detect.metrics import ConfusionMatrix

        confusion = ConfusionMatrix(nc=spec["nc"])
    stats = []
    for bi, (images, targets, tmask) in enumerate(
            dataset.epoch_batches(shuffle=False)):
        if max_batches is not None and bi >= max_batches:
            break
        x = torch.from_numpy(images).to(dev)
        det, nvalid = non_max_suppression(
            decode_predictions(model(x), spec), conf_thres=conf_thres,
            iou_thres=iou_thres, max_det=max_det, max_nms=max_nms,
            multi_label=True, merge=merge)
        det, nvalid = det.cpu().numpy(), nvalid.cpu().numpy()
        h, w = images.shape[1:3]
        for i in range(images.shape[0]):
            d = det[i][:int(nvalid[i])]
            lb = targets[i][tmask[i]]
            gt = np.zeros((len(lb), 5), np.float32)
            if len(lb):
                gt[:, 0] = lb[:, 0]
                gt[:, 1] = (lb[:, 1] - lb[:, 3] / 2) * w
                gt[:, 2] = (lb[:, 2] - lb[:, 4] / 2) * h
                gt[:, 3] = (lb[:, 1] + lb[:, 3] / 2) * w
                gt[:, 4] = (lb[:, 2] + lb[:, 4] / 2) * h
            stats.append((process_batch(d, gt, IOUV), d[:, 4], d[:, 5],
                          gt[:, 0]))
            if confusion is not None:
                confusion.process_batch(d, gt)
    model.train(was_training)
    plot_dir = save_dir if (plots and save_dir) else None
    if plot_dir:
        os.makedirs(plot_dir, exist_ok=True)
    names_dict = (names if isinstance(names, dict) or names is None
                  else {i: n for i, n in enumerate(names)})
    out = summarize(stats, names=names_dict, plot_dir=plot_dir)
    if confusion is not None:
        out["confusion_matrix"] = confusion.matrix
        if plot_dir:
            confusion.plot(save_dir=plot_dir, names=list(names or ()))
    return out


# --------------------------------------------------------------------------- #
# The orchestrator
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class EpochLog:
    epoch: int
    loss: float
    lr: float
    metrics: Dict[str, float]
    fitness: float
    seconds: float


class DetectorTrainer:
    """Runs epochs end to end; the reference yolov3/train.py loop.

    ``model`` is a ``DetectionModel`` holding the initial weights; it is
    moved to ``device`` and trained in place.  ``mesh``: a data mesh
    (``parallel.py``), one trainer per rank on ``mesh.device``: every
    rank reads the same epochs and keeps its rows of each batch; the step
    has the global batch's BatchNorm statistics, loss divisors and summed
    gradients, so every rank holds the single-device run's model; rank 0
    alone validates (every rank follows its fitness) and writes
    checkpoints, logs and plots.  A (data x model) mesh
    (``train/mesh.make_mesh_dp_tp``) also splits the model's layers over
    the model ranks (``tensor_parallel.py``): each rank holds its block of
    the output channels of every split layer's weights, BatchNorm
    statistics, optimizer moments and EMA; checkpoints and the validated
    EMA model hold the whole tensors, equal to a single process's.

    Subclass hooks (the segmentation trainer's): ``_build_step`` supplies
    the step, ``_validate`` the per-epoch metrics and fitness,
    ``_batch_arity`` how many arrays a dataset batch carries,
    ``_plot_train_batch`` draws a batch and ``_plot_final_val`` the final
    validation plots."""

    _batch_arity = 3  # (images, targets, tmask)

    def __init__(self, model, spec, train_ds: DetectorDataset,
                 val_ds: Optional[DetectorDataset] = None,
                 cfg: Optional[DetTrainConfig] = None,
                 hyp: Optional[LossHyp] = None,
                 save_dir: Optional[str] = None,
                 multi_scale: bool = False,
                 val_batches: Optional[int] = None,
                 mesh=None, plots: bool = False, names=None,
                 noval: bool = False, nosave: bool = False,
                 save_period: int = -1, image_weights: bool = False,
                 callbacks=None, loggers: bool = True, device="cuda"):
        self.mesh = mesh
        self.tp = mesh is not None and parallel.MODEL_AXIS in mesh.axis_names
        self.is_main = mesh is None or mesh.is_main
        self.device = (api.resolve_device(device) if mesh is None
                       else mesh.device)
        self.model = parallel.replicate(mesh, model.to(self.device))
        self.spec = spec
        self.train_ds = train_ds
        self.val_ds = val_ds
        self.cfg = cfg or DetTrainConfig()
        self.steps_per_epoch = max(1, len(train_ds) // train_ds.batch_size)
        imgsz = train_ds.img_size
        self.hyp = hyp or LossHyp(obj=1.0 * (imgsz / 640) ** 2)
        self.save_dir = save_dir
        self.val_batches = val_batches
        self._final_plots = plots and save_dir is not None
        self.plots = self._final_plots and self.is_main
        self.names = names
        self.noval = noval            # only validate the final epoch
        self.nosave = nosave          # only save the final checkpoint
        self.save_period = save_period
        self.image_weights = image_weights
        # per-class mAP vector feeding --image-weights (train.py:259)
        self.maps = np.zeros(spec["nc"], np.float32)
        if image_weights:
            from adaptiveisp_tpu_torch.detect.autoanchor import (
                labels_to_class_weights,
            )

            self._class_weights = labels_to_class_weights(
                list(train_ds.labels), spec["nc"]).astype(np.float32)

        self.tx, self._lr_fn = make_warmup_optimizer(
            self.cfg, self.steps_per_epoch)
        self.step_fn = self._build_step()
        self.state = init_detector_train_state(self.model, self.tx,
                                               self.cfg.ema_decay)
        # the EMA weights are validated on a copy (live BN statistics)
        self._eval_model = copy.deepcopy(self.model).eval()
        if self.tp:
            self.step_fn, self.state = tp_lib.shard_detector_train_step(
                self.step_fn, mesh, self.state)
        self.stopper = EarlyStopping(self.cfg.patience)
        self.best_fitness = 0.0
        self.history: List[EpochLog] = []
        # hook bus + logging backends: every epoch / save / end event fans
        # out to the metric writer and the offline run directory
        from adaptiveisp_tpu_torch.obs.callbacks import Callbacks

        self.callbacks = callbacks if callbacks is not None else Callbacks()
        if loggers and save_dir is not None and self.is_main:
            from adaptiveisp_tpu_torch.obs.loggers import Loggers

            Loggers(save_dir, self.callbacks, config=self.cfg)

        # multi-scale: stride-multiple sizes in the reference's band
        # (train.py:310-316), Python's round as the JAX package's
        self.sizes = [imgsz]
        if multi_scale:
            s = train_ds.stride
            self.sizes = sorted({
                int(round(imgsz * f / s)) * s for f in (0.75, 1.0, 1.25)})
        self._ms_rng = np.random.RandomState(0)

    start_epoch = 0

    # ------------------------------------------------------------------ #
    def _build_step(self):
        return make_detector_train_step(anchors_in_grid_units(self.spec),
                                        self.hyp, mesh=self.mesh)

    def _validate(self):
        metrics = {"precision": 0.0, "recall": 0.0, "map50": 0.0,
                   "map": 0.0}
        if self.val_ds is not None:
            metrics = validate_detector(
                self.ema_model(), self.val_ds, self.spec,
                max_batches=self.val_batches)
        return metrics, fitness_of(metrics)

    def _whole(self, state: Dict[str, torch.Tensor]):
        """``state`` (model-named tensors) with the split ones whole: a
        collective over the model ranks under tensor parallelism."""
        if not self.tp:
            return state
        return tp_lib.gather_state(self.mesh, state, self.model._tp_specs)

    def ema_state_dict(self) -> Dict[str, torch.Tensor]:
        """The EMA parameters with the live BatchNorm statistics (what
        validation and the learning gate's detector use), whole (every
        rank calls it under tensor parallelism)."""
        return self._whole(self.state.ema.state_dict(self.model))

    def _load_eval_model(self):
        """The eval copy of the model takes ``ema_state_dict()``; under
        tensor parallelism every rank calls it before rank 0 validates."""
        self._eval_model.load_state_dict(self.ema_state_dict())

    def ema_model(self):
        """The eval copy of the model holding ``ema_state_dict()`` (under
        tensor parallelism, as ``_load_eval_model`` last gathered it)."""
        if not self.tp:
            self._load_eval_model()
        return self._eval_model.eval()

    def _maybe_rescale(self, x: torch.Tensor) -> torch.Tensor:
        """Multi-scale: resize the NHWC batch on the device to a size drawn
        from ``sizes`` (bilinear, antialiased when shrinking)."""
        if len(self.sizes) == 1:
            return x
        size = int(self._ms_rng.choice(self.sizes))
        if size == x.shape[1]:
            return x
        y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size),
                          mode="bilinear", align_corners=False,
                          antialias=True)
        return y.permute(0, 2, 3, 1).contiguous()

    def _plot_train_batch(self, bi: int, images, targets, tmask, *extra):
        """train_batch{0,1,2}.jpg mosaics with drawn boxes."""
        from adaptiveisp_tpu_torch.obs.plots import plot_images

        rows = []
        for i in range(images.shape[0]):
            for t in np.asarray(targets[i])[np.asarray(tmask[i])]:
                rows.append([i, t[0], t[1], t[2], t[3], t[4]])
        plot_images(images, np.asarray(rows, np.float32), fname=os.path.join(
            self.save_dir, f"train_batch{bi}.jpg"), names=self.names)

    def _plot_labels(self):
        """labels.jpg distribution panel."""
        from adaptiveisp_tpu_torch.obs.plots import plot_labels

        labels = [lb for lb in self.train_ds.labels if len(lb)]
        if labels:
            plot_labels(np.concatenate(labels, 0), names=self.names or (),
                        save_dir=self.save_dir)

    def train_epoch(self, epoch: int) -> float:
        """One epoch; the losses stay on the device until its end, so the
        host builds the next batch while the device runs the step."""
        losses = []
        for bi, (images, *rest) in enumerate(self.train_ds.epoch_batches()):
            if self.plots and epoch == 0 and bi < 3:
                os.makedirs(self.save_dir, exist_ok=True)
                self._plot_train_batch(bi, images, *rest)
            if self.mesh is not None:
                x, *rest = parallel.shard_batch(self.mesh, (images, *rest))
            else:
                x, *rest = (torch.from_numpy(a).to(self.device)
                            for a in (images, *rest))
            self.state, out = self.step_fn(self.state, self._maybe_rescale(x),
                                           *rest)
            losses.append(out["loss"])
        if not losses:
            return float("nan")
        return float(torch.stack(losses).mean())

    def _save(self, name: str, epoch: int, fit: float):
        if self.save_dir is None:
            return
        model, ema = (self._whole(self.model.state_dict()),
                      self._whole(self.state.ema.params))
        opt_state = (tp_lib.gather_optimizer_state(
            self.mesh, self.state.optimizer, self.model,
            self.model._tp_specs) if self.tp
            else self.state.optimizer.state_dict())
        if not self.is_main:   # rank 0 writes; the ranks meet after it
            parallel.sync_global_devices(self.mesh)
            return
        os.makedirs(self.save_dir, exist_ok=True)
        cpu = lambda sd: {k: v.detach().cpu() for k, v in sd.items()}
        payload = {
            "epoch": epoch,
            "best_fitness": self.best_fitness,
            "model": cpu(model),
            "ema": cpu(ema),
            "updates": int(self.state.ema.updates),
            "fitness": fit,
            # optimizer + step so a resume continues exactly
            "opt_state": opt_state,
            "step": int(self.state.step),
            # the anchors the model was trained against (may differ from
            # the base spec after an AutoAnchor refit)
            "spec_anchors": [list(map(float, a))
                             for a in self.spec["anchors"]],
            "nc": int(self.spec["nc"]),
            # the data streams, so a resume repeats the same batches
            "data_rng": self.train_ds.rng.get_state(),
            "ms_rng": self._ms_rng.get_state(),
        }
        path = os.path.join(self.save_dir, name)
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        parallel.sync_global_devices(self.mesh)

    def resume(self, path: str) -> int:
        """Restore model, optimizer, EMA, step, best fitness and the data
        streams from a ``last.pt`` checkpoint and return the epoch to
        continue from.  A checkpoint without optimizer state (a stripped
        one) resumes the weights with a fresh optimizer.  Under tensor
        parallelism each rank takes its blocks of the whole tensors."""
        ckpt = load_detector_checkpoint(path)
        st = self.state
        specs = self.model._tp_specs if self.tp else {}
        cut = ((lambda sd: tp_lib.slice_state(self.mesh, sd, specs))
               if self.tp else (lambda sd: sd))
        self.model.load_state_dict(cut(ckpt["model"]))
        st.optimizer = self.tx(self.model)
        if "opt_state" in ckpt:
            opt_state = ckpt["opt_state"]
            if self.tp:
                opt_state = tp_lib.slice_optimizer_state(
                    self.mesh, opt_state, st.optimizer, self.model, specs)
            st.optimizer.load_state_dict(opt_state)
        if ckpt.get("ema") is not None:
            for k, v in cut(ckpt["ema"]).items():
                st.ema.params[k].copy_(v)
            st.ema.updates = int(ckpt["updates"])
        st.step = int(ckpt.get("step", 0))
        if "data_rng" in ckpt:
            self.train_ds.rng.set_state(ckpt["data_rng"])
            self._ms_rng.set_state(ckpt["ms_rng"])
        self.best_fitness = float(ckpt.get("best_fitness", 0.0))
        # keep the early-stop window consistent with the restored run
        self.stopper.best_fitness = self.best_fitness
        self.stopper.best_epoch = int(ckpt.get("epoch", 0))
        self.start_epoch = int(ckpt.get("epoch", -1)) + 1
        return self.start_epoch

    def fit(self, epochs: Optional[int] = None) -> List[EpochLog]:
        """The epoch loop: train -> val -> best/last checkpoints -> early
        stop (reference train.py:276-446)."""
        epochs = epochs or self.cfg.epochs
        curves = self.plots and plots_available()
        if curves:
            self._plot_labels()
        self.callbacks.run("on_train_start")
        for epoch in range(self.start_epoch, epochs):
            t0 = time.time()
            if self.image_weights:
                # weighted image re-sampling toward weak classes
                from adaptiveisp_tpu_torch.detect.autoanchor import (
                    labels_to_image_weights,
                )

                nc = len(self.maps)
                cw = self._class_weights * (1 - self.maps) ** 2 / nc
                iw = labels_to_image_weights(
                    list(self.train_ds.labels), nc, cw)
                n = len(self.train_ds.labels)
                if iw.sum() > 0:
                    self.train_ds.indices = self._ms_rng.choice(
                        n, size=n, p=iw / iw.sum())
            loss = self.train_epoch(epoch)
            final = epoch == epochs - 1
            validated = not (self.noval and not final)
            if validated:
                # rank 0 validates; every rank takes its metrics, so the
                # saves and the early stop below decide alike on each
                if self.tp:
                    self._load_eval_model()
                metrics, fit = parallel.on_main(self.mesh, self._validate)
                for c, ap in metrics.get("class_ap", {}).items():
                    if 0 <= c < len(self.maps):
                        self.maps[c] = ap
            else:  # --noval: only validate the final epoch
                metrics = {"precision": 0.0, "recall": 0.0,
                           "map50": 0.0, "map": 0.0}
                fit = self.best_fitness  # keeps early-stop inert

            # best fitness is tracked whatever is saved; the save gate
            # only chooses the files
            best_now = validated and fit >= self.best_fitness
            if best_now:
                self.best_fitness = fit
            if not self.nosave or final:
                if best_now:
                    self._save("best.pt", epoch, fit)
                self._save("last.pt", epoch, fit)
                if self.save_period > 0 and epoch % self.save_period == 0:
                    self._save(f"epoch{epoch}.pt", epoch, fit)
                if self.save_dir is not None:
                    self.callbacks.run(
                        "on_model_save",
                        os.path.join(self.save_dir, "last.pt"), epoch, fit)

            lr_now = float(self._lr_fn(self.state.step))
            log = EpochLog(epoch, loss, lr_now, metrics, fit,
                           time.time() - t0)
            self.history.append(log)
            self._append_csv(log)
            self.callbacks.run("on_fit_epoch_end", self._flat_metrics(log),
                               epoch)
            if self.stopper(epoch, fit):
                break
        self.callbacks.run("on_train_end")
        if (self.tp and self._final_plots and plots_available()
                and self.history and self.val_ds is not None):
            self._load_eval_model()   # every rank: rank 0 plots
        if curves and self.history:
            from adaptiveisp_tpu_torch.obs.plots import plot_results

            plot_results(os.path.join(self.save_dir, "results.csv"))
            if self.val_ds is not None:
                self._plot_final_val()
        return self.history

    def _plot_final_val(self):
        """Final curve and confusion plots from the EMA weights."""
        validate_detector(
            self.ema_model(), self.val_ds, self.spec,
            max_batches=self.val_batches, plots=True,
            save_dir=self.save_dir, names=self.names)

    @staticmethod
    def _flat_metrics(log: EpochLog) -> Dict[str, float]:
        """One flat scalar dict per epoch: the row every logging sink
        (csv / metric writer / offline run dir) receives."""
        flat = {"epoch": log.epoch, "loss": log.loss, "lr": log.lr,
                "fitness": log.fitness, "seconds": round(log.seconds, 2)}
        for k, v in log.metrics.items():
            if k == "class_ap":  # per-class-id vector, not a scalar column
                continue
            if isinstance(v, dict):
                for k2, v2 in v.items():
                    if isinstance(v2, (int, float)):
                        flat[f"{k}/{k2}"] = v2
            elif isinstance(v, (int, float)):
                flat[k] = v
        return flat

    def _append_csv(self, log: EpochLog):
        """Per-epoch results.csv."""
        if self.save_dir is None or not self.is_main:
            return
        os.makedirs(self.save_dir, exist_ok=True)
        path = os.path.join(self.save_dir, "results.csv")
        flat = self._flat_metrics(log)
        new = not os.path.exists(path)
        with open(path, "a") as f:
            if new:
                f.write(",".join(flat) + "\n")
            f.write(",".join(f"{v:.6g}" if isinstance(v, float) else str(v)
                             for v in flat.values()) + "\n")


def load_detector_checkpoint(path: str):
    return torch.load(path, map_location="cpu", weights_only=False)


def strip_optimizer(path: str, out: Optional[str] = None) -> str:
    """Finalise a best/last checkpoint for deployment (reference
    general.py strip_optimizer): the EMA takes the parameters' place, the
    optimizer state, EMA and counters go, epoch becomes -1.  The result
    loads wherever inference does (``--weights``) but cannot resume."""
    payload = load_detector_checkpoint(path)
    if payload.get("ema") is not None:
        payload["model"] = {**payload["model"], **payload["ema"]}
    for k in ("opt_state", "ema", "updates", "step", "data_rng", "ms_rng"):
        payload.pop(k, None)
    payload["epoch"] = -1
    out = out or path
    torch.save(payload, out)
    mb = os.path.getsize(out) / 1e6
    print(f"strip_optimizer: saved {out} ({mb:.1f} MB)")
    return out


def _load_initial_weights(path: str, model, spec):
    """--weights init for fine-tuning: a checkpoint of this trainer, an
    ultralytics ``.pt`` or a ``.pkl`` of flax variables (both through
    ``train_isp.load_yolo_weights``)."""
    from adaptiveisp_tpu_torch.train_isp import load_yolo_weights

    sd = load_yolo_weights(path, spec)
    if sd is not None:
        model.load_state_dict(sd)
    return model


def main(argv: Optional[Sequence[str]] = None):
    """``python -m adaptiveisp_tpu_torch.detect.train_loop``: the standalone
    detector trainer CLI (reference yolov3/train.py:463-516 surface)."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True,
                   help="train images: dir, .txt list, or glob")
    p.add_argument("--val-data", default=None)
    p.add_argument("--spec", default="yolov3",
                   help="yolov3 | yolov3-tiny (the port's specs)")
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--batch-size", type=int, default=16,
                   help="-1: the largest batch that fits (autobatch)")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr0", type=float, default=None,
                   help="override the hyp lr0")
    p.add_argument("--hyp", default=None,
                   help="hyperparameter YAML (defaults = hyp.scratch-low)")
    p.add_argument("--evolve", type=int, nargs="?", const=10, default=None,
                   help="evolve hyperparameters for N generations")
    p.add_argument("--patience", type=int, default=100)
    p.add_argument("--multi-scale", action="store_true")
    p.add_argument("--single-cls", action="store_true")
    p.add_argument("--weights", default=None,
                   help="initial weights: a best/last.pt of this trainer, "
                        "an ultralytics .pt, or a .pkl of flax variables")
    p.add_argument("--optimizer", default="SGD",
                   choices=["SGD", "Adam", "AdamW"])
    p.add_argument("--linear-lr", action="store_true",
                   help="linear LR decay (the reference default); cosine "
                        "one-cycle is this trainer's default")
    p.add_argument("--cos-lr", action="store_true",
                   help="cosine LR (accepted for reference-CLI compat; "
                        "already the default)")
    p.add_argument("--label-smoothing", type=float, default=None,
                   help="label smoothing epsilon (hyp override)")
    p.add_argument("--freeze", type=int, nargs="+", default=None,
                   help="freeze layers: single N = layers 0..N-1 "
                        "(backbone=10), or an explicit id list")
    p.add_argument("--image-weights", action="store_true",
                   help="weighted image re-sampling toward weak classes")
    p.add_argument("--rect", action="store_true",
                   help="rectangular training (per-batch shape buckets; "
                        "keeps HSV/flip/perspective, no mosaic/mixup)")
    p.add_argument("--noval", action="store_true",
                   help="only validate the final epoch")
    p.add_argument("--nosave", action="store_true",
                   help="only save the final checkpoint")
    p.add_argument("--noautoanchor", action="store_true",
                   help="disable the AutoAnchor BPR check/refit")
    p.add_argument("--save-period", type=int, default=-1,
                   help="also save epoch{N}.pt every N epochs")
    p.add_argument("--cache", default="none", choices=["none", "ram", "disk"])
    p.add_argument("--nc", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save-dir", default="runs/train-det")
    p.add_argument("--exist-ok", action="store_true",
                   help="write into --save-dir even if it exists (default: "
                        "auto-increment to save-dir2, 3, ...)")
    p.add_argument("--plots", action="store_true",
                   help="train-batch mosaics, label plots, results curves, "
                        "confusion matrix (curves need matplotlib)")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel ranks: 0 off, N ranks (NCCL on N "
                        "cards, gloo with --device cpu), below 0 every card")
    p.add_argument("--tp", type=int, default=0,
                   help="tensor-parallel: split every conv's output "
                        "channels over N ranks (with --dp M a data x "
                        "model mesh of max(M, 1) x N ranks; NCCL on "
                        "cards, gloo with --device cpu)")
    p.add_argument("--resume", default=None,
                   help="last.pt checkpoint to continue from (restores "
                        "optimizer / EMA / epoch / data streams)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    mesh, launched = parallel.cli_mesh(
        args.dp, args.device, "adaptiveisp_tpu_torch.detect.train_loop:main",
        argv, n_axis=args.tp, axis=parallel.MODEL_AXIS)
    if launched:
        return None

    import yaml

    from adaptiveisp_tpu_torch.detect.hyp import (
        evolve_detector,
        load_hyp,
        split_hyp,
    )
    from adaptiveisp_tpu_torch.detect.spec import resolve_spec

    dev = api.resolve_device(args.device) if mesh is None else mesh.device
    spec = resolve_spec(args.spec)
    if args.nc is not None and args.nc != spec["nc"]:
        spec = dict(spec, nc=args.nc)

    hyp_dict = load_hyp(args.hyp)
    if args.lr0 is not None:
        hyp_dict["lr0"] = args.lr0
    if args.label_smoothing is not None:
        hyp_dict["label_smoothing"] = args.label_smoothing
    nl = len(spec["anchors"])
    freeze = None
    if args.freeze:
        freeze = (tuple(range(args.freeze[0])) if len(args.freeze) == 1
                  else tuple(args.freeze))

    def new_model(run_spec):
        return api.load_detector(spec=run_spec, seed=args.seed,
                                 device=dev).model

    if args.batch_size == -1:
        from adaptiveisp_tpu_torch.detect.autobatch import autobatch_detector

        args.batch_size = autobatch_detector(
            new_model(spec), spec, imgsz=args.imgsz, device=dev)
        # every rank trains on rank 0's choice (the global batch)
        args.batch_size = parallel.broadcast_object(mesh, args.batch_size)

    val_ds = None
    if args.val_data:
        val_ds = DetectorDataset(args.val_data, img_size=args.imgsz,
                                 batch_size=args.batch_size, augment=False,
                                 rect=args.rect,
                                 nc=spec["nc"], single_cls=args.single_cls)

    def build_trainer(hyp_d, save_dir):
        cfg, loss_hyp, aug_hyp = split_hyp(
            hyp_d, nl=nl, nc=spec["nc"], imgsz=args.imgsz,
            epochs=args.epochs, batch_size=args.batch_size,
            patience=args.patience)
        cfg = dataclasses.replace(cfg, optimizer=args.optimizer,
                                  cos_lr=not args.linear_lr,
                                  freeze=freeze or ())
        train_ds = DetectorDataset(
            args.data, img_size=args.imgsz, batch_size=args.batch_size,
            augment=True, rect=args.rect, cache=args.cache,
            nc=spec["nc"], single_cls=args.single_cls, seed=args.seed,
            hyp=aug_hyp)
        run_spec = spec
        if not args.noautoanchor:
            # AutoAnchor: BPR check + k-means refit on this dataset's label
            # sizes; a failure warns and keeps the spec's anchors
            try:
                from adaptiveisp_tpu_torch.detect.autoanchor import (
                    check_anchors,
                )

                whs = [lb[:, 3:5] * args.imgsz for lb in train_ds.labels
                       if len(lb)]
                if whs:
                    anchors_px = np.asarray(
                        spec["anchors"], np.float32).reshape(-1, 2)
                    new, bpr, refit = check_anchors(
                        np.concatenate(whs, 0), anchors_px,
                        thr=hyp_d.get("anchor_t", 4.0))
                    if refit:
                        na2 = anchors_px.shape[0] // nl
                        run_spec = dict(spec, anchors=[
                            [float(v) for v in new[i * na2:(i + 1) * na2]
                             .reshape(-1)] for i in range(nl)])
                        print(f"AutoAnchor: refit anchors "
                              f"(BPR was {bpr:.3f})")
                        if save_dir:
                            os.makedirs(save_dir, exist_ok=True)
                            sp = os.path.join(save_dir, "spec.yaml")
                            with open(sp, "w") as f:
                                yaml.safe_dump(run_spec, f, sort_keys=False)
                            print(f"AutoAnchor: refit spec written to {sp}")
            except Exception as e:
                print(f"AutoAnchor skipped: {e}")
        model = new_model(run_spec)
        if args.weights:
            _load_initial_weights(args.weights, model, run_spec)
        return DetectorTrainer(model, run_spec, train_ds, val_ds,
                               cfg=cfg, hyp=loss_hyp, save_dir=save_dir,
                               multi_scale=args.multi_scale,
                               plots=args.plots, noval=args.noval,
                               nosave=args.nosave,
                               save_period=args.save_period,
                               image_weights=args.image_weights,
                               device=dev, mesh=mesh)

    if args.evolve:
        def build_and_fit(hyp_d):
            tr = build_trainer(hyp_d, save_dir=None)
            tr.fit()
            return tr.best_fitness

        res = evolve_detector(build_and_fit, generations=args.evolve,
                              save_dir=args.save_dir, base_hyp=hyp_dict,
                              seed=args.seed)
        print(f"evolve: best fitness {res['best_fitness']:.4f} over "
              f"{args.evolve} generations -> "
              f"{args.save_dir}/hyp_evolve.yaml")
        return res

    if args.save_dir and not args.resume:
        from adaptiveisp_tpu_torch.obs.logging import increment_path

        if mesh is None or mesh.is_main:
            args.save_dir = increment_path(args.save_dir,
                                           exist_ok=args.exist_ok)
        args.save_dir = parallel.broadcast_object(mesh, args.save_dir)
    trainer = build_trainer(hyp_dict, args.save_dir)
    if args.save_dir and (mesh is None or mesh.is_main):
        # run provenance: opt.yaml + hyp.yaml next to the checkpoints
        os.makedirs(args.save_dir, exist_ok=True)
        with open(os.path.join(args.save_dir, "opt.yaml"), "w") as f:
            yaml.safe_dump(vars(args), f, sort_keys=False)
        with open(os.path.join(args.save_dir, "hyp.yaml"), "w") as f:
            yaml.safe_dump(hyp_dict, f, sort_keys=False)
    if args.resume:
        start = trainer.resume(args.resume)
        print(f"resumed from {args.resume} at epoch {start} "
              f"(best fitness {trainer.best_fitness:.4f})")
    history = trainer.fit()
    for log in history:
        print(f"epoch {log.epoch}: loss {log.loss:.4f} lr {log.lr:.5f} "
              f"map50 {log.metrics['map50']:.4f} fitness {log.fitness:.4f} "
              f"({log.seconds:.1f}s)")
    print(f"best fitness {trainer.best_fitness:.4f} -> "
          f"{args.save_dir}/best.pt")
    return history


if __name__ == "__main__":
    main()
